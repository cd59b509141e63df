"""The hand-written CUDA kernels of dedflow_tpu_torch == their plain versions.

Every test here needs a card (marker `cuda`) and skips without one. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Inputs are
made with numpy from a seed on an odd-sized box (lattice kernels K1-K3,
with the reference and the melt-pool scenario: K1 with a heat source, K2
with the implicit phi/T tangents), on an RCM-ordered Delaunay mesh
(irregular-tier kernels K6-K10, K6 also in its 33-row mode), on an
unordered one (the gather tier's K4/K5, K5 also implicit), on a particle
cloud bucketed onto a cell grid (the DEM contact sweep K11) and on seeded
streams and windows (the probes K12 and K13, dedflow_tpu_torch.tools),
float32 on the card. Relative error = max|kernel - plain| / max|plain|;
the tolerances are float32 roundoff (different sum orders, hardware
rsqrtf), as in chip_smoke.py, which runs the same comparisons at full
size. Every kernel is also run twice: the two results are bit-identical
(no atomics). The segmented reduces K8/K9 also equal, bit for bit, each
target's contributions added one by one in plan order, the order of
their segment sum, and the contact sweep K11 equals its plain twin bit
for bit on clouds at bench.py's density. The staged K6 / K5 (the
solvers' Jacobian: each element's rows straight into K9's staging rows)
match their plain twins per block and equal the column kernels' rows
placed at the plan positions bit for bit (also on a chunked gather
context whose last range leaves pad elements out), and K9's segment sum
alone over them equals K9 over the column rows bit for bit. The fused K1
equals, bit for bit, K6's residual rows on the lattice inputs summed in
the plain order (the element buffer it no longer writes), with and without
the heat source; the staged K4 (the gather tier's residual: each pair's 6
components straight into K8's staging rows, from node-major states)
matches its plain twin, equals the column K4's rows placed at the plan
positions bit for bit (whole and chunked), and K8's segment sum alone over
them equals K8 over the column rows bit for bit. A K1 call on a corrupted
ticket workspace fails loudly instead of returning wrong sums. K3 and K7
also run in float64 (their double instances, against the plain versions at
float64 roundoff), refuse float16 and a CPU vector with a matrix on the
card, and a repeated step with pc "mg" (geometric multigrid on the
lattice, algebraic on WinELL) is bit-identical. K1c and K2c (any table of
up to 8 slabs) match their plain versions on a deformed box (the classes
tier), a shuffled, mirrored and recovered box (the lattice tier with
another split), an L-shaped part of a box (dead class lanes) and a box
with 8 classes and 21 DIA planes (torch_meshes.overlaid_mesh, a kernel
stress input), frozen and implicit, with and without the heat source:
their one-pass kernels (each table placed on its node grid) and their
two-pass entries, called directly and routed to on a context without a
grid; the one-pass K1c equals the two-pass one and, on the Kuhn box's own
table, the ticketed K1 bit for bit, and fails loudly on a corrupt ticket
workspace as K1 does; K3 with 27 planes matches its plain version in
float32 and float64. The scalar heat / Poisson slice (fem.heat): K8 and
K9 in their one-row mode on its plans match their plain versions and the
plan-order sums bit for bit with no staging buffer (the one-pass entry,
also on stress plans: empty targets, a target longer than its tile, no
contributions), and Jacobi-preconditioned CG on the card repeats its
count and iterate bit for bit and agrees with the CPU's float64 solve.
On a mixed mesh (mesh.gen.mixed_box_mesh: a hex over every cube and a
prism boundary layer, the WinELL tier on the 27-point stencil) the staged
K6, K9's segment sum and K7 on its 27-wide rows match their plain versions
as on the Delaunay mesh, and a step on the card agrees with the CPU's
float64 step.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dedflow_tpu_torch.app.scenarios import (
    laser_source,
    melt_pool_initial_state,
    melt_pool_scenario_config,
    reference_initial_state,
    reference_scenario_config,
)
from dedflow_tpu_torch.dem import grid as dem_grid
from dedflow_tpu_torch.dem.cells import cell_stats, make_grid
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.particles import particle_state
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import element_rows as er
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.fem import win_assembly as wa_
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.config import BCSpec
from dedflow_tpu_torch.mesh.gen import (
    box_mesh,
    deformed_mesh,
    delaunay_mesh,
    l_shaped_mesh,
    mixed_box_mesh,
    shuffled_mesh,
)
from dedflow_tpu_torch.mesh.recover import recover_lattice
from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu_torch.solver.newton import NSSolver, assemble_system
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_f64, dia_matvec_plain
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
from dedflow_tpu_torch.sparse.win_gather import JAC_ROWMAP, RES_ROWMAP, win_gather, win_gather_plain
from dedflow_tpu_torch.sparse.win_kernels import (
    winell_matvec,
    winell_matvec_f64,
    winell_matvec_plain,
)
from dedflow_tpu_torch.fem import heat
from dedflow_tpu_torch.fem.assembly import build_context, scatter_matrix, scatter_residual
from dedflow_tpu_torch.fem.dirichlet import StrongBC, apply_mat, apply_vec, build_mask
from dedflow_tpu_torch.solver.krylov import cg
from dedflow_tpu_torch.solver.pc import JacobiPC
from dedflow_tpu_torch.sparse.win_ring import (
    ring_reduce,
    ring_reduce_plain,
    ring_reduce_staged,
    ring_reduce_staged_plain,
)
from dedflow_tpu_torch.sparse.win_stream import (
    build_reduce_plan,
    stream_reduce,
    stream_reduce_plain,
    stream_reduce_staged,
    stream_reduce_staged_plain,
)
from dedflow_tpu_torch.sparse.winell import COMP2WIN
from dedflow_tpu_torch.tools import gather_probe as tgp
from dedflow_tpu_torch.tools import gmicro as tgm
from torch_meshes import overlaid_mesh

pytestmark = pytest.mark.cuda

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BOX = (7, 5, 6)


def rel(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = box_mesh(*BOX)
    solver = NSSolver(mesh, reference_scenario_config(), device="cuda")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(5).standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(*state, solver.cfg.time)
    return solver, state, wa, dwa


def test_k1_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    args = (solver.lctx, wa.T.contiguous(), dwa.T.contiguous(),
            solver.cfg.physics, solver.cfg.time)
    before = lat.residual_volume.launches
    got = lat.residual_volume(*args)
    assert lat.residual_volume.launches == before + 1
    assert torch.isfinite(got).all()
    assert rel(got, lat.residual_volume_plain(*args)) < 2e-5


def test_k1_kernel_layout_matches_the_tables():
    """The tiling the fused K1 was compiled with, read from the built
    kernel, is the one fem/lattice.py's RES_FUSED_* constants and the Kuhn
    table describe (the tables the CPU emulation checks); a ring slot is a
    tile's 64 cells x 24 pairs x 6 components."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    got = lat.residual_kernel_layout()
    assert got["tile"] == lat.RES_FUSED_TILE and got["threads"] == lat.RES_FUSED_THREADS
    assert got["blocks_per_sm"] == lat.RES_FUSED_BLOCKS_PER_SM
    assert got["slot_floats"] == lat.RES_FUSED_TILE**2 * 24 * 6
    lat._check_res_layout()


def _k1_equals_its_element_rows(lctx, wa_t, dwa_t, phys, scheme, src=None):
    """The fused K1, run three times (the calls' tickets and flags carry
    over in the context's workspace; the runs bit-identical), equals K6's
    residual rows of the lattice's (6, 67, N) inputs (the same element
    body) added in the plain order, bit for bit: the result of the two-pass
    kernel it replaces."""
    got = _twice(lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme, src),
                 lat.residual_volume)
    assert torch.equal(got, lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme, src))
    elem = ek.res_rows_call(lat._residual_inputs(lctx, wa_t, dwa_t, src), phys, scheme)
    assert torch.equal(got, lat._reduce_residual(lctx, elem))
    return got


def test_k1_fused_equals_the_element_rows_bit_for_bit(card, melt):
    solver, _, wa, dwa = card
    _k1_equals_its_element_rows(solver.lctx, wa.T.contiguous(), dwa.T.contiguous(),
                                solver.cfg.physics, solver.cfg.time)
    solver, _, wa, dwa, src = melt
    _k1_equals_its_element_rows(solver.lctx, wa.T.contiguous(), dwa.T.contiguous(),
                                solver.cfg.physics, solver.cfg.time, src)


def test_k1_fails_loudly_on_a_corrupt_workspace():
    """A K1 wait that cannot end traps instead of summing ring slots that
    were never produced. Moving the ticket counter off its call boundary
    makes item 0 take the call's last ticket with the next epoch, so the
    item of layer 1 waits on a flag that never comes: the launch fails
    after the wait's bound and the next synchronisation raises. Run in a
    fresh interpreter, since a trap ends its process's CUDA context."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    code = textwrap.dedent("""
        import numpy as np
        import torch
        from dedflow_tpu_torch.app.scenarios import reference_scenario_config
        from dedflow_tpu_torch.fem import lattice as lat
        from dedflow_tpu_torch.mesh.gen import box_mesh
        from dedflow_tpu_torch.solver.newton import NSSolver
        solver = NSSolver(box_mesh(7, 5, 6), reference_scenario_config(), device="cuda")
        lctx, cfg = solver.lctx, solver.cfg
        w = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 6, lctx.num_node)),
                            dtype=torch.float32, device="cuda")
        args = (lctx, w[0], w[1], cfg.physics, cfg.time)
        ok = torch.isfinite(lat.residual_volume(*args)).all().item()
        print("first call finite:", ok, flush=True)
        lctx.res_sync[0] += 1  # the ticket counter's low word
        out = lat.residual_volume(*args)
        torch.cuda.synchronize()
        print("second call returned", flush=True)
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert "first call finite: True" in run.stdout, run.stderr[-2000:]
    assert "second call returned" not in run.stdout
    assert run.returncode != 0 and "CUDA error" in run.stderr, run.stderr[-2000:]


@pytest.mark.parametrize("implicit", [False, True])
def test_k2_kernel_layout_matches_the_tables(implicit):
    """The tiling the fused K2 was compiled with, read from the built
    kernel, is the one fem/lattice.py's FUSED_* tables describe (the
    tables the CPU emulation of the fused pass checks), and its stage is a
    round's slabs x 16 pairs x a group on the tile's halo cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    got = lat.fused_kernel_layout(implicit)
    assert got["tile"] == lat.FUSED_TILE
    assert got["round_slabs"] == lat.FUSED_ROUND_SLABS[implicit]
    assert got["groups"] == lat.FUSED_GROUPS[implicit]
    assert got["plane_codes"] == lat.FUSED_PLANE_CODES
    halo = (lat.FUSED_TILE[0] + 1) * (lat.FUSED_TILE[1] + 1)
    assert got["stage_bytes"] == got["round_slabs"] * 16 * got["group_size"] * halo * 4


def test_k2_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    phys, scheme, lctx = solver.cfg.physics, solver.cfg.time, solver.lctx
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(
        solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets), keep
    )
    wa_t = wa.T.contiguous()
    for keep16, add16, b in (
        (keep[:16].contiguous(), add[:16].contiguous(), band),  # masked, facets
        (torch.ones_like(keep[:16]), torch.zeros_like(add[:16]), None),  # K2'
    ):
        before = lat.jacobian_volume.launches
        got = lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, b, lo)
        again = lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, b, lo)
        assert lat.jacobian_volume.launches == before + 2
        assert torch.equal(got, again)  # fixed-order plane sums, no atomics
        assert torch.isfinite(got).all()  # dead cells give 0, never NaN
        ref = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep16, add16, b, lo)
        assert rel(got, ref) < 2e-5


def test_k3_kernel_matches_plain(card):
    solver, _, wa, dwa = card
    jm = lat.assemble_jacobian_t(
        solver.lctx, solver.face_ctxs, solver.mask_t, wa, dwa,
        solver.cfg.physics, solver.cfg.time,
    )
    x = torch.as_tensor(
        np.random.default_rng(6).standard_normal((6, solver.lctx.num_node)),
        dtype=torch.float32, device="cuda",
    )
    for scal in (jm.scal, torch.zeros_like(jm.scal)):
        before = dia_matvec.launches
        got = dia_matvec(jm.data, scal, x, jm.offsets)
        assert dia_matvec.launches == before + 1
        assert rel(got, dia_matvec_plain(jm.data, scal, x, jm.offsets)) < 1e-5


def test_kernels_refuse_what_they_cannot_take(card):
    """A CUDA tensor never takes the plain version: K3 raises on float16
    (it takes float32 and float64), K1 on float64."""
    solver, _, wa, dwa = card
    with pytest.raises(ValueError, match="float32 or float64"):
        dia_matvec(
            torch.zeros((1, 16, 8), dtype=torch.float16, device="cuda"),
            torch.zeros((2, 8), dtype=torch.float16, device="cuda"),
            torch.zeros((6, 8), dtype=torch.float16, device="cuda"), (0,),
        )
    with pytest.raises(ValueError, match="float32"):
        lat.residual_volume(
            solver.lctx, wa.T.double().contiguous(), dwa.T.double().contiguous(),
            solver.cfg.physics, solver.cfg.time,
        )


def test_step_on_card_matches_cpu_f64(card):
    """One step_fixed(num_newton=2): float32 kernels on the card against the
    float64 plain versions on the CPU. The float32 GMRES stops at rtol 1e-4;
    the new states agree to ~1e-5 of their size (chip_smoke.py phase 4)."""
    solver, state, _, _ = card
    cpu = NSSolver(box_mesh(*BOX), reference_scenario_config(), device="cpu")
    got = solver.step_fixed(*state, num_newton=2)
    ref = cpu.step_fixed(*(t.cpu().double() for t in state), num_newton=2)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


def _twice(kernel, counter):
    """Run a kernel twice; check the launch count and that the two
    results are bit-identical and finite. Returns the result."""
    before = counter.launches
    got, again = kernel(), kernel()
    assert counter.launches == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    return got


@pytest.fixture(scope="module")
def irregular():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = delaunay_mesh(3000, seed=3)
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    solver = NSSolver(mesh, cfg, device="cuda")
    assert solver.fastpath == "winell"
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(7).standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(*state, solver.cfg.time)
    return solver, state, wa, dwa


# The 16 velocity/pressure components of a nodal block by sub-block, in
# the element Jacobian's packed order (rows ab*18+c). The pressure rows are
# orders of magnitude smaller than the velocity block, so each block is
# compared against its own scale.
VP_BLOCKS = {"uu": range(0, 9), "up": range(9, 12), "pu": range(12, 15), "pp": range(15, 16)}


def assert_blocks(got, ref, tol, implicit=False):
    """(..., 18, M) element Jacobians: each vel/p block within `tol` of
    its own scale; the phi/T identities exact, or (implicit) each phi/T
    tangent within `tol` of its own scale."""
    for block, comps in VP_BLOCKS.items():
        assert rel(got[..., comps, :], ref[..., comps, :]) < tol, block
    if implicit:
        for c in (16, 17):
            assert rel(got[..., c, :], ref[..., c, :]) < tol, c
    else:
        assert torch.equal(got[..., 16:, :], ref[..., 16:, :])


@pytest.fixture(scope="module")
def melt():
    """The melt-pool scenario on the lattice (implicit tangents), a
    perturbed state and the laser source, float32 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = box_mesh(*BOX)
    solver = NSSolver(mesh, melt_pool_scenario_config(), device="cuda")
    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    rng = np.random.default_rng(14)
    wg = wg + 0.1 * rng.standard_normal(wg.shape)
    dwg = dwg + 0.1 * rng.standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(*state, solver.cfg.time)
    src = laser_source(solver.cfg.physics.laser, mesh.xg, 0.01)
    return solver, state, wa, dwa, torch.as_tensor(src, dtype=torch.float32, device="cuda")


def test_k1_with_source_matches_plain(melt):
    solver, _, wa, dwa, src = melt
    args = (solver.lctx, wa.T.contiguous(), dwa.T.contiguous(), solver.cfg.physics,
            solver.cfg.time, src)
    got = _twice(lambda: lat.residual_volume(*args), lat.residual_volume)
    ref = lat.residual_volume_plain(*args)
    assert rel(got, ref) < 2e-5 and rel(got[5], ref[5]) < 2e-5


def test_k2_implicit_matches_plain(melt):
    """K2's implicit mode, masked with the facet band and unmasked: the
    vel/p data and the phi-phi / T-T scal rows, each on its own scale."""
    solver, _, wa, dwa, _ = melt
    phys, scheme, lctx = solver.cfg.physics, solver.cfg.time, solver.lctx
    assert lctx.scalar_implicit
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets), keep)
    wa_t = wa.T.contiguous()
    for k, a, b in ((keep, add, band), (torch.ones_like(keep), torch.zeros_like(add), None)):
        before = lat.jacobian_volume.launches
        data, scal = lat.jacobian_volume(lctx, wa_t, phys, scheme, k, a, b, lo)
        again = lat.jacobian_volume(lctx, wa_t, phys, scheme, k, a, b, lo)
        assert lat.jacobian_volume.launches == before + 2
        assert torch.equal(data, again[0]) and torch.equal(scal, again[1])
        rdata, rscal = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, k, a, b, lo)
        for block, comps in VP_BLOCKS.items():
            assert rel(data[:, list(comps)], rdata[:, list(comps)]) < 2e-5, block
        assert rel(scal[0::2], rscal[0::2]) < 2e-5 and rel(scal[1::2], rscal[1::2]) < 2e-5


def test_melt_step_on_card_matches_cpu_f64(melt):
    """One melt-pool step_fixed(num_newton=2) with the laser source on the
    lattice tier: float32 kernels on the card against the float64 plain
    versions on the CPU (chip_smoke.py phase 16)."""
    solver, state, _, _, src = melt
    cpu = NSSolver(box_mesh(*BOX), melt_pool_scenario_config(), device="cpu")
    got = solver.step_fixed(*state, num_newton=2, source=src)
    ref = cpu.step_fixed(*(t.cpu().double() for t in state), num_newton=2,
                         source=src.cpu().double())
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


def test_k6_kernels_match_plain(irregular):
    solver, _, wa, dwa = irregular
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    inp67 = wa_.residual_inputs(ctx, wa, dwa)
    got = _twice(lambda: ek.res_rows_call(inp67, phys, scheme), ek.res_rows_call)
    assert rel(got, er.res_rows(inp67, **ek.res_args(phys, scheme))) < 2e-5
    inp27 = wa_.jacobian_inputs(ctx, wa)
    got = _twice(lambda: ek.lhs_rows_call(inp27, phys, scheme), ek.lhs_rows_call)
    ref = er.lhs_rows(inp27, **ek.lhs_args(phys, scheme))
    ne = ctx.num_elem
    assert_blocks(got.reshape(16, 18, ne), ref.reshape(16, 18, ne), 2e-5)
    slabs = torch.stack([inp27, inp27.flip(-1)]).contiguous()  # slab-major form
    got3 = ek.lhs_rows_call(slabs, phys, scheme)
    ref3 = er.lhs_rows(slabs, **ek.lhs_args(phys, scheme))
    assert_blocks(got3.reshape(2, 16, 18, ne), ref3.reshape(2, 16, 18, ne), 2e-5)


def test_k6_implicit_mode_matches_plain(irregular):
    """K6's 33-row mode (the metric rows appended): 2-D and slab-major."""
    solver, _, wa, _ = irregular
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    ne = ctx.num_elem
    inp33 = wa_.jacobian_inputs(ctx, wa, scalar_implicit=True)
    assert inp33.shape == (33, ne)
    got = _twice(lambda: ek.lhs_rows_call(inp33, phys, scheme, scalar_implicit=True),
                 ek.lhs_rows_call)
    ref = er.lhs_rows(inp33, scalar_implicit=True, **ek.lhs_args(phys, scheme))
    assert_blocks(got.reshape(16, 18, ne), ref.reshape(16, 18, ne), 2e-5, implicit=True)
    slabs = torch.stack([inp33, inp33.flip(-1)]).contiguous()
    got3 = ek.lhs_rows_call(slabs, phys, scheme, scalar_implicit=True)
    ref3 = er.lhs_rows(slabs, scalar_implicit=True, **ek.lhs_args(phys, scheme))
    assert_blocks(got3.reshape(2, 16, 18, ne), ref3.reshape(2, 16, 18, ne), 2e-5, implicit=True)
    with pytest.raises(ValueError, match="33"):
        ek.lhs_rows_call(wa_.jacobian_inputs(ctx, wa), phys, scheme, scalar_implicit=True)


def _plan_order_sum(plan, x, comps, cstride):
    """Each target's contributions added one by one in plan order, in x's
    dtype: the order of the kernels' additions (K8/K9 sum each target's
    staged rows k ascending), so equal to them bit for bit."""
    flat = x.reshape(-1)
    vals = torch.stack([flat[plan.src.long() + c * cstride] for c in comps], 1)
    start, counts = plan.ptr[:-1].long(), torch.diff(plan.ptr.long())
    acc = torch.zeros((plan.num_tgt, len(comps)), dtype=x.dtype, device=x.device)
    for j in range(int(counts.max()) if vals.shape[0] else 0):
        live = counts > j
        acc[live] = acc[live] + vals[start[live] + j]
    return acc.T


def _check_reduces(res_plan, out24, jac_plan, out288, m):
    """K8 over the residual rows (per equation) and K9 over the Jacobian
    rows (per vel/p block): within 1e-5 of the plain version, two runs
    bit-identical, equal to the plan-order sum bit for bit."""
    got = _twice(lambda: stream_reduce(res_plan, out24, range(6), m), stream_reduce)
    ref = stream_reduce_plain(res_plan, out24, range(6), m)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):  # u, p, phi/T equations
        assert rel(got[rows], ref[rows]) < 1e-5
    assert torch.equal(got, _plan_order_sum(res_plan, out24, range(6), m))
    comps = wa_.JAC_COMPS  # output row r is WinELL row r
    got = _twice(lambda: ring_reduce(jac_plan, out288, comps, m), ring_reduce)
    ref = ring_reduce_plain(jac_plan, out288, comps, m)
    for block, fs in VP_BLOCKS.items():
        rows = [int(COMP2WIN[c]) for c in fs]
        assert rel(got[rows], ref[rows]) < 1e-5, block
    assert torch.equal(got, _plan_order_sum(jac_plan, out288, comps, m))


def test_k8_k9_reduces_match_plain(irregular):
    """K8 and K9 on the WinELL plans; K9 also as the implicit mode's second
    2-row pass (the phi-phi / T-T tangents of K6's 33-row output)."""
    solver, _, wa, dwa = irregular
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    ne = ctx.num_elem
    out24 = ek.res_rows_call(wa_.residual_inputs(ctx, wa, dwa), phys, scheme)
    out288 = ek.lhs_rows_call(wa_.jacobian_inputs(ctx, wa), phys, scheme)
    _check_reduces(ctx.res_plan, out24, ctx.jac_plan, out288, ne)
    inp33 = wa_.jacobian_inputs(ctx, wa, scalar_implicit=True)
    out288 = ek.lhs_rows_call(inp33, phys, scheme, scalar_implicit=True)
    got = _twice(lambda: ring_reduce(ctx.jac_plan, out288, (16, 17), ne), ring_reduce)
    ref = ring_reduce_plain(ctx.jac_plan, out288, (16, 17), ne)
    for r in range(2):  # each tangent against its own scale
        assert rel(got[r], ref[r]) < 1e-5
    assert torch.equal(got, _plan_order_sum(ctx.jac_plan, out288, (16, 17), ne))


def _pack(staged):
    """The staged kernels' (K, 16) rows and, implicit, (K, 8) tangents as one tensor."""
    stage, tang = staged
    return stage if tang is None else torch.cat([stage, tang], 1)


def _check_staged(kernel, counter, plain, column_rows, plan, m, implicit):
    """A staged element kernel: two runs bit-identical, each vel/p block
    (WinELL columns) and tangent within 2e-5 of the plain twin, equal to
    the column kernel's rows at the plan positions bit for bit; then K9's
    segment sum alone over its rows equal to K9 over the column rows bit
    for bit, and to its own twin within 1e-5."""
    got = _twice(lambda: _pack(kernel()), counter)
    ref = _pack(plain())
    for block, fs in VP_BLOCKS.items():
        cols = [int(COMP2WIN[c]) for c in fs]
        assert rel(got[:, cols], ref[:, cols]) < 2e-5, block
    if implicit:
        for c in (16, 17):
            assert rel(got[:, c], ref[:, c]) < 2e-5, c
        assert not bool(got[:, 18:].any())
    assert torch.equal(got, _pack(ek.stage_rows(plan, column_rows, implicit)))
    stage, tang = kernel()
    sums = _twice(lambda: ring_reduce_staged(plan, stage, 16), ring_reduce_staged)
    assert torch.equal(sums, ring_reduce(plan, column_rows, wa_.JAC_COMPS, m))
    assert rel(sums, ring_reduce_staged_plain(plan, stage, 16)) < 1e-5
    if implicit:
        tsums = ring_reduce_staged(plan, tang, 2)
        assert torch.equal(tsums, ring_reduce(plan, column_rows, (16, 17), m))


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
def test_k6_staged_matches_plain_and_the_column_rows(irregular, implicit):
    solver, _, wa, _ = irregular
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    inp = wa_.jacobian_inputs(ctx, wa, implicit)
    plan = ctx.jac_plan
    _check_staged(lambda: ek.lhs_rows_staged(inp, phys, scheme, plan, implicit),
                  ek.lhs_rows_staged,
                  lambda: ek.lhs_rows_staged_plain(inp, phys, scheme, plan, implicit),
                  ek.lhs_rows_call(inp, phys, scheme, scalar_implicit=implicit), plan,
                  ctx.num_elem, implicit)
    with pytest.raises(ValueError, match="element positions"):
        ek.lhs_rows_staged(inp[:, :-1].contiguous(), phys, scheme, plan, implicit)


@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunk1000"])
@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
def test_k5_staged_matches_plain_and_the_column_rows(gather, implicit, chunk):
    """On the gather tier's context, whole and in chunks of 1000 elements
    (the last range's pad elements have no plan entries: -1 positions)."""
    solver, w_t, _ = gather
    phys, scheme = solver.cfg.physics, solver.cfg.time
    ctx = solver.gctx if chunk is None else build_context(solver.mesh, device="cuda",
                                                          chunk=chunk)
    assert chunk is None or bool((ctx.ranges[-1].jac_plan.elem_pos < 0).any())
    for rng in ctx.ranges:
        m = rng.hi - rng.lo
        geom, ien_t = ctx.lhs_geom[:, rng.lo : rng.hi], ctx.ien_t[:, rng.lo : rng.hi]
        met = ctx.res_geom[13:19, rng.lo : rng.hi] if implicit else None
        _check_staged(
            lambda: ek.ns_lhs_gather_staged(geom, ien_t, w_t, phys, scheme, rng.jac_plan, met),
            ek.ns_lhs_gather_staged,
            lambda: ek.ns_lhs_gather_staged_plain(geom, ien_t, w_t, phys, scheme, rng.jac_plan,
                                                  met),
            ek.ns_lhs_gather(geom, ien_t, w_t, phys, scheme, met), rng.jac_plan, m, implicit)


@pytest.mark.parametrize("source", [False, True], ids=["no-source", "source"])
@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunk1000"])
def test_k4_staged_matches_plain_and_the_column_rows(gather, chunk, source):
    """The staged K4 on the gather tier's context, whole and in chunks of
    1000 elements (the last range's pad elements have no plan entries: -1
    positions), from the node-major (N, 6) states: two runs bit-identical,
    its rows within 2e-5 of the plain twin, equal to the column K4's rows
    at the plan positions bit for bit (zeros in columns 6-7); K8's segment
    sum alone over them equal to K8 over the column rows bit for bit and
    within 1e-5 of its own twin."""
    solver, w_t, dw_t = gather
    phys, scheme = solver.cfg.physics, solver.cfg.time
    w, dw = w_t.T.contiguous(), dw_t.T.contiguous()
    ctx = solver.gctx if chunk is None else build_context(solver.mesh, device="cuda",
                                                          chunk=chunk)
    assert chunk is None or bool((ctx.ranges[-1].res_plan.elem_pos < 0).any())
    src = (torch.as_tensor(np.random.default_rng(13).standard_normal(ctx.num_node),
                           dtype=torch.float32, device="cuda") if source else None)
    for rng in ctx.ranges:
        m, plan = rng.hi - rng.lo, rng.res_plan
        geom, ien_t = ctx.res_geom[:, rng.lo : rng.hi], ctx.ien_t[:, rng.lo : rng.hi]
        got = _twice(lambda: ek.ns_residual_gather_staged(geom, ien_t, w, dw, phys, scheme, plan,
                                                          src),
                     ek.ns_residual_gather_staged)
        ref = ek.ns_residual_gather_staged_plain(geom, ien_t, w, dw, phys, scheme, plan, src)
        assert rel(got[:, :6], ref[:, :6]) < 2e-5 and not bool(got[:, 6:].any())
        rows = ek.ns_residual_gather(geom, ien_t, w_t, dw_t, phys, scheme, src)
        assert torch.equal(got, ek.stage_residual_rows(plan, rows))
        sums = _twice(lambda: stream_reduce_staged(plan, got, 6), stream_reduce_staged)
        assert torch.equal(sums, stream_reduce(plan, rows, range(6), m))
        assert rel(sums, stream_reduce_staged_plain(plan, got, 6)) < 1e-5
    with pytest.raises(ValueError, match="contiguous"):  # the transposes the path no longer takes
        ek.ns_residual_gather_staged(ctx.res_geom[:, : ctx.ranges[0].hi - ctx.ranges[0].lo],
                                     ctx.ien_t[:, : ctx.ranges[0].hi - ctx.ranges[0].lo],
                                     w_t.T, dw_t.T, phys, scheme, ctx.ranges[0].res_plan)


def test_k8_k9_reduces_on_the_gather_plans(gather):
    """K8 and K9 on the gather tier's plans (unordered sources), over the
    element rows K4 and K5 leave."""
    solver, w_t, dw_t = gather
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.gctx
    (rng,) = ctx.ranges
    out24 = ek.ns_residual_gather(ctx.res_geom, ctx.ien_t, w_t, dw_t, phys, scheme)
    out288 = ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme)
    _check_reduces(rng.res_plan, out24, rng.jac_plan, out288, ctx.num_elem)


@pytest.mark.parametrize("c", [1, 2, 6, 8, 16])
@pytest.mark.parametrize("case", ["empty_targets", "no_contributions"])
def test_k8_k9_row_counts_and_empty_segments(c, case):
    """1 to 16 output rows (K8 up to 8) on seeded lists whose odd targets
    have no contribution, and on a plan without contributions: empty
    targets give zeros; a plan without targets launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    num_tgt, num_src = 5000, 8000
    k = 0 if case == "no_contributions" else 20000
    rng = np.random.default_rng(c)
    tgt, src = 2 * rng.integers(0, num_tgt // 2, k), rng.integers(0, num_src, k)
    plan = build_reduce_plan(tgt, src, num_tgt, device="cuda")
    x = torch.as_tensor(rng.standard_normal((c + 2) * num_src), dtype=torch.float32,
                        device="cuda")
    comps = tuple(range(2, c + 2))  # offset rows of a flat source
    empty = torch.diff(plan.ptr.long()) == 0
    for wrapper in [ring_reduce] + ([stream_reduce] if c <= 8 else []):
        got = _twice(lambda: wrapper(plan, x, comps, num_src), wrapper)
        assert got.shape == (c, num_tgt)
        assert not bool(got[:, empty].any())
        assert torch.equal(got, _plan_order_sum(plan, x, comps, num_src))
        if k:
            assert rel(got, ring_reduce_plain(plan, x, comps, num_src)) < 1e-5
        before = wrapper.launches
        none = wrapper(build_reduce_plan([], [], 0, device="cuda"), x, comps, num_src)
        assert none.shape == (c, 0) and wrapper.launches == before


def test_k7_spmv_matches_plain(irregular):
    solver, state, _, _ = irregular
    jm, _ = assemble_system(
        solver.wctx, solver.face_ctxs, solver.mask_t, *state, solver.cfg.physics, solver.cfg.time
    )
    x = torch.as_tensor(
        np.random.default_rng(8).standard_normal((6, solver.mesh.num_node)),
        dtype=torch.float32, device="cuda",
    )
    got = _twice(lambda: winell_matvec(jm, x), winell_matvec)
    ref = winell_matvec_plain(jm, x)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):  # u, p, phi/T equations
        assert rel(got[rows], ref[rows]) < 1e-5


@pytest.fixture(scope="module")
def mixed():
    """BOX with a hex over every cube and prisms on its lowest layer: the
    WinELL tier with 27 node blocks a row, the reference scenario."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = mixed_box_mesh(*BOX, prism_layers=1)
    solver = NSSolver(mesh, reference_scenario_config(), device="cuda")
    assert solver.fastpath == "winell"
    assert int(np.diff(solver.wctx.win_plan.row_ptr).max()) == 27
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(11).standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    return solver, state, alpha_states(*state, solver.cfg.time)[0]


def test_mixed_k6_staged_and_k9_segment_sum_match_plain(mixed):
    """The staged K6 and K9's segment sum on the mixed pattern (entries no
    tet couples: exact zeros), as test_k6_staged_matches_plain_and_the_column_rows."""
    solver, _, wa = mixed
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    inp, plan = wa_.jacobian_inputs(ctx, wa), ctx.jac_plan
    _check_staged(lambda: ek.lhs_rows_staged(inp, phys, scheme, plan), ek.lhs_rows_staged,
                  lambda: ek.lhs_rows_staged_plain(inp, phys, scheme, plan),
                  ek.lhs_rows_call(inp, phys, scheme), plan, ctx.num_elem, False)


def test_mixed_k7_spmv_matches_plain(mixed):
    """K7 on the assembled 27-wide Jacobian, per equation."""
    solver, state, _ = mixed
    jm, _ = assemble_system(
        solver.wctx, solver.face_ctxs, solver.mask_t, *state, solver.cfg.physics, solver.cfg.time
    )
    x = torch.as_tensor(
        np.random.default_rng(12).standard_normal((6, solver.mesh.num_node)),
        dtype=torch.float32, device="cuda",
    )
    got = _twice(lambda: winell_matvec(jm, x), winell_matvec)
    ref = winell_matvec_plain(jm, x)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):  # u, p, phi/T equations
        assert rel(got[rows], ref[rows]) < 1e-5


def test_mixed_step_on_card_matches_cpu_f64():
    """One step_fixed(num_newton=2) of the mixed BOX on the card in float32
    against the CPU in float64 (chip_smoke.py phase 23 (a))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = mixed_box_mesh(*BOX, prism_layers=1)
    cfg = reference_scenario_config()
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(13).standard_normal(dwg.shape)
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        assert solver.fastpath == "winell"
        outs.append(solver.step_fixed(*state_from_numpy(wg, dwgold, dwg, device), num_newton=2))
    for g, r in zip(*outs):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


def test_irregular_kernels_refuse_what_they_cannot_take(irregular):
    solver, _, wa, dwa = irregular
    inp = wa_.residual_inputs(solver.wctx, wa, dwa).double()
    with pytest.raises(ValueError, match="float32"):
        ek.res_rows_call(inp, solver.cfg.physics, solver.cfg.time)
    with pytest.raises(ValueError, match="at most 8"):
        stream_reduce(solver.wctx.res_plan, inp.float(), range(9), solver.wctx.num_elem)


def test_irregular_step_on_card_matches_cpu_f64():
    """The converted box (lattice dropped, RCM, WinELL tier, reference BCs
    with the Nitsche wall): one step_fixed(num_newton=2) on the card in
    float32 against the CPU in float64 (chip_smoke.py phase 7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = dataclasses.replace(box_mesh(*BOX), lattice=None)
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    cfg = reference_scenario_config(use_lattice="winell")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(9).standard_normal(dwg.shape)
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        assert solver.fastpath == "winell"
        outs.append(solver.step_fixed(*state_from_numpy(wg, dwgold, dwg, device), num_newton=2))
    for g, r in zip(*outs):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


def _dem_grid_state(cap):
    """400 particles bucketed onto a grid of capacity `cap` on the card,
    float32 (the cloud of the JAX K-sweep test, tests/test_dem.py:331-362)."""
    rng = np.random.default_rng(cap)
    x = rng.uniform(0.05, 0.55, size=(400, 3))
    v = rng.normal(scale=0.05, size=(400, 3))
    grid = make_grid([0, 0, 0], [0.6, 0.6, 0.6], cell_size=0.08, capacity=cap)
    return grid, dem_grid.to_grid(grid, particle_state(x, v, radius=0.03, device="cuda"), 400)


@pytest.mark.parametrize("cap", [2, 3, 8, 11, 13, 16])
def test_k11_contact_sweep_matches_plain(cap):
    """K11 against its plain twin with and without the tangential term.
    The kernel takes the plain version's pair order and IEEE float32 ops
    (no contraction), so its forces equal the plain twin's bit for bit.
    Capacities 2-12 take the kernel's unrolled instantiations, 13 and 16
    its loop over any K."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    grid, gs = _dem_grid_state(cap)
    for prm in (ContactParams(k_n=2e3, gamma_n=3.0),
                ContactParams(k_n=2e3, gamma_n=3.0, mu=0.3, gamma_t=2.0)):
        before = dem_grid.grid_pair_forces_cuda.launches
        got = [dem_grid.grid_pair_forces_cuda(grid, gs, prm) for _ in range(2)]
        assert dem_grid.grid_pair_forces_cuda.launches == before + 2
        ref = dem_grid.grid_pair_forces(grid, gs, prm)
        for c in range(3):
            assert torch.isfinite(got[0][c]).all()
            assert torch.equal(got[0][c], got[1][c])
            assert float(ref[c].abs().max()) > 0
            assert rel(got[0][c], ref[c]) < 1e-5
            assert torch.equal(got[0][c], ref[c])


def _bench_like_grid_state(cloud):
    """5,000 particles at the density of bench.py's DEM cases (radius 0.006,
    cell 2.5 r, capacity from the occupancy; bench.py:512-592): a uniform
    draw, or the settled bed's jittered lattice at a 0.45 solids fraction,
    whose touching neighbours sit in every direction, row ends included."""
    rng = np.random.default_rng(7)
    r, p = 0.006, 5000
    if cloud == "uniform":
        side = 0.96 * (p / 100_000) ** (1 / 3)
        x = 0.02 + rng.uniform(0.0, side, size=(p, 3))
    else:
        s = r * (4.0 * np.pi / (3.0 * 0.45)) ** (1.0 / 3.0)
        npx, ii = 17, np.arange(p)
        x = np.stack([(ii % npx + 0.5) * s, ((ii // npx) % npx + 0.5) * s,
                      (ii // (npx * npx) + 0.5) * s], axis=1)
        x = x + rng.uniform(-0.08, 0.08, size=(p, 3)) * s
    v = rng.normal(scale=0.05, size=(p, 3))
    probe = make_grid([0, 0, 0], (0.4, 0.4, 0.4), cell_size=2.5 * r, capacity=2)
    cap = max(2, cell_stats(probe, x)["max_per_cell"] + 1)
    grid = dataclasses.replace(probe, capacity=cap)
    return grid, dem_grid.to_grid(grid, particle_state(x, v, radius=r, device="cuda"), p)


@pytest.mark.parametrize("cloud", ["uniform", "settled_bed"])
@pytest.mark.parametrize("tangential", [False, True])
def test_k11_bit_equal_to_plain_on_bench_like_clouds(cloud, tangential):
    """K11's warp-cooperative sweep adds each centre's pair terms in the
    plain version's order with its IEEE float32 arithmetic: the forces
    equal the plain twin's bit for bit, and two runs equal each other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    grid, gs = _bench_like_grid_state(cloud)
    assert int(gs.mask.sum()) == 5000  # nothing dropped
    prm = ContactParams(k_n=2e3, gamma_n=3.0, mu=0.3 if tangential else 0.0,
                        gamma_t=2.0 if tangential else 0.0)
    got = dem_grid.grid_pair_forces_cuda(grid, gs, prm)
    again = dem_grid.grid_pair_forces_cuda(grid, gs, prm)
    ref = dem_grid.grid_pair_forces(grid, gs, prm)
    for c in range(3):
        assert float(ref[c].abs().max()) > 0
        assert torch.equal(got[c], ref[c]) and torch.equal(got[c], again[c])


def test_k11_refuses_float64():
    """A CUDA float64 grid state raises; it never takes the plain twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    grid, gs = _dem_grid_state(2)
    gs64 = dem_grid.GridState(
        pos=tuple(a.double() for a in gs.pos), vel=tuple(a.double() for a in gs.vel),
        radius=gs.radius.double(), mask=gs.mask.double(), pid=gs.pid,
    )
    with pytest.raises(ValueError, match="float32"):
        dem_grid.grid_pair_forces_cuda(grid, gs64, ContactParams())


@pytest.fixture(scope="module")
def gather():
    """The general gather tier on an unordered Delaunay mesh, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = delaunay_mesh(3000, seed=4)
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    solver = NSSolver(mesh, cfg, device="cuda")
    assert solver.fastpath == "gather"
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(10).standard_normal(dwg.shape)
    state = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(*state, solver.cfg.time)
    return solver, wa.T.contiguous(), dwa.T.contiguous()


def test_k4_k5_kernels_match_plain(gather):
    """K4/K5 against their plain twins (index gather + K6's bodies), whole
    mesh and on a column slice (an assembly chunk read in place), K4 with
    and without a heat source."""
    solver, w_t, dw_t = gather
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.gctx
    src = torch.as_tensor(np.random.default_rng(11).standard_normal(ctx.num_node),
                          dtype=torch.float32, device="cuda")
    for lo, hi in ((0, ctx.num_elem), (1000, 3000)):
        geom, ien = ctx.res_geom[:, lo:hi], ctx.ien_t[:, lo:hi]
        for s in (None, src):
            got = _twice(lambda: ek.ns_residual_gather(geom, ien, w_t, dw_t, phys, scheme, s),
                         ek.ns_residual_gather)
            assert rel(got, ek.ns_residual_gather_plain(geom, ien, w_t, dw_t, phys, scheme, s)) < 2e-5
        lgeom = ctx.lhs_geom[:, lo:hi]
        got = _twice(lambda: ek.ns_lhs_gather(lgeom, ien, w_t, phys, scheme), ek.ns_lhs_gather)
        ref = ek.ns_lhs_gather_plain(lgeom, ien, w_t, phys, scheme)
        assert_blocks(got.reshape(16, 18, hi - lo), ref.reshape(16, 18, hi - lo), 2e-5)
        # the implicit mode: the metric rows read as a strided view in place
        met = ctx.res_geom[13:19, lo:hi]
        got = _twice(lambda: ek.ns_lhs_gather(lgeom, ien, w_t, phys, scheme, met),
                     ek.ns_lhs_gather)
        ref = ek.ns_lhs_gather_plain(lgeom, ien, w_t, phys, scheme, met)
        assert_blocks(got.reshape(16, 18, hi - lo), ref.reshape(16, 18, hi - lo), 2e-5,
                      implicit=True)


def test_k10_gather_equals_plain_bit_for_bit(irregular):
    """K10 with the residual's 48-row and the Jacobian's 12-row maps, and
    the WinELL tier's element inputs through it: equal to the index gather
    exactly."""
    solver, _, wa, dwa = irregular
    ctx = solver.wctx
    x = torch.as_tensor(np.random.default_rng(12).standard_normal((14, ctx.num_node)),
                        dtype=torch.float32, device="cuda")
    for rowmap, rows, table in ((RES_ROWMAP, 48, x), (JAC_ROWMAP, 12, x[:3].contiguous())):
        got = _twice(lambda: win_gather(ctx.ien_t, table, rowmap, rows), win_gather)
        assert torch.equal(got, win_gather_plain(ctx.ien_t, table, rowmap, rows))
    got = _twice(lambda: wa_.residual_inputs(ctx, wa, dwa), win_gather)
    assert torch.equal(got, ek.res_gather_inputs(ctx.res_geom, ctx.ien_t, wa.T, dwa.T))
    got = _twice(lambda: wa_.jacobian_inputs(ctx, wa), win_gather)
    assert torch.equal(got, ek.lhs_gather_inputs(ctx.lhs_geom, ctx.ien_t, wa.T))


def test_gather_kernels_refuse_what_they_cannot_take(gather):
    solver, w_t, dw_t = gather
    ctx, phys, scheme = solver.gctx, solver.cfg.physics, solver.cfg.time
    with pytest.raises(ValueError, match="float32"):
        ek.ns_residual_gather(ctx.res_geom.double(), ctx.ien_t, w_t, dw_t, phys, scheme)
    with pytest.raises(ValueError, match="int32"):
        ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t.long(), w_t, phys, scheme)
    with pytest.raises(ValueError, match="C <= 16"):
        win_gather(ctx.ien_t, torch.zeros((17, ctx.num_node), device="cuda"), JAC_ROWMAP, 12)


@pytest.mark.parametrize("tier", ["winell", "gather"])
def test_melt_step_on_irregular_tiers_matches_cpu_f64(tier):
    """The melt pool on the converted box (lattice dropped, RCM) on the
    WinELL and gather tiers: one step_fixed(num_newton=2) with the laser
    source, card float32 against CPU float64 (chip_smoke.py phase 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = dataclasses.replace(box_mesh(*BOX), lattice=None)
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    cfg = melt_pool_scenario_config(use_lattice=tier)
    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(15).standard_normal(dwg.shape)
    src = laser_source(cfg.physics.laser, mesh.xg, 0.01)
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        assert solver.fastpath == tier
        s = torch.as_tensor(src, dtype=solver.dtype, device=device)
        outs.append(solver.step_fixed(*state_from_numpy(wg, dwgold, dwg, device), num_newton=2,
                                      source=s))
    for g, r in zip(*outs):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


@pytest.mark.parametrize("chunk", [None, 500])
def test_gather_step_on_card_matches_cpu_f64(chunk):
    """The gather tier on the box with the reference BCs and the Nitsche
    wall, whole-mesh and chunked: one step_fixed(num_newton=2) on the card
    in float32 against the CPU in float64 (chip_smoke.py phase 13)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = box_mesh(*BOX)
    cfg = reference_scenario_config(use_lattice="gather", assembly_chunk=chunk)
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(13).standard_normal(dwg.shape)
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        assert solver.fastpath == "gather" and solver.face_ctxs
        outs.append(solver.step_fixed(*state_from_numpy(wg, dwgold, dwg, device), num_newton=2))
    for g, r in zip(*outs):
        assert torch.isfinite(g).all()
        assert rel(g, r) < 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("ids", [128, 2560], ids=["tool-ids", "full-range-ids"])
def test_k12_probes_match_plain(ids):
    """Every K12 kernel on an (8, 8192) stream, on the tool's ids (< 128)
    and on ids up to 512 * 5 (every window gather's zero branch, every bin
    row of the reduce): copies and gathers bit for bit, the segment reduce
    and its accumulators to float32 roundoff (shared-memory atomics add in
    another order)."""
    dev = _card()
    x, _ = tgm.inputs(8192, dev, seed=12)
    idx = torch.randint(0, ids, x.shape, generator=torch.Generator(device=dev).manual_seed(ids),
                        device=dev, dtype=torch.int32)
    before = (tgm.lane_gather.launches, tgm.segment_reduce.launches)
    for probe in tgm.probes(x, idx):
        got, ref = probe.kernel(), probe.plain()
        if probe.exact:
            assert torch.equal(got, ref), probe.name
        else:
            assert rel(got, ref) < 1e-5, probe.name
    for nw in tgm.NWINS:
        assert torch.equal(tgm.window_gather(x, idx, nw), tgm.window_gather_plain(x, idx, nw))
    for hb in tgm.HBS:
        o, acc = tgm.segment_reduce(x, idx, hb, acc=True)
        po, pacc = tgm.segment_reduce_plain(x, idx, hb, acc=True)
        assert rel(acc, pacc) < 1e-5 and rel(o, po) < 1e-5
    assert tgm.lane_gather.launches == before[0] + 2
    assert tgm.segment_reduce.launches == before[1] + 2 * len(tgm.HBS)


@pytest.mark.parametrize("w", [512, 4096, 9000], ids=["1-pass", "2-pass", "4-pass"])
def test_k13_element_gather_equals_plain_bit_for_bit(w):
    """Both idioms, with the staged window in 1, 2 and 4 column passes, and
    a few ids outside the window (zeros)."""
    dev = _card()
    idx, win = tgp.inputs(w, dev, seed=w, nb=3)
    idx[0, :5] = torch.tensor([-1, w, w + 7, 0, w - 1], dtype=torch.int32)
    ref = tgp.element_gather_plain(idx, win)
    for idiom in ("global", "staged"):
        assert torch.equal(tgp.element_gather(idx, win, idiom), ref), idiom


@pytest.mark.parametrize("tool", ["gmicro", "gather_probe"])
def test_probe_runs_count_their_launches(capsys, tool):
    """The entry points' runs on the card: every line launched its kernel,
    the records account for every launch of the wrappers, and each has a
    time, a paced time, a plain and a library time."""
    _card()
    mod, size = {"gmicro": (tgm, 8192), "gather_probe": (tgp, 512)}[tool]
    counters = [tgm.copy2, tgm.lane_gather, tgm.window_gather, tgm.segment_reduce,
                tgp.element_gather]
    before = {c.__name__: c.launches for c in counters}
    recs = mod.run(size, torch.device("cuda"))
    for c in counters:
        assert c.launches - before[c.__name__] == sum(
            r["launches"] for r in recs if r["counter"] == c.__name__), c.__name__
    for r in recs:
        assert r["launches"] > 0, r["name"]
        assert r["max_abs_err"] == 0.0 or r["counter"] == "segment_reduce", r["name"]
        assert min(r["ms"], r["paced_ms"], r["plain_ms"], r["library_ms"]) > 0, r["name"]
    capsys.readouterr()


def test_probe_kernels_refuse_what_they_cannot_take():
    dev = _card()
    x, idx = tgm.inputs(1024, dev)
    with pytest.raises(ValueError):
        tgm.copy2(x[:, :1000].contiguous())  # n not a multiple of 512
    with pytest.raises(ValueError):
        tgm.segment_reduce(x, idx, 3)
    with pytest.raises(ValueError):
        tgm.lane_gather(x, idx[:1].contiguous(), "shuffle")
    with pytest.raises(ValueError):
        tgp.element_gather(idx[:4, :64].contiguous(), torch.zeros((20000, 16), device=dev),
                           "staged")


# Float64 modes of K3 and K7 (krylov.precision "f64" and "ir"): the double
# instance of the same row-per-thread product. Against the plain version
# in float64 on the same inputs: roundoff of sums of ~60 (K3) and ~64 (K7)
# products a row, in another order, relative to each equation's scale.
TOL_F64 = 1e-12


def test_k3_f64_matches_plain(card):
    solver, _, wa, dwa = card
    jm = lat.assemble_jacobian_t(
        solver.lctx, solver.face_ctxs, solver.mask_t, wa, dwa,
        solver.cfg.physics, solver.cfg.time,
    )
    data, scal = jm.data.double(), jm.scal.double()
    x = torch.as_tensor(np.random.default_rng(9).standard_normal((6, solver.lctx.num_node)),
                        dtype=torch.float64, device="cuda")
    before32, before64 = dia_matvec.launches, dia_matvec_f64.launches
    got, again = (dia_matvec(data, scal, x, jm.offsets) for _ in range(2))
    assert (dia_matvec.launches, dia_matvec_f64.launches) == (before32, before64 + 2)
    assert got.dtype == torch.float64 and torch.equal(got, again)
    ref = dia_matvec_plain(data, scal, x, jm.offsets)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):
        assert rel(got[rows], ref[rows]) < TOL_F64


def test_k7_f64_matches_plain(irregular):
    solver, state, _, _ = irregular
    jm, _ = assemble_system(
        solver.wctx, solver.face_ctxs, solver.mask_t, *state, solver.cfg.physics, solver.cfg.time
    )
    m64 = dataclasses.replace(jm, vals=jm.vals.double())
    x = torch.as_tensor(np.random.default_rng(10).standard_normal((6, solver.mesh.num_node)),
                        dtype=torch.float64, device="cuda")
    before32, before64 = winell_matvec.launches, winell_matvec_f64.launches
    got, again = (winell_matvec(m64, x) for _ in range(2))
    assert (winell_matvec.launches, winell_matvec_f64.launches) == (before32, before64 + 2)
    assert got.dtype == torch.float64 and torch.equal(got, again)
    ref = winell_matvec_plain(m64, x)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):
        assert rel(got[rows], ref[rows]) < TOL_F64


def test_spmv_kernels_refuse_other_dtypes_and_mixed_devices(card, irregular):
    """float16, mixed dtypes, and a CPU vector with a matrix on the card
    raise: nothing falls back to the plain version."""
    solver, _, wa, dwa = card
    z = lambda *shape, dt=torch.float16, dev="cuda": torch.zeros(shape, dtype=dt, device=dev)
    with pytest.raises(ValueError, match="float32 or float64"):
        dia_matvec(z(1, 16, 8, dt=torch.float64), z(2, 8, dt=torch.float64), z(6, 8), (0,))
    with pytest.raises(ValueError, match="float32 or float64"):
        dia_matvec(z(1, 16, 8, dt=torch.float32), z(2, 8, dt=torch.float32),
                   z(6, 8, dt=torch.float32, dev="cpu"), (0,))
    isolver, state, _, _ = irregular
    jm, _ = assemble_system(isolver.wctx, isolver.face_ctxs, isolver.mask_t, *state,
                            isolver.cfg.physics, isolver.cfg.time)
    n = isolver.mesh.num_node
    with pytest.raises(ValueError, match="float32 or float64"):
        winell_matvec(dataclasses.replace(jm, vals=jm.vals.half()), z(6, n))
    with pytest.raises(ValueError, match="float32 or float64"):
        winell_matvec(jm, z(6, n, dt=torch.float32, dev="cpu"))
    with pytest.raises(ValueError, match="float32 or float64"):
        winell_matvec_f64(dataclasses.replace(jm, vals=jm.vals.double()),
                          z(6, n, dt=torch.float64, dev="cpu"))


def test_repeated_amg_and_mg_steps_are_bit_identical(irregular):
    """pc "mg": algebraic multigrid on the WinELL tier and geometric on the
    lattice. Their sums are fixed-order segment reductions and gathers, no
    atomics: a repeated step equals the first bit for bit."""
    solver, state, _, _ = irregular
    cfg = dataclasses.replace(solver.cfg, krylov=dataclasses.replace(solver.cfg.krylov, pc="mg"))
    amg = NSSolver(solver.mesh, cfg, device="cuda")
    assert amg.wctx.amg_idx is not None
    mg = NSSolver(box_mesh(*BOX), dataclasses.replace(
        reference_scenario_config(), krylov=cfg.krylov), device="cuda")
    wg, dwgold, dwg = reference_initial_state(mg.mesh)
    mstate = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    for s, st in ((amg, state), (mg, mstate)):
        *first, fstats = s.step(*st)
        *again, astats = s.step(*st)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        assert fstats.krylov_iters == astats.krylov_iters
        assert all(bool(torch.isfinite(t).all()) for t in first)


@pytest.mark.parametrize("pc", ["simple", "mg"])
def test_pc_steps_on_card_match_cpu_f64(card, pc):
    """One step_fixed(num_newton=2) with pc "simple" / "mg" on the lattice:
    float32 on the card against float64 on the CPU (chip_smoke.py phase
    19's slice bar)."""
    _, state, _, _ = card
    cfg = reference_scenario_config()
    cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, pc=pc))
    got = NSSolver(box_mesh(*BOX), cfg, device="cuda").step_fixed(*state, num_newton=2)
    ref = NSSolver(box_mesh(*BOX), cfg, device="cpu").step_fixed(
        *(t.cpu().double() for t in state), num_newton=2)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all() and rel(g, r) < 1e-4


def _class_mesh(name: str):
    """The converted-mesh variants of box BOX (mesh.gen; the overlaid one
    torch_meshes') and the configuration each runs with."""
    box = box_mesh(*BOX)
    if name == "l-shaped":  # every component of the nodes no element touches held
        held = BCSpec(7, strong_components=(0, 1, 2, 3, 4, 5))
        return l_shaped_mesh(*BOX), dict(bcs=reference_scenario_config().bcs + (held,))
    if name == "recovered":
        return recover_lattice(shuffled_mesh(box, seed=1, mirror=True))[0], {}
    if name == "overlaid":  # 8 classes, 21 DIA planes: the widest tables
        return overlaid_mesh(*BOX), {}
    return deformed_mesh(box), {}


def _class_case(name: str, implicit: bool):
    """(solver, wa, dwa, source) on the card for a converted-mesh variant
    of box BOX, the melt-pool scenario when `implicit`."""
    mesh, over = _class_mesh(name)
    base = melt_pool_scenario_config() if implicit else reference_scenario_config()
    if "bcs" in over:
        over = dict(bcs=base.bcs + over["bcs"][-1:])
    cfg = dataclasses.replace(base, **over)
    solver = NSSolver(mesh, cfg, device="cuda")
    assert solver.fastpath == ("lattice" if name == "recovered" else "classes")
    init = melt_pool_initial_state if implicit else reference_initial_state
    wg, dwgold, dwg = init(mesh)
    rng = np.random.default_rng(21)
    wg, dwg = wg + 0.1 * rng.standard_normal(wg.shape), dwg + 0.1 * rng.standard_normal(dwg.shape)
    wa, dwa = alpha_states(*state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32), cfg.time)
    src = torch.as_tensor(laser_source(melt_pool_scenario_config().physics.laser, mesh.xg, 0.01),
                          dtype=torch.float32, device="cuda")
    return solver, wa, dwa, src


def _check_k1c_k2c(solver, wa, dwa, src, residual, jacobian, counters):
    """K1c (with and without the heat source) and K2c (masked with the
    facet band, and unmasked) through `residual` / `jacobian` against their
    plain versions per equation / vel/p block / phi-T tangent, each run
    twice (bit-identical, `counters` count two launches); the implicit
    mode's own count. Returns K1c's results."""
    lctx, phys, scheme = solver.lctx, solver.cfg.physics, solver.cfg.time
    implicit = lctx.scalar_implicit
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    out = []
    for source in (None, src):
        args = (lctx, wa_t, dwa_t, phys, scheme, source)
        got = _twice(lambda: residual(*args), counters[0])
        ref = lat.residual_volume_plain(*args)
        for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):
            assert rel(got[rows], ref[rows]) < 2e-5, rows
        out.append(got)
    nc = 18 if implicit else 16
    keep = keep_pc_rows(solver.mask_t, torch.float32)[:nc].contiguous()
    add = diag_add_rows(solver.mask_t, torch.float32)[:nc].contiguous()
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets),
                                     keep_pc_rows(solver.mask_t, torch.float32))
    for k, a, b in ((keep, add, band), (torch.ones_like(keep), torch.zeros_like(add), None)):
        call = lambda: jacobian(lctx, wa_t, phys, scheme, k, a, b, lo)
        pack = (lambda: torch.cat([t.reshape(-1) for t in call()])) if implicit else call
        _twice(pack, counters[1])
        got = call()
        ref = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, k, a, b, lo)
        data, rdata = (got[0], ref[0]) if implicit else (got, ref)
        for block, comps in VP_BLOCKS.items():
            assert rel(data[:, list(comps)], rdata[:, list(comps)]) < 2e-5, block
        if implicit:
            assert rel(got[1][0::2], ref[1][0::2]) < 2e-5 and rel(got[1][1::2], ref[1][1::2]) < 2e-5
    # the implicit mode has a count of its own; the frozen mode leaves it be
    before = counters[1].implicit_launches
    jacobian(lctx, wa_t, phys, scheme, keep, add)
    assert counters[1].implicit_launches == before + int(implicit)
    return out


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
@pytest.mark.parametrize("name", ["deformed", "recovered", "l-shaped", "overlaid"])
def test_k1c_k2c_match_plain(name, implicit):
    """The one-pass K1c and K2c, reached through K1's and K2's wrappers on
    a context without the fused tables whose table placed on a node grid
    (T = 6 and 15 planes; overlaid: T = 8 and 21 planes), against their
    plain versions per equation / vel/p block / phi-T tangent; two runs
    bit-identical. The two-pass entries count no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    solver, wa, dwa, src = _class_case(name, implicit)
    lctx = solver.lctx
    assert lctx.fused is None and lctx.grid is not None and lctx.res_sync is not None
    two = (lat.residual_volume_two_pass.launches, lat.jacobian_volume_two_pass.launches)
    _check_k1c_k2c(solver, wa, dwa, src, lat.residual_volume, lat.jacobian_volume,
                   (lat.residual_volume_classes, lat.jacobian_volume_classes))
    assert (lat.residual_volume_two_pass.launches, lat.jacobian_volume_two_pass.launches) == two


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
@pytest.mark.parametrize("name", ["deformed", "recovered", "overlaid"])
def test_k1c_k2c_two_passes_match_plain(name, implicit):
    """The two-pass entries, called directly and reached through the
    wrappers on the same context with its node grid taken away (a table
    that does not place), against their plain versions; their K1c equals
    the one-pass K1c bit for bit (the same body's values added in the
    plain order from +0.0f)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    solver, wa, dwa, src = _class_case(name, implicit)
    counters = (lat.residual_volume_two_pass, lat.jacobian_volume_two_pass)
    got = _check_k1c_k2c(solver, wa, dwa, src, lat.residual_volume_two_pass,
                         lat.jacobian_volume_two_pass, counters)
    one = [lat.residual_volume(solver.lctx, wa.T.contiguous(), dwa.T.contiguous(),
                               solver.cfg.physics, solver.cfg.time, s) for s in (None, src)]
    assert all(torch.equal(g, o) for g, o in zip(got, one))
    solver.lctx = dataclasses.replace(solver.lctx, grid=None, res_sync=None)
    before = lat.residual_volume_classes.launches, lat.jacobian_volume_classes.launches
    _check_k1c_k2c(solver, wa, dwa, src, lat.residual_volume, lat.jacobian_volume, counters)
    assert (lat.residual_volume_classes.launches, lat.jacobian_volume_classes.launches) == before


def test_k1c_equals_the_ticketed_k1_on_a_kuhn_context(card, melt):
    """The Kuhn box's own table through the one-pass K1c (the run-time
    corners in the Kuhn order) gives the ticketed K1's output bit for bit,
    with and without the heat source; the two share the context's ticket
    workspace, calls in order."""
    for solver, wa, dwa, src in ((card[0], card[2], card[3], None), melt[:1] + melt[2:]):
        lctx = solver.lctx
        assert lctx.fused is not None and lctx.grid is not None
        args = (lctx, wa.T.contiguous(), dwa.T.contiguous(), solver.cfg.physics,
                solver.cfg.time, src)
        k1 = lat.residual_volume(*args)
        k1c = _twice(lambda: lat.residual_volume_classes(*args), lat.residual_volume_classes)
        assert torch.equal(k1c, k1)
        assert torch.equal(lat.residual_volume(*args), k1)


def test_k1c_fails_loudly_on_a_corrupt_workspace():
    """The one-pass K1c waits as K1 does: on a class context whose ticket
    counter is moved off its call boundary, the launch fails after the
    wait's bound and the next synchronisation raises (fresh interpreter,
    since a trap ends its process's CUDA context)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    code = textwrap.dedent("""
        import numpy as np
        import torch
        from dedflow_tpu_torch.app.scenarios import reference_scenario_config
        from dedflow_tpu_torch.fem import lattice as lat
        from dedflow_tpu_torch.mesh.gen import box_mesh, deformed_mesh
        from dedflow_tpu_torch.solver.newton import NSSolver
        solver = NSSolver(deformed_mesh(box_mesh(7, 5, 6)), reference_scenario_config(),
                          device="cuda")
        lctx, cfg = solver.lctx, solver.cfg
        assert lctx.fused is None and lctx.grid is not None
        w = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 6, lctx.num_node)),
                            dtype=torch.float32, device="cuda")
        args = (lctx, w[0], w[1], cfg.physics, cfg.time)
        ok = torch.isfinite(lat.residual_volume(*args)).all().item()
        print("first call finite:", ok, lat.residual_volume_classes.launches, flush=True)
        lctx.res_sync[0] += 1  # the ticket counter's low word
        out = lat.residual_volume(*args)
        torch.cuda.synchronize()
        print("second call returned", flush=True)
    """)
    run = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert "first call finite: True 1" in run.stdout, run.stderr[-2000:]
    assert "second call returned" not in run.stdout
    assert run.returncode != 0 and "CUDA error" in run.stderr, run.stderr[-2000:]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_k3_wide_matches_plain(dtype, tol):
    """K3 on 27 planes (every corner difference of a 7 x 5 x 6 lattice
    cell), more than the Kuhn lattice's 15."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    sy, sz = 8, 48
    offs = tuple(sorted(dx + sy * dy + sz * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)))
    n = 8 * 6 * 7
    rng = np.random.default_rng(22)
    data, scal, x = (torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device="cuda")
                     for shape in ((27, 16, n), (54, n), (6, n)))
    counter = dia_matvec if dtype == torch.float32 else dia_matvec_f64
    got = _twice(lambda: dia_matvec(data, scal, x, offs), counter)
    ref = dia_matvec_plain(data, scal, x, offs)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):
        assert rel(got[rows], ref[rows]) < tol, rows


# ---------------------------------------------------------------------------
# the scalar heat / Poisson slice: K8 / K9 with one output row


def _poisson_system(mesh, device, dtype):
    """-lap(u) = 3 pi^2 sin(pi x) sin(pi y) sin(pi z), u = 0 on all faces:
    (K, b) with the constrained rows applied, and the context."""
    ctx = build_context(mesh, device=device, dtype=dtype, scalar_plans=True)
    x, y, z = mesh.xg.T
    f = 3 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)
    k, b = heat.assemble_poisson(ctx, torch.as_tensor(f, dtype=dtype, device=device))
    mask = torch.as_tensor(build_mask(mesh, [StrongBC(i, (0,)) for i in range(6)], 1),
                           device=device)
    return apply_mat(mask, k), apply_vec(mask[:, 0], b), ctx


@pytest.fixture(scope="module")
def poisson():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    mesh = box_mesh(9, 8, 7)
    return mesh, _poisson_system(mesh, "cuda", torch.float32)


def _peak_bytes(fn) -> int:
    """Device bytes a call allocates at its peak, above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def test_k8_k9_one_row_match_plain(poisson):
    """The heat scatters' one-row K8 / K9 on the Poisson plans: two runs
    bit-identical, within 1e-5 of the plain version, equal to the
    plan-order sum bit for bit, with no (K, 8) staging buffer (the one-pass
    entry allocates only its output); the scatters themselves through
    them."""
    mesh, (_, _, ctx) = poisson
    rng = np.random.default_rng(31)
    m = ctx.num_elem
    for plan, slots, kern, plain in ((ctx.scalar_res_plan, 4, stream_reduce, stream_reduce_plain),
                                     (ctx.scalar_jac_plan, 16, ring_reduce, ring_reduce_plain)):
        x = torch.as_tensor(rng.standard_normal((1, slots * m)), dtype=torch.float32,
                            device="cuda")
        got = _twice(lambda: kern(plan, x), kern)
        assert rel(got, plain(plan, x)) < 1e-5
        assert torch.equal(got, _plan_order_sum(plan, x, (0,), slots * m))
        assert _peak_bytes(lambda: kern(plan, x)) < plan.src.numel() * 32
    ef = torch.as_tensor(rng.standard_normal((m, 4)), dtype=torch.float32, device="cuda")
    ej = torch.as_tensor(rng.standard_normal((m, 4, 4, 1, 1)), dtype=torch.float32,
                         device="cuda")
    before = (stream_reduce.launches, ring_reduce.launches)
    f, data = scatter_residual(ctx, ef), scatter_matrix(ctx, ej)
    assert (stream_reduce.launches, ring_reduce.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(f, stream_reduce(ctx.scalar_res_plan, ef.reshape(1, -1))[0])
    assert rel(f, stream_reduce_plain(ctx.scalar_res_plan, ef.reshape(1, -1))[0]) < 1e-5
    assert data.shape == (ctx.win_plan.S, 1, 1)


def test_one_row_reduce_stress():
    """The one-pass one-row K8 / K9 on plans from build_reduce_plan:
    targets without contributions, a target longer than the kernel's tile
    of 8192 contributions, an odd target count, a plan without
    contributions, and source row 1 of a (2, M) source (offset by cstride):
    bit-equal to the plan-order sum, twice bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    rng = np.random.default_rng(41)
    t = 1001
    tgt = np.concatenate([rng.integers(0, t, 30000), np.full(10000, 517), np.full(300, 1000)])
    tgt = tgt[tgt % 7 != 3]
    src = rng.permutation(tgt.size)
    for plan, x, comps, cstride in (
            (build_reduce_plan(tgt, src, t), rng.standard_normal((1, tgt.size)), (0,), tgt.size),
            (build_reduce_plan(tgt, src, t), rng.standard_normal((2, tgt.size)), (1,), tgt.size),
            (build_reduce_plan([], [], 9), np.zeros((1, 4)), (0,), 4)):
        x = torch.as_tensor(x, dtype=torch.float32, device="cuda")
        ref = _plan_order_sum(plan, x, comps, cstride)
        for kern in (stream_reduce, ring_reduce):
            got = _twice(lambda: kern(plan, x, comps, cstride), kern)
            assert got.shape == (1, plan.num_tgt) and torch.equal(got, ref)


def test_cg_on_card_repeats_and_matches_cpu_f64(poisson):
    """Jacobi CG at rtol 1e-6 in float32: the same count and iterate bit for
    bit on a second run (deterministic sums), and the solution within
    1e-4 of the CPU's float64 solve."""
    mesh, (k, b, _) = poisson
    pc = JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])
    solve = lambda: cg(lambda v: k.matvec(v[:, None])[:, 0], b, maxit=500, atol=0.0,
                       rtol=1e-6, pc=pc)
    one, two = solve(), solve()
    assert one.converged and one.iters == two.iters and torch.equal(one.x, two.x)
    k64, b64, _ = _poisson_system(mesh, "cpu", torch.float64)
    ref = cg(lambda v: k64.matvec(v[:, None])[:, 0], b64, maxit=500, atol=0.0, rtol=1e-10,
             pc=JacobiPC.from_diag(k64.diag_blocks()[:, 0, 0]))
    assert ref.converged and rel(one.x, ref.x) < 1e-4
