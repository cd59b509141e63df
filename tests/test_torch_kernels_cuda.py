"""The hand-written CUDA kernels of dedflow_tpu_torch == their plain versions.

Every test here needs a card (marker `cuda`) and skips without one. The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.) Inputs are
made with numpy from a seed on an odd-sized box (lattice kernels K1-K3,
with the reference and the melt-pool scenario: K1 with a heat source, K2
with the implicit phi/T tangents), on an RCM-ordered Delaunay mesh
(irregular-tier kernels K6-K10, K6 also in its 33-row mode), on an
unordered one (the gather tier's K4/K5, K5 also implicit) and on a particle
cloud bucketed onto a cell grid (the DEM contact sweep K11), float32 on the
card. Relative error = max|kernel - plain| / max|plain|;
the tolerances are float32 roundoff (different sum orders, hardware
rsqrtf), as in chip_smoke.py, which runs the same comparisons at full
size. Every kernel is also run twice: the two results are bit-identical
(no atomics).
"""

import dataclasses

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
from dedflow_tpu_torch.dem.cells import make_grid
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.particles import particle_state
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import element_rows as er
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.fem import win_assembly as wa_
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu_torch.solver.newton import NSSolver, assemble_system
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_plain
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
from dedflow_tpu_torch.sparse.win_gather import JAC_ROWMAP, RES_ROWMAP, win_gather, win_gather_plain
from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain
from dedflow_tpu_torch.sparse.winell import COMP2WIN

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
        assert lat.jacobian_volume.launches == before + 1
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
    """A CUDA tensor never takes the plain version: float64 raises."""
    solver, _, wa, dwa = card
    with pytest.raises(ValueError, match="float32"):
        dia_matvec(
            torch.zeros((1, 16, 8), dtype=torch.float64, device="cuda"),
            torch.zeros((2, 8), dtype=torch.float64, device="cuda"),
            torch.zeros((6, 8), dtype=torch.float64, device="cuda"), (0,),
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


def test_k8_k9_reduces_match_plain(irregular):
    solver, _, wa, dwa = irregular
    phys, scheme, ctx = solver.cfg.physics, solver.cfg.time, solver.wctx
    ne = ctx.num_elem
    out24 = ek.res_rows_call(wa_.residual_inputs(ctx, wa, dwa), phys, scheme)
    got = _twice(lambda: stream_reduce(ctx.res_plan, out24, range(6), ne), stream_reduce)
    ref = stream_reduce_plain(ctx.res_plan, out24, range(6), ne)
    for rows in (slice(0, 3), slice(3, 4), slice(4, 6)):  # u, p, phi/T equations
        assert rel(got[rows], ref[rows]) < 1e-5
    out288 = ek.lhs_rows_call(wa_.jacobian_inputs(ctx, wa), phys, scheme)
    comps = wa_.JAC_COMPS  # output row r is WinELL row r
    got = _twice(lambda: ring_reduce(ctx.jac_plan, out288, comps, ne), ring_reduce)
    ref = ring_reduce_plain(ctx.jac_plan, out288, comps, ne)
    for block, fs in VP_BLOCKS.items():
        rows = [int(COMP2WIN[c]) for c in fs]
        assert rel(got[rows], ref[rows]) < 1e-5, block


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


@pytest.mark.parametrize("cap", [2, 3, 8, 11])
def test_k11_contact_sweep_matches_plain(cap):
    """K11 against its plain twin with and without the tangential term.
    The kernel takes the plain version's pair order and IEEE float32 ops
    (no contraction), so the bar is float32 roundoff of the sums."""
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
