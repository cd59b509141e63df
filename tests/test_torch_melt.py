"""dedflow_tpu_torch moving-laser melt pool (BASELINE config #3: the phi/T
equations active with their implicit tangents and a moving heat source)
== the JAX package, on every ported tier.

Inputs are made with numpy from a seed; relative error = max|port - jax| /
max|jax|.

- The scenario copies (laser source, melt-pool and cavity configurations
  and initial states) equal the JAX package's exactly.
- float64 element bodies and weak form: the 33-row implicit
  `element_rows.lhs_rows` against JAX `lhs_rows_call(backend="xla",
  scalar_implicit=True)`, `scalar_lhs_blocks` / `ns_lhs_packed(..., True)`
  and the K5 plain twin against the JAX weak form: 1e-12 (the same
  arithmetic in another framework).
- float32 plain twins against the JAX Pallas kernels in interpret mode:
  K6's 33-row mode on 512 columns (one grid step) and K1 with a heat
  source (the fused lattice kernel, block 128): 2e-5, float32 roundoff.
- float64 assembly: the lattice F with a source and the dense implicit J
  against the JAX lattice tier (box 5x4x4); the WinELL tier's and the
  gather tier's (whole and chunked) F and J on delaunay_mesh(300) + RCM
  against the JAX gather oracle: 1e-12.
- Steps: `step_fixed(2)` and the adaptive `step` with the laser source, at
  1e-9 with equal Newton and Krylov counts, on each tier: the lattice box
  5x4x4 against the JAX lattice solver, and the converted box 4x3x3
  (lattice metadata dropped, RCM) on the WinELL and the gather tiers against
  the JAX gather solver.
- The CLI's `--scenario melt-pool` (adaptive and `--fixed-newton`) and
  `--scenario cavity` on a CPU box.
The kernels themselves are held against these plain versions on a card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.fem import element as jel
from dedflow_tpu.fem import lattice as jlat
from dedflow_tpu.fem import ns as jns
from dedflow_tpu.fem import pallas_kernels as jpk
from dedflow_tpu.fem import weakform as jwf
from dedflow_tpu.fem.assembly import build_context as jbuild_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.sparse.topology import build_sparsity
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app import scenarios as tsc
from dedflow_tpu_torch.fem import assembly as tasm
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem import ns as tns
from dedflow_tpu_torch.fem import weakform as twf
from dedflow_tpu_torch.fem import win_assembly as twin
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import reorder as treo
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.sparse.topology import build_sparsity as t_build_sparsity


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CFG = jsc.melt_pool_scenario_config()
LASER_T = 0.01  # the source's time in the assembly tests


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


def _melt_state(mesh, seed):
    """The melt-pool initial state with every field perturbed (so every
    input row of the element bodies is non-zero)."""
    wg, dwgold, dwg = jsc.melt_pool_initial_state(mesh)
    rng = np.random.default_rng(seed)
    return wg + 0.1 * rng.standard_normal(wg.shape), dwgold, dwg + 0.1 * rng.standard_normal(dwg.shape)


def test_laser_source_matches_jax():
    laser, xg = CFG.physics.laser, box_mesh(5, 4, 4).xg
    for t in (0.0, LASER_T, 0.37):
        ref = jsc.laser_source(laser, xg, t)
        got = tsc.laser_source(_tcfg(CFG).physics.laser, tgen.box_mesh(5, 4, 4).xg, t)
        assert np.array_equal(got, ref) and ref.max() > 0


@pytest.mark.parametrize("name", ["melt-pool", "cavity"])
def test_scenario_copies_match_jax(name):
    jfns = {"melt-pool": (jsc.melt_pool_scenario_config, jsc.melt_pool_initial_state),
            "cavity": (jsc.lid_driven_cavity_config, jsc.lid_driven_cavity_initial_state)}
    tfns = {"melt-pool": (tsc.melt_pool_scenario_config, tsc.melt_pool_initial_state),
            "cavity": (tsc.lid_driven_cavity_config, tsc.lid_driven_cavity_initial_state)}
    (jconf, jinit), (tconf, tinit) = jfns[name], tfns[name]
    assert tconf() == _tcfg(jconf())
    assert tconf(use_lattice="gather") == _tcfg(jconf(use_lattice="gather"))
    for got, ref in zip(tinit(tgen.box_mesh(4, 3, 3)), jinit(box_mesh(4, 3, 3))):
        assert np.array_equal(got, ref)


def _tets(n, seed):
    """(n, 4, 3) jittered, positively oriented small tets."""
    rng = np.random.default_rng(seed)
    ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    x = 0.1 * (ref[None] + 0.2 * rng.standard_normal((n, 4, 3)))
    x += rng.standard_normal((n, 1, 3))
    neg = np.linalg.det(x[:, 1:] - x[:, :1]) < 0
    x[neg] = x[neg][:, [0, 2, 1, 3]]
    return x


def _lhs33(n, seed):
    """(33, n) implicit-mode K6 inputs: geometry rows, random nodal
    velocities (rows i*4+a), det/gg/tr, then the 6 metric entries."""
    g = jel.tet_geometry(jnp.asarray(_tets(n, seed)))
    lhs = np.asarray(jpk.lhs_geom_rows(g.shgrad, g.det_j, g.metric))
    res = np.asarray(jpk.res_geom_rows(g.shgrad, g.det_j, g.metric))
    u = np.random.default_rng(seed + 1).standard_normal((12, n))
    return np.concatenate([lhs[:12], u, lhs[12:], res[13:19]])


@pytest.mark.parametrize("batched", [False, True], ids=["rows", "slabs"])
def test_lhs_rows_implicit_f64_matches_jax_xla(batched):
    inp = _lhs33(48, 1)
    if batched:  # (S, 33, E): the lattice's slab-major layout
        inp = np.stack([inp, _lhs33(48, 3)])
    ref = jax.jit(functools.partial(jpk.lhs_rows_call, phys=CFG.physics, scheme=CFG.time,
                                    backend="xla", scalar_implicit=True))(jnp.asarray(inp))
    tc = _tcfg(CFG)
    got = ek.lhs_rows_call(torch.as_tensor(inp), tc.physics, tc.time, scalar_implicit=True)
    assert got.shape == ref.shape
    assert rel(got.numpy(), ref) < 1e-12
    scal = got.numpy().reshape(*got.shape[:-2], 16, 18, 48)[..., 16:, :]
    assert rel(scal, np.asarray(ref).reshape(scal.shape[:-3] + (16, 18, 48))[..., 16:, :]) < 1e-12


def test_lhs_rows_implicit_f32_matches_pallas_interpret():
    """K6's 33-row mode: the plain body in float32 against the JAX Pallas
    kernel through the interpreter on 512 columns (one grid step), each
    velocity/pressure block and each scalar tangent on its own scale."""
    inp = _lhs33(512, 5).astype(np.float32)
    ref = np.asarray(jpk.lhs_rows_call(jnp.asarray(inp), CFG.physics, CFG.time,
                                       interpret=True, scalar_implicit=True))
    tc = _tcfg(CFG)
    got = ek.lhs_rows_call(torch.as_tensor(inp), tc.physics, tc.time, scalar_implicit=True)
    assert got.dtype == torch.float32
    got, ref = got.numpy().reshape(16, 18, 512), ref.reshape(16, 18, 512)
    for comps in (slice(0, 9), slice(9, 12), slice(12, 15), slice(15, 16), [16], [17]):
        assert rel(got[:, comps], ref[:, comps]) < 2e-5, comps


@pytest.fixture(scope="module")
def delaunay():
    """delaunay_mesh(300, seed=5) + RCM: the JAX gather context (the oracle)
    and the port's mesh and sparsity; random alpha states and a source."""
    jm = delaunay_mesh(300, seed=5)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = tgen.delaunay_mesh(300, seed=5)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    assert np.array_equal(tm.ien, np.asarray(jm.ien))
    jctx = jbuild_context(jm, build_sparsity(np.asarray(jm.ien), jm.num_node, native=False))
    rng = np.random.default_rng(2)
    wa, dwa = rng.normal(size=(2, tm.num_node, 6))
    src = jsc.laser_source(CFG.physics.laser, jm.xg, LASER_T)
    return jm, tm, jctx, t_build_sparsity(tm.ien, tm.num_node), wa, dwa, src


@pytest.fixture(scope="module")
def oracle(delaunay):
    """The JAX gather oracle on the Delaunay mesh (no mask): F (6, N) with
    the source, unfrozen, and the dense implicit J."""
    jm, tm, jctx, tsp, wa, dwa, src = delaunay
    mask = jnp.zeros((jm.num_node, 6), bool)
    jwa, jdwa = jnp.asarray(wa), jnp.asarray(dwa)
    # each assembly jitted once (op by op it compiles every op)
    f_ref = np.asarray(jax.jit(lambda a, b, s: jns.assemble_residual(
        jctx, (), mask, a, b, CFG.physics, CFG.time, freeze_phi_temperature=False,
        source=s))(jwa, jdwa, jnp.asarray(src))).T
    j_ref = jax.jit(lambda a, b: jns.assemble_jacobian(
        jctx, (), mask, a, b, CFG.physics, CFG.time, scalar_implicit=True))(
        jwa, jdwa).to_block_dense()
    return f_ref, j_ref


def test_scalar_lhs_blocks_and_packed_match_jax(delaunay):
    jm, tm, jctx, tsp, wa, dwa, _ = delaunay
    tc = _tcfg(CFG)
    g = tasm.elem_geom(tasm.build_context(tm, tsp, device="cpu"))
    jef = jwf.gather_fields(jctx.ien, jnp.asarray(wa), jnp.asarray(dwa))
    ef = twf.gather_fields(torch.as_tensor(tm.ien), torch.as_tensor(wa), torch.as_tensor(dwa))
    refs = jax.jit(lambda c, f: (
        jwf.scalar_lhs_blocks(c, f, CFG.physics, CFG.time),
        jwf.ns_lhs_packed(c, f, CFG.physics, CFG.time, True),
        jwf.ns_lhs_elements(c, f, CFG.physics, CFG.time, True),
    ))(jctx, jef)
    for got, ref in zip(twf.scalar_lhs_blocks(g, ef, tc.physics, tc.time), refs[0]):
        assert rel(got.numpy(), ref) < 1e-12
    got = twf.ns_lhs_packed(g, ef, tc.physics, tc.time, scalar_implicit=True)
    assert rel(got.numpy(), refs[1]) < 1e-12
    got = twf.ns_lhs_elements(g, ef, tc.physics, tc.time, scalar_implicit=True)
    assert rel(got.numpy(), refs[2]) < 1e-12


def test_k5_implicit_plain_twin_matches_jax_weakform(delaunay):
    """K5 given the residual geometry's metric rows, whole mesh and on a
    column slice (an assembly chunk read in place)."""
    jm, tm, jctx, tsp, wa, dwa, _ = delaunay
    tc = _tcfg(CFG)
    ctx = tasm.build_context(tm, tsp, device="cpu")
    jef = jwf.gather_fields(jctx.ien, jnp.asarray(wa), jnp.asarray(dwa))
    ref = np.asarray(jwf.ns_lhs_packed(jctx, jef, CFG.physics, CFG.time, True))
    ref = ref.reshape(-1, 16, 18)
    w_t = torch.as_tensor(wa.T.copy())
    for lo, hi in ((0, ctx.num_elem), (100, 400)):
        got = ek.ns_lhs_gather(ctx.lhs_geom[:, lo:hi], ctx.ien_t[:, lo:hi], w_t, tc.physics,
                               tc.time, metric=ctx.res_geom[13:19, lo:hi])
        got = got.numpy().reshape(16, 18, hi - lo).transpose(2, 0, 1)
        assert rel(got, ref[lo:hi]) < 1e-12


def test_winell_source_and_implicit_jacobian_match_gather_oracle(delaunay, oracle):
    jm, tm, jctx, tsp, wa, dwa, src = delaunay
    f_ref, j_ref = oracle
    tc = _tcfg(CFG)
    ctx = twin.build_win_context(tm, tsp, device="cpu")
    f = twin.residual_win(ctx, torch.as_tensor(wa), torch.as_tensor(dwa), tc.physics, tc.time,
                          source=torch.as_tensor(src))
    assert rel(f.numpy(), f_ref) < 1e-12 and rel(f[5].numpy(), f_ref[5]) < 1e-12
    jt = twin.jacobian_win(ctx, torch.as_tensor(wa), tc.physics, tc.time, scalar_implicit=True)
    assert rel(jt.to_block_dense(), j_ref) < 1e-12


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunk64"])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_gather_tier_source_and_implicit_jacobian_match_gather_oracle(delaunay, oracle, chunk,
                                                                      kernel):
    """The gather tier's F with the source and implicit J, whole and in
    element ranges, through the weak form ("xla") and K4/K5's plain twins
    ("pallas")."""
    jm, tm, jctx, tsp, wa, dwa, src = delaunay
    f_ref, j_ref = oracle
    tc = _tcfg(CFG)
    ctx = tasm.build_context(tm, tsp, device="cpu", chunk=chunk, elements_kernel=kernel)
    mask_t = torch.zeros((6, tm.num_node), dtype=torch.bool)
    args = (ctx, (), mask_t, torch.as_tensor(wa), torch.as_tensor(dwa), tc.physics, tc.time)
    f = tns.assemble_residual(*args, freeze_phi_temperature=False, source=torch.as_tensor(src))
    assert rel(f.numpy(), f_ref) < 1e-12
    assert rel(tns.assemble_jacobian(*args, scalar_implicit=True).to_block_dense(), j_ref) < 1e-12


@pytest.fixture(scope="module")
def lattice():
    """box_mesh(5, 4, 4), the melt-pool scenario on the lattice tier: the JAX
    and port solvers (float64), a perturbed state and the laser source."""
    jm, tm = box_mesh(5, 4, 4), tgen.box_mesh(5, 4, 4)
    js = jnt.NSSolver(jm, CFG)
    ts = tnt.NSSolver(tm, _tcfg(CFG), device="cpu")
    assert js.fastpath == ts.fastpath == "lattice" and js.lctx.scalar_implicit
    assert ts.lctx.scalar_implicit and ts.face_ctxs
    return jm, js, ts, _melt_state(jm, 0), jsc.laser_source(CFG.physics.laser, jm.xg, LASER_T)


def _alphas(state, scheme, dtype):
    jwa = jns.alpha_states(*(jnp.asarray(a, dtype) for a in state), scheme)
    tdt = torch.float32 if dtype == jnp.float32 else torch.float64
    twa = alpha_states(*interop.state_from_numpy(*state, "cpu", tdt), scheme)
    return jwa, twa


def test_lattice_residual_with_source_f64_matches_jax(lattice):
    """F through the solvers' residual (the JAX one jitted): the volume
    terms with the source, the Nitsche wall, the mask, unfrozen phi/T."""
    jm, js, ts, state, src = lattice
    ref = js._residual(js.solve_ctx, js.face_ctxs, js.mask, *(jnp.asarray(a) for a in state),
                       source=jnp.asarray(src))
    got = tnt.residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t,
                       *interop.state_from_numpy(*state, "cpu"), ts.cfg.physics, ts.cfg.time,
                       False, source=torch.as_tensor(src))
    assert rel(got.numpy(), ref) < 1e-12
    assert rel(got[5].numpy(), np.asarray(ref)[5]) < 1e-12  # the heated T rows


def test_lattice_implicit_jacobian_f64_matches_jax(lattice):
    jm, js, ts, state, _ = lattice
    ref, _ = js._assemble_system(js.solve_ctx, js.face_ctxs, js.mask,
                                 *(jnp.asarray(a) for a in state))
    got, _ = tnt.assemble_system(ts.solve_ctx, ts.face_ctxs, ts.mask_t,
                                 *interop.state_from_numpy(*state, "cpu"), ts.cfg.physics,
                                 ts.cfg.time, scalar_implicit=True)
    nd = len(ts.lctx.offsets)
    assert got.scal.shape == (2 * nd, jm.num_node)
    assert rel(got.to_block_dense(), ref.to_block_dense()) < 1e-12
    # the tangents fill the off-diagonal planes too (the frozen mode's do not)
    assert float(got.scal.abs().sum()) > float(got.scal[2 * ts.lctx.offsets.index(0):][:2].abs().sum())


@pytest.fixture(scope="module")
def lattice32(lattice):
    jm, js, ts, state, src = lattice
    jl32 = jlat.build_lattice_context(jm, dtype=jnp.float32, rows_backend="xla",
                                      scalar_implicit=True)
    ts32 = tnt.NSSolver(tgen.box_mesh(5, 4, 4), ts.cfg, device="cpu", dtype=torch.float32)
    return jl32, ts32, _alphas(state, CFG.time, jnp.float32), src.astype(np.float32)


def test_plain_k1_with_source_matches_fused_interpret(lattice, lattice32):
    jm = lattice[0]
    jl32, ts32, ((wa, dwa), (twa, tdwa)), src = lattice32
    ref = jlat.residual_fused(jl32, wa.T, dwa.T, jnp.asarray(src)[None], CFG.physics, CFG.time,
                              interpret=True, block=128)
    got = tlat.residual_volume(ts32.lctx, twa.T.contiguous(), tdwa.T.contiguous(),
                               ts32.cfg.physics, ts32.cfg.time, torch.as_tensor(src))
    assert got.dtype == torch.float32
    ref = np.asarray(ref)[:, : jm.num_node]
    assert rel(got.numpy(), ref) < 2e-5
    assert rel(got[5].numpy(), ref[5]) < 2e-5


def test_plain_k2_implicit_f32_matches_jax_rows_path(lattice32):
    """K2's implicit plain version (data and scal, unmasked) against the JAX
    float32 rows path (33-row body + 96-slice reduce) of the same matrix."""
    jl32, ts32, ((wa, dwa), (twa, tdwa)), _ = lattice32
    ref = np.asarray(jax.jit(lambda w_t: jnp.stack(jlat._reduce_lhs_planes(jl32, jpk.lhs_rows_call(
        jlat._lhs_inputs(jl32, w_t), CFG.physics, CFG.time, backend="xla", scalar_implicit=True,
    ))))(wa.T))
    lctx = ts32.lctx
    n = lctx.num_node
    data, scal = tlat.jacobian_volume(lctx, twa.T.contiguous(), ts32.cfg.physics, ts32.cfg.time,
                                      torch.ones((18, n)), torch.zeros((18, n)))
    assert rel(data.numpy(), ref[:, :16]) < 2e-5
    scal = scal.numpy().reshape(-1, 2, n)
    for k in (0, 1):  # phi-phi, T-T
        assert rel(scal[:, k], ref[:, 16 + k]) < 2e-5


@pytest.fixture(scope="module")
def converted():
    """box_mesh(4, 3, 3) without its lattice metadata, RCM-reordered, the
    melt-pool scenario (Nitsche wall included): the JAX gather solver and
    the port's WinELL and gather solvers, float64."""
    jm = dataclasses.replace(box_mesh(4, 3, 3), lattice=None)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = dataclasses.replace(tgen.box_mesh(4, 3, 3), lattice=None)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    js = jnt.NSSolver(jm, dataclasses.replace(CFG, use_lattice="gather"))
    ports = {
        tier: tnt.NSSolver(tm, _tcfg(dataclasses.replace(CFG, use_lattice=tier)), device="cpu")
        for tier in ("winell", "gather")
    }
    assert js.fastpath == "gather" and [s.fastpath for s in ports.values()] == ["winell", "gather"]
    return jm, js, ports, _melt_state(jm, 3), jsc.laser_source(CFG.physics.laser, jm.xg, LASER_T)


def _solvers(lattice, converted, tier):
    """(JAX solver, port solver, state, source) of a tier."""
    if tier == "lattice":
        _, js, ts, state, src = lattice
        return js, ts, state, src
    _, js, ports, state, src = converted
    return js, ports[tier], state, src


@pytest.mark.parametrize("tier", ["lattice", "winell", "gather"])
def test_melt_step_fixed_matches_jax(lattice, converted, tier):
    js, ts, state, src = _solvers(lattice, converted, tier)
    ref = js.step_fixed(*(jnp.asarray(a) for a in state), num_newton=2, source=jnp.asarray(src))
    got = ts.step_fixed(*interop.state_from_numpy(*state, device="cpu"), num_newton=2,
                        source=torch.as_tensor(src))
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name


@pytest.mark.parametrize("tier", ["lattice", "winell", "gather"])
def test_melt_step_matches_jax(lattice, converted, tier):
    js, ts, state, src = _solvers(lattice, converted, tier)
    *ref, rstats = js.step(*(jnp.asarray(a) for a in state), source=jnp.asarray(src))
    *got, tstats = ts.step(*interop.state_from_numpy(*state, device="cpu"),
                           source=torch.as_tensor(src))
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name
    assert len(tstats.rnorms) == len(rstats.rnorms)
    assert tstats.krylov_iters == rstats.krylov_iters
    assert tstats.converged == rstats.converged
    assert rel(got[0][:, 5].numpy(), np.asarray(ref[0])[:, 5]) < 1e-9  # temperature


def test_cpu_tensors_count_no_kernel_launch(lattice, delaunay):
    """The melt modes' wrappers on CPU tensors run their plain versions and
    count no launch: K1 with a source, K2 implicit, K6 33-row, K5 implicit."""
    jm, js, ts, state, src = lattice
    _, (twa, tdwa) = _alphas(state, CFG.time, jnp.float64)
    counters = (tlat.residual_volume, tlat.jacobian_volume, ek.lhs_rows_call, ek.ns_lhs_gather)
    before = [c.launches for c in counters]
    n, phys, scheme = jm.num_node, ts.cfg.physics, ts.cfg.time
    tlat.residual_volume(ts.lctx, twa.T.contiguous(), tdwa.T.contiguous(), phys, scheme,
                         torch.as_tensor(src))
    tlat.jacobian_volume(ts.lctx, twa.T.contiguous(), phys, scheme, torch.ones((18, n),
                         dtype=torch.float64), torch.zeros((18, n), dtype=torch.float64))
    ek.lhs_rows_call(torch.as_tensor(_lhs33(8, 9)), phys, scheme, scalar_implicit=True)
    _, tm, _, tsp, wa, _, _ = delaunay
    ctx = tasm.build_context(tm, tsp, device="cpu")
    ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, torch.as_tensor(wa.T.copy()), phys, scheme,
                     metric=ctx.res_geom[13:19])
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize(
    "argv",
    [["--scenario", "melt-pool", "--steps", "2"],
     ["--scenario", "melt-pool", "--steps", "1", "--fixed-newton", "2"],
     ["--scenario", "cavity", "--steps", "1"]],
    ids=["melt-pool", "melt-pool-fixed-newton", "cavity"],
)
def test_cli_scenarios(capsys, tmp_path, argv):
    """One JSON line a step; the laser heats the melt pool (t_max > 0) and
    the cavity's lid drives a flow (Krylov iterations, nonzero norms)."""
    assert tmain.main(["--box", "4", "3", "3", "--device", "cpu", "--out", str(tmp_path),
                       *argv]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(recs) == int(argv[argv.index("--steps") + 1])
    for rec in recs:
        assert rec["scenario"] == argv[1] and rec["fastpath"] == "lattice"
        assert np.isfinite(rec["t_max"])
    if argv[1] == "melt-pool":
        assert all(r["t_max"] > 0 for r in recs)
        assert recs[-1]["t_max"] >= recs[0]["t_max"]
    else:
        assert recs[0]["t_max"] == 0.0
    if "--fixed-newton" not in argv:
        assert all(sum(r["krylov_iters"]) > 0 and np.isfinite(r["field_norms"]).all() for r in recs)
