"""dedflow_tpu_torch translation-class tier and recovered lattices == the JAX
package (float64 unless said otherwise).

Meshes from the port's generators of converted-mesh variants
(mesh.gen.deformed_mesh, shuffled_mesh, l_shaped_mesh: the meshes of the
JAX package's tests/test_classes.py and tests/test_recover.py), small, and
given to both packages; inputs made with numpy from a seed. Relative error
= max|port - jax| / max|jax|.

- (a) box_mesh(4, 3, 3) deformed, metadata stripped: the classes tier, 6
  classes; (b) box_mesh(4, 3, 3) shuffled and mirrored, then
  recover_lattice: the lattice tier with a non-Kuhn `lattice_tets`; (c) an
  L-shaped part of box_mesh(4, 4, 3) (cells removed, nodes kept), with the
  reference scenario's BCs on the sides that remain and every component of
  the nodes no element touches held: the classes tier with whole regions
  of dead lanes; (d) box_mesh(4, 3, 3) with two mirrored tets more in every
  cell (torch_meshes.overlaid_mesh, a kernel stress input that is not a
  conforming mesh): 8 classes and 21 DIA planes, the widest tables the
  tier takes.
- The contexts (geometry, mult, offsets, plane table): 1e-12 / equal.
- F and the dense J against JAX's XLA route: 1e-12.
- The plain K1 / K2 (the CPU route and the twins of K1c / K2c) against
  the JAX fused kernels in interpret mode on a class context: 2e-5 (f32).
- K3's plain version and fsbsr.shifted on 27 DIA planes against JAX's DIA
  product: 1e-12 / exact.
- step and step_fixed(2) on (a), (b), (c), (d), the melt pool on (a) and
  pc="mg" on (a), against the JAX solver's jitted Newton iteration driven by
  its step's loop: 1e-9, equal Newton and Krylov counts.
Detection, recovery, the tier choice, HDF5 files and the CLI's --mesh are
tests/test_torch_mesh_io.py's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.fem import lattice as jlat
from dedflow_tpu.fem import ns
from dedflow_tpu.mesh.mesh import Boundary, Mesh
from dedflow_tpu.mesh.recover import recover_lattice as jrecover
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.sparse.fsbsr import diag_add_rows as j_diag_add_rows
from dedflow_tpu.sparse.fsbsr import keep_pc_rows as j_keep_pc_rows
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import mesh as tmesh_mod
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
from torch_meshes import overlaid_mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


def _port_mesh(m: Mesh) -> tmesh_mod.Mesh:
    """The port's copy of a JAX mesh (the same arrays)."""
    tets = getattr(m, "lattice_tets", None)
    return tmesh_mod.Mesh(
        xg=np.asarray(m.xg).copy(), ien=np.asarray(m.ien).copy(),
        boundaries=[tmesh_mod.Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                    for b in m.boundaries],
        lattice=m.lattice, lattice_tets=None if tets is None else np.asarray(tets).copy(),
    )


def _jax_mesh(m: tmesh_mod.Mesh) -> Mesh:
    """The JAX package's copy of a port mesh (the same arrays)."""
    return Mesh(
        xg=m.xg.copy(), ien=m.ien.copy(),
        boundaries=[Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                    for b in m.boundaries],
        lattice=m.lattice, lattice_tets=None if m.lattice_tets is None else m.lattice_tets.copy(),
        ien_prism=m.ien_prism, ien_hex=m.ien_hex,
    )


REF = jsc.reference_scenario_config()
# the L-shaped mesh's configuration: the reference BCs on the box's sides
# that remain, every component of the nodes no element touches held
# (mesh.gen.l_shaped_mesh's group 7)
L_CFG = dataclasses.replace(
    REF, bcs=REF.bcs + (jcfg.BCSpec(7, strong_components=(0, 1, 2, 3, 4, 5)),))
MESHES = {
    "a": lambda: _jax_mesh(tgen.deformed_mesh(tgen.box_mesh(4, 3, 3))),
    "b": lambda: jrecover(_jax_mesh(
        tgen.shuffled_mesh(tgen.box_mesh(4, 3, 3), seed=1, mirror=True)))[0],
    "c": lambda: _jax_mesh(tgen.l_shaped_mesh(4, 4, 3)),
    "d": lambda: _jax_mesh(overlaid_mesh(4, 3, 3)),
}
TIER = {"a": "classes", "b": "lattice", "c": "classes", "d": "classes"}
CASES = {  # name: (mesh, config)
    "a": ("a", REF),
    "b": ("b", REF),
    "c": ("c", L_CFG),
    "d": ("d", REF),
    "melt-a": ("a", jsc.melt_pool_scenario_config()),
    "mg-a": ("a", dataclasses.replace(REF, krylov=dataclasses.replace(REF.krylov, pc="mg"))),
}


@pytest.fixture(scope="module")
def meshes():
    return {k: make() for k, make in MESHES.items()}


@pytest.fixture(scope="module")
def solvers(meshes):
    """{case: (JAX solver, port solver)}, built once for the module."""
    out = {}
    for name, (m, cfg) in CASES.items():
        js = jnt.NSSolver(meshes[m], cfg)
        ts = tnt.NSSolver(_port_mesh(meshes[m]), _tcfg(cfg), device="cpu")
        out[name] = (js, ts)
    return out


def _state(mesh, cfg, seed):
    melt = cfg.implicit_scalars
    wg, dwgold, dwg = (jsc.melt_pool_initial_state if melt else jsc.reference_initial_state)(mesh)
    rng = np.random.default_rng(seed)
    if melt:
        wg = wg + 0.1 * rng.standard_normal(wg.shape)
    return wg, dwgold, dwg + 0.1 * rng.standard_normal(dwg.shape)


def _source(mesh, cfg):
    laser = cfg.physics.laser
    return None if laser is None else jsc.laser_source(laser, np.asarray(mesh.xg), 0.01)


# ---------------------------------------------------------------------------
# contexts and assembly


@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_context_matches_jax(solvers, case):
    js, ts = solvers[case]
    assert js.fastpath == ts.fastpath == TIER[case]
    jl, tl = js.lctx, ts.lctx
    assert tl.deltas == jl.deltas and tl.offsets == jl.offsets and tl.plane_tab == jl.plane_tab
    assert (tl.dims is None) == (jl.dims is None) and tl.fused is None
    # each table places on a node grid: the one-pass K1c / K2c and K1c's workspace
    assert tl.grid is not None and tl.res_sync is not None
    if case == "d":
        assert (len(tl.deltas), len(tl.offsets)) == (8, 21)
    n, dmax = tl.num_node, jl.dmax
    np.testing.assert_array_equal(tl.mult.numpy(), np.asarray(jl.mult)[0, :n])
    jr = np.asarray(jl.res_geom)[:, :19, dmax : dmax + n]
    jh = np.asarray(jl.lhs_geom)[:, :15, dmax : dmax + n]
    assert rel(tl.res_geom.numpy(), jr) < 1e-12
    assert rel(tl.lhs_geom.numpy(), jh) < 1e-12


def _alphas(cfg, state, jdtype, tdtype):
    jw = ns.alpha_states(*(jnp.asarray(a, jdtype) for a in state), cfg.time)
    tw = alpha_states(*interop.state_from_numpy(*state, "cpu", tdtype), cfg.time)
    return jw, tw


@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_residual_and_jacobian_match_jax(meshes, solvers, case):
    """F and the dense J against the JAX solver's jitted residual and
    assembly (assemble_residual_t / assemble_jacobian_t at the alpha
    states; the residual's compile also serves jax_steps)."""
    js, ts = solvers[case]
    mesh, cfg = meshes[CASES[case][0]], CASES[case][1]
    state = _state(mesh, cfg, 4)
    twa, tdwa = _alphas(cfg, state, jnp.float64, torch.float64)[1]
    c, jstate = (js.solve_ctx, js.face_ctxs, js.mask), [jnp.asarray(a) for a in state]
    ref = js._residual(*c, *jstate, source=None)
    got = tlat.assemble_residual_t(ts.lctx, ts.face_ctxs, ts.mask_t, twa, tdwa, cfg.physics,
                                   cfg.time, True)
    assert rel(got.numpy(), ref) < 1e-12
    jref = js._assemble_system(*c, *jstate)[0].to_block_dense()
    jgot = tlat.assemble_jacobian_t(ts.lctx, ts.face_ctxs, ts.mask_t, twa, tdwa, cfg.physics,
                                    cfg.time).to_block_dense()
    assert rel(jgot, jref) < 1e-12


def test_plain_k1_k2_match_fused_interpret(meshes):
    """The L-shaped mesh (c) on a float32 class context of each package:
    the port's plain K1 (the CPU route of K1c) against the JAX t8 residual
    kernel, the plain K2 (K2c's twin) with the Dirichlet mask against the
    JAX masked Jacobian kernel, both run by the Pallas interpreter (two
    blocks of 128 lanes)."""
    mesh, cfg = meshes["c"], L_CFG
    jl = jlat.build_class_context(mesh, dtype=jnp.float32, rows_backend="pallas")
    ts = tnt.NSSolver(_port_mesh(mesh), _tcfg(cfg), device="cpu", dtype=torch.float32)
    tl = ts.lctx
    assert len(tl.deltas) == 6 and tl.fused is None
    (wa, dwa), (twa, tdwa) = _alphas(cfg, _state(mesh, cfg, 5), jnp.float32, torch.float32)
    n = mesh.num_node
    ref = jlat.residual_fused(jl, wa.T, dwa.T, None, cfg.physics, cfg.time, interpret=True,
                              block=128)
    got = tlat.residual_volume(tl, twa.T.contiguous(), tdwa.T.contiguous(), cfg.physics, cfg.time)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), np.asarray(ref)[:, :n]) < 2e-5
    js = jnt.NSSolver(mesh, cfg)
    keep, add = j_keep_pc_rows(js.mask.T, jnp.float32), j_diag_add_rows(js.mask.T, jnp.float32)
    jref = jlat.jacobian_fused(jl, wa.T, cfg.physics, cfg.time, interpret=True, block=128,
                               keep16=keep[:16], add16=add[:16])
    tk, ta = keep_pc_rows(ts.mask_t, torch.float32), diag_add_rows(ts.mask_t, torch.float32)
    jgot = tlat.jacobian_volume(tl, twa.T.contiguous(), cfg.physics, cfg.time,
                                tk[:16].contiguous(), ta[:16].contiguous())
    assert rel(jgot.numpy(), np.asarray(jref)[..., :n]) < 2e-5


# ---------------------------------------------------------------------------
# steps


def jax_steps(js, state, source=None, num_newton=2):
    """The JAX package's step and step_fixed(num_newton) on `state`, from
    the solver's own jitted pieces so that one compile of its Newton
    iteration serves both (tests/test_torch_preconditioners.py::jax_steps,
    with the heat source). Returns ((wgold, dwgold, dwg), krylov_iters,
    converged) of the adaptive step and the three states of the fixed
    one."""
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    src = None if source is None else jnp.asarray(source)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    newton = js.cfg.newton

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d, source=src)
        rnorm0 = js._norms(f) + 1e-16
        kits, conv = [], False
        for _ in range(num):
            d, f, rn, kit, _ = js._newton_iter(*c, wg, dwo, d, f, source=src)
            kits.append(int(kit))
            conv = bool(jnp.all((rn < newton.rtol * rnorm0) | (rn < newton.atol)))
            if adaptive and conv:
                break
        return (*js._update(wg, dwo, d), d), kits, conv

    return run(newton.max_iter, True), run(num_newton, False)[0]


@pytest.mark.parametrize("case", list(CASES))
def test_step_and_step_fixed_match_jax(meshes, solvers, case):
    js, ts = solvers[case]
    mesh, cfg = meshes[CASES[case][0]], CASES[case][1]
    assert ts.fastpath == js.fastpath == TIER[CASES[case][0]]
    state, src = _state(mesh, cfg, 3), _source(mesh, cfg)
    (ref, kits, conv), ref2 = jax_steps(js, state, src)
    tstate = interop.state_from_numpy(*state, device="cpu")
    tsrc = None if src is None else torch.as_tensor(src)
    *got, tstats = ts.step(*tstate, source=tsrc)
    got2 = ts.step_fixed(*tstate, num_newton=2, source=tsrc)
    for g, r in zip(got + list(got2), list(ref) + list(ref2)):
        assert rel(g.numpy(), r) < 1e-9
    assert tstats.krylov_iters == kits and tstats.converged == conv


def test_cpu_tensors_count_no_class_kernel_launch(solvers):
    """On CPU tensors the class entries run their plain versions and count
    nothing; the residual and Jacobian of a class context reach them (and
    never the fused K1 / K2, whose tables a class context does not have)."""
    _, ts = solvers["a"]
    counters = (tlat.residual_volume_classes, tlat.jacobian_volume_classes,
                tlat.residual_volume, tlat.jacobian_volume)
    before = [c.launches for c in counters]
    n = ts.lctx.num_node
    z = torch.zeros((6, n), dtype=torch.float64)
    phys, scheme = ts.cfg.physics, ts.cfg.time
    f = tlat.residual_volume_classes(ts.lctx, z, z, phys, scheme)
    j = tlat.jacobian_volume_classes(ts.lctx, z, phys, scheme, torch.ones((16, n), dtype=z.dtype),
                                     torch.zeros((16, n), dtype=z.dtype))
    assert f.shape == (6, n) and j.shape == (len(ts.lctx.offsets), 16, n)
    assert [c.launches for c in counters] == before


def test_dia_products_past_sixteen_planes_match_jax():
    """K3's plain version and fsbsr.shifted on 27 planes (every corner
    difference of a lattice cell; a class table of up to 8 slabs reaches
    97) against the JAX package's XLA DIA product: 1e-12."""
    from dedflow_tpu.sparse.fsbsr import FSDIAMatrixT as JDIA
    from dedflow_tpu_torch.sparse import dia_kernels, fsbsr

    sy, sz = 5, 20
    offs = tuple(sorted(dx + sy * dy + sz * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)))
    n = 5 * 4 * 6
    rng = np.random.default_rng(31)
    data, scal, x = (rng.standard_normal(shape) for shape in ((27, 16, n), (54, n), (6, n)))
    ref = JDIA(data=jnp.asarray(data), scal=jnp.asarray(scal), offsets=offs).matvec_t(
        jnp.asarray(x))
    t = torch.as_tensor
    got = dia_kernels.dia_matvec(t(data), t(scal), t(x), offs)
    assert rel(got.numpy(), ref) < 1e-12
    xs = fsbsr.shifted(t(x), offs)
    for k, o in enumerate(offs):
        want = np.zeros((6, n))
        lo, hi = max(0, -o), min(n, n - o)
        want[:, lo:hi] = x[:, lo + o : hi + o]
        np.testing.assert_array_equal(xs[:, k].numpy(), want)
