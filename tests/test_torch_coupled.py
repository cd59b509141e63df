"""dedflow_tpu_torch FEM-DEM coupling and coupled step == the JAX package's (CPU, float64).

- coupling on box_mesh(4, 4, 4) and on a small RCM-ordered Delaunay mesh:
  `element_grid` equal, `locate` / `locate_lattice` elements equal and
  barycentric weights at 1e-12, `interpolate`, `drag_exchange` and
  `drag_exchange_lattice` forces at 1e-12; the lattice locator finds the
  general locator's elements (box_mesh's cell-major element order); the
  reaction conserves momentum (tests/test_dem.py:161-172);
- the locator on any lattice mesh: box_mesh(4, 4, 4) shuffled (with and
  without `mirror`) and recovered by recover_lattice, where CoupledSolver
  finds every interior point and its drag and reaction equal the
  generated box's at 1e-12 (the reaction under the node map); the same
  shuffled mesh without a lattice against the JAX CoupledSolver's element
  grid at 1e-12; on the generated box the table route is bit-equal to
  box_mesh's cell * 6 + t (the JAX package's locator, which finds only
  that order);
- the fluid with a load: `residual(..., nodal_force=)` on the lattice tier
  (the slice's box 4x3x3, Nitsche wall) and on the WinELL tier (converted
  box 5, held to the JAX gather solver) at 1e-12;
- the slice: `CoupledSolver.step` on box_mesh(4, 3, 3) with the
  20-particle configuration of tests/test_dem.py:190-203 (cell capacity
  3), for use_grid
  True and False (adaptive step) and `step(num_newton=2)`: fluid and
  particle states at 1e-9 with equal Newton and Krylov counts, against
  the JAX CoupledSolver.step's parts driven from its jitted pieces (one
  compile of its Newton iteration serves every case);
- the CLI's coupled scenario.

torch runs with one intra-op thread here (see tests/test_torch_dem.py).
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.coupled import CoupledConfig as JCoupledConfig
from dedflow_tpu.app.coupled import CoupledSolver as JCoupledSolver
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.dem import coupling as jcoup
from dedflow_tpu.dem.cells import cell_stats, make_grid
from dedflow_tpu.dem.contact import ContactParams
from dedflow_tpu.dem.integrate import DEMConfig
from dedflow_tpu.dem.particles import particle_state
from dedflow_tpu.fem.assembly import build_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.mesh.mesh import Boundary, Mesh
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app.coupled import CoupledSolver as TCoupledSolver
from dedflow_tpu_torch.dem import coupling as tcoup
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import reorder as treo
from dedflow_tpu_torch.mesh.recover import recover_lattice as trecover
from dedflow_tpu_torch.solver import newton as tnt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def tcfg_of(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


def _box4():
    return box_mesh(4, 4, 4), tgen.box_mesh(4, 4, 4)


def _delaunay():
    jm = delaunay_mesh(300, seed=5)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = tgen.delaunay_mesh(300, seed=5)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    return jm, tm


@pytest.fixture(scope="module", params=["box4", "delaunay"])
def meshes(request):
    """(JAX mesh, JAX FEMContext, port mesh, port CouplingGeometry), f64."""
    jm, tm = {"box4": _box4, "delaunay": _delaunay}[request.param]()
    np.testing.assert_array_equal(tm.ien, np.asarray(jm.ien))
    geom = tcoup.coupling_geometry(tm.xg, tm.ien, "cpu", torch.float64)
    return jm, build_context(jm), tm, geom


def points(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.02, 0.98, size=(n, 3)), [[2.0, 2.0, 2.0]]])


def test_locate_and_interpolate_match_jax(meshes):
    jm, ctx, tm, geom = meshes
    grid = jcoup.element_grid(jm.xg, jm.ien)
    tgrid = tcoup.element_grid(tm.xg, tm.ien)
    assert dataclasses.asdict(tgrid) == dataclasses.asdict(grid)
    x = points(60, seed=1)
    je, jb = jcoup.locate(grid, ctx, jnp.asarray(x))
    te, tb = tcoup.locate(tgrid, geom, torch.as_tensor(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[-1] == -1 and (te[:-1] >= 0).double().mean() > 0.8
    assert rel(tb, jb) < 1e-12
    field = np.random.default_rng(2).normal(size=(jm.num_node, 3))
    ref = jcoup.interpolate(ctx, je, jb, jnp.asarray(field))
    assert rel(tcoup.interpolate(geom, te, tb, torch.as_tensor(field)), ref) < 1e-12


def test_locate_lattice_matches_jax_and_the_general_locator():
    jm, tm = _box4()
    ctx = build_context(jm)
    geom = tcoup.coupling_geometry(tm.xg, tm.ien, "cpu", torch.float64)
    x = points(80, seed=3)
    args = ((4, 4, 4), np.zeros(3), np.full(3, 0.25))
    je, jb = jcoup.locate_lattice(*args, ctx, jnp.asarray(x))
    te, tb = tcoup.locate_lattice(*args, geom, torch.as_tensor(x))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert rel(tb, jb) < 1e-12
    ge, gb = tcoup.locate(tcoup.element_grid(tm.xg, tm.ien), geom, torch.as_tensor(x))
    found = ge >= 0
    np.testing.assert_array_equal(te.numpy(), ge.numpy())  # e = cell * 6 + t
    assert rel(tb[found], gb[found]) < 1e-12


def test_drag_exchange_matches_jax(meshes):
    jm, ctx, tm, geom = meshes
    rng = np.random.default_rng(4)
    x = rng.uniform(0.1, 0.9, size=(40, 3))
    v = rng.normal(scale=0.1, size=x.shape)
    r = rng.uniform(0.01, 0.02, size=40)
    w = rng.normal(size=(jm.num_node, 6))
    jst = particle_state(x, v, radius=r)
    tst = interop.particles_from_numpy(x, v, 1.0, r, device="cpu")
    grid = jcoup.element_grid(jm.xg, jm.ien)
    jf, jn = jcoup.drag_exchange(grid, ctx, jst, jnp.asarray(w), 2e-3)
    tf, tn = tcoup.drag_exchange(
        tcoup.element_grid(tm.xg, tm.ien), geom, tst, torch.as_tensor(w), 2e-3
    )
    assert rel(tf, jf) < 1e-12 and rel(tn, jn) < 1e-12
    if jm.lattice is not None:
        args = (jm.lattice, np.zeros(3), np.full(3, 0.25))
        jf, jn = jcoup.drag_exchange_lattice(*args, ctx, jst, jnp.asarray(w), 2e-3)
        tf, tn = tcoup.drag_exchange_lattice(*args, geom, tst, torch.as_tensor(w), 2e-3)
        assert rel(tf, jf) < 1e-12 and rel(tn, jn) < 1e-12


def test_drag_exchange_conserves_momentum():
    _, tm = _box4()
    geom = tcoup.coupling_geometry(tm.xg, tm.ien, "cpu", torch.float64)
    rng = np.random.default_rng(5)
    st = interop.particles_from_numpy(
        rng.uniform(0.2, 0.8, size=(25, 3)), None, 1.0, 0.01, device="cpu"
    )
    w = torch.zeros((tm.num_node, 6), dtype=torch.float64)
    w[:, 0] = 1.0  # uniform u_x = 1
    f_p, f_n = tcoup.drag_exchange(tcoup.element_grid(tm.xg, tm.ien), geom, st, w, mu=1.0e-3)
    assert (f_p[:, 0] > 0).all()  # drag pushes particles along +x
    np.testing.assert_allclose(f_n.sum(0).numpy(), -f_p.sum(0).numpy(), rtol=1e-10)


# ---------------------------------------------------------------------------
# the coupled locator on a recovered lattice (box_mesh(4, 4, 4) shuffled)


@pytest.fixture(scope="module")
def lattice_solvers():
    """Port CoupledSolvers (CPU, f64) on box_mesh(4, 4, 4) as generated,
    shuffled (seed 3) and recovered with and without `mirror`, and shuffled
    without a lattice, each with the map of the box's nodes to its own;
    the JAX CoupledSolver on the unlatticed mesh."""
    cfg = reference_scenario_config()
    jccfg = JCoupledConfig(dem=dem_cfg(), drag_mu=2e-3, substeps=1)
    tccfg = interop.coupled_config_from_dict(dataclasses.asdict(jccfg))
    box = tgen.box_mesh(4, 4, 4)
    rp = np.random.RandomState(3).permutation(box.num_node)  # shuffled_mesh's node map
    meshes = {"box": (box, np.arange(box.num_node))}
    for mirror in (False, True):
        rec, perm = trecover(tgen.shuffled_mesh(box, seed=3, mirror=mirror))
        meshes[f"recovered{'_mirror' * mirror}"] = (rec, perm[rp])
    shuf = tgen.shuffled_mesh(box, seed=3)
    meshes["shuffled"] = (shuf, rp)
    out = {k: (TCoupledSolver(m, tcfg_of(cfg), tccfg, device="cpu"), node_map)
           for k, (m, node_map) in meshes.items()}
    jshuf = Mesh(xg=shuf.xg.copy(), ien=shuf.ien.copy(),
                 boundaries=[Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                             for b in shuf.boundaries])
    return out, JCoupledSolver(jshuf, cfg, jccfg)


def _particles(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.02, 0.98, size=(n, 3))
    return x, rng.normal(scale=0.1, size=x.shape), rng.uniform(0.01, 0.02, size=n)


@pytest.mark.parametrize("name", ["recovered", "recovered_mirror"])
def test_coupled_locator_on_a_recovered_lattice(lattice_solvers, name):
    """Every one of 200 interior points located on the recovered mesh (file
    element order, cells numbered x-fastest); the drag at 1e-12 of the
    generated box's at the same (for `mirror`, the reflected) points, and
    the reaction equal under the node map."""
    solvers, _ = lattice_solvers
    (box, _), (ts, node_map) = solvers["box"], solvers[name]
    assert ts.fluid.mesh.lattice == (4, 4, 4) and ts.grid is None
    x, v, r = _particles(200, seed=7)
    elem, _ = ts._locate(torch.as_tensor(x))
    assert bool((elem >= 0).all())
    xb = x.copy()
    if name.endswith("mirror"):
        xb[:, 0] = 1.0 - xb[:, 0]
    w = np.random.default_rng(8).normal(size=(box.fluid.mesh.num_node, 6))
    wr = np.empty_like(w)
    wr[node_map] = w
    f_box, n_box = box.drag(torch.as_tensor(w),
                            interop.particles_from_numpy(xb, v, 1.0, r, device="cpu"))
    f_rec, n_rec = ts.drag(torch.as_tensor(wr),
                           interop.particles_from_numpy(x, v, 1.0, r, device="cpu"))
    assert rel(f_rec, f_box) < 1e-12
    assert rel(n_rec[node_map], n_box) < 1e-12


def test_coupled_element_grid_matches_jax_without_a_lattice(lattice_solvers):
    """The shuffled mesh without a lattice: the element grid's locator, the
    drag and the reaction at 1e-12 of the JAX CoupledSolver's."""
    solvers, js = lattice_solvers
    ts, _ = solvers["shuffled"]
    assert ts.fluid.mesh.lattice is None and js._lattice is None
    x, v, r = _particles(200, seed=9)
    w = np.random.default_rng(10).normal(size=(ts.fluid.mesh.num_node, 6))
    jf, jn = jcoup.drag_exchange(js.grid, js._coupling_ctx, particle_state(x, v, radius=r),
                                 jnp.asarray(w), js.ccfg.drag_mu)
    tf, tn = ts.drag(torch.as_tensor(w), interop.particles_from_numpy(x, v, 1.0, r, device="cpu"))
    assert rel(tf, jf) < 1e-12 and rel(tn, jn) < 1e-12


def test_coupled_locator_table_is_cell_major_on_the_generated_box(lattice_solvers):
    """On box_mesh the cells table is cell * 6 + t and the locator's
    elements and weights equal the table-free route's bit for bit."""
    solvers, _ = lattice_solvers
    ts, _ = solvers["box"]
    assert torch.equal(ts._lat_cells, torch.arange(64 * 6).reshape(64, 6))
    x = torch.as_tensor(points(200, seed=11))
    te, tb = ts._locate(x)
    oe, ob = tcoup.locate_lattice(ts._lattice, ts._lat_origin, ts._lat_spacing, ts.geom, x)
    assert torch.equal(te, oe) and torch.equal(tb, ob)


def test_lattice_cells_raises_on_a_wrong_count():
    box = tgen.box_mesh(2, 2, 2)
    with pytest.raises(ValueError, match="not 5 each"):
        tcoup.lattice_cells((2, 2, 2), np.zeros(3), np.full(3, 0.5), box.xg, box.ien, 5)
    with pytest.raises(ValueError, match="off the uniform"):
        tcoup.lattice_cells((2, 2, 2), np.zeros(3), np.full(3, 0.4), box.xg, box.ien, 6)


# ---------------------------------------------------------------------------
# the slice (box_mesh(4, 3, 3), reference scenario) and the fluid with a load


def dem_cfg():
    """tests/test_dem.py:196-203, with cell capacity 3 in place of 8: the
    fullest cell of the cloud holds 2, and the JAX compile of the
    27 x K-slot sweep grows with K."""
    return DEMConfig(
        grid=make_grid([0, 0, 0], [1, 1, 1], cell_size=0.1, capacity=3),
        contact=ContactParams(k_n=1e3, gamma_n=1.0),
        gravity=(0.0, 0.0, 0.0),
        dt=1e-3,
        walls_lo=(0.0, 0.0, 0.0),
        walls_hi=(1.0, 1.0, 1.0),
    )


@pytest.fixture(scope="module")
def coupled():
    """The JAX CoupledSolver and the port's (CPU, f64) on box_mesh(4, 3, 3)
    with the 20-particle cloud of tests/test_dem.py:190-203 (grid path;
    `with_grid` gives the candidate-list twins), and the initial states.
    One JAX solver serves every test here, so its step compiles once."""
    mesh, tmesh = box_mesh(4, 3, 3), tgen.box_mesh(4, 3, 3)
    cfg = reference_scenario_config()
    x = np.random.default_rng(0).uniform(0.3, 0.7, size=(20, 3))
    assert cell_stats(dem_cfg().grid, x)["max_per_cell"] <= 2
    jccfg = JCoupledConfig(dem=dem_cfg(), drag_mu=5.0, substeps=10, use_grid=True)
    js = JCoupledSolver(mesh, cfg, jccfg)
    ts = TCoupledSolver(
        tmesh, tcfg_of(cfg), interop.coupled_config_from_dict(dataclasses.asdict(jccfg)),
        device="cpu",
    )
    return js, ts, x, reference_initial_state(mesh)


def with_grid(solver, use_grid):
    other = copy.copy(solver)
    other.ccfg = dataclasses.replace(solver.ccfg, use_grid=use_grid)
    return other


def _lattice_solvers(coupled):
    js, ts, _, _ = coupled
    return js.fluid, ts.fluid


def _winell_solvers(coupled):
    cfg = reference_scenario_config()
    jm = dataclasses.replace(box_mesh(5, 5, 5), lattice=None)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = dataclasses.replace(tgen.box_mesh(5, 5, 5), lattice=None)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    js = jnt.NSSolver(jm, dataclasses.replace(cfg, use_lattice="gather"))
    ts = tnt.NSSolver(tm, tcfg_of(dataclasses.replace(cfg, use_lattice="winell")), device="cpu")
    assert ts.fastpath == "winell" and ts.face_ctxs
    return js, ts


@pytest.mark.parametrize("make", [_lattice_solvers, _winell_solvers], ids=["lattice", "winell"])
def test_residual_with_nodal_force_matches_jax(coupled, make):
    js, ts = make(coupled)
    n = ts.mesh.num_node
    rng = np.random.default_rng(6)
    states = [rng.normal(size=(n, 6)) for _ in range(3)]
    load = rng.normal(size=(n, 3))
    tcommon = dict(phys=ts.cfg.physics, scheme=ts.cfg.time, freeze=ts.cfg.freeze_phi_temperature)
    jst, tst = [jnp.asarray(s) for s in states], [torch.as_tensor(s) for s in states]
    # the JAX solver's jitted residual (its configuration's physics, scheme
    # and freeze)
    f_ref = np.asarray(js._residual(js.solve_ctx, js.face_ctxs, js.mask, *jst,
                                    nodal_force=jnp.asarray(load)))
    f_ref = f_ref if f_ref.shape == (6, n) else f_ref.T
    f = tnt.residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tcommon,
                     nodal_force=torch.as_tensor(load))
    assert ts.face_ctxs and rel(f, f_ref) < 1e-12
    f0 = tnt.residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tcommon)
    # the load lands on the free momentum rows only, before freeze and mask
    free = ~ts.mask_t[:3]
    assert torch.equal((f0 - f)[:3][~free], torch.zeros_like(f[:3][~free]))
    assert rel((f0 - f)[:3][free], torch.as_tensor(load).T[free]) < 1e-12


@pytest.fixture(scope="module")
def jax_coupled_steps(coupled):
    """The JAX CoupledSolver.step's three parts on the slice
    (dedflow_tpu/app/coupled.py:110-135) from its own pieces, so that one
    compile of its Newton iteration (shared with the nodal-load residual
    test's) serves the adaptive step and step_fixed(2): the drag
    (drag_exchange_lattice on the fluid's FEMContext, jitted whole), the
    fluid's predict / residual / Newton iterations / update with the
    reaction as the nodal load (the adaptive loop stops on the JAX
    solver's own predicate, newton_adaptive's), then dem_run_grid or the
    candidate-list dem_run with the drag. Returns {(use_grid, num_newton):
    (fluid states, particles, (Krylov counts, converged) or None)}."""
    from dedflow_tpu.dem.grid import dem_run_grid as jdem_run_grid
    from dedflow_tpu.dem.integrate import dem_run as jdem_run

    js, _, x, state = coupled
    fl, ccfg = js.fluid, js.ccfg
    pst = particle_state(x, radius=0.02, mass=0.01)
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    f_p, f_nodes = jax.jit(lambda ctx, p, w: jcoup.drag_exchange_lattice(
        js._lattice, js._lat_origin, js._lat_spacing, ctx, p, w, ccfg.drag_mu))(
        js._coupling_ctx, pst, wg)
    load = f_nodes.astype(wg.dtype)
    c = (fl.solve_ctx, fl.face_ctxs, fl.mask)

    def fluid(num, adaptive):
        d = fl._predict(dwg)
        f = fl._residual(*c, wg, dwo, d, nodal_force=load)
        rnorm0 = fl._norms(f) + 1e-16
        kits, conv = [], False
        for _ in range(num):
            d, f, rn, kit, _ = fl._newton_iter(*c, wg, dwo, d, f, nodal_force=load)
            kits.append(int(kit))
            conv = bool(jnp.all((rn < fl.cfg.newton.rtol * rnorm0) | (rn < fl.cfg.newton.atol)))
            if adaptive and conv:
                break
        return (*fl._update(wg, dwo, d), d), (kits, conv)

    adaptive, fixed = fluid(fl.cfg.newton.max_iter, True), fluid(2, False)
    grid_p = jdem_run_grid(ccfg.dem, pst, ccfg.substeps, ext=f_p)
    return {(True, None): (adaptive[0], grid_p, adaptive[1]),
            (False, None): (adaptive[0], jdem_run(ccfg.dem, pst, ccfg.substeps, ext=f_p),
                            adaptive[1]),
            (True, 2): (fixed[0], grid_p, None)}


@pytest.mark.parametrize(
    "use_grid,num_newton", [(True, None), (False, None), (True, 2)],
    ids=["grid-adaptive", "candidates-adaptive", "grid-fixed2"],
)
def test_coupled_step_matches_jax(coupled, jax_coupled_steps, use_grid, num_newton):
    _, ts, x, state = coupled
    ts = with_grid(ts, use_grid)
    jfluid, jp, jstats = jax_coupled_steps[(use_grid, num_newton)]
    *tfluid, tp, tstats = ts.step(
        *interop.state_from_numpy(*state, device="cpu"),
        interop.particles_from_numpy(x, None, 0.01, 0.02, device="cpu"), num_newton=num_newton,
    )
    for name, g, r in zip(("wgold", "dwgold", "dwg"), tfluid, jfluid):
        assert rel(g, r) < 1e-9, name
    assert np.abs(np.asarray(jp.x) - x).max() > 0  # the particles moved
    for name in ("x", "v"):
        assert rel(getattr(tp, name), getattr(jp, name)) < 1e-9, name
    if num_newton is None:
        assert len(tstats.rnorms) == len(jstats[0])
        assert tstats.krylov_iters == jstats[0]
        assert tstats.converged == jstats[1]
    else:
        assert tstats is None and jstats is None


def test_cli_runs_the_coupled_scenario(capsys, tmp_path):
    rc = tmain.main(["--scenario", "coupled", "--box", "4", "3", "3", "--particles", "64",
                     "--steps", "1", "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["scenario"] == "coupled" and rec["fastpath"] == "lattice"
    assert sum(rec["krylov_iters"]) > 0 and all(np.isfinite(rec["field_norms"]))
