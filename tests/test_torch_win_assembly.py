"""dedflow_tpu_torch windowed irregular tier (fem.win_assembly, NSSolver
fastpath "winell") == the JAX package.

Meshes: delaunay_mesh(600, seed=5) + RCM (tests/test_win_assembly.py) and
the "converted" box 5 (box_mesh with lattice=None, RCM, the reference
scenario's BCs including the weak Nitsche wall). Inputs are made with
numpy from a seed. Relative error = max|port - jax| / max|jax|.

- float64 against the JAX general gather tier (fem.assembly + fem.ns, the
  oracle the JAX WinELL module is tested against; the JAX WinELL tier
  itself is float32 only): F and the dense J at 1e-12 (the same arithmetic,
  other sum orders); with facets and Dirichlet mask on the converted box
  through the solvers' residual / assemble_system; `step_fixed(2)` states
  to 1e-9, and `step` with equal Newton and Krylov counts. Both solvers
  run GMRES with the same block-Jacobi field split (the JAX gather tier's
  NSFieldSplitPC on (N, 6) vectors, the port's NSFieldSplitPCT on (6, N)),
  so the counts match.
- float32 against the JAX WinELL module (backend="xla", jac_scatter
  "ring"): F and J to 2e-5 relative, float32 roundoff of the element
  bodies and of sums in another order.
- Tier routing mirrors test_winell_auto_gate_rejects_bad_ordering.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem import ns
from dedflow_tpu.fem import win_assembly as jwin
from dedflow_tpu.fem.assembly import build_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.mesh import reorder as jreo
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.sparse.topology import build_sparsity
from dedflow_tpu_torch import config as tconfig
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app.scenarios import reference_scenario_config as treference_config
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import win_assembly as twin
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


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


@pytest.fixture(scope="module")
def delaunay():
    jm = delaunay_mesh(600, seed=5)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = tgen.delaunay_mesh(600, seed=5)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    assert np.array_equal(tm.ien, np.asarray(jm.ien)) and np.array_equal(tm.xg, jm.xg)
    assert treo.bandwidth(tm.ien) == jreo.bandwidth(np.asarray(jm.ien))
    jsp = build_sparsity(np.asarray(jm.ien), jm.num_node, native=False)
    tsp = t_build_sparsity(tm.ien, tm.num_node)
    for name in ("row_ptr", "col_ind", "elem_nnz", "diag_idx"):
        assert np.array_equal(getattr(tsp, name), getattr(jsp, name)), name
    rng = np.random.default_rng(2)
    wa, dwa = rng.normal(size=(2, tm.num_node, 6))
    return jm, tm, jsp, tsp, reference_scenario_config(), wa, dwa


def test_residual_and_jacobian_f64_match_gather_oracle(delaunay):
    jm, tm, jsp, tsp, cfg, wa, dwa = delaunay
    tc = _tcfg(cfg)
    ctx = twin.build_win_context(tm, tsp, device="cpu")
    gctx = build_context(jm, jsp)
    mask = jnp.zeros((jm.num_node, 6), bool)
    jwa, jdwa = jnp.asarray(wa), jnp.asarray(dwa)
    # the oracle's assembly jitted once each (op by op it compiles every op)
    f_ref = np.asarray(jax.jit(lambda a, b: ns.assemble_residual(
        gctx, (), mask, a, b, cfg.physics, cfg.time, freeze_phi_temperature=False))(jwa, jdwa)).T
    f = twin.residual_win(ctx, torch.as_tensor(wa), torch.as_tensor(dwa), tc.physics, tc.time)
    assert rel(f.numpy(), f_ref) < 1e-12
    j_ref = jax.jit(lambda a, b: ns.assemble_jacobian(
        gctx, (), mask, a, b, cfg.physics, cfg.time))(jwa, jdwa)
    jm_t = twin.jacobian_win(ctx, torch.as_tensor(wa), tc.physics, tc.time)
    assert rel(jm_t.to_block_dense(), j_ref.to_block_dense()) < 1e-12


def test_residual_and_jacobian_f32_match_jax_winell_xla(delaunay):
    jm, tm, jsp, tsp, cfg, wa, dwa = delaunay
    tc = _tcfg(cfg)
    wa32, dwa32 = wa.astype(np.float32), dwa.astype(np.float32)
    jctx = jwin.build_win_context(jm, jsp, jac_scatter="ring", backend="xla")
    ctx = twin.build_win_context(tm, tsp, device="cpu", dtype=torch.float32)
    f_ref = np.asarray(jwin.residual_win(
        jctx, jnp.asarray(wa32), jnp.asarray(dwa32), cfg.physics, cfg.time, backend="xla"
    ))
    f = twin.residual_win(ctx, torch.as_tensor(wa32), torch.as_tensor(dwa32), tc.physics, tc.time)
    assert f.dtype == torch.float32
    assert rel(f.numpy(), f_ref) < 2e-5
    j_ref = jwin.jacobian_win(jctx, jnp.asarray(wa32), cfg.physics, cfg.time, backend="xla")
    jt = twin.jacobian_win(ctx, torch.as_tensor(wa32), tc.physics, tc.time)
    vals_ref = np.asarray(j_ref.vals)[:18][:, jctx.win_plan.entry_of_nnz]
    assert rel(jt.vals.numpy(), vals_ref) < 2e-5


@pytest.mark.parametrize("jac_scatter", ["pull", "stream", "segment"])
def test_every_jac_scatter_option_gives_the_same_matrix(delaunay, jac_scatter):
    jm, tm, jsp, tsp, cfg, wa, dwa = delaunay
    tc = _tcfg(cfg)
    w = torch.as_tensor(wa)
    ring = twin.jacobian_win(twin.build_win_context(tm, tsp, device="cpu"), w, tc.physics, tc.time)
    other = twin.jacobian_win(
        twin.build_win_context(tm, tsp, device="cpu", jac_scatter=jac_scatter), w, tc.physics,
        tc.time,
    )
    assert torch.equal(other.vals, ring.vals)


@pytest.fixture(scope="module")
def converted():
    """box_mesh(5, 5, 5) without its lattice metadata, RCM-reordered, the
    reference scenario (weak Nitsche wall included): the JAX gather solver
    and the port's WinELL solver, both float64."""
    cfg = reference_scenario_config()
    jm = dataclasses.replace(box_mesh(5, 5, 5), lattice=None)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = dataclasses.replace(tgen.box_mesh(5, 5, 5), lattice=None)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    js = jnt.NSSolver(jm, dataclasses.replace(cfg, use_lattice="gather"))
    ts = tnt.NSSolver(tm, _tcfg(dataclasses.replace(cfg, use_lattice="winell")), device="cpu")
    assert js.fastpath == "gather" and ts.fastpath == "winell" and ts.face_ctxs
    wg, dwgold, dwg = reference_initial_state(jm)
    dwg = dwg + 0.1 * np.random.default_rng(3).standard_normal(dwg.shape)
    return js, ts, (wg, dwgold, dwg)


def test_facets_and_mask_match_gather_solver(converted):
    js, ts, state = converted
    rng = np.random.default_rng(4)
    states = [rng.normal(size=state[0].shape) for _ in range(3)]
    tcommon = dict(phys=ts.cfg.physics, scheme=ts.cfg.time)
    jst, tst = [jnp.asarray(s) for s in states], [torch.as_tensor(s) for s in states]
    # the gather solver's jitted residual and assembly (its configuration's
    # physics, scheme and freeze)
    f_ref = js._residual(js.solve_ctx, js.face_ctxs, js.mask, *jst)
    f = tnt.residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tcommon,
                     freeze=ts.cfg.freeze_phi_temperature)
    assert rel(f.numpy(), np.asarray(f_ref).T) < 1e-12
    j_ref, _ = js._assemble_system(js.solve_ctx, js.face_ctxs, js.mask, *jst)
    jmat, pc = tnt.assemble_system(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tcommon)
    assert rel(jmat.to_block_dense(), j_ref.to_block_dense()) < 1e-12
    assert torch.isfinite(pc(torch.ones((6, ts.mesh.num_node), dtype=torch.float64))).all()


def test_step_fixed_matches_gather_solver(converted):
    js, ts, state = converted
    ref = js.step_fixed(*(jnp.asarray(a) for a in state), num_newton=2)
    got = ts.step_fixed(*interop.state_from_numpy(*state, device="cpu"), num_newton=2)
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name


def test_step_matches_gather_solver(converted):
    js, ts, state = converted
    *ref, rstats = js.step(*(jnp.asarray(a) for a in state))
    *got, tstats = ts.step(*interop.state_from_numpy(*state, device="cpu"))
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name
    assert len(tstats.rnorms) == len(rstats.rnorms)
    assert tstats.krylov_iters == rstats.krylov_iters
    assert tstats.converged == rstats.converged


def _raw_delaunay():
    return tgen.delaunay_mesh(800, seed=11)


@pytest.mark.parametrize(
    "make,expect",
    [
        (_raw_delaunay, "gather"),
        (lambda: treo.reorder_mesh(_raw_delaunay(), treo.rcm_order(_raw_delaunay().ien, 800)),
         "winell"),
        (lambda: dataclasses.replace(tgen.box_mesh(4, 4, 4), lattice=None), "classes"),
        (lambda: tgen.box_mesh(4, 4, 4), "lattice"),
    ],
    ids=["raw-delaunay", "rcm-delaunay", "box-without-lattice", "box"],
)
def test_tier_routing_follows_the_jax_ladder(make, expect):
    mesh = make()
    bcs = () if mesh.boundaries == [] else reference_scenario_config().bcs
    cfg = _tcfg(dataclasses.replace(reference_scenario_config(), bcs=bcs))
    assert tnt.NSSolver(mesh, cfg, device="cpu").fastpath == expect


def test_cli_config_reaches_the_winell_tier(tmp_path, capsys):
    """--config replaces the reference scenario as a whole, so the file
    carries the reference BCs: the step then does real work (a nonzero
    residual, Krylov iterations) on the WinELL tier."""
    path = tmp_path / "cfg.json"
    tconfig.save_config(treference_config(use_lattice="winell"), str(path))
    rc = tmain.main(["--box", "3", "3", "3", "--steps", "1", "--device", "cpu",
                     "--config", str(path), "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["fastpath"] == "winell" and all(np.isfinite(rec["field_norms"]))
    assert sum(rec["krylov_iters"]) > 0 and max(rec["field_norms"]) > 0
