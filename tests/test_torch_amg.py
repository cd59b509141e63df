"""dedflow_tpu_torch algebraic multigrid on the WinELL tier (solver.amg,
pc="mg") == the JAX package (float64).

Mesh: delaunay_mesh(600, seed=5) + RCM, the plans built with
amg_min_nodes=64 (600 -> 75 -> 10 rows: three levels). Inputs are made
with numpy from a seed. Relative error = max|port - jax| / max|jax|.

- build_amg_plan and the context's plan arrays: exactly equal.
- Each level's Galerkin values and inverse diagonal, a V-cycle, and
  AMGSchurPCT's entry products and apply on the JAX package's own WinELL
  Jacobian carried over (interop.winell_from_numpy): 1e-12.
- The WinELL fallbacks (pc "simple", and "mg" without an AMG plan) warn
  with the JAX package's texts, on both packages.
- Steps: NSSolver.step and step_fixed(num_newton=2) with pc "mg" on the
  WinELL tier (NSSolver builds the AMG plan, as the JAX solver does)
  against the JAX package's AMG step in float64 (`jax_amg_steps`: its
  WinELL matrix stores float32 values, so J and F come from its float64
  gather solver on the same mesh): new states to 1e-9, equal Newton and
  Krylov counts.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem import win_assembly as jwin
from dedflow_tpu.mesh.gen import delaunay_mesh
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.solver import amg as jamg
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JFS
from dedflow_tpu.sparse.topology import build_sparsity
from dedflow_tpu.sparse.winell import COMP2WIN
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.fem import win_assembly as twin
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import reorder as treo
from dedflow_tpu_torch.solver import amg as tamg
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT as TFS
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
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


@pytest.fixture(scope="module")
def amg():
    """Both packages' WinELL contexts with AMG plans, the JAX package's
    Jacobian at a seeded state and the same matrix in the port."""
    jm = delaunay_mesh(600, seed=5)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = tgen.delaunay_mesh(600, seed=5)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    jsp = build_sparsity(np.asarray(jm.ien), jm.num_node, native=False)
    tsp = t_build_sparsity(tm.ien, tm.num_node)
    jctx = jwin.build_win_context(jm, jsp, backend="xla", with_amg=True, amg_min_nodes=64)
    tctx = twin.build_win_context(tm, tsp, device="cpu", with_amg=True, amg_min_nodes=64)
    cfg = reference_scenario_config()
    rng = np.random.default_rng(3)
    wa = rng.normal(size=(tm.num_node, 6))
    jmat = jwin.jacobian_win(jctx, jnp.asarray(wa), cfg.physics, cfg.time, backend="xla")
    # the JAX package's WinELL values are float32 (its rows 18/19 hold index
    # bits); both packages then work on the same values in float64
    jmat = dataclasses.replace(jmat, vals=jmat.vals.astype(jnp.float64))
    tmat = interop.winell_from_numpy(jmat.vals, jctx.win_plan.entry_of_nnz, tctx.win_plan,
                                     dtype=torch.float64)
    return jctx, tctx, tsp, jmat, tmat, rng.standard_normal((6, tm.num_node))


def test_amg_plan_equals_jax(amg):
    jctx, tctx, tsp, *_ = amg
    n = tsp.num_node
    rows = np.repeat(np.arange(n), np.diff(tsp.row_ptr))
    got = tamg.build_amg_plan(rows, tsp.col_ind, n, min_nodes=64)
    ref = jamg.build_amg_plan(rows, tsp.col_ind, n, min_nodes=64)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert (g.n, g.nc, g.ec) == (r.n, r.nc, r.ec)
        for name in ("col", "rowseg", "diag_mask", "f2c_perm", "f2c_tgt"):
            a, b = getattr(g, name), getattr(r, name)
            assert (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))
    idx, jidx = tctx.amg_idx, jctx.amg_idx
    assert idx.ns == jidx.ns and idx.ecs == jidx.ecs
    for li in range(len(idx.ns)):
        assert np.array_equal(idx.col[li].numpy(), np.asarray(jidx.col[li]))
        assert np.array_equal(np.diff(idx.row_off[li].numpy()),
                              np.bincount(np.asarray(jidx.rowseg[li]), minlength=idx.ns[li]))
        assert np.array_equal(idx.diag_mask[li].numpy(), np.asarray(jidx.diag_mask[li]) > 0)
    for li in range(len(idx.ecs)):
        assert np.array_equal(idx.f2c_perm[li].numpy(), np.asarray(jidx.f2c_perm[li]))
    assert np.array_equal(tctx.amg_eon.numpy(), np.arange(tsp.nnz))


def test_amg_levels_and_vcycle_match_jax(amg):
    jctx, tctx, _, jmat, tmat, x = amg
    app = tmat.vals[15]
    japp = jmat.vals[:, jctx.amg_eon][15]
    lv, jlv = tamg.build_values(tctx.amg_idx, app), jamg.build_values(jctx.amg_idx, japp)
    assert len(lv) == len(jlv) == 3
    for (v, d), (jv, jd) in zip(lv, jlv):
        assert rel(v.numpy(), jv) < 1e-12 and rel(d.numpy(), jd) < 1e-12
    r = x[3]
    assert rel(tamg.vcycle(tctx.amg_idx, lv, torch.tensor(r)).numpy(),
               jamg.vcycle(jctx.amg_idx, jlv, jnp.asarray(r))) < 1e-12


def test_amg_schur_pc_products_and_apply_match_jax(amg):
    jctx, tctx, _, jmat, tmat, x = amg
    pc = tamg.AMGSchurPCT.from_winell(tmat, tctx.amg_idx, tctx.amg_eon, outer=3)
    jpc = jamg.AMGSchurPCT.from_winell(jmat, jctx.amg_idx, jctx.amg_eon, outer=3)
    p, u = torch.tensor(x[3]), torch.tensor(x[:3])
    pp, up = pc.matvec_pp_up(p)
    assert rel(up.numpy(), jpc._matvec_up(jnp.asarray(x[3]))) < 1e-12
    assert rel(pc.matvec_pu(u).numpy(), jpc._matvec_pu(jnp.asarray(x[:3]))) < 1e-12
    assert rel(pp.numpy(), jpc._segsum(jpc.app * jnp.asarray(x[3])[jpc.idx.col[0]])) < 1e-12
    assert rel(pc(torch.tensor(x)).numpy(), jpc(jnp.asarray(x))) < 1e-12


WINELL_SIMPLE = ("krylov.pc='simple' is not available on the windowed irregular path; "
                 "using the fieldsplit (block-Jacobi) preconditioner")
WINELL_MG = ("krylov.pc='mg' is not available on the windowed irregular path without an "
             "AMG plan (build_win_context with_amg); using the fieldsplit (block-Jacobi) "
             "preconditioner")


@pytest.mark.parametrize("pc_type,text", [("simple", WINELL_SIMPLE), ("mg", WINELL_MG)],
                         ids=["simple", "mg-without-plan"])
def test_winell_fallbacks_warn_as_jax(monkeypatch, amg, pc_type, text):
    """Both packages' assemble_system on their WinELL contexts (without the
    AMG plan), the Jacobian assembly replaced by the fixture's matrix."""
    jctx, tctx, _, jmat, tmat, _ = amg
    monkeypatch.setattr(jwin, "jacobian_win", lambda *a, **k: jmat)
    monkeypatch.setattr(tnt, "jacobian_win", lambda *a, **k: tmat)
    jctx, tctx = (dataclasses.replace(c, amg_idx=None) for c in (jctx, tctx))
    n, scheme = tctx.num_node, reference_scenario_config().time
    z = np.zeros((n, 6))
    with pytest.warns(UserWarning, match=re.escape(text)):
        _, jp = jnt.assemble_system(jctx, (), jnp.zeros((n, 6), bool), *(jnp.asarray(z),) * 3,
                                    None, scheme, pc_type=pc_type)
    with pytest.warns(UserWarning, match=re.escape(text)):
        _, tp = tnt.assemble_system(tctx, (), torch.zeros((6, n), dtype=torch.bool),
                                    *(torch.tensor(z),) * 3, None, scheme, pc_type=pc_type)
    assert isinstance(jp, JFS) and isinstance(tp, TFS)


@dataclasses.dataclass
class _EntryMatrix:
    """The JAX gather tier's FSBSR Jacobian as AMGSchurPCT.from_winell reads
    a WinELL matrix: `vals` (18, nnz) in WinELL component order, CSR entry
    order, and its diagonal rows."""

    vals: jnp.ndarray
    diag_idx: np.ndarray

    def diag_rows(self):
        return self.vals[:, self.diag_idx][jnp.asarray(COMP2WIN)]


def jax_amg_steps(js, sparsity, state, num_newton=2):
    """The JAX package's WinELL step with pc "mg" (assemble_system's
    AMGSchurPCT.from_winell, then GMRES on J, newton.py:110-118, 437-510)
    in float64: the JAX package's own WinELL matrix holds float32 values, so
    J and F come from its float64 gather solver `js` on the same mesh (the
    port's WinELL assembly equals that one to 1e-12,
    tests/test_torch_win_assembly.py), the AMG plan from the CSR pattern
    with the solver's default min_nodes. Returns the adaptive step's
    ((wgold, dwgold, dwg), krylov_iters, converged) and the fixed step's
    states."""
    import jax

    from dedflow_tpu.solver.krylov import gmres

    n = sparsity.num_node
    rows = np.repeat(np.arange(n), np.diff(sparsity.row_ptr))
    idx = jamg.AMGIndices.from_plan(jamg.build_amg_plan(rows, sparsity.col_ind, n))
    eon = jnp.arange(sparsity.nnz)
    _, nnz_to_ell, _ = sparsity.ell_tables()
    kcfg, newton = js.cfg.krylov, js.cfg.newton

    @jax.jit
    def solve(jmat, pc, f):
        mv = lambda x: jmat.matvec(x.T).T
        sol = gmres(mv, f.T, maxit=kcfg.max_iter, atol=kcfg.atol, rtol=kcfg.rtol, pc=pc,
                    restart=kcfg.restart)
        return sol.x, sol.iters

    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d)
        rnorm0 = js._norms(f) + 1e-16
        kits, conv = [], False
        for _ in range(num):
            jmat, _ = js._assemble_system(*c, wg, dwo, d)
            vals = jmat.data.reshape(-1, 18)[jnp.asarray(nnz_to_ell)].T[jnp.asarray(np.argsort(COMP2WIN))]
            pc = jamg.AMGSchurPCT.from_winell(
                _EntryMatrix(vals, sparsity.diag_idx), idx, eon, outer=js.cfg.krylov.pc_mg_outer)
            dx, kit = solve(jmat, pc, f)
            d = d - dx.T
            f = js._residual(*c, wg, dwo, d)
            rn = js._norms(f)
            kits.append(int(kit))
            conv = bool(jnp.all((rn < newton.rtol * rnorm0) | (rn < newton.atol)))
            if adaptive and conv:
                break
        return (*js._update(wg, dwo, d), d), kits, conv

    return run(newton.max_iter, True), run(num_newton, False)[0]


def test_winell_mg_step_and_step_fixed_match_jax():
    jm = delaunay_mesh(600, seed=5)
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = tgen.delaunay_mesh(600, seed=5)
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, pc="mg"))
    ts = tnt.NSSolver(tm, _tcfg(cfg), device="cpu")
    assert ts.fastpath == "winell" and ts.wctx.amg_idx is not None
    js = jnt.NSSolver(jm, dataclasses.replace(
        cfg, use_lattice="gather", krylov=dataclasses.replace(cfg.krylov, pc="fieldsplit")))
    assert js.fastpath == "gather"
    wg, dwgold, dwg = reference_initial_state(jm)
    state = (wg, dwgold, dwg + 0.1 * np.random.default_rng(4).standard_normal(dwg.shape))
    (ref, kits, conv), ref2 = jax_amg_steps(js, t_build_sparsity(tm.ien, tm.num_node), state)
    tstate = interop.state_from_numpy(*state, device="cpu")
    *got, tstats = ts.step(*tstate)
    got2 = ts.step_fixed(*tstate, num_newton=2)
    for g, r in zip(got + list(got2), list(ref) + list(ref2)):
        assert rel(g.numpy(), r) < 1e-9
    assert tstats.krylov_iters == kits and tstats.converged == conv
