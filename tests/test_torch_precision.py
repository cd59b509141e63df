"""dedflow_tpu_torch linear-solve precision (krylov.precision "f64" and
"ir", solver.refine) and the float64 modes of K3 and K7 == the JAX package.

Meshes: box_mesh(4, 3, 3) (the reference scenario, lattice tier) and
delaunay_mesh(300, seed=5) (a random ELL matrix on its pattern). Inputs are
made with numpy from a seed. Relative error = max|port - jax| / max|jax|.

- The float64 products of K3 and K7 on CPU tensors (their plain twins,
  counting no launch) against the JAX package's float64 products: 1e-12.
- gmres_ir_device and gmres_ir on the port's assembled system (float64
  operator, float32 operator and field-split preconditioner inside)
  against the JAX package's refinement on the same arrays: equal cycle and
  inner-iteration counts, both at a relative residual <= 1e-10, solutions
  within 1e-8 of each other (each solve is accurate to about cond(J) x
  1e-10).
- Steps from a float32 state with precision "f64" (rtol 1e-10) and "ir":
  NSSolver.step and step_fixed(num_newton=2) against the JAX solver's
  jitted Newton iteration driven by its step's loop, equal Newton and
  Krylov counts, every linear solve at <= 1e-10; the float32 states agree
  to 1e-5 (their assembly is float32 in both packages, in other sum
  orders). The refinement's inner solves stop at 1e-5 there (the test's
  docstring says why).
- The CLI's --precision ir runs a float32 state without --dtype, as the
  JAX CLI does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem.assembly import build_context as jbuild_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.solver import refine as jref
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JPC
from dedflow_tpu.sparse import topology as jtop
from dedflow_tpu.sparse.fsbsr import FSBSRMatrix
from dedflow_tpu.sparse.fsbsr import FSDIAMatrixT as JDIA
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.solver import refine as tref
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT as TPC
from dedflow_tpu_torch.sparse import topology as ttop
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_f64
from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_f64
from dedflow_tpu_torch.sparse.winell import WinELLMatrixT, build_winell_plan
from dedflow_tpu_torch.utils.dtypes import cast_floats


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


def _perturbed(mesh, seed):
    wg, dwgold, dwg = reference_initial_state(mesh)
    return wg, dwgold, dwg + 0.1 * np.random.default_rng(seed).standard_normal(dwg.shape)


@pytest.fixture(scope="module")
def system():
    """The port's masked lattice J and F at a perturbed state of
    box_mesh(4, 3, 3), float64."""
    ts = tnt.NSSolver(tgen.box_mesh(4, 3, 3), _tcfg(reference_scenario_config()), device="cpu")
    state = interop.state_from_numpy(*_perturbed(box_mesh(4, 3, 3), 5), device="cpu")
    wa, dwa = alpha_states(*state, ts.cfg.time)
    args = (ts.lctx, ts.face_ctxs, ts.mask_t, wa, dwa, ts.cfg.physics, ts.cfg.time)
    return tlat.assemble_jacobian_t(*args), tlat.assemble_residual_t(*args)


def test_f64_products_on_cpu_tensors_match_jax(system):
    jm, _ = system
    x = np.random.default_rng(1).standard_normal((6, jm.num_rows))
    jj = JDIA(data=jnp.asarray(jm.data.numpy()), scal=jnp.asarray(jm.scal.numpy()),
              offsets=jm.offsets)
    before = (dia_matvec.launches, dia_matvec_f64.launches)
    got = dia_matvec(jm.data, jm.scal, torch.tensor(x), jm.offsets)
    assert rel(got.numpy(), jj.matvec_t(jnp.asarray(x))) < 1e-12
    assert (dia_matvec.launches, dia_matvec_f64.launches) == before

    jmesh, tmesh = delaunay_mesh(300, seed=5), tgen.delaunay_mesh(300, seed=5)
    jctx = jbuild_context(jmesh, jtop.build_sparsity(np.asarray(jmesh.ien), jmesh.num_node,
                                                     native=False))
    tsp = ttop.build_sparsity(tmesh.ien, tmesh.num_node)
    rng = np.random.default_rng(2)
    data = rng.standard_normal((tmesh.num_node, tsp.max_row, 18)) * tsp.ell_tables()[2][..., None]
    jmat = FSBSRMatrix(data=jnp.asarray(data), ell_col=jctx.ell_col, diag_slot=jctx.diag_slot)
    plan = build_winell_plan(tsp.row_ptr, tsp.col_ind, tmesh.num_node, device="cpu")
    tmat = interop.fsbsr_from_numpy(data, tsp, plan, dtype=torch.float64)
    x = rng.standard_normal((6, tmesh.num_node))
    before = (winell_matvec.launches, winell_matvec_f64.launches)
    for fn in (winell_matvec, winell_matvec_f64):
        assert rel(fn(tmat, torch.tensor(x)).numpy(), jmat.matvec(jnp.asarray(x.T)).T) < 1e-12
    assert (winell_matvec.launches, winell_matvec_f64.launches) == before


def test_cast_operator_keeps_the_matrix_and_its_plan(system):
    jm, _ = system
    m32 = cast_floats(jm, torch.float32)
    assert type(m32) is type(jm) and m32.offsets == jm.offsets
    assert m32.data.dtype == m32.scal.dtype == torch.float32
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    w = cast_floats(WinELLMatrixT(torch.ones((18, 2)), plan), torch.float64)
    assert w.vals.dtype == torch.float64 and w.plan.col_t is plan.col_t


@pytest.fixture(scope="module")
def refined(system):
    """Both packages' refinement of J dx = F: float64 operator, float32
    operator and float32 field-split preconditioner inside."""
    jm, f = system
    m32 = cast_floats(jm, torch.float32)
    pc32 = TPC.from_diag_rows(m32.diag_rows())
    jj64 = JDIA(data=jnp.asarray(jm.data.numpy()), scal=jnp.asarray(jm.scal.numpy()),
                offsets=jm.offsets)
    jj32 = JDIA(data=jj64.data.astype(jnp.float32), scal=jj64.scal.astype(jnp.float32),
                offsets=jm.offsets)
    jpc32 = JPC.from_diag_rows(jj32.diag_rows())
    b = f.numpy()
    kw = dict(tol=1e-10, max_cycles=10, inner_maxit=120, inner_rtol=1e-6)
    got = tref.gmres_ir_device(jm.matvec_t, m32.matvec_t, f, pc=pc32, **kw)
    ref = jax.jit(lambda b: jref.gmres_ir_device(jj64.matvec_t, jj32.matvec_t, b, pc=jpc32,
                                                 **kw))(jnp.asarray(b))
    got_h = tref.gmres_ir(jm.matvec_t, m32.matvec_t, f, pc=pc32, **kw)
    ref_h = jref.gmres_ir(jj64.matvec_t, jax.jit(jj32.matvec_t), jnp.asarray(b), pc=jpc32, **kw)
    return got, ref, got_h, ref_h


def test_refinement_matches_jax(refined):
    got, ref, got_h, ref_h = refined
    assert got.cycles == int(ref.cycles) >= 2
    assert got.inner_iters == int(ref.inner_iters)
    assert float(got.rel_residual) <= 1e-10 and float(ref.rel_residual) <= 1e-10
    assert rel(got.x.numpy(), ref.x) < 1e-8
    assert got.x.dtype == torch.float64


def test_host_stepped_refinement_matches_jax(refined):
    got, _, got_h, ref_h = refined
    assert got_h.cycles == ref_h.cycles and got_h.inner_iters == ref_h.inner_iters
    assert got_h.rel_residual <= 1e-10 and ref_h.rel_residual <= 1e-10
    assert rel(got_h.x.numpy(), ref_h.x) < 1e-8
    assert rel(got_h.x.numpy(), got.x.numpy()) < 1e-8


def jax_steps(js, state, num_newton=2):
    """The JAX package's step and step_fixed(num_newton) on `state`, run
    from the solver's own jitted pieces so that one compile of its Newton
    iteration serves both (newton.py:437-510): ((wgold, dwgold, dwg),
    krylov_iters, linear_rels, converged) of the adaptive step and the
    fixed step's states."""
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    newton = js.cfg.newton

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d)
        rnorm0 = js._norms(f) + 1e-16
        kits, lrels, conv = [], [], False
        for _ in range(num):
            d, f, rn, kit, lrel = js._newton_iter(*c, wg, dwo, d, f)
            kits.append(int(kit))
            lrels.append(float(lrel))
            conv = bool(jnp.all((rn < newton.rtol * rnorm0) | (rn < newton.atol)))
            if adaptive and conv:
                break
        return (*js._update(wg, dwo, d), d), kits, lrels, conv

    return run(newton.max_iter, True), run(num_newton, False)[0]


@pytest.mark.parametrize("precision,rtol", [("f64", 1e-10), ("ir", 1e-4)], ids=["f64", "ir"])
def test_step_from_f32_state_matches_jax(precision, rtol):
    """The inner float32 solves stop at ir_inner_rtol 1e-5: at the default
    1e-6 a float32 GMRES on the second Newton iteration's small residual
    stalls near its roundoff floor, and whether it ends at 15 iterations or
    at its cap of 120 then depends on the last bit of each sum (observed:
    30 against 135 inner iterations, both at <= 1e-10)."""
    cfg = reference_scenario_config()
    cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(
        cfg.krylov, pc="simple", precision=precision, rtol=rtol, ir_inner_rtol=1e-5))
    js = jnt.NSSolver(box_mesh(4, 3, 3), cfg, dtype=jnp.float32)
    ts = tnt.NSSolver(tgen.box_mesh(4, 3, 3), _tcfg(cfg), device="cpu", dtype=torch.float32)
    state = _perturbed(box_mesh(4, 3, 3), 6)
    (ref, kits, lrels, conv), ref2 = jax_steps(js, [a.astype(np.float32) for a in state])
    tstate = interop.state_from_numpy(*state, device="cpu", dtype=torch.float32)
    *got, tstats = ts.step(*tstate)
    got2 = ts.step_fixed(*tstate, num_newton=2)
    for g, r in zip(got + list(got2), list(ref) + list(ref2)):
        assert g.dtype == torch.float32 and rel(g.numpy(), r) < 1e-5
    assert tstats.krylov_iters == kits and tstats.converged == conv
    assert max(tstats.linear_rels) <= 1e-10 and max(lrels) <= 1e-10


def test_cli_precision_ir_runs_a_float32_state(monkeypatch, capsys, tmp_path):
    seen = []

    class Recorder(tnt.NSSolver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append((self.dtype, self.cfg.krylov.precision))

    monkeypatch.setattr(tmain, "NSSolver", Recorder)
    assert tmain.main(["--box", "3", "2", "2", "--steps", "1", "--device", "cpu",
                       "--precision", "ir", "--out", str(tmp_path)]) == 0
    assert seen == [(torch.float32, "ir")]
    assert '"fastpath": "lattice"' in capsys.readouterr().out
