"""dedflow_tpu_torch SIMPLE and geometric-multigrid preconditioners, the
lagged Jacobian and the CLI's --pc == the JAX package (float64).

Meshes: box_mesh(6, 4, 4) (node grid 7 x 5 x 5) for the lattice pieces,
box_mesh(4, 3, 3) for the steps, delaunay_mesh(300, seed=5) in its
generated order for the gather tier's products. Inputs are made with numpy
from a seed. Relative error = max|port - jax| / max|jax|.

- The lattice band products (FSDIAMatrixT.matvec_up/pu/pp, SchurBandsT),
  the exact S_hat diagonal, SIMPLEPCT's apply, each level of a multigrid
  hierarchy built to 3 levels through `min_nodes` (planes, inverse
  diagonals), a V-cycle and MGSIMPLEPCT's apply: 1e-12; the hierarchy's
  offsets and dims, `decode_offsets` and `infer_dims`: exactly equal.
- The gather tier's CSR-entry products (WinELLMatrixT.matvec_up/pu/pp
  against FSBSRMatrix's on the same ELL data) and SIMPLEPC's apply: 1e-12.
- The fallbacks warn with the JAX package's texts, on both packages.
- Steps: NSSolver.step and step_fixed(num_newton=2) with pc "simple" and
  "mg" on the lattice, "simple" on the gather tier, and the lagged
  Jacobian, against the JAX solver's jitted Newton iteration driven by its
  step's loop (`jax_steps`: one compile serves both steps): new states to
  1e-9 relative, equal Newton and Krylov counts.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem.assembly import build_context as jbuild_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.solver import mg as jmg
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.solver import pc as jpc
from dedflow_tpu.sparse import topology as jtop
from dedflow_tpu.sparse.fsbsr import FSBSRMatrix
from dedflow_tpu.sparse.fsbsr import FSDIAMatrixT as JDIA
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.solver import mg as tmg
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.solver import pc as tpc
from dedflow_tpu_torch.sparse import topology as ttop
from dedflow_tpu_torch.sparse.winell import build_winell_plan


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


def _with_krylov(cfg, **kw):
    return dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, **kw))


def _perturbed(mesh, seed):
    wg, dwgold, dwg = reference_initial_state(mesh)
    return wg, dwgold, dwg + 0.1 * np.random.default_rng(seed).standard_normal(dwg.shape)


@pytest.fixture(scope="module")
def lattice():
    """The port's masked lattice Jacobian at a perturbed state (float64),
    the same arrays as the JAX package's FSDIAMatrixT, and seeded vectors."""
    mesh = tgen.box_mesh(6, 4, 4)
    ts = tnt.NSSolver(mesh, _tcfg(reference_scenario_config()), device="cpu")
    state = interop.state_from_numpy(*_perturbed(box_mesh(6, 4, 4), 1), device="cpu")
    wa, dwa = alpha_states(*state, ts.cfg.time)
    jm = tlat.assemble_jacobian_t(ts.lctx, ts.face_ctxs, ts.mask_t, wa, dwa,
                                  ts.cfg.physics, ts.cfg.time)
    jj = JDIA(data=jnp.asarray(jm.data.numpy()), scal=jnp.asarray(jm.scal.numpy()),
              offsets=jm.offsets)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, mesh.num_node))
    return ts, jm, jj, x


def test_lattice_band_products_match_jax(lattice):
    _, jm, jj, x = lattice
    p, u = x[3], x[:3]
    bands, jbands = jm.schur_bands(), jj.schur_bands()
    for got, ref in (
        (jm.matvec_up(torch.tensor(p)), jj.matvec_up(jnp.asarray(p))),
        (jm.matvec_pu(torch.tensor(u)), jj.matvec_pu(jnp.asarray(u))),
        (jm.matvec_pp(torch.tensor(p)), jj.matvec_pp(jnp.asarray(p))),
        (bands.matvec_up(torch.tensor(p)), jbands.matvec_up(jnp.asarray(p))),
        (bands.matvec_pu(torch.tensor(u)), jbands.matvec_pu(jnp.asarray(u))),
        (bands.matvec_pp(torch.tensor(p)), jbands.matvec_pp(jnp.asarray(p))),
        (bands.matvec_pp_up(torch.tensor(p))[0], jbands.matvec_pp(jnp.asarray(p))),
        (bands.matvec_pp_up(torch.tensor(p))[1], jbands.matvec_up(jnp.asarray(p))),
    ):
        assert rel(got.numpy(), ref) < 1e-12


def test_schur_diag_and_simple_apply_match_jax(lattice):
    _, jm, jj, x = lattice
    base = tpc.NSFieldSplitPCT.from_diag_rows(jm.diag_rows())
    jbase = jpc.NSFieldSplitPCT.from_diag_rows(jj.diag_rows())
    assert rel(jm.schur_diag(base.inv_vel_rows).numpy(),
               jj.schur_diag(jbase.inv_vel_rows)) < 1e-12
    got = tpc.SIMPLEPCT.from_matrix(jm, sweeps=4, omega=0.7)(torch.tensor(x))
    ref = jpc.SIMPLEPCT.from_matrix(jj, sweeps=4, omega=0.7)(jnp.asarray(x))
    assert rel(got.numpy(), ref) < 1e-12


def test_multigrid_levels_vcycle_and_apply_match_jax(lattice):
    ts, jm, jj, x = lattice
    dims = ts.lctx.dims
    assert dims == (7, 5, 5)
    bands, jbands = jm.schur_bands(), jj.schur_bands()
    levels = tmg.build_hierarchy(bands.app, jm.offsets, dims, min_nodes=8)
    jlevels = jmg.build_hierarchy(jbands.app, jj.offsets, dims, min_nodes=8)
    assert len(levels) == len(jlevels) >= 3
    for lv, jlv in zip(levels, jlevels):
        assert lv.offsets == jlv.offsets and lv.dims == jlv.dims
        assert rel(lv.planes.numpy(), jlv.planes) < 1e-12
        assert rel(lv.inv_diag.numpy(), jlv.inv_diag) < 1e-12
    r = x[3]
    assert rel(tmg.vcycle(levels, torch.tensor(r)).numpy(),
               jmg.vcycle(jlevels, jnp.asarray(r))) < 1e-12
    got = tmg.MGSIMPLEPCT.from_matrix(jm, dims, min_nodes=8)(torch.tensor(x))
    ref = jmg.MGSIMPLEPCT.from_matrix(jj, dims, min_nodes=8)(jnp.asarray(x))
    assert rel(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("box", [(6, 4, 4), (3, 5, 2), (8, 8, 8)])
def test_decode_offsets_and_infer_dims_equal_jax(box):
    offs = tlat.lattice_tables(*box)[3]
    n = (box[0] + 1) * (box[1] + 1) * (box[2] + 1)
    gx, gy = box[0] + 1, box[1] + 1
    assert tmg.decode_offsets(offs, gx, gy) == jmg.decode_offsets(offs, gx, gy)
    assert tmg.infer_dims(offs, n) == jmg.infer_dims(offs, n)
    assert tmg.infer_dims(offs, n + 1) == jmg.infer_dims(offs, n + 1)
    with pytest.raises(ValueError):
        tmg.decode_offsets((gx * gy * 2,), gx, gy)


def test_sharded_multigrid_raises_a16(lattice):
    """The sharded multigrid (A16 (d'), ported: tests/test_torch_sharded.py
    runs it on ranks) takes the rank's SlabComm; the JAX package's (device
    mesh, axis) pair raises."""
    ts, jm, _, _ = lattice
    with pytest.raises(TypeError, match="SlabComm"):
        tmg.MGSIMPLEPCT.from_matrix(jm, ts.lctx.dims, shard=(object(), "dd"))


@pytest.fixture(scope="module")
def gather_pair():
    """One random ELL field-split matrix on delaunay_mesh(300) as the JAX
    package's FSBSRMatrix and as the port's CSR-entry matrix."""
    jm = delaunay_mesh(300, seed=5)
    tm = tgen.delaunay_mesh(300, seed=5)
    jctx = jbuild_context(jm, jtop.build_sparsity(np.asarray(jm.ien), jm.num_node, native=False))
    tsp = ttop.build_sparsity(tm.ien, tm.num_node)
    _, _, ell_valid = tsp.ell_tables()
    rng = np.random.default_rng(7)
    data = rng.standard_normal((tm.num_node, tsp.max_row, 18)) * ell_valid[..., None]
    jmat = FSBSRMatrix(data=jnp.asarray(data), ell_col=jctx.ell_col, diag_slot=jctx.diag_slot)
    plan = build_winell_plan(tsp.row_ptr, tsp.col_ind, tm.num_node, device="cpu")
    tmat = interop.fsbsr_from_numpy(data, tsp, plan, dtype=torch.float64)
    x = rng.standard_normal((6, tm.num_node))
    return jmat, tmat, x


def test_gather_products_and_simple_apply_match_jax(gather_pair):
    jmat, tmat, x = gather_pair
    p, u = x[3], x[:3]
    assert rel(tmat.matvec_up(torch.tensor(p)).numpy(), jmat.matvec_up(jnp.asarray(p)).T) < 1e-12
    assert rel(tmat.matvec_pu(torch.tensor(u)).numpy(), jmat.matvec_pu(jnp.asarray(u.T))) < 1e-12
    assert rel(tmat.matvec_pp(torch.tensor(p)).numpy(), jmat.matvec_pp(jnp.asarray(p))) < 1e-12
    assert rel(tmat.diag_p().numpy(), jmat.diag_p()) == 0.0
    got = tpc.SIMPLEPC.from_matrix(tmat, sweeps=3, omega=0.6)(torch.tensor(x))
    ref = jpc.SIMPLEPC.from_matrix(jmat, sweeps=3, omega=0.6)(jnp.asarray(x.T))
    assert rel(got.numpy(), ref.T) < 1e-12


MG_GATHER = ("krylov.pc='mg' requires the lattice fast path (structured node grid); "
             "falling back to the SIMPLE preconditioner")
MG_NO_GRID = ("krylov.pc='mg' needs a structured node grid and none could be inferred "
              "from the class stencil - falling back to the SIMPLE preconditioner")


def _small_states(n):
    z = np.zeros((n, 6))
    return (z, z, z)


def test_gather_tier_mg_falls_back_to_simple_with_jax_warning(monkeypatch, gather_pair):
    """Both packages' assemble_system on the gather tier (a context of
    neither the lattice nor the WinELL kind), with the Jacobian assembly
    replaced by the gather pair's matrix."""
    jmat, tmat, _ = gather_pair
    scheme = reference_scenario_config().time
    monkeypatch.setattr(jnt.ns, "assemble_jacobian", lambda *a, **k: jmat)
    monkeypatch.setattr(tnt.ns, "assemble_jacobian", lambda *a, **k: tmat)
    n = tmat.num_node
    with pytest.warns(UserWarning, match=re.escape(MG_GATHER)):
        _, jp = jnt.assemble_system(None, (), None, *map(jnp.asarray, _small_states(n)), None,
                                    scheme, pc_type="mg")
    with pytest.warns(UserWarning, match=re.escape(MG_GATHER)):
        _, tp = tnt.assemble_system(None, (), None, *map(torch.tensor, _small_states(n)), None,
                                    scheme, pc_type="mg")
    assert isinstance(jp, jpc.SIMPLEPC) and isinstance(tp, tpc.SIMPLEPC)


def test_lattice_mg_without_a_grid_falls_back_to_simple(monkeypatch, lattice):
    """A lattice context without a node grid whose stencil decodes to none
    (infer_dims returns None on both sides), the assembly replaced by the
    lattice fixture's matrix."""
    from dedflow_tpu.fem.lattice import build_lattice_context

    ts, jm, jj, _ = lattice
    scheme = reference_scenario_config().time
    monkeypatch.setattr(jmg, "infer_dims", lambda *a: None)
    monkeypatch.setattr(tnt, "infer_dims", lambda *a: None)
    monkeypatch.setattr(jnt, "assemble_jacobian_t", lambda *a, **k: jj)
    monkeypatch.setattr(tnt, "assemble_jacobian_t", lambda *a, **k: jm)
    jctx = dataclasses.replace(build_lattice_context(box_mesh(1, 1, 1)), dims=None)
    tctx = dataclasses.replace(ts.lctx, dims=None)
    n = jm.num_rows
    with pytest.warns(UserWarning, match=re.escape(MG_NO_GRID)):
        _, jp = jnt.assemble_system(jctx, (), None, *map(jnp.asarray, _small_states(n)), None,
                                    scheme, pc_type="mg")
    with pytest.warns(UserWarning, match=re.escape(MG_NO_GRID)):
        _, tp = tnt.assemble_system(tctx, (), None, *map(torch.tensor, _small_states(n)), None,
                                    scheme, pc_type="mg")
    assert isinstance(jp, jpc.SIMPLEPCT) and isinstance(tp, tpc.SIMPLEPCT)


def jax_steps(js, state, num_newton=2):
    """The JAX package's step and step_fixed(num_newton) on `state`, run
    from the solver's own jitted pieces so that one compile of its Newton
    iteration serves both: predict, residual, the Newton iterations (with
    lag_jacobian: J and the preconditioner once, then solve_update), update,
    and the adaptive loop's convergence test (newton.py:437-510). Returns
    ((wgold, dwgold, dwg), krylov_iters, converged) of the adaptive step
    and the three states of the fixed one."""
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    newton = js.cfg.newton

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d)
        rnorm0 = js._norms(f) + 1e-16
        lagged = js._assemble_system(*c, wg, dwo, d) if newton.lag_jacobian else None
        kits, conv = [], False
        for _ in range(num):
            if lagged is not None:
                d, f, rn, kit, _ = js._solve_update(*c, *lagged, wg, dwo, d, f)
            else:
                d, f, rn, kit, _ = js._newton_iter(*c, wg, dwo, d, f)
            kits.append(int(kit))
            conv = bool(jnp.all((rn < newton.rtol * rnorm0) | (rn < newton.atol)))
            if adaptive and conv:
                break
        return (*js._update(wg, dwo, d), d), kits, conv

    adaptive = run(newton.max_iter, True)
    return adaptive, run(num_newton, False)[0]


STEP_CASES = {
    "lattice-simple": (dict(), dict(pc="simple"), dict()),
    "lattice-mg": (dict(), dict(pc="mg"), dict()),
    "gather-simple": (dict(use_lattice="gather"), dict(pc="simple"), dict()),
    "lattice-simple-lagged": (dict(), dict(pc="simple"), dict(lag_jacobian=True)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_and_step_fixed_match_jax(case):
    """NSSolver.step and step_fixed(num_newton=2) on box_mesh(4, 3, 3) from
    one perturbed state: states to 1e-9, equal Newton and Krylov counts."""
    scen, kry, newton = STEP_CASES[case]
    cfg = _with_krylov(reference_scenario_config(**scen), **kry)
    cfg = dataclasses.replace(cfg, newton=dataclasses.replace(cfg.newton, **newton))
    js = jnt.NSSolver(box_mesh(4, 3, 3), cfg)
    ts = tnt.NSSolver(tgen.box_mesh(4, 3, 3), _tcfg(cfg), device="cpu")
    assert js.fastpath == ts.fastpath
    state = _perturbed(box_mesh(4, 3, 3), 3)
    (ref, kits, conv), ref2 = jax_steps(js, state)
    tstate = interop.state_from_numpy(*state, device="cpu")
    *got, tstats = ts.step(*tstate)
    got2 = ts.step_fixed(*tstate, num_newton=2)
    for g, r in zip(got + list(got2), list(ref) + list(ref2)):
        assert rel(g.numpy(), r) < 1e-9
    assert tstats.krylov_iters == kits and tstats.converged == conv


def test_cli_takes_pc(capsys, tmp_path):
    rc = tmain.main(["--box", "3", "2", "2", "--steps", "1", "--device", "cpu", "--pc", "mg",
                     "--out", str(tmp_path)])
    assert rc == 0
    rec = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(rec) == 1 and '"fastpath": "lattice"' in rec[0]
