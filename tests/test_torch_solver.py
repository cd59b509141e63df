"""dedflow_tpu_torch GMRES, Newton stepping and CLI == the JAX package's (float64).

- GMRES (with and without restart) on the port's assembled J and F, handed
  to the JAX gmres as the same arrays: equal iteration counts, x to 1e-10
  relative (the same block-MGS Arnoldi; roundoff differs only in sum order).
- The whole slice on box_mesh(6, 4, 4) (the mesh `__graft_entry__.entry()`
  uses): `NSSolver.step_fixed(num_newton=2)` and `NSSolver.step` against the
  JAX NSSolver from the same numpy state. New states to 1e-9 relative
  (max|port - jax| / max|jax| per state), equal Newton and Krylov counts.
- The port's CLI at that size on the CPU, and its step count: `--steps`
  overrides the config's `num_steps` only when given, as in the JAX CLI;
  without `--box` it runs box 8 x 8 x 8, as the JAX CLI does.
- `krylov.solver` is ignored, as in the JAX package: a "cg" config steps
  exactly like the "gmres" one.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.mesh.gen import box_mesh
from dedflow_tpu.solver.krylov import gmres as jgmres
from dedflow_tpu.solver.newton import NSSolver
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JPC
from dedflow_tpu.sparse.fsbsr import FSDIAMatrixT as JDIA
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh.gen import box_mesh as t_box_mesh
from dedflow_tpu_torch.solver.krylov import gmres as tgmres
from dedflow_tpu_torch.solver.newton import NSSolver as TNSSolver
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT as TPC

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BOX = (6, 4, 4)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def solvers():
    mesh = box_mesh(*BOX)
    cfg = reference_scenario_config()
    js = NSSolver(mesh, cfg)
    ts = TNSSolver(t_box_mesh(*BOX), interop.config_from_dict(jcfg._to_dict(cfg)), device="cpu")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(2).standard_normal(dwg.shape)
    return js, ts, (wg, dwgold, dwg)


@pytest.fixture(scope="module")
def system(solvers):
    """The port's J and F at the perturbed state (float64)."""
    _, ts, state = solvers
    wa, dwa = alpha_states(*interop.state_from_numpy(*state, device="cpu"), ts.cfg.time)
    args = (ts.lctx, ts.face_ctxs, ts.mask_t, wa, dwa, ts.cfg.physics, ts.cfg.time)
    return tlat.assemble_jacobian_t(*args), tlat.assemble_residual_t(*args)


@pytest.mark.parametrize(
    "restart,rtol", [(None, 1e-4), (None, 1e-9), (12, 1e-6)],
    ids=["full-1e-4", "full-1e-9", "restart12-1e-6"],
)
def test_gmres_matches_jax(system, restart, rtol):
    jm, f = system
    jj = JDIA(
        data=jnp.asarray(jm.data.numpy()), scal=jnp.asarray(jm.scal.numpy()),
        offsets=jm.offsets,
    )
    ref = jgmres(
        jj.matvec_t, jnp.asarray(f.numpy()), maxit=120, atol=1e-12, rtol=rtol,
        pc=JPC.from_diag_rows(jj.diag_rows()), restart=restart,
    )
    got = tgmres(
        jm.matvec_t, f, maxit=120, atol=1e-12, rtol=rtol,
        pc=TPC.from_diag_rows(jm.diag_rows()), restart=restart,
    )
    assert got.iters == int(ref.iters) > 0
    assert got.converged == bool(ref.converged)
    assert rel(got.x.numpy(), ref.x) < 1e-10
    assert rel(got.resnorm.numpy(), ref.resnorm) < 1e-8


def test_step_fixed_matches_jax(solvers):
    js, ts, state = solvers
    ref = js.step_fixed(*(jnp.asarray(a) for a in state), num_newton=2)
    got = ts.step_fixed(*interop.state_from_numpy(*state, device="cpu"), num_newton=2)
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name


def test_step_matches_jax(solvers):
    js, ts, state = solvers
    *ref, rstats = js.step(*(jnp.asarray(a) for a in state))
    *got, tstats = ts.step(*interop.state_from_numpy(*state, device="cpu"))
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name
    assert len(tstats.rnorms) == len(rstats.rnorms)
    assert tstats.krylov_iters == rstats.krylov_iters
    assert tstats.converged == rstats.converged
    assert rel(np.stack(tstats.rnorms), np.stack(rstats.rnorms)) < 1e-8


def test_cli_prints_one_json_line_per_step(capsys, tmp_path):
    rc = tmain.main(["--box", *map(str, BOX), "--steps", "1", "--device", "cpu", "--dtype", "f64",
                     "--out", str(tmp_path)])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["step"] == 1 and rec["newton_iters"] >= 1
    assert len(rec["krylov_iters"]) == rec["newton_iters"]
    assert len(rec["field_norms"]) == 4 and all(np.isfinite(rec["field_norms"]))
    assert rec["wall_s"] > 0


def test_cli_steps_default_to_the_configs_num_steps():
    assert tmain._parser().parse_args([]).steps is None


@pytest.mark.parametrize("steps,expected", [(None, 3), ("1", 1)], ids=["config", "flag"])
def test_cli_runs_num_steps_unless_steps_is_given(capsys, tmp_path, steps, expected):
    from dedflow_tpu_torch.app.scenarios import reference_scenario_config as t_reference
    from dedflow_tpu_torch.config import save_config

    cfg = tmp_path / "cfg.json"
    save_config(dataclasses.replace(t_reference(), num_steps=3), str(cfg))
    argv = ["--box", "3", "3", "3", "--device", "cpu", "--dtype", "f64", "--config", str(cfg),
            "--out", str(tmp_path)]
    assert tmain.main(argv + (["--steps", steps] if steps else [])) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert [r["step"] for r in recs] == list(range(1, expected + 1))


def test_cli_box_defaults_to_the_jax_clis():
    """The JAX CLI runs box_mesh(8, 8, 8) without --box (app/main.py:193)."""
    assert tuple(tmain._parser().parse_args([]).box) == (8, 8, 8)


def test_krylov_solver_is_ignored_as_in_the_jax_package(solvers):
    """The JAX package's step never reads krylov.solver and always runs
    GMRES (config.py:99-101): a "cg" config steps like the "gmres" one."""
    _, ts, state = solvers
    cfg = dataclasses.replace(ts.cfg, krylov=dataclasses.replace(ts.cfg.krylov, solver="cg"))
    cg = TNSSolver(t_box_mesh(*BOX), cfg, device="cpu")
    tstate = interop.state_from_numpy(*state, device="cpu")
    *got, gstats = cg.step(*tstate)
    *ref, rstats = ts.step(*tstate)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert gstats.krylov_iters == rstats.krylov_iters
