"""dedflow_tpu_torch run outputs == the JAX package's: solution snapshots,
restarts, particle files, JSONL metrics, profiler traces (io/h5.py,
dem/particles.py, utils/log.py, utils/profiling.py, app/main.py).

- Solution and particle files cross over both ways exactly: the port
  writes and the JAX package reads, and the reverse; `solution_datasets`
  / `state_from_datasets` equal JAX's datasets and reconstruction.
- The CLI at box 3 x 2 x 2, float64 on the CPU: sol.0 and sol.<k> at the
  --save-every cadence, the metrics records with the JAX CLI's keys,
  `--resume` equal to stepping NSSolver from JAX's reconstruction
  (read_solution_h5, dwgold = dwg), the melt pool's laser at the absolute
  step after a restart, particle files from the coupled scenario.
- A recovered shuffled mesh (--mesh): snapshots in the file's node order,
  equal to the solver's state permuted back; a restart reads them back.
- --profile writes a trace, --log-level debug is accepted, and without
  h5py the CLI stops before it builds a solver (exit code 2); the stage
  timers report as the JAX package's.
"""

import ast
import dataclasses
import glob
import json
import logging
import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from dedflow_tpu.dem import particles as jpart
from dedflow_tpu.io import h5 as jh5
from dedflow_tpu.utils import profiling as jprof
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app.scenarios import (
    laser_source,
    melt_pool_initial_state,
    melt_pool_scenario_config,
    reference_initial_state,
    reference_scenario_config,
)
from dedflow_tpu_torch.dem import particles as tpart
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.io import h5 as th5
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh.recover import recover_lattice
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parents[1]
BOX = ["--box", "3", "2", "2"]
CPU64 = ["--device", "cpu", "--dtype", "f64"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _states(n: int, dtype, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 6)).astype(dtype), rng.standard_normal((n, 6)).astype(dtype)


def _equal_snapshots(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


# ---------------------------------------------------------------------------
# files


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_solution_files_cross_over(tmp_path, writer, dtype):
    wg, dwg = _states(17, dtype)
    path = str(tmp_path / "sol.5.h5")
    (th5 if writer == "port" else jh5).write_solution_h5(path, wg, dwg, step=5, time=0.25)
    assert not os.path.exists(path + ".tmp")
    got = (jh5 if writer == "port" else th5).read_solution_h5(path)
    _equal_snapshots(got, jh5.read_solution_h5(path))
    assert got["step"] == 5 and got["time"] == 0.25
    np.testing.assert_array_equal(got["wg"][:, [0, 1, 2, 4, 5]], wg[:, [0, 1, 2, 4, 5]])
    assert not got["wg"][:, 3].any()  # the reference keeps the pressure in dwg
    np.testing.assert_array_equal(got["dwg"], dwg)


def test_solution_datasets_match_jax(tmp_path):
    """The in-memory datasets equal the JAX writer's file, and
    state_from_datasets equals JAX's reconstruction, torch input included;
    a snapshot without dphi / dT (the reference's) reads with zeros there."""
    wg, dwg = _states(11, np.float64, seed=1)
    path = str(tmp_path / "sol.h5")
    jh5.write_solution_h5(path, wg, dwg, step=3, time=0.15)
    got = th5.solution_datasets(torch.as_tensor(wg), torch.as_tensor(dwg), 3, 0.15)
    with h5py.File(path, "r") as f:
        names = []
        f.visititems(lambda name, obj: names.append(name) if isinstance(obj, h5py.Dataset)
                     else None)
        assert sorted(names) == sorted(got)
        for name in names:
            np.testing.assert_array_equal(got[name], f[name][()])
    _equal_snapshots(th5.state_from_datasets(got), jh5.read_solution_h5(path))
    bare = {k: v for k, v in got.items() if k not in ("dphi", "dT", "meta/step", "meta/time")}
    with h5py.File(path, "w") as f:
        for k, v in bare.items():
            f.create_dataset(k, data=v)
    _equal_snapshots(th5.state_from_datasets(bare), jh5.read_solution_h5(path))


@pytest.mark.parametrize("writer", ["port", "jax", "reference"])
def test_particle_files_cross_over(tmp_path, writer):
    """Group coord / vel / acc (3P,), mass, radius; the reference's files
    have no mass or radius, which read as 1.0 and 0.1."""
    rng = np.random.default_rng(2)
    x, v, a = rng.random((3, 9, 3))
    mass, radius = rng.random(9) + 0.5, rng.random(9) * 0.05
    path = str(tmp_path / "particles.3.h5")
    if writer == "port":
        st = tpart.particle_state(x, v, mass=mass, radius=radius, device="cpu")
        st.a = torch.as_tensor(a)
        tpart.save_particles(path, "ptc", st)
    elif writer == "jax":
        st = jpart.particle_state(x, v, mass=mass, radius=radius)
        jpart.save_particles(path, "ptc", dataclasses.replace(st, a=np.asarray(a)))
    else:
        with h5py.File(path, "w") as f:
            for name, arr in (("coord", x), ("vel", v), ("acc", a)):
                f.create_dataset(f"ptc/{name}", data=arr.reshape(-1))
        mass, radius = np.ones(9), np.full(9, 0.1)
    got = tpart.load_particles(path, "ptc", device="cpu")
    ref = jpart.load_particles(path, "ptc")
    for name, want in (("x", x), ("v", v), ("a", a), ("mass", mass), ("radius", radius)):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
        np.testing.assert_array_equal(getattr(got, name).numpy(), want)
    again = tpart.particles_from_datasets(tpart.particle_datasets(got), device="cpu")
    assert all(torch.equal(getattr(again, f), getattr(got, f))
               for f in ("x", "v", "a", "mass", "radius"))


# ---------------------------------------------------------------------------
# the CLI


def _jax_record_keys() -> set:
    """The keys of the JAX CLI's metrics record (dedflow_tpu/app/main.py:
    `rec = {...}` and `rec[...] = ...`), and the writer's wall_s."""
    keys = {"wall_s"}
    for node in ast.walk(ast.parse((ROOT / "dedflow_tpu/app/main.py").read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "rec" and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "rec"):
            keys.add(node.targets[0].slice.value)
    return keys


def _run(capsys, out, *argv, files=None):
    rc = tmain.main([*argv, "--out", str(out)], files=files)
    captured = capsys.readouterr()
    lines = [json.loads(ln) for ln in captured.out.splitlines() if ln.startswith("{")]
    return rc, lines, captured.err


def _metrics(out) -> list:
    return [json.loads(ln) for ln in (Path(out) / "metrics.jsonl").read_text().splitlines()]


def _step_from(solver, snap, source=None):
    """NSSolver.step from JAX's restart reconstruction (dwgold = dwg)."""
    state = state_from_numpy(snap["wg"], snap["dwg"], snap["dwg"], "cpu", torch.float64)
    return solver.step(*state, source=source)


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """Two reference steps with a snapshot after each, then a restart from
    sol.1 into a copy of the directory."""
    out = tmp_path_factory.mktemp("run")
    assert tmain.main([*BOX, *CPU64, "--steps", "2", "--save-every", "1", "--out", str(out)]) == 0
    again = tmp_path_factory.mktemp("resumed")
    for name in ("sol.0.h5", "sol.1.h5"):
        (again / name).write_bytes((out / name).read_bytes())
    assert tmain.main([*BOX, *CPU64, "--steps", "1", "--resume", "1", "--save-every", "1",
                       "--out", str(again)]) == 0
    return out, again


def test_cli_writes_snapshots_and_metrics(ref_run):
    out, _ = ref_run
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "sol.0.h5", "sol.1.h5", "sol.2.h5"]
    mesh = tgen.box_mesh(3, 2, 2)
    wg, _, dwg = reference_initial_state(mesh)
    _equal_snapshots(jh5.read_solution_h5(str(out / "sol.0.h5")),
                     th5.state_from_datasets(th5.solution_datasets(wg, dwg, 0, 0.0)))
    recs = _metrics(out)
    dt = reference_scenario_config().time.dt
    assert [(r["step"], r["t"]) for r in recs] == [(1, dt), (2, 2 * dt)]
    for r in recs:
        assert set(r) == _jax_record_keys()
        assert len(r["rnorm"]) == 4 and len(r["linear_rel"]) == r["newton_iters"]
        assert len(r["krylov_iters"]) == r["newton_iters"]
    snap = jh5.read_solution_h5(str(out / "sol.2.h5"))
    assert snap["step"] == 2 and snap["time"] == 2 * dt


def test_cli_resume_equals_stepping_jax_reconstruction(ref_run):
    out, again = ref_run
    assert _metrics(again)[0]["step"] == 2
    solver = NSSolver(tgen.box_mesh(3, 2, 2), reference_scenario_config(), device="cpu",
                      dtype=torch.float64)
    wg, _, dwg, _ = _step_from(solver, jh5.read_solution_h5(str(out / "sol.1.h5")))
    _equal_snapshots(th5.read_solution_h5(str(again / "sol.2.h5")),
                     th5.state_from_datasets(th5.solution_datasets(wg, dwg, 2, 0.1)))


def test_cli_melt_pool_resume_takes_the_absolute_step(tmp_path, capsys):
    """After --resume 1 the laser is evaluated at step 2's time level."""
    rc, _, _ = _run(capsys, tmp_path, *BOX, *CPU64, "--scenario", "melt-pool", "--steps", "1")
    assert rc == 0
    mesh, cfg = tgen.box_mesh(3, 2, 2), melt_pool_scenario_config()
    dt = cfg.time.dt
    wg, _, dwg = melt_pool_initial_state(mesh)
    th5.write_solution_h5(str(tmp_path / "sol.1.h5"), wg, dwg, step=1, time=dt)
    rc, lines, _ = _run(capsys, tmp_path, *BOX, *CPU64, "--scenario", "melt-pool", "--steps",
                        "1", "--resume", "1", "--save-every", "1")
    assert rc == 0 and [ln["step"] for ln in lines] == [2]
    src = torch.as_tensor(laser_source(cfg.physics.laser, mesh.xg, (1 + cfg.time.alpha_f) * dt))
    solver = NSSolver(mesh, cfg, device="cpu", dtype=torch.float64)
    wg2, _, dwg2, _ = _step_from(solver, jh5.read_solution_h5(str(tmp_path / "sol.1.h5")), src)
    _equal_snapshots(th5.read_solution_h5(str(tmp_path / "sol.2.h5")),
                     th5.state_from_datasets(th5.solution_datasets(wg2, dwg2, 2, 2 * dt)))


def test_cli_recovered_mesh_keeps_the_files_node_order(tmp_path, capsys):
    """Snapshots of a --mesh run on the recovered lattice hold the file's
    node order: sol.0 is the initial state of the file's mesh, sol.1 the
    solver's state permuted back; a restart permutes it in again."""
    shuffled = tgen.shuffled_mesh(tgen.box_mesh(3, 2, 2), seed=7, mirror=True)
    path = str(tmp_path / "shuffled.h5")
    th5.write_mesh_h5(path, shuffled)
    out = tmp_path / "out"
    rc, lines, err = _run(capsys, out, "--mesh", path, *CPU64, "--steps", "1",
                          "--save-every", "1")
    assert rc == 0 and lines[0]["fastpath"] == "lattice" and "recovered 3x2x2" in err
    wg0, _, dwg0 = reference_initial_state(shuffled)
    _equal_snapshots(th5.read_solution_h5(str(out / "sol.0.h5")),
                     th5.state_from_datasets(th5.solution_datasets(wg0, dwg0, 0, 0.0)))
    mesh, perm = recover_lattice(th5.read_mesh_h5(path))
    solver = NSSolver(mesh, reference_scenario_config(), device="cpu", dtype=torch.float64)
    wg, _, dwg, _ = solver.step(*state_from_numpy(*reference_initial_state(mesh), "cpu",
                                                  torch.float64))
    _equal_snapshots(th5.read_solution_h5(str(out / "sol.1.h5")), th5.state_from_datasets(
        th5.solution_datasets(wg.numpy()[perm], dwg.numpy()[perm], 1, 0.05)))
    rc, _, _ = _run(capsys, out, "--mesh", path, *CPU64, "--steps", "1", "--resume", "1",
                    "--save-every", "1")
    assert rc == 0
    snap = jh5.read_solution_h5(str(out / "sol.1.h5"))
    inv = np.argsort(perm)
    wg2, _, dwg2, _ = _step_from(solver, {"wg": snap["wg"][inv], "dwg": snap["dwg"][inv]})
    _equal_snapshots(th5.read_solution_h5(str(out / "sol.2.h5")), th5.state_from_datasets(
        th5.solution_datasets(wg2.numpy()[perm], dwg2.numpy()[perm], 2, 0.1)))


def test_cli_coupled_run_writes_particle_files(tmp_path, capsys):
    rc, lines, _ = _run(capsys, tmp_path, "--scenario", "coupled", "--box", "4", "3", "3",
                        "--particles", "64", "--steps", "1", "--save-every", "1",
                        "--device", "cpu")
    assert rc == 0 and len(lines) == 1
    got = tpart.load_particles(str(tmp_path / "particles.1.h5"), "ptc", device="cpu")
    ref = jpart.load_particles(str(tmp_path / "particles.1.h5"), "ptc")
    assert got.num_particle == 64
    for name in ("x", "v", "a", "mass", "radius"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert bool(torch.isfinite(got.x).all())


def test_cli_profile_and_log_level(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc, lines, err = _run(capsys, tmp_path, "--box", "2", "2", "2", *CPU64, "--steps", "1",
                          "--profile", str(prof), "--log-level", "debug", "--metrics",
                          str(tmp_path / "m.jsonl"))
    assert rc == 0 and len(lines) == 1
    assert logging.getLogger("dedflow").level == logging.DEBUG
    assert "assembly fastpath: lattice" in err
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert [r["step"] for r in map(json.loads, (tmp_path / "m.jsonl").read_text().splitlines())
            ] == [1]
    assert not (tmp_path / "metrics.jsonl").exists()


def test_cli_without_h5py_stops_before_the_solver(tmp_path, capsys, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the solver was built")

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(tmain, "NSSolver", boom)
    out = tmp_path / "out"
    rc, lines, err = _run(capsys, out, *BOX, *CPU64, "--steps", "1")
    assert rc == 2 and not lines and "h5py" in err
    assert not out.exists()
    # a caller with its own file calls runs without h5py
    store = {}
    files = tmain.RunFiles(write_solution=lambda p, wg, dwg, step, time: store.update(
        {p: th5.solution_datasets(wg, dwg, step, time)}), needs_h5py=False)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "h5py", None)
    rc, lines, _ = _run(capsys, out, *BOX, *CPU64, "--steps", "1", "--save-every", "1",
                        files=files)
    assert rc == 0 and sorted(map(os.path.basename, store)) == ["sol.0.h5", "sol.1.h5"]


def test_stage_timers_report_as_jax():
    reports = []
    for timers in (tprof.StageTimers(), jprof.StageTimers()):
        for name, sync in (("assemble", None), ("solve", 1), ("assemble", None)):
            with timers.stage(name, sync=sync):
                pass
        reports.append(timers.report())
    got, ref = reports
    assert list(got) == list(ref) == ["assemble", "solve"]
    assert all(got[k]["calls"] == ref[k]["calls"] and set(got[k]) == set(ref[k]) for k in got)
