"""dedflow_tpu_torch policy: import boundary, no fallback, copies kept in sync.

- The port and chip_smoke.py import nothing of JAX or of the JAX package.
- A CUDA request without a card raises; a kernel that cannot be built
  raises; unported tiers and options raise NotImplementedError.
- chip_smoke.py fails and prints no result without a card, and alone in a
  directory.
- The port's copy of config.py keeps the JAX package's field names and
  defaults, and configurations cross over through interop.
"""

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu_torch import config as tcfg
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app.scenarios import reference_scenario_config
from dedflow_tpu_torch.mesh.gen import box_mesh
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.utils import dtypes, nvcc

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dedflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "dedflow_tpu"), f"{path.name} imports {mod}"


def test_fresh_interpreter_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import dedflow_tpu_torch, dedflow_tpu_torch.solver.newton, "
        "dedflow_tpu_torch.app.main, dedflow_tpu_torch.interop, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dedflow_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        dtypes.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        NSSolver(box_mesh(2, 2, 2), reference_scenario_config(), device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(nvcc, "_loaded", {})
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.load("dia_spmv")


def test_default_dtypes():
    assert dtypes.default_dtype(torch.device("cpu")) == torch.float64
    assert dtypes.default_dtype(torch.device("cuda")) == torch.float32
    assert dtypes.parse_dtype("f32", torch.device("cpu")) == torch.float32
    with pytest.raises(ValueError):
        dtypes.parse_dtype("bf16", torch.device("cpu"))


@pytest.mark.parametrize(
    "overrides",
    [
        dict(krylov=tcfg.KrylovConfig(pc="simple")),
        dict(krylov=tcfg.KrylovConfig(pc="mg")),
        dict(krylov=tcfg.KrylovConfig(precision="ir")),
        dict(implicit_scalars=True),
        dict(assembly_chunk=64),
        dict(lattice_backend="xla"),
        dict(use_lattice="gather"),
        dict(use_lattice="winell"),
        dict(physics=tcfg.Physics(laser=tcfg.Laser())),
        dict(newton=tcfg.NewtonConfig(lag_jacobian=True)),
    ],
    ids=lambda o: next(iter(o)),
)
def test_unported_options_raise(overrides):
    cfg = dataclasses.replace(reference_scenario_config(), **overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NSSolver(box_mesh(2, 2, 2), cfg)


def test_mesh_without_lattice_raises():
    mesh = box_mesh(2, 2, 2)
    mesh.lattice = None
    with pytest.raises(NotImplementedError, match="classes tier"):
        NSSolver(mesh, reference_scenario_config())


def test_step_with_source_raises():
    solver = NSSolver(box_mesh(2, 2, 2), reference_scenario_config())
    state = [torch.zeros((27, 6), dtype=torch.float64) for _ in range(3)]
    with pytest.raises(NotImplementedError):
        solver.step(*state, source=torch.zeros(27, dtype=torch.float64))


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = None
    return out


@pytest.mark.parametrize(
    "name", ["SolverConfig", "Physics", "TimeScheme", "NewtonConfig", "KrylovConfig",
             "BCSpec", "Laser"],
)
def test_config_copy_matches_jax(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_config_crosses_over_through_interop():
    from dedflow_tpu.app.scenarios import reference_scenario_config as jref

    d = jcfg._to_dict(jref())
    assert interop.config_from_dict(json.loads(json.dumps(d))) == reference_scenario_config()


def _run_smoke(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=300,
    )


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if not torch.cuda.is_available():
        res = _run_smoke(ROOT)
        assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
