"""dedflow_tpu_torch policy: import boundary, no fallback, copies kept in sync.

- The port and chip_smoke.py import nothing of JAX or of the JAX package.
- A CUDA request without a card raises, and every public constructor
  and converter targets the card unless asked for the CPU; a kernel that
  cannot be built raises; a CUDA tensor given to a kernel wrapper goes to
  the kernel (or raises), never to the plain version, and a CPU tensor
  counts no launch; unported tiers and options raise NotImplementedError
  naming their ROADMAP item.
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
from dedflow_tpu_torch.dem import grid as dem_grid
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.sparse import dia_kernels, win_gather, win_kernels, win_ring, win_stream
from dedflow_tpu_torch.sparse.winell import WinELLMatrixT, build_winell_plan
from dedflow_tpu_torch.tools import gather_probe as tgp
from dedflow_tpu_torch.tools import gmicro as tgm
from dedflow_tpu_torch.utils import dtypes, nvcc

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
        "dedflow_tpu_torch.app.main, dedflow_tpu_torch.app.coupled, "
        "dedflow_tpu_torch.dem.grid, dedflow_tpu_torch.interop, "
        "dedflow_tpu_torch.tools.gmicro, dedflow_tpu_torch.tools.gather_probe, "
        "dedflow_tpu_torch.fem.ns, dedflow_tpu_torch.app.kernel_ab, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dedflow_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def _coupled_config():
    from dedflow_tpu_torch.app.coupled import CoupledConfig
    from dedflow_tpu_torch.dem.cells import make_grid
    from dedflow_tpu_torch.dem.integrate import DEMConfig

    return CoupledConfig(dem=DEMConfig(grid=make_grid([0, 0, 0], [1, 1, 1], 0.25)))


def _coupled_solver(**kw):
    from dedflow_tpu_torch.app.coupled import CoupledSolver

    return CoupledSolver(box_mesh(2, 2, 2), reference_scenario_config(), _coupled_config(), **kw)


@pytest.mark.parametrize(
    "make",
    [
        lambda: dtypes.resolve_device("cuda"),
        lambda: NSSolver(box_mesh(2, 2, 2), reference_scenario_config(), device="cuda"),
        lambda: NSSolver(box_mesh(2, 2, 2), reference_scenario_config()),
        lambda: _coupled_solver(),
        lambda: _coupled_solver(device="cuda"),
        lambda: NSSolver(box_mesh(2, 2, 2), reference_scenario_config(use_lattice="gather")),
    ],
    ids=["resolve_device", "NSSolver-cuda", "NSSolver-default", "CoupledSolver-default",
         "CoupledSolver-cuda", "NSSolver-gather-default"],
)
def test_cuda_request_without_card_raises(monkeypatch, make):
    """The entry points target the card unless asked for the CPU, and a
    CUDA request without a card raises (never falls back)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        make()


def _small_mesh_and_sparsity():
    from dedflow_tpu_torch.sparse.topology import build_sparsity

    mesh = box_mesh(1, 1, 1)
    return mesh, build_sparsity(mesh.ien, mesh.num_node)


@pytest.mark.parametrize(
    "make",
    [
        lambda: interop.state_from_numpy(*([[[0.0] * 6]] * 3)),
        lambda: interop.dia_from_numpy([[[0.0]] * 16], [[0.0], [0.0]], (0,), 1),
        lambda: interop.particles_from_numpy([[0.5, 0.5, 0.5]], None, 1.0, 0.1),
        lambda: interop.grid_state_from_numpy(*([[[0.0]]] * 2), [[0.0]], [[0.0]], [[0]]),
        lambda: win_stream.build_reduce_plan([0], [0], 1),
        lambda: build_winell_plan([0, 1], [0], 1),
        lambda: _build_win_context(*_small_mesh_and_sparsity()),
        lambda: _build_context(*_small_mesh_and_sparsity()),
    ],
    ids=["state_from_numpy", "dia_from_numpy", "particles_from_numpy", "grid_state_from_numpy",
         "build_reduce_plan", "build_winell_plan", "build_win_context", "build_context"],
)
def test_constructors_default_to_the_card(monkeypatch, make):
    """The public constructors and converters put their tensors on the card
    unless the caller asks for the CPU (the JAX package's land on the
    default backend); without a card the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        make()


def _build_win_context(mesh, sparsity):
    from dedflow_tpu_torch.fem.win_assembly import build_win_context

    return build_win_context(mesh, sparsity)


def _build_context(mesh, sparsity):
    from dedflow_tpu_torch.fem.assembly import build_context

    return build_context(mesh, sparsity)


def test_multi_device_options_raise_a16():
    from dedflow_tpu_torch.dem.grid import dem_run_grid
    from dedflow_tpu_torch.dem.particles import particle_state

    with pytest.raises(NotImplementedError, match="A16"):
        _coupled_solver(device="cpu", device_mesh=object())
    pst = particle_state([[0.5, 0.5, 0.5]], device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        dem_run_grid(_coupled_config().dem, pst, 1, shard=(object(), "dd"))


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
        dict(lattice_backend="xla"),
        dict(use_lattice="off"),
        dict(assembly_chunk=64, lattice_backend="xla"),
    ],
    ids=["lattice_backend", "use_lattice1", "assembly_chunk"],
)
def test_unported_options_raise(overrides):
    """Options still unported raise, on the gather tier too (an assembly
    chunk with a lattice backend)."""
    cfg = dataclasses.replace(reference_scenario_config(), **overrides)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NSSolver(box_mesh(2, 2, 2), cfg, device="cpu")


@pytest.mark.parametrize(
    "overrides",
    [
        dict(krylov=tcfg.KrylovConfig(pc="simple")),
        dict(krylov=tcfg.KrylovConfig(pc="mg")),
        dict(krylov=tcfg.KrylovConfig(precision="ir")),
        dict(assembly_chunk=64, krylov=tcfg.KrylovConfig(pc="simple")),
        dict(newton=tcfg.NewtonConfig(lag_jacobian=True)),
        dict(krylov=tcfg.KrylovConfig(precision="f64")),
        dict(krylov=tcfg.KrylovConfig(solver="cg")),
    ],
    ids=["krylov0", "krylov1", "krylov2", "assembly_chunk", "newton", "krylov3", "krylov4"],
)
def test_ported_krylov_options_step(overrides):
    """The Krylov options of ROADMAP A11 run (they raised before they were
    ported): one step_fixed(num_newton=1) on box_mesh(2, 2, 2), finite."""
    cfg = dataclasses.replace(reference_scenario_config(), **overrides)
    solver = NSSolver(box_mesh(2, 2, 2), cfg, device="cpu")
    z = torch.zeros((solver.mesh.num_node, 6), dtype=torch.float64)
    out = solver.step_fixed(z, z, z + 0.01, num_newton=1)
    assert all(bool(torch.isfinite(t).all()) for t in out)


def test_mesh_without_lattice_raises():
    mesh = box_mesh(2, 2, 2)
    mesh.lattice = None
    with pytest.raises(NotImplementedError, match="classes tier"):
        NSSolver(mesh, reference_scenario_config(), device="cpu")


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(nvcc, "_loaded", {})
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")


def _k6_res():
    return ek.res_rows_call(torch.zeros((67, 8)), *_phys_scheme())


def _k6_lhs():
    return ek.lhs_rows_call(torch.zeros((27, 8)), *_phys_scheme())


def _k6_lhs_implicit():
    return ek.lhs_rows_call(torch.zeros((33, 8)), *_phys_scheme(), scalar_implicit=True)


def _lattice_box(implicit: bool):
    return lat.build_lattice_context(box_mesh(1, 1, 1), "cpu", torch.float32,
                                     scalar_implicit=implicit)


def _k1_source():
    lctx, z = _lattice_box(False), torch.zeros((6, 8))
    return lat.residual_volume(lctx, z, z, *_phys_scheme(), source=torch.zeros(8))


def _k2_implicit():
    lctx = _lattice_box(True)
    return lat.jacobian_volume(lctx, torch.zeros((6, 8)), *_phys_scheme(), torch.ones((18, 8)),
                               torch.zeros((18, 8)))[1]


def _k7():
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    return win_kernels.winell_matvec(WinELLMatrixT(torch.zeros((18, 2)), plan), torch.zeros((6, 2)))


def _k7_f64():
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    mat = WinELLMatrixT(torch.zeros((18, 2), dtype=torch.float64), plan)
    return win_kernels.winell_matvec(mat, torch.zeros((6, 2), dtype=torch.float64))


def _k3(dtype):
    def call():
        z = lambda *shape: torch.zeros(shape, dtype=dtype)
        return dia_kernels.dia_matvec(z(1, 16, 4), z(2, 4), z(6, 4), (0,))

    return call


def _k8():
    plan = win_stream.build_reduce_plan([0, 1, 1], [0, 1, 2], 2, device="cpu")
    return win_stream.stream_reduce(plan, torch.zeros((6, 3)))


def _k9():
    plan = win_stream.build_reduce_plan([0, 1, 1], [0, 1, 2], 2, device="cpu")
    return win_ring.ring_reduce(plan, torch.zeros((16, 3)))


def _k11():
    from dedflow_tpu_torch.dem.cells import make_grid
    from dedflow_tpu_torch.dem.contact import ContactParams
    from dedflow_tpu_torch.dem.grid import GridState

    grid = make_grid([0, 0, 0], [1, 1, 1], 0.5, capacity=2)
    z = lambda: torch.zeros((2, grid.num_cell), dtype=torch.float32)
    gs = GridState(pos=(z(), z(), z()), vel=(z(), z(), z()), radius=z(), mask=z(),
                   pid=torch.zeros((2, grid.num_cell), dtype=torch.int32))
    return dem_grid.grid_pair_forces_cuda(grid, gs, ContactParams())


def _phys_scheme():
    cfg = reference_scenario_config()
    return cfg.physics, cfg.time


def _k4():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((6, 3))
    return ek.ns_residual_gather(torch.zeros((19, 8)), ien, w, w, *_phys_scheme())


def _k5():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    return ek.ns_lhs_gather(torch.zeros((15, 8)), ien, torch.zeros((6, 3)), *_phys_scheme())


def _k5_implicit():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    return ek.ns_lhs_gather(torch.zeros((15, 8)), ien, torch.zeros((6, 3)), *_phys_scheme(),
                            metric=torch.zeros((6, 8)))


def _staged_plan(m):
    """A Jacobian plan of m elements with its element positions, every
    (e, ab) onto its own target."""
    src = [ab * 18 * m + e for ab in range(16) for e in range(m)]
    plan = win_stream.build_reduce_plan(list(range(16 * m)), src, 16 * m, device="cpu")
    return win_stream.with_element_positions(plan, m, 16, 18)


def _k6_staged():
    return ek.lhs_rows_staged(torch.zeros((27, 8)), *_phys_scheme(), _staged_plan(8))


def _k6_staged_implicit():
    return ek.lhs_rows_staged(torch.zeros((33, 8)), *_phys_scheme(), _staged_plan(8),
                              scalar_implicit=True)


def _k5_staged():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    return ek.ns_lhs_gather_staged(torch.zeros((15, 8)), ien, torch.zeros((6, 3)),
                                   *_phys_scheme(), _staged_plan(8))


def _k5_staged_implicit():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    return ek.ns_lhs_gather_staged(torch.zeros((15, 8)), ien, torch.zeros((6, 3)),
                                   *_phys_scheme(), _staged_plan(8), metric=torch.zeros((6, 8)))


def _k9_segment_sum():
    return win_ring.ring_reduce_staged(_staged_plan(2), torch.zeros((32, 16)), 16)


def _res_staged_plan(m):
    """A residual plan of m elements with its element positions, every
    (e, a) onto its own target."""
    src = [a * 6 * m + e for a in range(4) for e in range(m)]
    plan = win_stream.build_reduce_plan(list(range(4 * m)), src, 4 * m, device="cpu")
    return win_stream.with_element_positions(plan, m, 4, 6)


def _k4_staged():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((3, 6))
    return ek.ns_residual_gather_staged(torch.zeros((19, 8)), ien, w, w, *_phys_scheme(),
                                        _res_staged_plan(8), source=torch.zeros(3))


def _k8_segment_sum():
    return win_stream.stream_reduce_staged(_res_staged_plan(2), torch.zeros((8, 8)), 6)


def _k10():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    return win_gather.win_gather(ien, torch.zeros((3, 5)), win_gather.JAC_ROWMAP, 12)


def _stream():
    return torch.zeros((8, 512)), torch.zeros((8, 512), dtype=torch.int32)


def _k12_copy():
    return tgm.copy2(_stream()[0])


def _k12_lane(idiom):
    return lambda: tgm.lane_gather(*_stream(), idiom)


def _k12_window():
    return tgm.window_gather(*_stream(), 2)


def _k12_reduce():
    return tgm.segment_reduce(*_stream(), 16, acc=True)


def _k13(idiom):
    return lambda: tgp.element_gather(torch.zeros((4, 8), dtype=torch.int32),
                                      torch.zeros((16, 16)), idiom)


@pytest.mark.parametrize(
    "call,plain",
    [
        (_k6_res, (ek, "res_rows")),
        (_k6_lhs, (ek, "lhs_rows")),
        (_k7, (win_kernels, "winell_matvec_plain")),
        (_k7_f64, (win_kernels, "winell_matvec_plain")),
        (_k3(torch.float32), (dia_kernels, "dia_matvec_plain")),
        (_k3(torch.float64), (dia_kernels, "dia_matvec_plain")),
        (_k8, (win_stream, "seg_reduce_plain")),
        (_k9, (win_ring, "seg_reduce_plain")),
        (_k11, (dem_grid, "grid_pair_forces")),
        (_k4, (ek, "ns_residual_gather_plain")),
        (_k5, (ek, "ns_lhs_gather_plain")),
        (_k10, (win_gather, "win_gather_plain")),
        (_k1_source, (lat, "residual_volume_plain")),
        (_k2_implicit, (lat, "jacobian_volume_plain")),
        (_k6_lhs_implicit, (ek, "lhs_rows")),
        (_k5_implicit, (ek, "ns_lhs_gather_plain")),
        (_k12_copy, (tgm, "copy2_plain")),
        (_k12_lane("smem"), (tgm, "lane_gather_plain")),
        (_k12_lane("shuffle"), (tgm, "lane_gather_plain")),
        (_k12_window, (tgm, "window_gather_plain")),
        (_k12_reduce, (tgm, "segment_reduce_plain")),
        (_k13("global"), (tgp, "element_gather_plain")),
        (_k13("staged"), (tgp, "element_gather_plain")),
        (_k6_staged, (ek, "lhs_rows_staged_plain")),
        (_k6_staged_implicit, (ek, "lhs_rows_staged_plain")),
        (_k5_staged, (ek, "ns_lhs_gather_staged_plain")),
        (_k5_staged_implicit, (ek, "ns_lhs_gather_staged_plain")),
        (_k9_segment_sum, (win_ring, "ring_reduce_staged_plain")),
        (_k4_staged, (ek, "ns_residual_gather_staged_plain")),
        (_k8_segment_sum, (win_stream, "stream_reduce_staged_plain")),
    ],
    ids=["K6-res", "K6-lhs", "K7", "K7-f64", "K3", "K3-f64", "K8", "K9", "K11", "K4", "K5", "K10", "K1-source",
         "K2-implicit", "K6-lhs-implicit", "K5-implicit", "K12-copy", "K12-lane-smem",
         "K12-lane-shuffle", "K12-window", "K12-reduce", "K13-global", "K13-staged",
         "K6-staged", "K6-staged-implicit", "K5-staged", "K5-staged-implicit",
         "K9-segment-sum", "K4-staged", "K8-segment-sum"],
)
def test_cuda_tensor_goes_to_the_kernel_never_the_plain_version(
    monkeypatch, tmp_path, call, plain
):
    """Every tensor reads as a CUDA tensor and nvcc is missing: each new
    wrapper must try to build its kernel (and raise), never run its plain
    version."""
    assert call() is not None  # a real CPU tensor takes the plain version
    _no_nvcc(monkeypatch, tmp_path)

    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(*plain, boom)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()


@pytest.mark.parametrize(
    "call,counter",
    [(_k4, (ek, "ns_residual_gather")), (_k5, (ek, "ns_lhs_gather")),
     (_k10, (win_gather, "win_gather")), (_k12_copy, (tgm, "copy2")),
     (_k12_lane("shuffle"), (tgm, "lane_gather")), (_k12_window, (tgm, "window_gather")),
     (_k12_reduce, (tgm, "segment_reduce")), (_k13("staged"), (tgp, "element_gather")),
     (_k6_staged, (ek, "lhs_rows_staged")), (_k5_staged, (ek, "ns_lhs_gather_staged")),
     (_k9_segment_sum, (win_ring, "ring_reduce_staged")),
     (_k4_staged, (ek, "ns_residual_gather_staged")),
     (_k8_segment_sum, (win_stream, "stream_reduce_staged")),
     (_k7_f64, (win_kernels, "winell_matvec_f64")),
     (_k3(torch.float64), (dia_kernels, "dia_matvec_f64"))],
    ids=["K4", "K5", "K10", "K12-copy", "K12-lane", "K12-window", "K12-reduce", "K13",
         "K6-staged", "K5-staged", "K9-segment-sum", "K4-staged", "K8-segment-sum",
         "K7-f64", "K3-f64"],
)
def test_cpu_tensors_count_no_launch(call, counter):
    """On CPU tensors the wrappers run their plain twins and count nothing."""
    fn = getattr(*counter)
    before = fn.launches
    assert call() is not None
    assert fn.launches == before


def _rcm_delaunay():
    mesh = delaunay_mesh(300, seed=1)
    return reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))


def test_pc_mg_on_the_winell_tier_builds_the_amg_plan():
    """pc="mg" on the WinELL tier is algebraic multigrid: NSSolver builds
    the pattern-only plan with the context (it raised, naming A14, before
    A11 was ported)."""
    cfg = dataclasses.replace(reference_scenario_config(), bcs=(), pin_pressure=True)
    plain = NSSolver(_rcm_delaunay(), cfg, device="cpu")
    assert plain.fastpath == "winell" and plain.wctx.amg_idx is None
    mg = NSSolver(_rcm_delaunay(), dataclasses.replace(
        cfg, krylov=tcfg.KrylovConfig(pc="mg")), device="cpu")
    assert mg.fastpath == "winell" and mg.wctx.amg_idx is not None


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
