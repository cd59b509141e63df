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
        "dedflow_tpu_torch.fem.ns, dedflow_tpu_torch.app.kernel_ab, chip_smoke, "
        "dedflow_tpu_torch.mesh.recover, dedflow_tpu_torch.io.h5, dedflow_tpu_torch.fem.heat, "
        "dedflow_tpu_torch.utils.log, dedflow_tpu_torch.utils.profiling, "
        "dedflow_tpu_torch.dem.particles, dedflow_tpu_torch.parallel.sharded, "
        "dedflow_tpu_torch.parallel.launch, dedflow_tpu_torch.parallel.dryrun, "
        "dedflow_tpu_torch.parallel.partition, dedflow_tpu_torch.parallel.spmd\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'dedflow_tpu', 'h5py')]\n"
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
        lambda: _sharded_solver(),
        lambda: _dryrun(),
    ],
    ids=["resolve_device", "NSSolver-cuda", "NSSolver-default", "CoupledSolver-default",
         "CoupledSolver-cuda", "NSSolver-gather-default", "ShardedNSSolver-default",
         "dryrun_multichip-default"],
)
def test_cuda_request_without_card_raises(monkeypatch, make):
    """The entry points target the card unless asked for the CPU, and a
    CUDA request without a card raises (never falls back)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        make()


def _sharded_solver():
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver

    return ShardedNSSolver(box_mesh(2, 2, 4), reference_scenario_config())


def _dryrun():
    from dedflow_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(2)


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
        lambda: _bsr_zeros(_small_mesh_and_sparsity()[1]),
        lambda: _particles_from_datasets(),
    ],
    ids=["state_from_numpy", "dia_from_numpy", "particles_from_numpy", "grid_state_from_numpy",
         "build_reduce_plan", "build_winell_plan", "build_win_context", "build_context",
         "bsr_zeros", "particles_from_datasets"],
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


def _bsr_zeros(sparsity):
    from dedflow_tpu_torch.sparse.bsr import bsr_zeros

    return bsr_zeros(sparsity, 1, 1)


def _particles_from_datasets():
    from dedflow_tpu_torch.dem.particles import particles_from_datasets

    return particles_from_datasets({"coord": [0.5] * 3, "vel": [0.0] * 3, "acc": [0.0] * 3})


def _device_defaults(path: Path):
    """(function, default) of each function argument named `device` with a
    default in a port source."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.Lambda)):
            args = node.args
            pos = args.posonlyargs + args.args
            pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None]
            for a, d in pairs:
                if a.arg == "device" and isinstance(d, ast.Constant):
                    yield getattr(node, "name", "<lambda>"), d.value


def test_no_port_function_defaults_to_the_cpu():
    """Every port function that takes a device defaults to the card or
    requires it (AMGIndices.from_plan, the last one that defaulted to the
    CPU, requires it)."""
    import inspect

    from dedflow_tpu_torch.solver.amg import AMGIndices

    assert inspect.signature(AMGIndices.from_plan).parameters["device"].default is (
        inspect.Parameter.empty)
    found = {(p.name, fn): d for p in PORT_FILES if p.name != "chip_smoke.py"
             for fn, d in _device_defaults(p)}
    assert found and not {k: d for k, d in found.items() if d != "cuda"}


def test_multi_device_options_raise_a16():
    """The coupled solver on ranks (A16 (c), ported) takes `sharded=True`
    and the process group, not the JAX package's device mesh; the fluid's
    Krylov options (A16 (d'), ported) pass to it, and what stays unported
    on ranks raises, naming its item, before any rank communicates: the
    classes tier on z-slabs (A16 (b'')), a lattice_backend (A9).
    dem_run_grid's `shard` is the ranks' SlabComm."""
    import dataclasses

    from dedflow_tpu_torch.app.coupled import CoupledSolver
    from dedflow_tpu_torch.config import NewtonConfig
    from dedflow_tpu_torch.dem.grid import dem_run_grid
    from dedflow_tpu_torch.dem.particles import particle_state

    with pytest.raises(TypeError, match="device_mesh"):
        _coupled_solver(device="cpu", device_mesh=object())
    lagged = dataclasses.replace(reference_scenario_config(lattice_backend="xla"),
                                 newton=NewtonConfig(lag_jacobian=True))
    with pytest.raises(NotImplementedError, match="A9"):
        CoupledSolver(box_mesh(2, 2, 4), lagged, _coupled_config(), device="cpu", sharded=True)
    no_lattice = box_mesh(2, 2, 4)
    no_lattice.lattice = None
    with pytest.raises(NotImplementedError, match="A16 \\(b''\\)"):
        CoupledSolver(no_lattice, reference_scenario_config(), _coupled_config(), device="cpu",
                      sharded=True)
    pst = particle_state([[0.5, 0.5, 0.5]], device="cpu")
    with pytest.raises(TypeError, match="SlabComm"):
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
        dict(assembly_chunk=64, lattice_backend="xla"),
    ],
    ids=["lattice_backend", "assembly_chunk"],
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


def _mesh_without_lattice(mesh):
    mesh.lattice = None
    return mesh


@pytest.mark.parametrize(
    "make_mesh,overrides",
    [
        (lambda jgen: jgen.box_mesh(2, 2, 2), dict(use_lattice="off")),
        (lambda jgen: _mesh_without_lattice(jgen.box_mesh(2, 2, 2)), dict()),
    ],
    ids=["use_lattice1", "mesh_without_lattice"],
)
def test_ported_tier_options_step(make_mesh, overrides):
    """The translation-class tier of ROADMAP A10 runs (these raised before
    it was ported): use_lattice="off" on a box and a box without its
    lattice metadata step, finite, on the tier the JAX NSSolver picks."""
    from dedflow_tpu.app.scenarios import reference_scenario_config as jref
    from dedflow_tpu.mesh import gen as jgen
    from dedflow_tpu.solver.newton import NSSolver as JNSSolver
    from dedflow_tpu_torch.mesh import gen as tgen

    jcfg_ = dataclasses.replace(jref(), **overrides)
    cfg = dataclasses.replace(reference_scenario_config(), **overrides)
    solver = NSSolver(make_mesh(tgen), cfg, device="cpu")
    assert solver.fastpath == JNSSolver(make_mesh(jgen), jcfg_).fastpath == "classes"
    z = torch.zeros((solver.mesh.num_node, 6), dtype=torch.float64)
    out = solver.step_fixed(z, z, z + 0.01, num_newton=1)
    assert all(bool(torch.isfinite(t).all()) for t in out)


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


def _class_box(implicit: bool):
    """A class context (6 classes) of box_mesh(1, 1, 1) without its
    lattice metadata."""
    mesh = box_mesh(1, 1, 1)
    mesh.lattice = None
    return lat.build_class_context(mesh, "cpu", torch.float32, scalar_implicit=implicit)


def _k1c():
    lctx, z = _class_box(False), torch.zeros((6, 8))
    return lat.residual_volume_classes(lctx, z, z, *_phys_scheme(), source=torch.zeros(8))


def _k1c_routed():
    """K1's wrapper on a class context: K1c."""
    lctx, z = _class_box(False), torch.zeros((6, 8))
    return lat.residual_volume(lctx, z, z, *_phys_scheme())


def _k1c_two_pass():
    lctx, z = _class_box(False), torch.zeros((6, 8))
    return lat.residual_volume_two_pass(lctx, z, z, *_phys_scheme(), source=torch.zeros(8))


def _k2c_two_pass():
    lctx = _class_box(True)
    return lat.jacobian_volume_two_pass(lctx, torch.zeros((6, 8)), *_phys_scheme(),
                                        torch.ones((18, 8)), torch.zeros((18, 8)))[1]


def _k2c():
    lctx = _class_box(False)
    return lat.jacobian_volume(lctx, torch.zeros((6, 8)), *_phys_scheme(), torch.ones((16, 8)),
                               torch.zeros((16, 8)))


def _k2c_implicit():
    lctx = _class_box(True)
    return lat.jacobian_volume_classes(lctx, torch.zeros((6, 8)), *_phys_scheme(),
                                       torch.ones((18, 8)), torch.zeros((18, 8)))[1]


def _k7():
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    return win_kernels.winell_matvec(WinELLMatrixT(torch.zeros((18, 2)), plan), torch.zeros((6, 2)))


def _k7_halo():
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    plan.col_t[1] = 3  # row 1 couples to a ghost column of the (6, 4) local vector
    return win_kernels.winell_matvec_halo(WinELLMatrixT(torch.zeros((18, 2)), plan),
                                          torch.zeros((6, 4)))


def _k7_f64():
    plan = build_winell_plan([0, 1, 2], [0, 1], 2, device="cpu")
    mat = WinELLMatrixT(torch.zeros((18, 2), dtype=torch.float64), plan)
    return win_kernels.winell_matvec(mat, torch.zeros((6, 2), dtype=torch.float64))


def _k3(dtype):
    def call():
        z = lambda *shape: torch.zeros(shape, dtype=dtype)
        return dia_kernels.dia_matvec(z(1, 16, 4), z(2, 4), z(6, 4), (0,))

    return call


def _k3_wide(dtype):
    """K3 with 27 planes, more than the Kuhn lattice's 15."""
    def call():
        z = lambda *shape: torch.zeros(shape, dtype=dtype)
        return dia_kernels.dia_matvec(z(27, 16, 40), z(54, 40), z(6, 40),
                                      tuple(dx + 3 * dy + 9 * dz for dz in (-1, 0, 1)
                                            for dy in (-1, 0, 1) for dx in (-1, 0, 1)))

    return call


def _k3_banded():
    """K3's banded entry (a rank of the z-slab decomposition): 4 own rows,
    x with a band of 2 nodes each side."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    return dia_kernels.dia_matvec_banded(z(3, 16, 4), z(6, 4), z(6, 8), (-2, 0, 2), 2)


def _k3_banded_f64():
    """K3's float64 banded entry (krylov.precision "f64" / "ir" on a rank's
    slab)."""
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)
    return dia_kernels.dia_matvec_banded(z(3, 16, 4), z(6, 4), z(6, 8), (-2, 0, 2), 2)


def _k8():
    plan = win_stream.build_reduce_plan([0, 1, 1], [0, 1, 2], 2, device="cpu")
    return win_stream.stream_reduce(plan, torch.zeros((6, 3)))


def _k9():
    plan = win_stream.build_reduce_plan([0, 1, 1], [0, 1, 2], 2, device="cpu")
    return win_ring.ring_reduce(plan, torch.zeros((16, 3)))


def _k8_one_row():
    """K8 with one output row: the one-pass entry (dedflow_gather_sum)."""
    plan = win_stream.build_reduce_plan([0, 1, 1], [0, 1, 2], 2, device="cpu")
    return win_stream.stream_reduce(plan, torch.zeros((1, 3)))


def _k9_one_row():
    plan = win_stream.build_reduce_plan([0, 1, 1], [2, 1, 0], 2, device="cpu")
    return win_ring.ring_reduce(plan, torch.zeros((1, 3)))


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
    return win_gather.win_gather(ien, torch.zeros((27, 8)), 12, torch.zeros((5, 6)))


def _k10_residual():
    ien = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.zeros((5, 6))
    return win_gather.win_gather(ien, torch.zeros((67, 8)), 19, w, w, torch.zeros(5),
                                 geom=torch.zeros((19, 8)))


def _stream():
    return torch.zeros((8, 512)), torch.zeros((8, 512), dtype=torch.int32)


def _k12_copy():
    return tgm.copy2(_stream()[0])


def _k12_lane(idiom):
    return lambda: tgm.lane_gather(*_stream(), idiom)


def _k12_window():
    return tgm.window_gather(*_stream(), 2)


def _k12_reduce():
    return tgm.segment_reduce(*_stream(), 16)


def _k12_bins():
    return tgm.segment_reduce(*_stream(), 2)


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
        (_k12_bins, (tgm, "segment_reduce_plain")),
        (_k10_residual, (win_gather, "win_gather_plain")),
        (_k13("global"), (tgp, "element_gather_plain")),
        (_k13("staged"), (tgp, "element_gather_plain")),
        (_k6_staged, (ek, "lhs_rows_staged_plain")),
        (_k6_staged_implicit, (ek, "lhs_rows_staged_plain")),
        (_k5_staged, (ek, "ns_lhs_gather_staged_plain")),
        (_k5_staged_implicit, (ek, "ns_lhs_gather_staged_plain")),
        (_k9_segment_sum, (win_ring, "ring_reduce_staged_plain")),
        (_k4_staged, (ek, "ns_residual_gather_staged_plain")),
        (_k8_segment_sum, (win_stream, "stream_reduce_staged_plain")),
        (_k1c, (lat, "residual_volume_plain")),
        (_k1c_routed, (lat, "residual_volume_plain")),
        (_k2c, (lat, "jacobian_volume_plain")),
        (_k2c_implicit, (lat, "jacobian_volume_plain")),
        (_k3_wide(torch.float32), (dia_kernels, "dia_matvec_plain")),
        (_k3_wide(torch.float64), (dia_kernels, "dia_matvec_plain")),
        (_k1c_two_pass, (lat, "residual_volume_plain")),
        (_k2c_two_pass, (lat, "jacobian_volume_plain")),
        (_k8_one_row, (win_stream, "seg_reduce_plain")),
        (_k9_one_row, (win_ring, "seg_reduce_plain")),
        (_k3_banded, (dia_kernels, "dia_matvec_banded_plain")),
        (_k7_halo, (win_kernels, "winell_matvec_plain")),
    ],
    ids=["K6-res", "K6-lhs", "K7", "K7-f64", "K3", "K3-f64", "K8", "K9", "K11", "K4", "K5", "K10", "K1-source",
         "K2-implicit", "K6-lhs-implicit", "K5-implicit", "K12-copy", "K12-lane-smem",
         "K12-lane-shuffle", "K12-window", "K12-reduce", "K12-reduce-bins", "K10-residual",
         "K13-global", "K13-staged",
         "K6-staged", "K6-staged-implicit", "K5-staged", "K5-staged-implicit",
         "K9-segment-sum", "K4-staged", "K8-segment-sum", "K1c", "K1c-routed", "K2c",
         "K2c-implicit", "K3-wide", "K3-wide-f64", "K1c-two-pass", "K2c-two-pass",
         "K8-one-row", "K9-one-row", "K3-banded", "K7-halo"],
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


@pytest.mark.parametrize("rows,symbol", [(1, "dedflow_gather_sum"), (6, "dedflow_stream_reduce"),
                                         (16, "dedflow_ring_reduce")])
def test_one_row_reduces_take_the_one_pass_entry(monkeypatch, rows, symbol):
    """On a CUDA tensor, K8 / K9 with one output row launch the one-pass
    entry and allocate only their output (no (K, 8) staging buffer); more
    rows keep the staged entries. The launch is faked: no card here."""
    plan = win_stream.build_reduce_plan([0, 1, 1, 2], [0, 1, 2, 3], 3, device="cpu")
    asked, shapes = [], []
    real_empty = torch.empty

    def function(name, sym, argtypes):
        asked.append((name, sym))
        return lambda *a: 0

    def empty(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(nvcc, "function", function)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch, "empty", empty)
    wrapper = win_stream.stream_reduce if rows <= 8 else win_ring.ring_reduce
    before = wrapper.launches
    out = wrapper(plan, torch.zeros((rows, 4)))
    assert asked == [("seg_reduce", symbol)] and out.shape == (rows, 3)
    assert wrapper.launches == before + 1
    assert shapes == ([(1, 3)] if rows == 1 else [(rows, 3), (4, 8 * -(-rows // 8))])


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
     (_k3(torch.float64), (dia_kernels, "dia_matvec_f64")),
     (_k1c, (lat, "residual_volume_classes")), (_k2c, (lat, "jacobian_volume_classes")),
     (_k2c_implicit, (lat, "jacobian_volume_classes")),
     (_k3_wide(torch.float32), (dia_kernels, "dia_matvec")),
     (_k3_wide(torch.float64), (dia_kernels, "dia_matvec_f64")),
     (_k1c_two_pass, (lat, "residual_volume_two_pass")),
     (_k2c_two_pass, (lat, "jacobian_volume_two_pass")),
     (_k8_one_row, (win_stream, "stream_reduce")), (_k9_one_row, (win_ring, "ring_reduce")),
     (_k3_banded, (dia_kernels, "dia_matvec_banded")), (_k10_residual, (win_gather, "win_gather")),
     (_k12_bins, (tgm, "segment_reduce")), (_k7_halo, (win_kernels, "winell_matvec_halo")),
     (_k3_banded_f64, (dia_kernels, "dia_matvec_banded_f64"))],
    ids=["K4", "K5", "K10", "K12-copy", "K12-lane", "K12-window", "K12-reduce", "K13",
         "K6-staged", "K5-staged", "K9-segment-sum", "K4-staged", "K8-segment-sum",
         "K7-f64", "K3-f64", "K1c", "K2c", "K2c-implicit", "K3-wide", "K3-wide-f64",
         "K1c-two-pass", "K2c-two-pass", "K8-one-row", "K9-one-row", "K3-banded",
         "K10-residual", "K12-reduce-bins", "K7-halo", "K3-banded-f64"],
)
def test_cpu_tensors_count_no_launch(call, counter):
    """On CPU tensors the wrappers run their plain twins and count nothing
    (K2c's implicit-mode count included)."""
    fn = getattr(*counter)
    counts = lambda: (fn.launches, getattr(fn, "implicit_launches", 0))
    before = counts()
    assert call() is not None
    assert counts() == before


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
