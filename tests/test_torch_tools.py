"""dedflow_tpu_torch's check tools and small helpers (ROADMAP A18, A19) ==
the JAX package, on the CPU.

- A19: io.h5.state_to_reference_flat / reference_flat_to_state equal to
  the JAX package's bit for bit (float32 and float64) and inverse to each
  other; mesh.gen.single_tet_mesh equal to the JAX package's.
- tools.mesh_convert: with one in-memory stand-in for meshio's mesh (two
  tetra blocks, wedges, a hexahedron, physically tagged triangles, and a
  vertex block the converters skip) in sys.modules["meshio"], the port's
  `from_meshio` gives the JAX tool's Mesh array for array, and both
  tools' `main` write HDF5 files equal dataset by dataset; no module of
  the port imports meshio (or JAX) when it is imported. The port's CLI
  steps that file with `--mesh` on the CPU, on the JAX ladder's tier.
- tools.residual_check: the float64 J and F it assembles on the CPU equal
  the JAX tool's host assembly at 1e-12 (box 4); both solves pass the
  1e-10 bar with the plain versions; `--out` writes the printed line.
- tools.nonlinear_f64_check and tools.selfcheck at box 4 / n = 5 on the
  CPU: their records, the float32 steps within 1e-4 of the float64 one,
  the plain "kernels" equal to their plain versions.
"""

import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

from functools import partial

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.fem import ns as jns
from dedflow_tpu.fem.lattice import assemble_jacobian_t, assemble_residual_t, build_lattice_context
from dedflow_tpu.io import h5 as jh5
from dedflow_tpu.mesh import gen as jgen
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.io import h5 as th5
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.tools import mesh_convert, nonlinear_f64_check, residual_check, selfcheck

ROOT = Path(__file__).resolve().parents[1]


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


# ---------------------------------------------------------------------------
# A19


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_reference_flat_layout_matches_jax(dtype):
    state = np.random.default_rng(1).standard_normal((7, 6)).astype(dtype)
    flat = th5.state_to_reference_flat(state)
    ref = jh5.state_to_reference_flat(state)
    assert flat.dtype == ref.dtype == dtype and np.array_equal(flat, ref)
    back = th5.reference_flat_to_state(flat)
    assert back.dtype == dtype and np.array_equal(back, jh5.reference_flat_to_state(ref))
    assert np.array_equal(back, state)
    # u node-interleaved, then p, phi, T
    assert np.array_equal(flat[:3], state[0, :3]) and np.array_equal(flat[21:28], state[:, 3])


def test_single_tet_mesh_matches_jax():
    got, ref = tgen.single_tet_mesh(), jgen.single_tet_mesh()
    for field in ("xg", "ien"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.boundaries == ref.boundaries == [] and got.lattice is None


# ---------------------------------------------------------------------------
# mesh_convert


class _CellBlock:
    def __init__(self, kind, data):
        self.type, self.data = kind, np.asarray(data)


def _meshio_standin():
    """A meshio mesh as Gmsh gives it: the tets of a 3 x 2 x 2 box in two
    tetra blocks, a prism layer on z-, one hexahedron, the six sides'
    triangles tagged 1..6 (two blocks), and a vertex block."""
    m = tgen.mixed_box_mesh(3, 2, 2, hexes=True, prism_layers=1)
    tri = [(b.ien, np.full(b.num_facet, k + 1)) for k, b in enumerate(m.boundaries)]
    tri_a = np.concatenate([t for t, _ in tri[:3]]), np.concatenate([g for _, g in tri[:3]])
    tri_b = np.concatenate([t for t, _ in tri[3:]]), np.concatenate([g for _, g in tri[3:]])
    half = m.num_tet // 2
    cells = [_CellBlock("tetra", m.ien[:half]), _CellBlock("triangle", tri_a[0]),
             _CellBlock("wedge", m.ien_prism), _CellBlock("vertex", [[0], [5]]),
             _CellBlock("tetra", m.ien[half:]), _CellBlock("hexahedron", m.ien_hex[:1]),
             _CellBlock("triangle", tri_b[0])]
    tags = [np.zeros(half), tri_a[1], np.zeros(m.num_prism), np.zeros(2),
            np.zeros(m.num_tet - half), np.zeros(1), tri_b[1]]
    mesh = types.SimpleNamespace(points=m.xg, cells=cells, cell_data={"gmsh:physical": tags})
    return mesh, m


@pytest.fixture
def meshio_standin(monkeypatch):
    mesh, source = _meshio_standin()
    monkeypatch.setitem(sys.modules, "meshio", types.SimpleNamespace(read=lambda path: mesh))
    return source


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_mesh_convert",
                                                  ROOT / "tools" / "mesh_convert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_mesh_convert_matches_the_jax_tool(tmp_path, meshio_standin):
    jtool = _jax_tool()
    got, ref = mesh_convert.from_meshio("in.msh"), jtool.from_meshio("in.msh")
    pairs = [(getattr(got, f), getattr(ref, f)) for f in ("xg", "ien", "ien_prism", "ien_hex")]
    assert len(got.boundaries) == len(ref.boundaries) == 6
    pairs += [(getattr(a, f), getattr(b, f)) for a, b in zip(got.boundaries, ref.boundaries)
              for f in ("nodes", "ien", "f2e", "forn")]
    for a, b in pairs:
        assert a.dtype == b.dtype and np.array_equal(a, b)
    src = meshio_standin
    assert np.array_equal(got.ien, src.ien) and np.array_equal(got.ien_prism, src.ien_prism)
    assert np.array_equal(got.ien_hex, src.ien_hex[:1])
    for a, b in zip(got.boundaries, src.boundaries):  # tag k + 1 is the box's side k
        assert np.array_equal(a.f2e, b.f2e) and np.array_equal(a.forn, b.forn)
    got.validate()
    paths = [str(tmp_path / f"{name}.h5") for name in ("port", "jax")]
    assert mesh_convert.main(["in.msh", paths[0]]) == 0
    assert jtool.main(["in.msh", paths[1]]) == 0
    port, jax_ = _datasets(paths[0]), _datasets(paths[1])
    assert sorted(port) == sorted(jax_) and "mesh/ien/prism" in port and "mesh/ien/hex" in port
    for name in port:
        assert port[name].dtype == jax_[name].dtype and np.array_equal(port[name], jax_[name]), name


def test_mesh_convert_without_meshio_exits(monkeypatch):
    monkeypatch.setitem(sys.modules, "meshio", None)  # import meshio raises ImportError
    with pytest.raises(SystemExit, match="meshio is required"):
        mesh_convert.from_meshio("in.msh")


def test_port_tools_import_neither_meshio_nor_jax():
    code = (
        "import sys\n"
        "import dedflow_tpu_torch.tools.mesh_convert, dedflow_tpu_torch.tools.residual_check, "
        "dedflow_tpu_torch.tools.nonlinear_f64_check, dedflow_tpu_torch.tools.selfcheck\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('meshio', 'jax', 'dedflow_tpu', "
        "'h5py')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_cli_steps_a_converted_mixed_mesh(tmp_path, capsys, meshio_standin):
    """The converted file through --mesh: recovery skips a mixed mesh, the
    tier is the JAX NSSolver's on the same file, one finite step."""
    path = str(tmp_path / "mixed.h5")
    assert mesh_convert.main(["in.msh", path]) == 0
    capsys.readouterr()
    rc = tmain.main(["--mesh", path, "--steps", "1", "--device", "cpu", "--dtype", "f64",
                     "--out", str(tmp_path)])
    out = capsys.readouterr()
    recs = [json.loads(ln) for ln in out.out.splitlines() if ln.startswith("{")]
    assert rc == 0 and len(recs) == 1 and np.isfinite(recs[0]["field_norms"]).all()
    assert "no structured lattice recovered" in out.err
    ref = jnt.NSSolver(jh5.read_mesh_h5(path), jsc.reference_scenario_config()).fastpath
    assert recs[0]["fastpath"] == ref


# ---------------------------------------------------------------------------
# the check tools


def test_residual_check_assembles_the_jax_tools_system(tmp_path, capsys):
    """J and F as the JAX tool assembles them on its host (NSSolver +
    build_lattice_context(rows_backend="xla"), float64; its functions
    jitted, one compile each), 1e-12; the solves pass the bar; main prints
    and writes one line."""
    n = 4
    j, f, mesh = residual_check.assemble_f64(n)
    jmesh = jgen.box_mesh(n, n, n)
    cfg = jsc.reference_scenario_config()
    js = jnt.NSSolver(jmesh, cfg, dtype=jnp.float64)
    lctx = build_lattice_context(jmesh, dtype=jnp.float64, rows_backend="xla")
    wa, dwa = jns.alpha_states(*(jnp.asarray(a) for a in jsc.reference_initial_state(jmesh)),
                               cfg.time)
    args = (lctx, js.face_ctxs, js.mask, wa, dwa)
    kw = dict(phys=cfg.physics, scheme=cfg.time)
    assert rel(f.numpy(), np.asarray(jax.jit(partial(assemble_residual_t, **kw))(*args))) < 1e-12
    assert rel(j.to_block_dense(),
               jax.jit(partial(assemble_jacobian_t, **kw))(*args).to_block_dense()) < 1e-12
    out = tmp_path / "res.json"
    assert residual_check.main([str(n), "--device", "cpu", "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip()
    doc = json.loads(line)
    assert out.read_text().strip() == line
    assert doc["pass"] and doc["device"] == "cpu" and doc["card"] is None
    assert doc["num_tet"] == mesh.num_tet == 6 * n**3
    assert doc["f64_gmres_rel_residual"] <= 1e-10 and doc["ir_rel_residual"] <= 1e-10
    assert doc["ir_cycles"] >= 1 and doc["f64_gmres_iters"] > 0


def test_nonlinear_check_record():
    doc = nonlinear_f64_check.nonlinear_check(4, 1, "cpu")
    assert doc["device_f64"] is None and "A9" in doc["device_f64_absent"]
    assert doc["num_tet"] == 384 and doc["card"] is None
    for run in ("cpu_f64", "device_ir", "device_f32"):
        r = doc[run]
        assert r["fastpath"] == "lattice" and len(r["field_norms"]) == len(r["wall_s"]) == 1
        assert np.isfinite(r["field_norms"]).all()
    for run in ("device_ir", "device_f32"):
        assert doc[run]["rel_state_diff_vs_cpu_f64"] < 1e-4
    assert doc["device_f32"]["newton_iters"] == doc["cpu_f64"]["newton_iters"]
    json.dumps(doc)


def test_selfcheck_record():
    doc = selfcheck.selfcheck(5, "cpu")
    assert doc["pass"] and doc["fastpath"] == "lattice" and doc["num_tet"] == 6 * 5 * 3 * 4
    assert set(doc["checks"]) == {"K1", "K2", "K2'"}
    for c in doc["checks"].values():
        assert c["repeat_bitwise"] and c["rel"] == 0.0 and c["tol"] == 2e-5
