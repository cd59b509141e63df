"""dedflow_tpu_torch mesh files, lattice recovery and the tier ladder ==
the JAX package.

- detect_delta_classes and recover_lattice (mesh.recover): keys, classes,
  bases, the permuted mesh and the node permutation exactly equal to the
  JAX package's, on a shuffled box with and without grading or mirroring
  (mesh.gen.shuffled_mesh, the mesh of the JAX package's
  tests/test_recover.py); both refuse a deformed and an unstructured mesh.
- The tier: the port's NSSolver `fastpath` equals the JAX NSSolver's on each
  mesh and use_lattice mode ("off" ignores a box's metadata and finds its
  classes; an unstructured numbering falls to WinELL or gather; "on" raises
  on both without a stencil).
- HDF5 (io.h5, needs h5py): the port's write_mesh_h5 read by the JAX
  read_mesh_h5 and the other way round, every array exactly equal, prism
  and hex tables kept.
- The CLI: --mesh on a shuffled box file steps on the recovered lattice,
  --no-lattice-recover on a box file without metadata on the classes
  tier; --mesh with --box, and --mesh with the coupled scenario, are
  refused.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.fem import lattice as jlat
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.mesh.mesh import Boundary, Mesh
from dedflow_tpu.mesh.recover import recover_lattice as jrecover
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import mesh as tmesh_mod
from dedflow_tpu_torch.mesh.recover import recover_lattice as trecover
from dedflow_tpu_torch.solver import newton as tnt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


def _port_mesh(m: Mesh) -> tmesh_mod.Mesh:
    """The port's copy of a JAX mesh (the same arrays)."""
    tets = getattr(m, "lattice_tets", None)
    return tmesh_mod.Mesh(
        xg=np.asarray(m.xg).copy(), ien=np.asarray(m.ien).copy(),
        boundaries=[tmesh_mod.Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                    for b in m.boundaries],
        lattice=m.lattice, lattice_tets=None if tets is None else np.asarray(tets).copy(),
        ien_prism=m.ien_prism, ien_hex=m.ien_hex,
    )


def _jax_mesh(m: tmesh_mod.Mesh) -> Mesh:
    """The JAX package's copy of a port mesh (the same arrays)."""
    return Mesh(
        xg=m.xg.copy(), ien=m.ien.copy(),
        boundaries=[Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                    for b in m.boundaries],
        lattice=m.lattice, lattice_tets=None if m.lattice_tets is None else m.lattice_tets.copy(),
        ien_prism=m.ien_prism, ien_hex=m.ien_hex,
    )


REF = jsc.reference_scenario_config()


# ---------------------------------------------------------------------------
# detection and recovery


MESHES = {
    "deformed": lambda: _jax_mesh(tgen.deformed_mesh(tgen.box_mesh(4, 3, 3))),
    "box": lambda: box_mesh(3, 3, 2),
    "shuffled": lambda: _jax_mesh(tgen.shuffled_mesh(tgen.box_mesh(3, 3, 2), seed=4)),
    "recovered": lambda: jrecover(_jax_mesh(
        tgen.shuffled_mesh(tgen.box_mesh(3, 3, 2), seed=1, mirror=True)))[0],
}


@pytest.mark.parametrize("name", ["deformed", "box", "shuffled"])
def test_detect_delta_classes_matches_jax(name):
    mesh = MESHES[name]()
    ref = jlat.detect_delta_classes(np.asarray(mesh.ien))
    got = tlat.detect_delta_classes(np.asarray(mesh.ien))
    if name == "shuffled":  # a random numbering is not translation-regular
        assert ref is None and got is None
        return
    assert got[0].shape == (6, 4)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("grade,mirror", [(False, False), (True, False), (False, True),
                                          (True, True)], ids=["plain", "graded", "mirrored",
                                                              "graded-mirrored"])
def test_recover_lattice_matches_jax(grade, mirror):
    shuf = _jax_mesh(tgen.shuffled_mesh(tgen.box_mesh(4, 3, 5), seed=2, grade=grade,
                                        mirror=mirror))
    jm, jperm = jrecover(shuf)
    tm, tperm = trecover(_port_mesh(shuf))
    np.testing.assert_array_equal(tperm, jperm)
    assert tm.lattice == jm.lattice == (4, 3, 5)
    np.testing.assert_array_equal(tm.lattice_tets, jm.lattice_tets)
    np.testing.assert_array_equal(tm.xg, jm.xg)
    np.testing.assert_array_equal(tm.ien, jm.ien)
    for tb, jb in zip(tm.boundaries, jm.boundaries, strict=True):
        for f in ("nodes", "ien", "f2e", "forn"):
            np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    assert tlat.is_kuhn_split(tm.lattice_tets) is False


@pytest.mark.parametrize("which", ["deformed", "delaunay"])
def test_recover_lattice_refuses_what_jax_refuses(which):
    mesh = (_jax_mesh(tgen.deformed_mesh(tgen.box_mesh(3, 3, 3))) if which == "deformed"
            else delaunay_mesh(60, seed=2))
    assert jrecover(mesh) is None and trecover(_port_mesh(mesh)) is None
    if which == "delaunay":
        assert tlat.build_class_context(_port_mesh(mesh), "cpu", torch.float64) is None


# ---------------------------------------------------------------------------
# tier choice


TIER_CASES = [
    ("deformed", "auto"), ("deformed", "on"), ("deformed", "off"), ("box", "off"),
    ("box", "auto"), ("recovered", "auto"), ("recovered", "off"), ("shuffled", "auto"),
    ("shuffled", "off"),
]


@pytest.mark.parametrize("mesh_name,mode", TIER_CASES, ids=[f"{m}-{k}" for m, k in TIER_CASES])
def test_tier_choice_matches_jax(mesh_name, mode):
    """The JAX NSSolver's `fastpath` on each mesh and use_lattice mode:
    "off" ignores the box's metadata and finds its classes; an unstructured
    numbering falls to WinELL or gather."""
    mesh = MESHES[mesh_name]()
    cfg = dataclasses.replace(REF, use_lattice=mode)
    js = jnt.NSSolver(mesh, cfg)
    ts = tnt.NSSolver(_port_mesh(mesh), _tcfg(cfg), device="cpu")
    assert ts.fastpath == js.fastpath
    if ts.fastpath in ("lattice", "classes"):
        assert ts.lctx.deltas == js.lctx.deltas and ts.lctx.offsets == js.lctx.offsets


def test_use_lattice_on_refuses_a_mesh_without_a_stencil():
    mesh = _jax_mesh(tgen.shuffled_mesh(tgen.box_mesh(2, 2, 2), seed=5))
    cfg = dataclasses.replace(REF, use_lattice="on")
    with pytest.raises(ValueError, match="does not match"):
        jnt.NSSolver(mesh, cfg)
    with pytest.raises(ValueError, match="does not match"):
        tnt.NSSolver(_port_mesh(mesh), _tcfg(cfg), device="cpu")


# ---------------------------------------------------------------------------
# HDF5 files


def _mesh_with_every_table() -> Mesh:
    """A shuffled box with its boundary tables, and prism and hex tables
    (the schema's stencil-only slots)."""
    m = _jax_mesh(tgen.shuffled_mesh(tgen.box_mesh(3, 2, 2), seed=6))
    rng = np.random.default_rng(6)
    return Mesh(xg=m.xg, ien=m.ien, boundaries=m.boundaries,
                ien_prism=rng.integers(0, m.num_node, (5, 6)),
                ien_hex=rng.integers(0, m.num_node, (3, 8)))


def _same_mesh(a, b, dtypes: bool = True) -> None:
    """Every array of meshes a and b equal, and with `dtypes` of one dtype."""
    pairs = [(getattr(a, f), getattr(b, f)) for f in ("xg", "ien", "ien_prism", "ien_hex")]
    assert len(a.boundaries) == len(b.boundaries) > 0
    pairs += [(getattr(ba, f), getattr(bb, f)) for ba, bb in zip(a.boundaries, b.boundaries)
              for f in ("nodes", "ien", "f2e", "forn")]
    for x, y in pairs:
        assert not dtypes or x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_files_cross_between_the_packages(tmp_path, writer):
    """A file written by either package reads back the same in both, and
    as the mesh written."""
    pytest.importorskip("h5py")
    from dedflow_tpu.io import h5 as jh5
    from dedflow_tpu_torch.io import h5 as th5

    mesh = _mesh_with_every_table()
    path = str(tmp_path / "mesh.h5")
    if writer == "port":
        th5.write_mesh_h5(path, _port_mesh(mesh))
    else:
        jh5.write_mesh_h5(path, mesh)
    got, ref = th5.read_mesh_h5(path), jh5.read_mesh_h5(path)
    assert isinstance(got, tmesh_mod.Mesh)
    assert got.lattice is None and got.lattice_tets is None
    _same_mesh(got, ref)
    _same_mesh(got, mesh, dtypes=False)
    got.validate()


# ---------------------------------------------------------------------------
# the CLI


def _cli(capsys, argv, out):
    rc = tmain.main(argv + ["--steps", "1", "--device", "cpu", "--dtype", "f64", "--out", str(out)])
    out = capsys.readouterr()
    recs = [json.loads(ln) for ln in out.out.splitlines() if ln.startswith("{")]
    return rc, recs, out.err


def test_cli_mesh_file_steps_on_the_recovered_lattice(tmp_path, capsys):
    pytest.importorskip("h5py")
    from dedflow_tpu.io.h5 import write_mesh_h5

    path = str(tmp_path / "shuffled.h5")
    write_mesh_h5(path, _jax_mesh(tgen.shuffled_mesh(tgen.box_mesh(3, 2, 2), seed=7,
                                                     mirror=True)))
    rc, recs, err = _cli(capsys, ["--mesh", path], tmp_path)
    assert rc == 0 and len(recs) == 1
    assert recs[0]["fastpath"] == "lattice" and all(np.isfinite(recs[0]["field_norms"]))
    assert "36 nodes, 72 tets" in err and "recovered 3x2x2 lattice (6 tets/cell)" in err


def test_cli_no_lattice_recover_runs_the_classes_tier(tmp_path, capsys):
    pytest.importorskip("h5py")
    from dedflow_tpu.io.h5 import write_mesh_h5

    path = str(tmp_path / "box.h5")
    write_mesh_h5(path, box_mesh(3, 2, 2))  # the file carries no lattice metadata
    rc, recs, err = _cli(capsys, ["--mesh", path, "--no-lattice-recover"], tmp_path)
    assert rc == 0 and recs[0]["fastpath"] == "classes" and "recovered" not in err
    rc, recs, err = _cli(capsys, ["--mesh", path], tmp_path)
    assert rc == 0 and recs[0]["fastpath"] == "lattice" and "recovered 3x2x2" in err


def test_cli_refuses_mesh_with_box():
    with pytest.raises(SystemExit):
        tmain._parser().parse_args(["--mesh", "m.h5", "--box", "2", "2", "2"])
    assert tmain._parser().parse_args(["--mesh", "m.h5"]).mesh == "m.h5"


def test_cli_runs_the_coupled_scenario_on_generated_boxes_only(tmp_path, capsys):
    """The coupled scenario's particle locator assumes the Kuhn split of a
    generated box: a --mesh file is refused before any work."""
    pytest.importorskip("h5py")
    from dedflow_tpu.io.h5 import write_mesh_h5

    path = str(tmp_path / "box.h5")
    write_mesh_h5(path, box_mesh(2, 2, 2))
    rc, recs, err = _cli(capsys, ["--mesh", path, "--scenario", "coupled"], tmp_path)
    assert rc == 2 and recs == [] and "generated boxes only" in err
