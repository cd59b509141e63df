"""dedflow_tpu_torch's multi-device path (ROADMAP A16, first slice) on gloo
ranks on the CPU, float64.

A box cut into z-slabs over 2 and 3 ranks (parallel.sharded.ShardedNSSolver):
one spawn per world size (a module fixture) runs every case on the ranks
(tests/torch_sharded_ranks.py) and writes the gathered arrays to a file;
the cases below are asserts on it, against the port's one-process solver
and the JAX package's one-device functions (which tests/test_sharding.py
holds equal to its shard_map functions), relative error max|got - ref| /
max|ref|:

- F, J (DIA data and scal rows: masked, with the facet band of the weak
  z+ wall on the last rank) at 1e-12, and the same with a weak x+ face,
  whose facets cross every seam; the K3 product and the field-split apply
  at 1e-12;
- GMRES with all-reduced inner products: the one-process iterate (1e-9)
  and count, the same count and residual history on every rank;
- step_fixed(num_newton=2) and step within 1e-9 of the JAX one-device
  step, with equal Newton and Krylov counts;
- the CLI's --devices run writes the one-process run's snapshots; the
  dry run's step; dryrun_multichip(2) itself on the CPU.

Without spawning: the partition functions bit-equal to the JAX package's,
the z-slab cut, K3's banded plain twin against the whole matrix's rows,
the refused options, the launcher's failure and timeout paths and the
kernel build's file lock across two processes.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_sharded_ranks as ranks_mod
from torch_sharded_ranks import BOX, CLI_STEPS, CONFIGS, case_state, cli_argv, probe_vector

from dedflow_tpu.app.scenarios import box_channel_bcs as j_box_channel_bcs
from dedflow_tpu.app.scenarios import reference_scenario_config as j_reference_config
from dedflow_tpu.config import BCSpec as JBCSpec
from dedflow_tpu.mesh.gen import box_mesh as j_box_mesh
from dedflow_tpu.parallel import partition as jpart
from dedflow_tpu.solver.newton import NSSolver as JNSSolver
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JPC
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu_torch.fem.lattice import slab_layers
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS, box_mesh
from dedflow_tpu_torch.parallel import launch
from dedflow_tpu_torch.parallel import partition as tpart
from dedflow_tpu_torch.parallel.dryrun import dryrun_multichip
from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
from dedflow_tpu_torch.solver.krylov import gmres as tgmres
from dedflow_tpu_torch.solver.newton import NSSolver as TNSSolver
from dedflow_tpu_torch.solver.newton import assemble_system, residual
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec_banded_plain, dia_matvec_plain
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT

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
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module", params=(2, 3), ids=("w2", "w3"))
def ranks(request, tmp_path_factory):
    """(world, gathered arrays, output directory) of one spawn of `world`
    gloo ranks running every case (torch_sharded_ranks.scenarios)."""
    world = request.param
    out = tmp_path_factory.mktemp(f"sharded{world}")
    launch.spawn(ranks_mod.scenarios, world, "cpu", args=(str(out),), timeout=300)
    return world, dict(np.load(out / f"w{world}.npz")), out


def jax_steps(js, state, num_newton=2):
    """The JAX package's step and step_fixed(num_newton) from its solver's
    jitted pieces, one compile of its Newton iteration serving both
    (tests/test_torch_classes.py::jax_steps). Returns ((wgold, dwgold,
    dwg), krylov_iters, newton count) of the adaptive step and the fixed
    step's three states."""
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    newton = js.cfg.newton

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d)
        rnorm0 = js._norms(f) + 1e-16
        kits = []
        for _ in range(num):
            d, f, rn, kit, _ = js._newton_iter(*c, wg, dwo, d, f)
            kits.append(int(kit))
            if adaptive and bool(jnp.all((rn < newton.rtol * rnorm0) | (rn < newton.atol))):
                break
        return (*js._update(wg, dwo, d), d), kits

    return run(newton.max_iter, True), run(num_newton, False)[0]


JAX_CONFIGS = {
    "ref": j_reference_config,
    "weakx": lambda: j_reference_config(bcs=j_box_channel_bcs() + (JBCSpec(boundary=1, weak=True),)),
}


@pytest.fixture(scope="module")
def refs():
    """Per configuration: the one-process port's and the JAX one-device
    solver's F and dense J at the case's state, and the port's J and
    preconditioner; the state as numpy and as port tensors."""
    tmesh, jmesh = box_mesh(*BOX), j_box_mesh(*BOX)
    state = case_state(tmesh)
    tstate = interop.state_from_numpy(*state, device="cpu")
    out = {}
    for name, make in CONFIGS.items():
        cfg, jc = make(), JAX_CONFIGS[name]()
        ts = TNSSolver(tmesh, cfg, device="cpu")
        jm, pc = assemble_system(ts.lctx, ts.face_ctxs, ts.mask_t, *tstate, cfg.physics, cfg.time)
        js = JNSSolver(jmesh, jc)
        # its jitted residual and assembly (assemble_residual_t /
        # assemble_jacobian_t at the alpha states; the residual's compile
        # also serves jax_steps)
        c, jstate = (js.solve_ctx, js.face_ctxs, js.mask), [jnp.asarray(a) for a in state]
        jf, (jj, _) = js._residual(*c, *jstate), js._assemble_system(*c, *jstate)
        out[name] = dict(ts=ts, js=js, jm=jm, pc=pc, jj=jj, port_F=residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tstate, cfg.physics, cfg.time,
                                         cfg.freeze_phi_temperature).numpy(),
                         port_J=jm.to_block_dense(), jax_F=np.asarray(jf),
                         jax_J=jj.to_block_dense())
    return state, tstate, out


def _dense(got: dict, name: str, offsets) -> np.ndarray:
    return FSDIAMatrixT(data=torch.as_tensor(got[f"{name}_data"]),
                        scal=torch.as_tensor(got[f"{name}_scal"]), offsets=offsets).to_block_dense()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_residual_matches_one_process_and_jax(ranks, refs, name):
    _, got, _ = ranks
    ref = refs[2][name]
    assert rel(got[f"{name}_F"], ref["port_F"]) < 1e-12
    assert rel(got[f"{name}_F"], ref["jax_F"]) < 1e-12


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jacobian_matches_one_process_and_jax(ranks, refs, name):
    """The gathered DIA data and scal rows: masked (constrained rows stay
    identity rows after the carry), with the facet band."""
    _, got, _ = ranks
    ref = refs[2][name]
    dense = _dense(got, name, ref["jm"].offsets)
    assert rel(dense, ref["port_J"]) < 1e-12
    assert rel(dense, ref["jax_J"]) < 1e-12
    assert rel(got[f"{name}_scal"], ref["jm"].scal.numpy()) < 1e-12


def test_weak_x_face_spans_every_rank(ranks):
    """The weak x+ face's facets lie on every rank, so their rows reach
    the seams: its F and J differ from the reference scenario's there."""
    _, got, _ = ranks
    mesh = box_mesh(*BOX)
    x_plus = np.unique(mesh.boundaries[1].ien)
    layers = np.unique(x_plus // ((BOX[0] + 1) * (BOX[1] + 1)))
    assert layers.tolist() == list(range(BOX[2] + 1))
    assert not np.allclose(got["weakx_F"], got["ref_F"])


@pytest.mark.parametrize("what", ["Ax", "Px"])
def test_product_and_preconditioner_match(ranks, refs, what):
    """K3's banded product (a band exchange each side) and the field-split
    apply (node-local) on a seeded vector."""
    _, got, _ = ranks
    ref = refs[2]["ref"]
    x = probe_vector(box_mesh(*BOX).num_node)
    jj = ref["jj"]
    if what == "Ax":
        port, jax_ = ref["jm"].matvec_t(torch.as_tensor(x)), jj.matvec_t(jnp.asarray(x))
    else:
        port, jax_ = ref["pc"](torch.as_tensor(x)), JPC.from_diag_rows(jj.diag_rows())(
            jnp.asarray(x))
    assert rel(got[f"ref_{what}"], port.numpy()) < 1e-12
    assert rel(got[f"ref_{what}"], np.asarray(jax_)) < 1e-12


def test_gmres_matches_one_process(ranks, refs):
    world, got, _ = ranks
    _, tstate, out = refs
    ref = out["ref"]
    f = torch.as_tensor(ref["port_F"])
    sol = tgmres(ref["jm"].matvec_t, f, maxit=120, atol=1e-12, rtol=1e-6, pc=ref["pc"])
    assert int(got["rank0_gmres_iters"]) == sol.iters > 0
    assert rel(got["ref_gmres_x"], sol.x.numpy()) < 1e-9


def test_ranks_take_the_same_krylov_path(ranks):
    """Every stop decision comes from all-reduced values: each rank's
    iteration counts and residual histories are the same bits."""
    world, got, _ = ranks
    keys = ("gmres_iters", "gmres_rhist", "step_krylov", "step_rnorms", "step_converged")
    for r in range(1, world):
        for k in keys:
            assert np.array_equal(got[f"rank{r}_{k}"], got[f"rank0_{k}"]), (r, k)
    assert got["rank0_gmres_rhist"].shape == (int(got["rank0_gmres_iters"]),)
    n_own = [int(got[f"rank{r}_n_own"]) for r in range(world)]
    assert sum(n_own) == box_mesh(*BOX).num_node
    sent = [int(got[f"rank{r}_sent_bytes"]) for r in range(world)]
    assert min(sent) > 0 and all(int(got[f"rank{r}_allreduces"]) > 0 for r in range(world))
    # gather_state(broadcast=True) gives every rank the state rank 0 gathers
    for r in range(world):
        assert np.array_equal(got[f"rank{r}_broadcast_dwg"], got["step_dwg"])


@pytest.fixture(scope="module")
def jax_ref_steps(refs):
    state, _, out = refs
    return jax_steps(out["ref"]["js"], state)


def test_step_fixed_matches_jax(ranks, jax_ref_steps):
    _, got, _ = ranks
    ref = jax_ref_steps[1]
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"fixed_{key}"], r) < 1e-9, key


def test_step_matches_jax(ranks, jax_ref_steps):
    _, got, _ = ranks
    (ref, kits), _ = jax_ref_steps
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"step_{key}"], r) < 1e-9, key
    assert got["rank0_step_krylov"].tolist() == kits
    assert len(got["rank0_step_rnorms"]) == len(kits)


def _h5_datasets(path: Path) -> dict:
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = obj[()]

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli1")
    assert tmain.main(cli_argv(1, str(out))) == 0
    return out


def test_cli_devices_writes_the_one_process_snapshots(ranks, one_process_cli):
    """--devices N: rank 0 writes sol.0 .. sol.<steps> from the gathered
    state, with the one-process run's datasets and values."""
    world, got, out = ranks
    assert int(got["cli_rc"]) == 0
    for step in range(CLI_STEPS + 1):
        ref = _h5_datasets(one_process_cli / f"sol.{step}.h5")
        sharded = _h5_datasets(out / f"cli{world}" / f"sol.{step}.h5")
        assert sorted(sharded) == sorted(ref)
        for key, r in ref.items():
            if np.asarray(r).dtype.kind == "f":
                assert rel(sharded[key], r) < 1e-9 if np.abs(r).max() else np.array_equal(
                    sharded[key], r), key
            else:
                assert np.array_equal(sharded[key], r), key
    recs = [json.loads(ln) for ln in (out / f"cli{world}" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == list(range(1, CLI_STEPS + 1))
    assert all(r["ranks"] == world and r["backend"] == "gloo" for r in recs)


def _one_process_fixed(mesh):
    ts = TNSSolver(mesh, reference_scenario_config(), device="cpu")
    state = interop.state_from_numpy(*reference_initial_state(mesh), device="cpu")
    return [t.numpy() for t in ts.step_fixed(*state, num_newton=2)]


def test_dryrun_body_matches_one_process(ranks):
    world, got, _ = ranks
    ref = _one_process_fixed(box_mesh(3, 3, 2 * world))
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"dryrun_{key}"], r) < 1e-9, key


def test_dryrun_multichip_on_the_cpu():
    """The public dry run: its own 2 gloo ranks, box_mesh(3, 3, 4)."""
    got = dryrun_multichip(2, device="cpu", timeout=120)
    for g, r in zip(got, _one_process_fixed(box_mesh(3, 3, 4))):
        assert rel(g, r) < 1e-9


# ---------------------------------------------------------------------------
# no spawn


PARTITION_MESHES = {"box": lambda gen: gen.box_mesh(5, 3, 4),
                    "delaunay": lambda gen: gen.delaunay_mesh(200, seed=3)}


@pytest.mark.parametrize("native", [False, None], ids=["numpy", "jax-default"])
@pytest.mark.parametrize("mesh_name", ["box", "delaunay"])
def test_partition_bit_equal_to_jax(mesh_name, native):
    """rcb_parts, partition_mesh and permute / unpermute_state equal the
    JAX package's bit for bit, with its NumPy body and with its default
    (the C++ fast path where it builds)."""
    from dedflow_tpu.mesh import gen as jgen
    from dedflow_tpu_torch.mesh import gen as tgen

    jmesh, tmesh = (PARTITION_MESHES[mesh_name](g) for g in (jgen, tgen))
    np.testing.assert_array_equal(jmesh.xg, tmesh.xg)
    kw = {} if native is None else {"native": native}
    for parts in (2, 3, 5):
        np.testing.assert_array_equal(tpart.rcb_parts(tmesh.xg, parts),
                                      jpart.rcb_parts(jmesh.xg, parts, **kw))
    if native is not None:  # partition_mesh takes JAX's default
        return
    for parts in (2, 3):
        tm, ti = tpart.partition_mesh(tmesh, parts)
        jm, ji = jpart.partition_mesh(jmesh, parts)
        np.testing.assert_array_equal(tm.xg, jm.xg)
        np.testing.assert_array_equal(tm.ien, jm.ien)
        for tb, jb in zip(tm.boundaries, jm.boundaries):
            for f in ("nodes", "ien", "f2e", "forn"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
        for f in dataclasses.fields(ji):
            np.testing.assert_array_equal(getattr(ti, f.name), getattr(ji, f.name))
        state = np.random.default_rng(0).standard_normal((tmesh.num_node, 6))
        perm = tpart.permute_state(ti, state)
        np.testing.assert_array_equal(perm, jpart.permute_state(ji, state))
        np.testing.assert_array_equal(tpart.unpermute_state(ti, perm),
                                      jpart.unpermute_state(ji, perm))
        np.testing.assert_array_equal(tpart.unpermute_state(ti, perm), state)


def test_slab_cut():
    """Whole node layers, as even as possible, at least 2 a rank."""
    assert slab_layers(7, 2) == (0, 4, 7)
    assert slab_layers(7, 3) == (0, 3, 5, 7)
    assert slab_layers(56, 2) == (0, 28, 56)
    assert slab_layers(8, 4) == (0, 2, 4, 6, 8)
    with pytest.raises(ValueError, match="at least 2"):
        slab_layers(7, 4)


def test_banded_product_is_the_whole_matrix_rows():
    """K3's banded plain twin on a rank's rows, x holding a node layer of
    each neighbour around them, equals the whole matrix's product on those
    rows to roundoff (the sum order over planes moves with the length): the
    entries reaching past the band are the dead cells' exact zeros."""
    ts = TNSSolver(box_mesh(*BOX), reference_scenario_config(), device="cpu")
    tstate = interop.state_from_numpy(*case_state(ts.mesh), device="cpu")
    jm, _ = assemble_system(ts.lctx, ts.face_ctxs, ts.mask_t, *tstate, ts.cfg.physics,
                            ts.cfg.time)
    x = torch.as_tensor(probe_vector(ts.mesh.num_node))
    whole = dia_matvec_plain(jm.data, jm.scal, x, jm.offsets)
    sz = (BOX[0] + 1) * (BOX[1] + 1)
    for lo, hi in ((0, 3), (3, 5), (5, 7)):
        a, b = lo * sz, hi * sz
        xa, xb = max(a - sz, 0), min(b + sz, ts.mesh.num_node)
        got = dia_matvec_banded_plain(jm.data[..., a:b].contiguous(),
                                      jm.scal[:, a:b].contiguous(), x[:, xa:xb].contiguous(),
                                      jm.offsets, a - xa)
        assert rel(got.numpy(), whole[:, a:b].numpy()) < 1e-14


@pytest.mark.parametrize(
    "overrides,item",
    [
        (dict(use_lattice="gather"), "A16 \\(b'\\)"),
        (dict(use_lattice="winell"), "A16 \\(b'\\)"),
        (dict(assembly_chunk=64), "A16 \\(b'\\)"),
        (dict(use_lattice="off"), "A16 \\(b'\\)"),
        (dict(implicit_scalars=True), "A16 \\(b'\\)"),
        (dict(krylov_pc="mg"), "A16 \\(d'\\)"),
        (dict(krylov_pc="simple"), "A16 \\(d'\\)"),
        (dict(krylov_precision="f64"), "A16 \\(d'\\)"),
        (dict(krylov_precision="ir"), "A16 \\(d'\\)"),
        (dict(lag_jacobian=True), "A16 \\(d'\\)"),
        (dict(lattice_backend="xla"), "A9"),
    ],
    ids=["gather", "winell", "chunk", "classes", "implicit", "pc-mg", "pc-simple", "f64", "ir",
         "lagged", "lattice-backend"],
)
def test_options_outside_the_slice_raise(overrides, item):
    """Nothing silently runs one process: each option ShardedNSSolver does
    not take raises before any rank communicates."""
    from dedflow_tpu_torch import config as tcfg

    cfg = reference_scenario_config()
    kry = {k[7:]: overrides.pop(k) for k in list(overrides) if k.startswith("krylov_")}
    if kry:
        cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, **kry))
    if overrides.pop("lag_jacobian", False):
        cfg = dataclasses.replace(cfg, newton=tcfg.NewtonConfig(lag_jacobian=True))
    cfg = dataclasses.replace(cfg, **overrides)
    with pytest.raises(NotImplementedError, match=item):
        ShardedNSSolver(box_mesh(2, 2, 4), cfg, device="cpu")


@pytest.mark.parametrize("make_mesh", [
    lambda: _without_lattice(box_mesh(2, 2, 4)),
    lambda: _with_tets(box_mesh(2, 2, 4), _KUHN_TETS[::-1].copy()),
], ids=["no-lattice", "other-split"])
def test_meshes_outside_the_slice_raise(make_mesh):
    with pytest.raises(NotImplementedError, match="A16 \\(b'\\)"):
        ShardedNSSolver(make_mesh(), reference_scenario_config(), device="cpu")


def _without_lattice(mesh):
    mesh.lattice = None
    return mesh


def _with_tets(mesh, tets):
    mesh.lattice_tets = tets
    return mesh


def test_coupled_devices_raises_a16c(tmp_path):
    with pytest.raises(NotImplementedError, match="A16 \\(c\\)"):
        tmain.main(["--scenario", "coupled", "--devices", "2", "--box", "2", "2", "4",
                    "--device", "cpu", "--out", str(tmp_path)])


def test_spawn_fails_on_a_failing_rank_and_times_out_on_a_hung_one():
    """A rank that raises fails the run with its traceback (the rank
    waiting for it is stopped); a run past its timeout raises, never
    hangs (here the rank is still starting when the second passes)."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 .*rank one gives up"):
        launch.spawn(ranks_mod.fails, 2, "cpu", timeout=60)
    with pytest.raises(TimeoutError):
        launch.spawn(ranks_mod.hangs, 1, "cpu", timeout=1)
    assert time.perf_counter() - t0 < 60


LOCK_CODE = """
import sys, time
sys.path.insert(0, {root!r})
from dedflow_tpu_torch.utils import nvcc
with nvcc.build_lock({path!r}):
    t0 = time.time()
    time.sleep(0.4)
    print(t0, time.time())
"""


def test_nvcc_build_lock_serialises_processes(tmp_path):
    """Two processes that find no built library take turns in the locked
    build section (their intervals in it do not overlap)."""
    code = LOCK_CODE.format(root=str(ROOT), path=str(tmp_path / "build"))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    spans = sorted(tuple(map(float, p.communicate(timeout=60)[0].split())) for p in procs)
    assert all(p.returncode == 0 for p in procs)
    assert spans[0][1] <= spans[1][0]
