"""dedflow_tpu_torch's multi-device path (ROADMAP A16: the z-slab and RCB
modes, the coupled FEM-DEM step) on gloo ranks on the CPU, float64.

parallel.sharded.ShardedNSSolver on 2 and 3 ranks: one spawn per world
size (a module fixture; in turns, in the background, while this
process builds its references) runs every case on the ranks
(tests/torch_sharded_ranks.py) and writes the gathered arrays to a file;
the cases below are asserts on it, against the port's one-process solver
and the JAX package's one-device functions (which tests/test_sharding.py
holds equal to its sharded solver), relative error max|got - ref| /
max|ref|. A box cut into z-slabs:

- F, J (DIA data and scal rows: masked, with the facet band of the weak
  z+ wall on the last rank) at 1e-12, and the same with a weak x+ face,
  whose facets cross every seam; the K3 product and the field-split apply
  at 1e-12;
- GMRES with all-reduced inner products: the one-process iterate (1e-9)
  and count, the same count and residual history on every rank;
- step_fixed(num_newton=2) and step within 1e-9 of the JAX one-device
  step, with equal Newton and Krylov counts;
- the CLI's --devices run writes the one-process run's snapshots (also
  with --chunk 64, the RCB mode); the dry run's step in both modes;
  dryrun_multichip(2) itself on the CPU.

The RCB mode (torch_sharded_ranks.RCB_CASES: a Delaunay mesh, a box on
"gather" with its weak z+ wall across the parts, the melt pool with its
source, an assembly chunk, a mixed box on "winell"), against the port's
one-process gather solver and the JAX one-device gather NSSolver (its
references jitted once per mesh in a module fixture):

- F, J (each rank's entries mapped to the one-process CSR entries), the
  K7 halo product and the field-split apply at 1e-12; GMRES at 1e-9 with
  equal counts; step_fixed(2) and step at 1e-9 with equal Newton and
  Krylov counts; every rank's histories the same bits;
- the halo exchange equals the ghosts' own values, moves no more values
  than the neighbours' ghosts, and no collective that moves a whole vector
  runs in a step.

The coupled FEM-DEM step (torch_sharded_ranks.COUPLED_CASES: the box on
z-slabs, the Delaunay mesh on RCB parts; CoupledSolver(sharded=True)
.step(num_newton=2)) and the sharded DEM (DEM_CASES, one rebuild window):

- the fluid within 1e-12 of the port's one process and, on the box,
  within 1e-8 of the JAX CoupledSolver's step (the bar of the JAX
  package's own sharded coupled test); the particles bit-equal to one
  process's on every rank, the DEM on cell slabs with its bands traded,
  no whole-vector collective in the step;
- dem_run_grid(shard=) bit-equal to one process's, within 1e-12 of the
  JAX dem_run_grid, replicated where its reach does not fit a slab;
  HaloComm.reverse_add sums the ghost rows onto their owners; the CLI's
  `--scenario coupled --devices 2` writes the one-process run's files.

Without spawning: the partition functions bit-equal to the JAX package's,
the RCB halo plan against the JAX build_halo_plan, the mode choice against
the JAX constructor's conditions, the z-slab cut, K3's banded and K7's
halo plain twins against the whole matrix's rows, the refused options,
the launcher's failure and timeout paths and the kernel build's file lock
across two processes.
"""

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_sharded_ranks as ranks_mod
from torch_sharded_ranks import BOX, CLI_MODES, CLI_STEPS, CONFIGS, RCB_CASES, case_state
from torch_sharded_ranks import COUPLED_CASES, COUPLED_NEWTON, DEM_CASES, DEM_STEPS
from torch_sharded_ranks import cli_argv, cli_coupled_argv, coupled_setup, dem_case_run
from torch_sharded_ranks import probe_vector, rcb_state

from dedflow_tpu.app.scenarios import box_channel_bcs as j_box_channel_bcs
from dedflow_tpu.app.scenarios import reference_scenario_config as j_reference_config
from dedflow_tpu.config import BCSpec as JBCSpec
from dedflow_tpu.mesh.gen import box_mesh as j_box_mesh
from dedflow_tpu.parallel import partition as jpart
from dedflow_tpu.solver.newton import NSSolver as JNSSolver
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JPC
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app.coupled import CoupledSolver as TCoupledSolver
from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu_torch.fem.lattice import slab_layers
from dedflow_tpu_torch.dem import grid as tdem_grid
from dedflow_tpu_torch.fem import assembly as tasm
from dedflow_tpu_torch.mesh import gen as tgen_mod
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS, box_mesh, delaunay_mesh, mixed_box_mesh
from dedflow_tpu_torch.parallel import launch, sharded
from dedflow_tpu_torch.parallel import partition as tpart
from dedflow_tpu_torch.parallel.dryrun import dryrun_multichip
from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
from dedflow_tpu_torch.parallel.spmd import build_halo_plan
from dedflow_tpu_torch.solver.krylov import gmres as tgmres
from dedflow_tpu_torch.solver.newton import NSSolver as TNSSolver
from dedflow_tpu_torch.solver.newton import _choose_tier, assemble_system, residual
from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec_banded_plain, dia_matvec_plain
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.sparse.win_kernels import winell_matvec_plain
from dedflow_tpu_torch.sparse.winell import WinELLMatrixT

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


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """{world: (its run, output directory)}: one spawn a world size of gloo
    ranks running every case (torch_sharded_ranks.scenarios), one after
    the other in a background thread (at most 3 ranks at once beside the
    other test workers), so that the ranks run while this process builds
    its references."""
    pool = ThreadPoolExecutor(max_workers=1)
    runs = {}
    for world in (2, 3):
        out = tmp_path_factory.mktemp(f"sharded{world}")
        runs[world] = (pool.submit(launch.spawn, ranks_mod.scenarios, world, "cpu",
                                   args=(str(out),), timeout=300), out)
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module", params=(2, 3), ids=("w2", "w3"))
def ranks(request, spawned, refs, rcb_refs, jax_ref_steps, one_process_cli, coupled_refs):
    """(world, gathered arrays, output directory) of the spawn of `world`
    ranks; the references are built first, while the ranks run."""
    world = request.param
    run, out = spawned[world]
    run.result()
    return world, dict(np.load(out / f"w{world}.npz")), out


def jax_steps(js, state, num_newton=2, source=None, nodal_force=None):
    """The JAX package's step and step_fixed(num_newton) from its solver's
    jitted pieces, one compile of its Newton iteration serving both
    (tests/test_torch_classes.py::jax_steps), with the nodal heat `source`
    and the nodal momentum load `nodal_force` where given. Returns
    ((wgold, dwgold, dwg), krylov_iters) of the adaptive step and the fixed
    step's three states."""
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    newton = js.cfg.newton
    kw = {"source": source} if nodal_force is None else {"source": source,
                                                           "nodal_force": nodal_force}

    def run(num, adaptive):
        d = js._predict(dwg)
        f = js._residual(*c, wg, dwo, d, **kw)
        rnorm0 = js._norms(f) + 1e-16
        kits = []
        for _ in range(num):
            d, f, rn, kit, _ = js._newton_iter(*c, wg, dwo, d, f, **kw)
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
        # assemble_jacobian_t at the alpha states; the residual's compile,
        # with a zero nodal load, also serves jax_steps and the coupled
        # step's fluid, jax_coupled_step)
        c, jstate = (js.solve_ctx, js.face_ctxs, js.mask), [jnp.asarray(a) for a in state]
        jf = js._residual(*c, *jstate, source=None, nodal_force=zero_load(tmesh))
        jj, _ = js._assemble_system(*c, *jstate)
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


def zero_load(mesh):
    """A zero nodal momentum load (N, 3): the JAX solver's jitted pieces then
    take the coupled step's signature, and one compile serves both."""
    return jnp.zeros((mesh.num_node, 3))


@pytest.fixture(scope="module")
def jax_ref_steps(refs):
    state, _, out = refs
    return jax_steps(out["ref"]["js"], state, nodal_force=zero_load(box_mesh(*BOX)))


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
    """The one-process CLI's run directory of each mode's arguments."""
    runs = {}
    for mode in CLI_MODES:
        runs[mode] = tmp_path_factory.mktemp(f"cli1_{mode}")
        assert tmain.main(cli_argv(1, str(runs[mode]), mode)) == 0
    runs["coupled"] = tmp_path_factory.mktemp("cli1_coupled")
    assert tmain.main(cli_coupled_argv(1, str(runs["coupled"]))) == 0
    return runs


def test_cli_devices_writes_the_one_process_snapshots(ranks, one_process_cli):
    """--devices N: rank 0 writes sol.0 .. sol.<steps> from the gathered
    state, with the one-process run's datasets and values."""
    _check_cli_run(ranks, one_process_cli["slab"], "")


def test_cli_devices_rcb_writes_the_one_process_snapshots(ranks, one_process_cli):
    """The same with --chunk 64: every rank takes the RCB mode."""
    _check_cli_run(ranks, one_process_cli["rcb"], "_rcb")


def _check_cli_run(ranks, ref_dir, tag: str) -> None:
    world, got, out = ranks
    assert int(got[f"cli{tag}_rc"]) == 0
    for step in range(CLI_STEPS + 1):
        ref = _h5_datasets(ref_dir / f"sol.{step}.h5")
        sharded = _h5_datasets(out / f"cli{world}{tag}" / f"sol.{step}.h5")
        assert sorted(sharded) == sorted(ref)
        for key, r in ref.items():
            if np.asarray(r).dtype.kind == "f":
                assert rel(sharded[key], r) < 1e-9 if np.abs(r).max() else np.array_equal(
                    sharded[key], r), key
            else:
                assert np.array_equal(sharded[key], r), key
    recs = [json.loads(ln) for ln in (out / f"cli{world}{tag}" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in recs] == list(range(1, CLI_STEPS + 1))
    assert all(r["ranks"] == world and r["backend"] == "gloo" for r in recs)


def _one_process_fixed(mesh, **overrides):
    ts = TNSSolver(mesh, reference_scenario_config(**overrides), device="cpu")
    state = interop.state_from_numpy(*reference_initial_state(mesh), device="cpu")
    return [t.numpy() for t in ts.step_fixed(*state, num_newton=2)]


def test_dryrun_body_matches_one_process(ranks):
    world, got, _ = ranks
    ref = _one_process_fixed(box_mesh(3, 3, 2 * world))
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"dryrun_{key}"], r) < 1e-9, key


def test_dryrun_rcb_body_matches_one_process(ranks):
    """The dry run's RCB mode: the same box on use_lattice "gather"."""
    world, got, _ = ranks
    ref = _one_process_fixed(box_mesh(3, 3, 2 * world), use_lattice="gather")
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"dryrun_rcb_{key}"], r) < 1e-9, key


def test_dryrun_multichip_on_the_cpu():
    """The public dry run: its own 2 gloo ranks, box_mesh(3, 3, 4)."""
    got = dryrun_multichip(2, device="cpu", timeout=120)
    for g, r in zip(got, _one_process_fixed(box_mesh(3, 3, 4))):
        assert rel(g, r) < 1e-9


# ---------------------------------------------------------------------------
# the RCB mode (rcb_scenarios in the same spawn)

RCB_NAMES = list(RCB_CASES)


def _jax_mesh(m):
    """The JAX package's copy of a port mesh (the same arrays)."""
    from dedflow_tpu.mesh.mesh import Boundary as JBoundary
    from dedflow_tpu.mesh.mesh import Mesh as JMesh

    return JMesh(xg=m.xg.copy(), ien=m.ien.copy(),
                 boundaries=[JBoundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                             for b in m.boundaries],
                 lattice=m.lattice, ien_prism=m.ien_prism, ien_hex=m.ien_hex)


def _jax_config(cfg, path):
    """The JAX package's copy of a port configuration (through its JSON)."""
    from dedflow_tpu import config as jcfg
    from dedflow_tpu_torch import config as tcfg

    tcfg.save_config(cfg, str(path))
    return jcfg.load_config(str(path))


@pytest.fixture(scope="module")
def rcb_refs(tmp_path_factory):
    """Per RCB case, on its mesh in its own node order: the port's
    one-process gather solver and the JAX one-device gather NSSolver (its
    residual, assembly and Newton iteration, and here its product with the
    field-split apply and its GMRES, each jitted once); their F, J on the
    port's CSR entries, product, field-split apply and GMRES at the case's
    state, and the JAX steps."""
    from dedflow_tpu.solver.krylov import gmres as jgmres
    from dedflow_tpu.solver.newton import NSSolver as JSolver

    out = {}
    for name, (make_mesh, make_cfg, melt) in RCB_CASES.items():
        mesh, cfg = make_mesh(), dataclasses.replace(make_cfg(), use_lattice="gather")
        ts = TNSSolver(mesh, cfg, device="cpu")
        js = JSolver(_jax_mesh(mesh), _jax_config(cfg, tmp_path_factory.mktemp(name) / "c.json"))
        assert ts.fastpath == js.fastpath == "gather"
        wg, dwo, dwg, src = rcb_state(mesh, melt)
        tst = interop.state_from_numpy(wg, dwo, dwg, device="cpu")
        tsrc = None if src is None else torch.as_tensor(src)
        f = residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, cfg.physics, cfg.time,
                     cfg.freeze_phi_temperature, None, tsrc)
        jm, pc = assemble_system(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, cfg.physics,
                                 cfg.time, cfg.implicit_scalars)
        x = torch.as_tensor(probe_vector(mesh.num_node))
        sol = tgmres(jm.matvec_t, f, maxit=120, atol=1e-12, rtol=1e-6, pc=pc)
        c, jstate = (js.solve_ctx, js.face_ctxs, js.mask), [jnp.asarray(a) for a in (wg, dwo, dwg)]
        jsrc = None if src is None else jnp.asarray(src)
        jf = js._residual(*c, *jstate, source=jsrc)
        jj, jpc = js._assemble_system(*c, *jstate)
        sparsity = build_sparsity(mesh.ien, mesh.num_node, extra_ien=mesh.extra_cells)
        jvals = interop.fsbsr_from_numpy(np.asarray(jj.data), sparsity, jm.plan).vals.numpy()
        xj = jnp.asarray(x.numpy().T)
        jax_ax, jax_px = jax.jit(lambda v: (jj.matvec(v), jpc(v)))(xj)
        jsol = jax.jit(lambda b: jgmres(jj.matvec, b, maxit=120, atol=1e-12, rtol=1e-6,
                                        pc=jpc))(jf)
        out[name] = dict(
            mesh=mesh, port_F=f.numpy().T, jax_F=np.asarray(jf), port_J=jm.vals.numpy(),
            jax_J=jvals, plan=jm.plan, port_Ax=jm.matvec_t(x).numpy().T,
            jax_Ax=np.asarray(jax_ax), port_Px=pc(x).numpy().T, jax_Px=np.asarray(jax_px),
            port_gmres_x=sol.x.numpy().T, port_gmres_iters=sol.iters,
            jax_gmres_x=np.asarray(jsol.x), jax_gmres_iters=int(jsol.iters),
            jax_steps=jax_steps(js, (wg, dwo, dwg), source=jsrc),
        )
    return out


def _rcb_J(got: dict, name: str, world: int, plan) -> tuple:
    """The ranks' entries placed on the one-process CSR entries: (18, S)
    values and which entries a rank holds (each at most once)."""
    keys = plan.grow * plan.num_node + plan.col
    vals, held = np.zeros((18, plan.S)), np.zeros(plan.S, dtype=bool)
    for r in range(world):
        k = got[f"rcb_{name}_rank{r}_keys"]
        at = np.searchsorted(keys, k)
        assert np.array_equal(keys[at], k), "an entry outside the one-process pattern"
        assert not held[at].any(), "an entry on two ranks"
        vals[:, at], held[at] = got[f"rcb_{name}_rank{r}_vals"], True
    return vals, held


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_residual_matches_one_process_and_jax(ranks, rcb_refs, name):
    _, got, _ = ranks
    ref = rcb_refs[name]
    assert rel(got[f"rcb_{name}_F"], ref["port_F"]) < 1e-12
    assert rel(got[f"rcb_{name}_F"], ref["jax_F"]) < 1e-12


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_jacobian_matches_one_process_and_jax(ranks, rcb_refs, name):
    """Each own row's entries on exactly one rank, masked, with the facet
    blocks; the one-process pattern's other entries (a mixed mesh's prism /
    hex stencil) are zeros there too."""
    world, got, _ = ranks
    ref = rcb_refs[name]
    vals, held = _rcb_J(got, name, world, ref["plan"])
    assert rel(vals, ref["port_J"]) < 1e-12
    assert rel(vals, ref["jax_J"]) < 1e-12
    assert held.all() != (name == "mixed")
    assert not ref["port_J"][:, ~held].any()


@pytest.mark.parametrize("what", ["Ax", "Px"])
@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_product_and_preconditioner_match(ranks, rcb_refs, name, what):
    """K7's halo entry (plain twin: the ghosts exchanged, then the own
    rows' product) and the field-split apply (node-local)."""
    _, got, _ = ranks
    ref = rcb_refs[name]
    assert rel(got[f"rcb_{name}_{what}"], ref[f"port_{what}"]) < 1e-12
    assert rel(got[f"rcb_{name}_{what}"], ref[f"jax_{what}"]) < 1e-12


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_gmres_matches_one_process(ranks, rcb_refs, name):
    """GMRES on the halo operator against the port's one-process solve and
    the JAX package's gmres at the same f, field-split PC and settings."""
    _, got, _ = ranks
    ref = rcb_refs[name]
    iters = int(got[f"rcb_{name}_rank0_gmres_iters"])
    assert iters == ref["port_gmres_iters"] == ref["jax_gmres_iters"] > 0
    assert rel(got[f"rcb_{name}_gmres_x"], ref["port_gmres_x"]) < 1e-9
    assert rel(got[f"rcb_{name}_gmres_x"], ref["jax_gmres_x"]) < 1e-9


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_step_fixed_matches_jax(ranks, rcb_refs, name):
    _, got, _ = ranks
    ref = rcb_refs[name]["jax_steps"][1]
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"rcb_{name}_fixed_{key}"], r) < 1e-9, key


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_step_matches_jax(ranks, rcb_refs, name):
    _, got, _ = ranks
    (ref, kits), _ = rcb_refs[name]["jax_steps"]
    for key, r in zip(("wgold", "dwgold", "dwg"), ref):
        assert rel(got[f"rcb_{name}_step_{key}"], r) < 1e-9, key
    assert got[f"rcb_{name}_rank0_step_krylov"].tolist() == kits
    assert len(got[f"rcb_{name}_rank0_step_rnorms"]) == len(kits)


@pytest.mark.parametrize("name", RCB_NAMES)
def test_rcb_ranks_share_the_krylov_path_and_exchange_ghosts_only(ranks, name):
    """Every rank took the RCB mode on the gather tier; its iteration counts
    and residual histories are the same bits; the halo exchange filled the
    ghosts with their owners' values, the ranks sent as many values as
    they hold ghosts (each ghost filled once, by its owner), no rank holds
    every other rank's nodes, and no collective that moves a whole vector
    ran in the step (test_halo_plan_moves_surface_values checks the sizes
    on larger meshes)."""
    world, got, _ = ranks
    n = RCB_CASES[name][0]().num_node
    at = lambda r, k: got[f"rcb_{name}_rank{r}_{k}"]
    keys = ("gmres_iters", "gmres_rhist", "step_krylov", "step_rnorms", "step_converged")
    for r in range(world):
        assert str(at(r, "mode")) == "rcb" and str(at(r, "fastpath")) == "gather"
        assert bool(at(r, "halo_ok")) and int(at(r, "whole_vector_calls")) == 0
        for k in keys:
            assert np.array_equal(at(r, k), at(0, k)), (r, k)
        assert int(at(r, "sent_values")) > 0
        assert int(at(r, "n_ghost")) < n - int(at(r, "n_own"))
        assert int(at(r, "exchanges")) > 0 and int(at(r, "allreduces")) > 0
    assert sum(int(at(r, "n_own")) for r in range(world)) == n
    # every value sent fills one ghost slot, and each ghost is filled once
    assert sum(int(at(r, "sent_values")) for r in range(world)) == sum(
        int(at(r, "n_ghost")) for r in range(world))


# ---------------------------------------------------------------------------
# the coupled FEM-DEM step and the sharded DEM (coupled_scenarios in the same spawn)

COUPLED_NAMES = list(COUPLED_CASES)
DEM_NAMES = list(DEM_CASES)


def _jax_dem_config(cfg):
    """The JAX package's copy of a port DEMConfig."""
    from dedflow_tpu.dem.cells import CellGrid as JCellGrid
    from dedflow_tpu.dem.contact import ContactParams as JContactParams
    from dedflow_tpu.dem.integrate import DEMConfig as JDEMConfig

    d = dataclasses.asdict(cfg)
    d["grid"] = JCellGrid(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in d["grid"].items()})
    d["contact"] = JContactParams(**d["contact"])
    return JDEMConfig(**d)


def jax_coupled_step(js, mesh, jccfg, pst, state, num_newton: int):
    """The JAX CoupledSolver.step(num_newton=) on a box (its
    app/coupled.py:110-135: drag_exchange_lattice on the solver's
    FEMContext, step_fixed with the reaction as the nodal force, then
    dem_run_grid with the drag), its step_fixed driven from the solver's
    jitted pieces (`jax_steps`, compiled once with a nodal load for the
    box's other cases), the drag jitted whole. Returns ((wgold, dwgold,
    dwg), particle state)."""
    from dedflow_tpu.dem import coupling as jcoup
    from dedflow_tpu.dem.grid import dem_run_grid as jdem_run_grid

    lo, hi = np.asarray(mesh.xg).min(axis=0), np.asarray(mesh.xg).max(axis=0)
    spacing = (hi - lo) / np.asarray(mesh.lattice, float)
    f_p, f_nodes = jax.jit(lambda ctx, p, w: jcoup.drag_exchange_lattice(
        mesh.lattice, lo, spacing, ctx, p, w, jccfg.drag_mu))(js.ctx, pst, jnp.asarray(state[0]))
    _, fixed = jax_steps(js, state, num_newton, nodal_force=f_nodes.astype(jnp.float64))
    return [np.asarray(a) for a in fixed], jdem_run_grid(jccfg.dem, pst, jccfg.substeps,
                                                         ext=f_p)


@pytest.fixture(scope="module")
def coupled_refs(refs):
    """Per coupled case, the port's one-process CoupledSolver.step(num_newton
    =COUPLED_NEWTON) (the Delaunay mesh on the gather tier, as the RCB
    mode) and its initial particles; the JAX CoupledSolver's step on the
    box (`jax_coupled_step`, on the "ref" case's JAX solver); per DEM case
    the port's one-process dem_run_grid, and the JAX dem_run_grid of the
    packed cloud."""
    from dedflow_tpu.app.scenarios import coupled_scenario_setup as j_coupled_setup
    from dedflow_tpu.dem.grid import dem_run_grid as jdem_run_grid
    from dedflow_tpu.dem.particles import particle_state as jparticles

    out = {}
    for name, (make_mesh, make_cfg) in COUPLED_CASES.items():
        mesh = make_mesh()
        cfg = dataclasses.replace(make_cfg(), use_lattice="gather") if name != "box" \
            else make_cfg()
        ccfg, pst = coupled_setup(mesh, "cpu")
        ts = TCoupledSolver(mesh, cfg, ccfg, device="cpu")
        state = case_state(mesh)
        *fluid, p1, _ = ts.step(*interop.state_from_numpy(*state, device="cpu"), pst,
                                num_newton=COUPLED_NEWTON)
        out[name] = dict(fluid=[t.numpy() for t in fluid], x=p1.x.numpy(), v=p1.v.numpy(),
                         x0=pst.x.numpy(), mesh=mesh)
        if name == "box":
            f_p = ts.drag(torch.as_tensor(state[0]), pst)[0]
            ts.ccfg = dataclasses.replace(ccfg, use_grid=False)
            cand = ts.advance_particles(pst, f_p)
            out[name].update(candidates_x=cand.x.numpy(), candidates_v=cand.v.numpy())
        if name == "box":
            jmesh = j_box_mesh(*BOX)
            jccfg, jpst = j_coupled_setup(jmesh, num_particles=pst.num_particle)
            np.testing.assert_array_equal(np.asarray(jpst.x), pst.x.numpy())
            jccfg = dataclasses.replace(jccfg, dem=_jax_dem_config(ccfg.dem))
            jfluid, jp1 = jax_coupled_step(refs[2]["ref"]["js"], jmesh, jccfg, jpst, state,
                                           COUPLED_NEWTON)
            out[name].update(jax_fluid=jfluid, jax_x=np.asarray(jp1.x), jax_v=np.asarray(jp1.v))
    for name, make in DEM_CASES.items():
        x, v, r, cfg, ext = make()
        got = dem_case_run(name, "cpu")
        out[f"dem_{name}"] = dict(x=got.x.numpy(), v=got.v.numpy(), x0=x, cfg=cfg, r=r)
        if name == "packed":
            ref = jdem_run_grid(_jax_dem_config(cfg), jparticles(x, v, mass=1.0, radius=r),
                                DEM_STEPS, rebuild_every=DEM_STEPS, ext=jnp.asarray(ext))
            out[f"dem_{name}"].update(jax_x=np.asarray(ref.x), jax_v=np.asarray(ref.v))
    return out


@pytest.mark.parametrize("name", COUPLED_NAMES)
def test_coupled_step_matches_one_process(ranks, coupled_refs, name):
    """CoupledSolver(sharded=True).step(num_newton=2) against the port's one
    process: the fluid to 1e-12, the particles bit for bit (each drag
    computed by one rank with the one-process operations; the DEM on cell
    slabs, K11's halo entry's plain twin), the same particles on every
    rank; the DEM ran on slabs, traded its bands (two static, then one a
    substep), and no collective moved a whole vector."""
    world, got, _ = ranks
    ref = coupled_refs[name]
    for key, r in zip(("wgold", "dwgold", "dwg"), ref["fluid"]):
        assert rel(got[f"coupled_{name}_{key}"], r) < 1e-12, key
    assert np.abs(ref["x"] - ref["x0"]).max() > 0  # the particles moved
    at = lambda k, r: got[f"coupled_{name}_{k}_rank{r}"]
    for r in range(world):
        assert np.array_equal(at("x", r), ref["x"]) and np.array_equal(at("v", r), ref["v"])
        assert str(at("mode", r)) == ("slab" if name == "box" else "rcb")
        assert at("windows", r).tolist() == [1, 0]
        assert int(at("dem_exchanges", r)) == 2 + 10  # coupled_scenario_setup's 10 substeps
        assert int(at("fluid_exchanges", r)) > 0 and int(at("whole_vector_calls", r)) == 0
        assert at("timings", r).tolist() == ["dem_s", "drag_s", "fluid_s"]


def test_coupled_candidate_dem_is_replicated(ranks, coupled_refs):
    """With use_grid=False the ranks run the candidate-list dem_run on every
    particle, as the JAX package does: bit-equal to one process's from the
    same (bit-equal) drag."""
    world, got, _ = ranks
    ref = coupled_refs["box"]
    assert np.abs(ref["candidates_x"] - ref["x0"]).max() > 0
    for r in range(world):
        for key in ("x", "v"):
            assert np.array_equal(got[f"coupled_box_candidates_{key}_rank{r}"],
                                  ref[f"candidates_{key}"]), (r, key)


def test_coupled_step_matches_jax(ranks, coupled_refs):
    """The sharded coupled step on the box against the JAX package's
    one-device CoupledSolver step, at the bar of its own sharded test
    (tests/test_sharding.py:211-245: rtol 1e-8)."""
    _, got, _ = ranks
    ref = coupled_refs["box"]
    for key, r in zip(("wgold", "dwgold", "dwg"), ref["jax_fluid"]):
        assert rel(got[f"coupled_box_{key}"], r) < 1e-8, key
    for key in ("x", "v"):
        assert rel(got[f"coupled_box_{key}_rank0"], ref[f"jax_{key}"]) < 1e-8, key


def _touching_pairs_across_slabs(x, r, grid, world: int) -> int:
    """Touching pairs whose cells lie in two ranks' slabs of the flat cell
    axis (padded to a multiple of `world`)."""
    coords = np.clip(np.floor((x - np.asarray(grid.origin)) / grid.cell_size), 0,
                     np.asarray(grid.dims) - 1).astype(np.int64)
    nx, ny, nz = grid.dims
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    slab = cid // (-(-grid.num_cell // world))
    gap = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) - 2 * r
    i, j = np.triu_indices(len(x), 1)
    return int(((gap[i, j] < 0) & (slab[i] != slab[j])).sum())


@pytest.mark.parametrize("name", DEM_NAMES)
def test_sharded_dem_run_grid_bit_equal_to_one_process(ranks, coupled_refs, name):
    """dem_run_grid(shard=SlabComm) over one window: bit-equal to one
    process's on every rank. The packed cloud runs on slabs at 2 and 3
    ranks (touching pairs across the seams); the coarse grid's reach fits
    a slab on 2 ranks, not on 3, where every rank runs the whole grid
    (no band traded), as the JAX package does."""
    world, got, _ = ranks
    ref = coupled_refs[f"dem_{name}"]
    cfg = ref["cfg"]
    ncp = -(-cfg.grid.num_cell // world) * world
    fits = tdem_grid.shard_halo_fits(cfg.grid, ncp, world)
    assert fits == (name == "packed" or world == 2)
    assert np.abs(ref["x"] - ref["x0"]).max() > 0
    if name == "packed":
        assert _touching_pairs_across_slabs(ref["x0"], ref["r"], cfg.grid, world) > 0
    for r in range(world):
        at = lambda k: got[f"dem_{name}_{k}_rank{r}"]
        assert np.array_equal(at("x"), ref["x"]) and np.array_equal(at("v"), ref["v"])
        assert at("windows").tolist() == ([1, 0] if fits else [0, 1])
        assert int(at("exchanges")) == (2 + DEM_STEPS if fits else 0)


def test_sharded_dem_run_grid_matches_jax(ranks, coupled_refs):
    _, got, _ = ranks
    ref = coupled_refs["dem_packed"]
    for key in ("x", "v"):
        assert rel(got[f"dem_packed_{key}_rank0"], ref[f"jax_{key}"]) < 1e-12, key


def test_reverse_add_returns_ghost_rows_to_their_owners(ranks):
    """HaloComm.reverse_add on the Delaunay mesh's parts: each rank's local
    rows of one nodal array, summed back onto the owners, give each node's
    value times 1 + the number of ranks that hold it as a ghost."""
    world, got, _ = ranks
    mesh = COUPLED_CASES["delaunay"][0]()
    g = probe_vector(mesh.num_node)[:3].T
    held = np.ones(mesh.num_node)
    for r in range(world):
        lay = tpart.part_layout(mesh, world, r)
        held[lay.nodes[lay.n_own :]] += 1
    assert held.max() > 1
    assert rel(got["coupled_delaunay_reverse_add"], g * held[:, None]) < 1e-14


def test_cli_coupled_devices_writes_the_one_process_files(spawned, one_process_cli):
    """`--scenario coupled --devices 2`: rank 0 writes sol.0, sol.1 (the
    gathered state, within 1e-9 of the one-process run's) and particles.1
    (the one-process run's bit for bit: the first step's drag reads the
    initial state), with the metrics of 2 gloo ranks."""
    run, out = spawned[2]
    run.result()
    assert int(np.load(out / "w2.npz")["cli_coupled_rc"]) == 0
    ref_dir, got_dir = one_process_cli["coupled"], out / "cli2_coupled"
    for step in (0, 1):
        ref, sharded_ = (_h5_datasets(d / f"sol.{step}.h5") for d in (ref_dir, got_dir))
        assert sorted(sharded_) == sorted(ref)
        for key, r in ref.items():
            assert (rel(sharded_[key], r) < 1e-9 if np.asarray(r).dtype.kind == "f"
                    and np.abs(r).max() else np.array_equal(sharded_[key], r)), key
    ref, sharded_ = (_h5_datasets(d / "particles.1.h5") for d in (ref_dir, got_dir))
    assert sorted(sharded_) == sorted(ref) and ref
    for key, r in ref.items():
        assert np.array_equal(sharded_[key], r), key
    recs = [json.loads(ln) for ln in (got_dir / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], r["ranks"], r["backend"]) for r in recs] == [(1, 2, "gloo")]


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
        (dict(use_lattice="gather"), "rcb"),
        (dict(use_lattice="winell"), "rcb"),
        (dict(assembly_chunk=64), "rcb"),
        (dict(use_lattice="off"), "A16 \\(b''\\)"),
        (dict(implicit_scalars=True), "rcb"),
        (dict(krylov_pc="mg"), "A16 \\(d'\\)"),
        (dict(krylov_pc="simple"), "A16 \\(d'\\)"),
        (dict(krylov_precision="f64"), "A16 \\(d'\\)"),
        (dict(krylov_precision="ir"), "A16 \\(d'\\)"),
        (dict(lag_jacobian=True), "A16 \\(d'\\)"),
        (dict(lattice_backend="xla"), "A9"),
    ],
    ids=["gather-runs-rcb", "winell-runs-rcb", "chunk-runs-rcb", "classes-b2", "implicit-runs-rcb",
         "pc-mg", "pc-simple", "f64", "ir", "lagged", "lattice-backend"],
)
def test_options_outside_the_slice_raise(overrides, item):
    """Nothing silently runs one process: each option ShardedNSSolver does
    not take raises before any rank communicates, naming its ROADMAP item;
    "gather", "winell", an assembly chunk and implicit_scalars take the RCB
    mode (the spawned cases run them)."""
    from dedflow_tpu_torch import config as tcfg

    cfg = reference_scenario_config()
    kry = {k[7:]: overrides.pop(k) for k in list(overrides) if k.startswith("krylov_")}
    if kry:
        cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, **kry))
    if overrides.pop("lag_jacobian", False):
        cfg = dataclasses.replace(cfg, newton=tcfg.NewtonConfig(lag_jacobian=True))
    cfg = dataclasses.replace(cfg, **overrides)
    if item == "rcb":
        assert sharded._refuse_unported(box_mesh(2, 2, 4), cfg) == "rcb"
        return
    with pytest.raises(NotImplementedError, match=item):
        ShardedNSSolver(box_mesh(2, 2, 4), cfg, device="cpu")


@pytest.mark.parametrize("make_mesh", [
    lambda: _without_lattice(box_mesh(2, 2, 4)),
    lambda: _with_tets(box_mesh(2, 2, 4), _KUHN_TETS[::-1].copy()),
], ids=["no-lattice-classes-b2", "other-split-b2"])
def test_meshes_outside_the_slice_raise(make_mesh):
    """A box without its lattice metadata (the classes tier) and a lattice
    of another tet split: the JAX lattice mode's meshes that the z-slab
    path does not take yet."""
    with pytest.raises(NotImplementedError, match="A16 \\(b''\\)"):
        ShardedNSSolver(make_mesh(), reference_scenario_config(), device="cpu")


def _without_lattice(mesh):
    mesh.lattice = None
    return mesh


def _with_tets(mesh, tets):
    mesh.lattice_tets = tets
    return mesh


MODE_MESHES = {
    "box": lambda: box_mesh(2, 2, 4),
    "no-lattice": lambda: _without_lattice(box_mesh(2, 2, 4)),
    "other-split": lambda: _with_tets(box_mesh(2, 2, 4), _KUHN_TETS[::-1].copy()),
    "mixed": lambda: mixed_box_mesh(2, 2, 3),
    "delaunay": lambda: delaunay_mesh(60, seed=2),
}
MODE_OPTIONS = {"auto": {}, "gather": dict(use_lattice="gather"),
                "winell": dict(use_lattice="winell"), "off": dict(use_lattice="off"),
                "on": dict(use_lattice="on"), "chunk": dict(assembly_chunk=32),
                "implicit": dict(implicit_scalars=True)}


@pytest.mark.parametrize("option", list(MODE_OPTIONS))
@pytest.mark.parametrize("mesh_name", list(MODE_MESHES))
def test_sharded_mode_matches_the_jax_constructor(mesh_name, option):
    """The mode against the JAX ShardedNSSolver's conditions
    (dedflow_tpu/parallel/sharded.py:121-150): its lattice mode takes a mesh
    only if `use_lattice` is not "gather", there is no chunk and no
    implicit_scalars, the mesh has lattice metadata (not under "off") or
    the JAX detect_delta_classes finds translation classes on a tets-only
    mesh, and the one-device solver then lands on a lattice context
    (fastpath "lattice" or "classes": the tier that solver.newton's
    _choose_tier picks, which test_torch_mixed.py and test_torch_mesh_io.py
    hold equal to the JAX solver's per use_lattice mode). Every other mesh
    takes the RCB mode."""
    from dedflow_tpu.fem.lattice import detect_delta_classes as jdetect

    mesh = MODE_MESHES[mesh_name]()
    cfg = reference_scenario_config(**MODE_OPTIONS[option])
    maybe_fast = (cfg.use_lattice != "gather" and cfg.assembly_chunk is None
                  and not cfg.implicit_scalars)
    regular = (mesh.lattice is not None and cfg.use_lattice != "off") or (
        not mesh.extra_cells and jdetect(np.asarray(mesh.ien)) is not None)
    if maybe_fast and regular:
        try:
            lattice_ctx = _choose_tier(mesh, cfg) in ("lattice", "classes")
        except ValueError:  # use_lattice "on" off its stencil: both constructors raise
            with pytest.raises(ValueError, match="use_lattice='on'"):
                sharded.sharded_mode(mesh, cfg)
            return
    expected = "slab" if maybe_fast and regular and lattice_ctx else "rcb"
    assert sharded.sharded_mode(mesh, cfg) == expected


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("mesh_name", ["delaunay", "box"])
def test_halo_plan_matches_jax_build_halo_plan(mesh_name, parts):
    """On the same partition, each rank's sends to each other rank are the
    JAX plan's send table row of that hop (sender-local indices, ascending,
    then the table's zero padding), and the receiver's ghost block from
    that rank has the same length; ranks the JAX plan does not pair
    exchange nothing."""
    from dedflow_tpu.mesh import gen as jgen
    from dedflow_tpu.parallel.spmd import build_halo_plan as jbuild_halo_plan
    from dedflow_tpu.sparse import topology as jtop

    make = {"delaunay": lambda g: g.delaunay_mesh(500, seed=7), "box": lambda g: g.box_mesh(5, 4, 6)}
    tmesh, jmesh = make[mesh_name](tgen_mod), make[mesh_name](jgen)
    pmesh, _ = jpart.partition_mesh(jmesh, parts)
    ell_col = jtop.build_sparsity(pmesh.ien, pmesh.num_node, native=False).ell_tables()[0]
    hops, send_idx, _, _ = jbuild_halo_plan(ell_col, parts)
    lays = [tpart.part_layout(tmesh, parts, r) for r in range(parts)]
    plans = [build_halo_plan(tmesh.ien, lay) for lay in lays]
    paired = set()
    for s_hop in hops:
        tbl = np.asarray(send_idx[s_hop])
        for src in range(parts):
            dst = src - s_hop
            if not 0 <= dst < parts:
                continue
            ours = plans[src].send.get(dst, np.zeros(0, dtype=np.int64))
            assert np.array_equal(tbl[src, : ours.size], ours), (s_hop, src)
            assert not tbl[src, ours.size :].any(), (s_hop, src)
            lo, hi = plans[dst].recv.get(src, (0, 0))
            assert hi - lo == ours.size
            paired.add((src, dst))
    for r, plan in enumerate(plans):
        assert {(r, q) for q in plan.send} <= paired
        assert (plan.n_own, plan.n_x) == (lays[r].n_own, lays[r].mesh.num_node)


@pytest.mark.parametrize("parts", [2, 4])
def test_halo_plan_moves_surface_values(parts):
    """On a 16^3 box, each rank receives exactly its ghosts (one exchange
    fills them, by block), the ranks send exactly as many values as they
    receive, and a rank's ghosts are a few node layers of the cuts (under 3
    layers of 17 x 17 a neighbour), not the other ranks' nodes."""
    mesh = box_mesh(16, 16, 16)
    layer = 17 * 17
    plans = [build_halo_plan(mesh.ien, tpart.part_layout(mesh, parts, r)) for r in range(parts)]
    for plan in plans:
        blocks = sorted(plan.recv.values())
        assert blocks[0][0] == 0 and blocks[-1][1] == plan.n_ghost
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        assert plan.n_ghost <= 3 * layer * len(plan.recv)
        assert plan.n_ghost < (mesh.num_node - plan.n_own) / 2
    assert sum(i.size for p in plans for i in p.send.values()) == sum(p.n_ghost for p in plans)


def test_halo_product_is_the_whole_matrix_rows():
    """K7's halo plain twin on a part's own rows, x its local vector
    [own | ghosts], equals the whole matrix's product on those rows to
    roundoff (a row's entries are summed in its local column order)."""
    mesh = delaunay_mesh(300, seed=4)
    ts = TNSSolver(mesh, reference_scenario_config(bcs=(), pin_pressure=True), device="cpu")
    state = interop.state_from_numpy(*case_state(mesh), device="cpu")
    jm, _ = assemble_system(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *state, ts.cfg.physics,
                            ts.cfg.time)
    x = torch.as_tensor(probe_vector(mesh.num_node))
    whole = winell_matvec_plain(jm, x)
    lay = tpart.part_layout(mesh, 2, 1)
    sub = lay.mesh
    own = tasm.build_context(sub, None, device="cpu", own=lay.n_own)
    rows, cols = lay.nodes[own.win_plan.grow], lay.nodes[own.win_plan.col]
    key = jm.plan.grow * mesh.num_node + jm.plan.col
    at = torch.as_tensor(np.searchsorted(key, rows * mesh.num_node + cols))
    part = WinELLMatrixT(vals=jm.vals[:, at].contiguous(), plan=own.win_plan)
    got = winell_matvec_plain(part, x[:, lay.nodes].contiguous(), sub.num_node)
    assert rel(got.numpy(), whole[:, lay.nodes[: lay.n_own]].numpy()) < 1e-14
    with pytest.raises(ValueError, match="expected"):
        winell_matvec_plain(part, x[:, lay.nodes].contiguous())


def test_coupled_devices_raises_a16c(tmp_path):
    """A16 (c) is ported: `--scenario coupled --devices N` runs (the world-2
    spawn's CLI case). What stays refused, before any rank starts, is the
    coupled scenario on a mesh file (its particle locator assumes the
    generator's Kuhn split), and the fluid options A16 (d') leaves out,
    before the coupled solver's ranks communicate."""
    assert tmain.main(["--scenario", "coupled", "--devices", "2", "--mesh", "box.h5",
                       "--device", "cpu", "--out", str(tmp_path)]) == 2
    mesh, cfg = box_mesh(2, 2, 4), reference_scenario_config()
    cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, pc="mg"))
    with pytest.raises(NotImplementedError, match="A16 \\(d'\\)"):
        TCoupledSolver(mesh, cfg, coupled_setup(mesh, "cpu")[0], device="cpu", sharded=True)


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
