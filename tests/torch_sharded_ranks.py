"""The rank side of tests/test_torch_sharded.py: what each gloo rank runs on
the CPU (no JAX here, so that a rank imports only torch and the port).

`scenarios(device, out_dir)` runs every sharded case once on the ranks of
one process group, the z-slab cases, the RCB cases (`RCB_CASES`,
`rcb_scenarios`) and the coupled FEM-DEM cases (`COUPLED_CASES`,
`DEM_CASES`, `coupled_scenarios`), and rank 0 writes the gathered arrays to
out_dir/w<world>.npz; the test module's cases are asserts on that file.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.app.coupled import CoupledSolver
from dedflow_tpu_torch.app.scenarios import coupled_scenario_setup
from dedflow_tpu_torch.app.scenarios import box_channel_bcs, reference_scenario_config
from dedflow_tpu_torch.app.scenarios import laser_source, melt_pool_initial_state
from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config, reference_initial_state
from dedflow_tpu_torch.config import BCSpec
from dedflow_tpu_torch.dem import grid as dem_grid
from dedflow_tpu_torch.dem.cells import CellGrid, cell_stats, make_grid
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.integrate import DEMConfig
from dedflow_tpu_torch.dem.particles import particle_state
from dedflow_tpu_torch.mesh.gen import box_mesh, delaunay_mesh, mixed_box_mesh
from dedflow_tpu_torch.parallel import dryrun
from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
from dedflow_tpu_torch.parallel.spmd import SlabComm
from dedflow_tpu_torch.solver.krylov import gmres
from dedflow_tpu_torch.solver.newton import assemble_system

BOX = (4, 3, 6)  # 7 node layers: 4 + 3 on 2 ranks, 3 + 2 + 2 on 3
SEED = 5
CLI_STEPS = 2


def weak_x_config():
    """The reference scenario with the x+ face (do-nothing there) weak as
    well: its facets span every rank, across the seams."""
    return reference_scenario_config(bcs=box_channel_bcs() + (BCSpec(boundary=1, weak=True),))


CONFIGS = {"ref": reference_scenario_config, "weakx": weak_x_config}


def case_state(mesh):
    """The reference initial state with seeded perturbations (numpy)."""
    wg, dwgold, dwg = reference_initial_state(mesh)
    rng = np.random.default_rng(SEED)
    return (wg + 0.05 * rng.standard_normal(wg.shape), dwgold + 0.05 * rng.standard_normal(
        wg.shape), dwg + 0.1 * rng.standard_normal(wg.shape))


def probe_vector(num_node: int) -> np.ndarray:
    """(6, N) seeded vector for the product and the preconditioner."""
    return np.random.default_rng(SEED + 1).standard_normal((6, num_node))


# The RCB mode's cases: name -> (mesh, configuration, melt pool). Each
# mesh is one the JAX ShardedNSSolver RCB-partitions (its
# tests/test_sharding.py:77-110 Delaunay mesh, a box forced to gather whose
# weak z+ facets cross the parts, the melt pool with its source, an
# assembly chunk, a mixed box on use_lattice "winell").
RCB_CASES = {
    "delaunay": (lambda: delaunay_mesh(500, seed=7),
                 lambda: reference_scenario_config(bcs=(), pin_pressure=True), False),
    "gather": (lambda: box_mesh(5, 4, 6), lambda: reference_scenario_config(use_lattice="gather"),
               False),
    "melt": (lambda: box_mesh(4, 4, 4), lambda: melt_pool_scenario_config(use_lattice="gather"),
             True),
    "chunk": (lambda: box_mesh(*BOX), lambda: reference_scenario_config(assembly_chunk=64), False),
    "mixed": (lambda: mixed_box_mesh(3, 3, 4, prism_layers=1),
              lambda: reference_scenario_config(use_lattice="winell"), False),
}
MELT_T = 0.05  # the laser's time for the melt case's source


def rcb_state(mesh, melt: bool):
    """(wgold, dwgold, dwg, source or None) of an RCB case (numpy)."""
    if not melt:
        return (*case_state(mesh), None)
    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    rng = np.random.default_rng(SEED)
    dwg = dwg + 0.1 * rng.standard_normal(dwg.shape)
    src = laser_source(melt_pool_scenario_config().physics.laser, mesh.xg, MELT_T)
    return wg + 0.05 * rng.standard_normal(wg.shape), dwgold, dwg, src


def global_keys(s) -> np.ndarray:
    """row * N + column of each of the rank's matrix entries, in the
    mesh's node order."""
    plan = s.gctx.win_plan
    return s.own[plan.grow] * s.mesh.num_node + s.layout.nodes[plan.col]


class NoWholeVector:
    """A context in which every torch.distributed collective that moves a
    whole vector (all_gather, gather, broadcast, scatter and their object
    forms) raises; `calls` counts the attempts."""

    NAMES = ("all_gather", "all_gather_into_tensor", "all_gather_object", "gather",
             "gather_object", "broadcast", "broadcast_object_list", "scatter", "all_to_all",
             "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor")

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self.saved = {n: getattr(dist, n) for n in self.NAMES if hasattr(dist, n)}

        def refuse(*a, **k):
            self.calls += 1
            raise AssertionError("a collective that moves a whole vector ran on the RCB path")

        for n in self.saved:
            setattr(dist, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(dist, n, f)


def rcb_scenarios(device: str, out: dict) -> None:
    """Every RCB case on this process group: F, J (each rank's entries with
    their global keys), the K7 halo product, the field-split apply, the
    halo exchange against the ghosts' own values, GMRES, step_fixed(2) and
    step, the step with every whole-vector collective refused; rank 0 adds
    the gathered arrays to `out`."""
    world, rank = dist.get_world_size(), dist.get_rank()
    for name, (make_mesh, make_cfg, melt) in RCB_CASES.items():
        mesh, cfg = make_mesh(), make_cfg()
        s = ShardedNSSolver(mesh, cfg, device=device)
        wg, dwgold, dwg, src = rcb_state(mesh, melt)
        state = [s.shard_state(a) for a in (wg, dwgold, dwg)]
        source = None if src is None else s.shard_nodal(src)
        phys, scheme = cfg.physics, cfg.time

        def gather(t, key):
            full = s.gather_state(t)
            if rank == 0:
                out[f"rcb_{name}_{key}"] = full

        f = s.residual(*state, source=source)
        gather(f.T, "F")
        jm, pc = assemble_system(s.pctx, s.face_ctxs, s.mask_t, *state, phys, scheme,
                                 cfg.implicit_scalars)
        x = s.shard_state(probe_vector(mesh.num_node).T).T.contiguous()
        gather(jm.matvec_t(x).T, "Ax")
        gather(pc(x).T, "Px")
        ghosts = s.shard_nodal(probe_vector(mesh.num_node).T, ghosts=True).T
        halo_ok = bool(torch.equal(s.comm.exchange(x), ghosts))
        sol = gmres(jm.matvec_t, f, maxit=120, atol=1e-12, rtol=1e-6, pc=pc,
                    allreduce=s.comm.allreduce_sum)
        gather(sol.x.T, "gmres_x")
        for key, t in zip(("wgold", "dwgold", "dwg"),
                          s.step_fixed(*state, num_newton=2, source=source)):
            gather(t, f"fixed_{key}")
        s.comm.stats.reset()
        with NoWholeVector() as guard:
            *new, stats = s.step(*state, source=source)
        st = s.comm.stats
        for key, t in zip(("wgold", "dwgold", "dwg"), new):
            gather(t, f"step_{key}")
        plan = s.comm.plan
        hist = {"mode": s.mode, "fastpath": s.fastpath, "keys": global_keys(s),
                "vals": jm.vals.numpy(), "halo_ok": halo_ok, "gmres_iters": sol.iters,
                "gmres_rhist": sol.rhist.numpy(), "step_krylov": np.asarray(stats.krylov_iters),
                "step_rnorms": np.stack(stats.rnorms), "step_converged": stats.converged,
                "n_own": plan.n_own, "n_ghost": plan.n_ghost,
                "sent_values": sum(i.size for i in plan.send.values()),
                "peers": sorted(plan.send), "exchanges": st.exchanges,
                "sent_bytes": st.sent_bytes, "allreduces": st.allreduces,
                "whole_vector_calls": guard.calls, "elems": s.gctx.num_elem}
        hists = [None] * world if rank == 0 else None
        dist.gather_object(hist, hists, dst=0)
        if rank == 0:
            for r, h in enumerate(hists):
                out.update({f"rcb_{name}_rank{r}_{k}": np.asarray(v) for k, v in h.items()})


# The coupled FEM-DEM cases: name -> (mesh, configuration). The box takes
# the z-slab mode, the Delaunay mesh (the RCB cases' first) the RCB mode.
# COUPLED_P particles of coupled_scenario_setup's default radius (a 5%
# solids fraction: 0.0499 on the unit box) give an (11, 11, 11) DEM grid,
# whose reach omax = 133 cells fits a slab of 666 / 444 cells on 2 / 3
# ranks; the cell capacity is the cloud's largest occupancy + 1 (the JAX
# reference's sweep compiles in time with K).
COUPLED_CASES = {
    "box": (lambda: box_mesh(*BOX), reference_scenario_config),
    "delaunay": RCB_CASES["delaunay"][:2],
}
COUPLED_P = 48
COUPLED_NEWTON = 2


def coupled_setup(mesh, device):
    """(CoupledConfig, ParticleState) of a coupled case on `device`."""
    ccfg, pst = coupled_scenario_setup(mesh, num_particles=COUPLED_P, device=device)
    k = cell_stats(ccfg.dem.grid, pst.x.cpu().numpy())["max_per_cell"] + 1
    grid = dataclasses.replace(ccfg.dem.grid, capacity=k)
    return dataclasses.replace(ccfg, dem=dataclasses.replace(ccfg.dem, grid=grid)), pst


def packed_cloud():
    """90 particles of radius 0.03 on a jittered 10 x 3 x 3 lattice of
    spacing 0.058 along x from 0.28 to 0.80, every lattice neighbour
    touching, across the seams of 2 and 3 ranks' slabs; walls, gravity,
    linear drag and an external force; a (15, 15, 15) grid (omax 241 fits
    a slab of 1,688 / 1,125 cells on 2 / 3 ranks) of capacity the largest
    occupancy + 1. Returns (x, v, radius, DEMConfig, ext)."""
    rng = np.random.default_rng(7)
    i = np.arange(90)
    x = np.stack([0.28 + (i % 10) * 0.058, 0.45 + (i // 10 % 3) * 0.058,
                  0.45 + (i // 30) * 0.058], axis=1) + rng.uniform(-0.002, 0.002, size=(90, 3))
    v = rng.normal(scale=0.05, size=(90, 3))
    grid = make_grid([0, 0, 0], [1, 1, 1], cell_size=0.08, capacity=1)
    grid = dataclasses.replace(grid, capacity=cell_stats(grid, x)["max_per_cell"] + 1)
    cfg = DEMConfig(grid=grid, contact=ContactParams(k_n=2e3, gamma_n=3.0, mu=0.3, gamma_t=2.0),
                    gravity=(0.0, 0.0, -9.81), dt=1e-4, walls_lo=(0, 0, 0), walls_hi=(1, 1, 1),
                    linear_drag=0.5)
    ext = np.random.default_rng(8).normal(scale=0.2, size=x.shape)
    return x, v, 0.03, cfg, ext


def coarse_cloud():
    """Twelve particles on a (3, 3, 3) grid (cells of 0.5): omax = 13 fits
    a slab of 14 cells on 2 ranks, not of 9 on 3, where the run stays
    replicated."""
    rng = np.random.default_rng(9)
    x = rng.uniform(0.1, 0.9, size=(12, 3))
    v = rng.normal(scale=0.05, size=(12, 3))
    grid = CellGrid(origin=(-0.25, -0.25, -0.25), cell_size=0.5, dims=(3, 3, 3), capacity=8)
    cfg = DEMConfig(grid=grid, contact=ContactParams(k_n=2e3, gamma_n=3.0), dt=1e-4,
                    walls_lo=(0, 0, 0), walls_hi=(1, 1, 1))
    return x, v, 0.12, cfg, None


# The sharded dem_run_grid's cases: one rebuild window of DEM_STEPS substeps.
DEM_CASES = {"packed": packed_cloud, "coarse": coarse_cloud}
DEM_STEPS = 5


def dem_case_run(name: str, device, shard=None):
    """dem_run_grid over one window of DEM_STEPS substeps of a DEM case."""
    x, v, r, cfg, ext = DEM_CASES[name]()
    st = particle_state(x, v, radius=r, mass=1.0, device=device)
    ext_t = None if ext is None else torch.as_tensor(ext, dtype=st.x.dtype, device=st.x.device)
    return dem_grid.dem_run_grid(cfg, st, DEM_STEPS, rebuild_every=DEM_STEPS, ext=ext_t,
                                 shard=shard)


def coupled_scenarios(device: str, out: dict) -> None:
    """The coupled cases on this process group: CoupledSolver(sharded=True)
    .step(num_newton=COUPLED_NEWTON) from the case's state, with every
    whole-vector collective refused (the drag exchange moves O(P) values
    and bands); on the box, the DEM substeps with use_grid=False (dem_run
    on every rank) from the initial drag; the sharded dem_run_grid of the
    DEM cases; on the RCB
    mesh, HaloComm.reverse_add of the local rows of a seeded nodal array.
    Rank 0 adds the gathered arrays and every rank's counters to `out`."""
    world, rank = dist.get_world_size(), dist.get_rank()
    hist = {}
    for name, (make_mesh, make_cfg) in COUPLED_CASES.items():
        mesh = make_mesh()
        ccfg, pst = coupled_setup(mesh, device)
        s = CoupledSolver(mesh, make_cfg(), ccfg, device=device, sharded=True)
        state = [s.fluid.shard_state(a) for a in case_state(mesh)]
        dem_grid.dem_run_grid.windows.update(slabs=0, replicated=0)
        timings = {}
        with NoWholeVector() as guard:
            *new, p1, _ = s.step(*state, pst, num_newton=COUPLED_NEWTON, timings=timings)
        for key, t in zip(("wgold", "dwgold", "dwg"), new):
            full = s.fluid.gather_state(t)
            if rank == 0:
                out[f"coupled_{name}_{key}"] = full
        hist.update({f"coupled_{name}_{k}": v for k, v in (
            ("x", p1.x.numpy()), ("v", p1.v.numpy()), ("mode", s.fluid.mode),
            ("windows", [dem_grid.dem_run_grid.windows[k] for k in ("slabs", "replicated")]),
            ("dem_exchanges", s.dem_comm.stats.exchanges),
            ("fluid_exchanges", s.fluid.comm.stats.exchanges),
            ("whole_vector_calls", guard.calls), ("timings", sorted(timings)))})
        if name == "box":  # use_grid=False: the candidate-list DEM, replicated on every rank
            f_p = s.drag(state[0], pst)[0]
            s.ccfg = dataclasses.replace(ccfg, use_grid=False)
            cand = s.advance_particles(pst, f_p)
            hist.update(coupled_box_candidates_x=cand.x.numpy(),
                        coupled_box_candidates_v=cand.v.numpy())
        if s.fluid.mode == "rcb":
            y = s.fluid.shard_nodal(probe_vector(mesh.num_node)[:3].T, ghosts=True).T
            got = s.fluid.gather_state(s.fluid.comm.reverse_add(y.contiguous()).T)
            if rank == 0:
                out[f"coupled_{name}_reverse_add"] = got
    for name in DEM_CASES:
        comm = SlabComm()
        dem_grid.dem_run_grid.windows.update(slabs=0, replicated=0)
        got = dem_case_run(name, device, shard=comm)
        hist.update({f"dem_{name}_{k}": v for k, v in (
            ("x", got.x.numpy()), ("v", got.v.numpy()), ("exchanges", comm.stats.exchanges),
            ("windows", [dem_grid.dem_run_grid.windows[k] for k in ("slabs", "replicated")]))})
    hists = [None] * world if rank == 0 else None
    dist.gather_object(hist, hists, dst=0)
    if rank == 0:
        for r, h in enumerate(hists):
            out.update({f"{k}_rank{r}": np.asarray(v) for k, v in h.items()})


# the CLI's modes: the box on z-slabs, and with assembly chunks (the RCB mode)
CLI_MODES = {"slab": (), "rcb": ("--chunk", "64")}


def cli_argv(devices: int, out: str, mode: str = "slab") -> list:
    return ["--box", *map(str, BOX), "--steps", str(CLI_STEPS), "--save-every", "1",
            "--devices", str(devices), "--device", "cpu", "--dtype", "f64", "--out", out,
            "--log-level", "warning", *CLI_MODES[mode]]


def cli_coupled_argv(devices: int, out: str) -> list:
    """The coupled scenario's CLI run: one adaptive step of COUPLED_P
    particles on the box, snapshots sol.0, sol.1 and particles.1."""
    return ["--scenario", "coupled", "--box", *map(str, BOX), "--particles", str(COUPLED_P),
            "--steps", "1", "--save-every", "1", "--devices", str(devices), "--device", "cpu",
            "--dtype", "f64", "--out", out, "--log-level", "warning"]


def scenarios(device: str, out_dir: str) -> None:
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = box_mesh(*BOX)
    out = {}

    def gather(s, t, key, node_axis=-1):
        """The rank's own rows gathered in node order."""
        full = s.gather_state(t.movedim(node_axis, 0))
        if rank == 0:
            out[key] = np.moveaxis(full, 0, node_axis)

    hist = {}
    for name, make in CONFIGS.items():
        cfg = make()
        s = ShardedNSSolver(mesh, cfg, device=device)
        state = [s.shard_state(a) for a in case_state(mesh)]
        f = s.residual(*state)
        jm, pc = assemble_system(s.sctx, s.face_ctxs, s.mask_t, *state, cfg.physics, cfg.time)
        gather(s, f, f"{name}_F")
        gather(s, jm.data, f"{name}_data")
        gather(s, jm.scal, f"{name}_scal")
        if name != "ref":
            continue
        x = s.shard_state(probe_vector(mesh.num_node).T).T.contiguous()
        gather(s, jm.matvec_t(x), "ref_Ax")
        gather(s, pc(x), "ref_Px")
        sol = gmres(jm.matvec_t, f, maxit=120, atol=1e-12, rtol=1e-6, pc=pc,
                    allreduce=s.comm.allreduce_sum)
        gather(s, sol.x, "ref_gmres_x")
        for key, t in zip(("wgold", "dwgold", "dwg"), s.step_fixed(*state, num_newton=2)):
            gather(s, t, f"fixed_{key}", 0)
        *new, stats = s.step(*state)
        for key, t in zip(("wgold", "dwgold", "dwg"), new):
            gather(s, t, f"step_{key}", 0)
        everywhere = s.gather_state(new[2], broadcast=True)  # the same array on every rank
        hist = {"gmres_iters": sol.iters, "gmres_rhist": sol.rhist.numpy(),
                "step_krylov": np.asarray(stats.krylov_iters),
                "step_rnorms": np.stack(stats.rnorms), "step_converged": stats.converged,
                "sent_bytes": s.comm.stats.sent_bytes, "allreduces": s.comm.stats.allreduces,
                "n_own": s.sctx.n_own, "broadcast_dwg": everywhere}
    hists = [None] * world if rank == 0 else None
    dist.gather_object(hist, hists, dst=0)
    if rank == 0:
        for r, h in enumerate(hists):
            out.update({f"rank{r}_{k}": np.asarray(v) for k, v in h.items()})

    rcb_scenarios(device, out)
    coupled_scenarios(device, out)

    # the CLI's --devices runs, in this process group (the coupled one on 2 ranks)
    rcs = {}
    argvs = {mode: cli_argv(world, os.path.join(
        out_dir, f"cli{world}" + ("" if mode == "slab" else f"_{mode}")), mode) for mode in CLI_MODES}
    if world == 2:
        argvs["coupled"] = cli_coupled_argv(world, os.path.join(out_dir, "cli2_coupled"))
    for mode, argv in argvs.items():
        args = tmain._parser().parse_args(argv)
        rcs[mode] = tmain.run(args, tmain.RunFiles(), tmain.get_logger(level="warning"),
                              torch.device(device))
    # the dry run's body, in both modes
    fixed = {mode: dryrun._dryrun_rank(device, world, mode) for mode in dryrun.MODES}
    if rank == 0:
        for mode, rc in rcs.items():
            out["cli_rc" if mode == "slab" else f"cli_{mode}_rc"] = np.asarray(rc)
        for mode, states in fixed.items():
            for key, a in zip(("wgold", "dwgold", "dwg"), states):
                out[f"dryrun_{key}" if mode == "slab" else f"dryrun_{mode}_{key}"] = a
        np.savez(os.path.join(out_dir, f"w{world}.npz"), **out)


def fails(device: str) -> None:
    """Rank 1 raises while rank 0 waits for it in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank one gives up")
    dist.barrier()


def hangs(device: str) -> None:
    time.sleep(600)


def slab_kernels_on_card(device: str, box: tuple, seed: int):
    """A rank of tests/test_torch_kernels_cuda.py's slab test: F, J and a
    product of J on this rank's slab of `box` (K1, K2 and K3's banded
    entry), with the plain twins replaced by functions that raise; rank 0
    returns the gathered arrays and each rank's launch counts."""
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.sparse import dia_kernels as dk

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran on the card")

    lat.residual_volume_plain = lat.jacobian_volume_plain = refuse
    dk.dia_matvec_banded_plain = refuse
    counters = (lat.residual_volume, lat.jacobian_volume, dk.dia_matvec_banded)
    for c in counters:
        c.launches = 0
    mesh = box_mesh(*box)
    cfg = reference_scenario_config()
    s = ShardedNSSolver(mesh, cfg, device=device)
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(seed).standard_normal(dwg.shape)
    state = [s.shard_state(a) for a in (wg, dwgold, dwg)]
    f = s.residual(*state)
    jm, _ = assemble_system(s.sctx, s.face_ctxs, s.mask_t, *state, cfg.physics, cfg.time)
    x = np.random.default_rng(seed + 1).standard_normal((6, mesh.num_node))
    y = jm.matvec_t(s.shard_state(x.T).T.contiguous())
    out = [s.gather_state(t.movedim(-1, 0)) for t in (f, jm.data, jm.scal, y)]
    launches = [None] * s.comm.world if dist.get_rank() == 0 else None
    dist.gather_object([c.launches for c in counters], launches, dst=0)
    if dist.get_rank() == 0:
        return [np.moveaxis(a, 0, -1) for a in out], x, launches
