"""Command-line driver of the port: the reference, lid-driven cavity,
moving-laser melt-pool or coupled FEM-DEM powder-settling scenario on a box
mesh or on a mesh read from an HDF5 file, with solution snapshots, restarts,
a JSONL metrics stream and profiler traces (counterpart of
dedflow_tpu/app/main.py).

    python -m dedflow_tpu_torch.app.main [--box NX NY NZ | --mesh PATH \\
        [--no-lattice-recover]] [--steps K] --device cuda|cpu --dtype f32|f64 \\
        [--config cfg.json] [--chunk E] [--scenario reference|cavity|melt-pool] \\
        [--fixed-newton K] [--pc fieldsplit|simple|mg] [--precision state|f64|ir] \\
        [--out DIR] [--save-every S] [--resume N] [--metrics FILE] [--profile DIR] \\
        [--log-level debug|info|warning]
    python -m dedflow_tpu_torch.app.main --scenario coupled --box 55 55 55 \\
        --particles 100000 [--particle-radius R] [--dem-substeps 10] [--no-dem-grid]

`--mesh PATH` reads a mesh in the reference's HDF5 schema (io.h5,
tools/mesh_convert.py's files). On a file without lattice metadata the run
first tries mesh.recover.recover_lattice, as the JAX CLI does: a box stored
as an unstructured tet soup comes back in lattice order with its cells' own
tet split, and the solver takes the lattice tier; `--no-lattice-recover`
skips that, and a translation-regular mesh then runs on the classes tier.
A file with prism / hex tables (tools.mesh_convert's `wedge` and
`hexahedron` cells) runs as in the JAX CLI: recovery skips it and the
solver takes the tier whose stencil holds its cells (solver.newton).
`--mesh` excludes `--box`; without either the run takes box 8 8 8, as the
JAX CLI's does. The coupled scenario runs on generated boxes only (its
particle locator assumes the Kuhn split). `--steps K` runs K time steps;
without it the run takes the config's `num_steps` (4000 for the built-in
scenarios), as the JAX CLI does. `--config` loads a SolverConfig from JSON
in place of the scenario's (config.load_config). It replaces the scenario
as a whole, BCs included, so start from the reference scenario's own JSON:
`config.save_config(reference_scenario_config(use_lattice="winell"),
path)` runs the box on the windowed irregular tier, `use_lattice="gather"`
on the general gather tier. `--chunk E` sets the assembly chunk (E
elements per range), which puts the run on the general gather tier.
`--scenario cavity` is the lid-driven cavity (BASELINE config #2),
`--scenario melt-pool` the moving-laser melt pool (BASELINE config #3: the
phi/T equations active with their implicit tangents; each step evaluates
the laser source at the generalized-alpha time level (step - 1 + alpha_f)
dt, with the absolute step after a restart). `--fixed-newton K` steps with
K Newton iterations each (`step_fixed`) instead of the adaptive loop.
`--scenario coupled` releases `--particles` particles in the upper half of
the box (app.scenarios.coupled_scenario_setup, the JAX CLI's defaults) and
steps app.coupled.CoupledSolver: drag exchange, the fluid step with the
drag reaction as a nodal load, then the DEM substeps (the grid-resident
path with kernel K11 unless --no-dem-grid). `--pc` picks the Krylov
preconditioner and `--precision` the linear solve's precision, with the
JAX CLI's meanings (config.KrylovConfig). `--precision ir` without
`--dtype` runs a float32 state on either device.

Outputs, as the JAX CLI's (dedflow_tpu/app/main.py:286-398): the directory
`--out` (default ".") is made; a fresh run writes `sol.0.h5`, the initial
state, before its first step, and every run writes `sol.<step>.h5` after
each step that `--save-every` (default: the config's `save_every`, 10)
divides, and with the coupled scenario `particles.<step>.h5` (group "ptc",
dem.particles.save_particles) beside it. `--resume N` reads
`out/sol.N.h5`, rebuilds the state as the reference does (wg with a zero
pressure slot, dwgold = dwg; io.h5.state_from_datasets) and runs steps
N+1 .. N+K. On a recovered mesh the files hold the file's node order: the
state is permuted through the recovery's node permutation on the way out
and back on the way in. The solution files need h5py: a run without it
stops before it builds the solver (exit code 2), never skipping a snapshot.
`--metrics` (default out/metrics.jsonl) appends one JSON record a step
(utils.log.MetricsWriter: step, t, step_wall_s, and from the adaptive loop
newton_iters, converged, rnorm, krylov_iters and linear_rel; wall_s);
`--profile DIR` wraps the steps in a torch.profiler trace written to DIR
(utils.profiling.trace; the card's kernels included); `--log-level` sets
the stderr logger's level (utils.log.get_logger). Prints one JSON line per
time step on stdout: step, the scenario, the assembly tier (`fastpath`),
wall seconds (after a device synchronize), the largest temperature
(`t_max`) and, from the adaptive loop, Newton iterations, Krylov
iterations per Newton iteration, the last field norms and whether Newton
converged. A non-finite residual or temperature ends the run with exit
code 2. The JAX CLI's --platform is the port's --device.

`--devices N` (N > 1; the JAX CLI's, dedflow_tpu/app/main.py:74, 255-283)
runs a scenario on N ranks (parallel.sharded.ShardedNSSolver, started
by parallel.launch), on any mesh: a Kuhn box on its lattice tier
with each rank owning a z-slab of it, every other mesh (`--mesh FILE`,
`--chunk`, a config's use_lattice "gather" / "winell", the melt pool)
RCB-partitioned onto the gather tier with each rank owning a part and
exchanging its ghosts. On "cuda" one card a rank under NCCL where there
are N cards, else every rank on card 0 under gloo; on "cpu" gloo. Rank 0
writes the snapshots, the metrics (with the ranks and the backend) and
the JSON lines from the gathered state, the same files as one process;
the other ranks log warnings only. `--scenario coupled --devices N` runs
app.coupled.CoupledSolver(sharded=True) on the ranks: the fluid in either
mode, the DEM on cell slabs with K11's halo entry; rank 0 writes
`sol.<step>.h5` from the gathered state and `particles.<step>.h5` (the
particles are the same on every rank). Every option ShardedNSSolver does
not take raises, naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dedflow_tpu_torch.app.coupled import CoupledSolver
from dedflow_tpu_torch.app.scenarios import (
    coupled_scenario_setup,
    laser_source,
    lid_driven_cavity_config,
    lid_driven_cavity_initial_state,
    melt_pool_initial_state,
    melt_pool_scenario_config,
    reference_initial_state,
    reference_scenario_config,
)
from dedflow_tpu_torch.config import load_config
from dedflow_tpu_torch.dem.particles import save_particles
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.io.h5 import read_mesh_h5, read_solution_h5, write_solution_h5
from dedflow_tpu_torch.mesh.gen import box_mesh
from dedflow_tpu_torch.mesh.recover import recover_lattice
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.utils.dtypes import parse_dtype, resolve_device
from dedflow_tpu_torch.utils.log import MetricsWriter, get_logger
from dedflow_tpu_torch.utils.profiling import trace


@dataclass(frozen=True)
class RunFiles:
    """The run's mesh, solution and particle file calls: HDF5 through h5py
    by default (io.h5, dem.particles). A caller on a machine without h5py
    passes its own with `needs_h5py=False` (chip_smoke.py keeps the
    datasets of io.h5.solution_datasets in memory)."""

    read_mesh: Callable = read_mesh_h5  # --mesh path -> Mesh
    write_solution: Callable = write_solution_h5  # (path, wg, dwg, step=, time=)
    read_solution: Callable = read_solution_h5  # path -> {"wg", "dwg", ...}
    save_particles: Callable = save_particles  # (path, group, state)
    needs_h5py: bool = True


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    m = p.add_mutually_exclusive_group()
    m.add_argument("--mesh", default=None,
                   help="mesh HDF5 (schema of tools/mesh_convert; needs h5py)")
    m.add_argument("--box", type=int, nargs=3, default=(8, 8, 8), metavar=("NX", "NY", "NZ"),
                   help="box cells per axis (default 8 8 8)")
    p.add_argument("--no-lattice-recover", action="store_true",
                   help="skip structured-lattice recovery on --mesh files")
    p.add_argument("--steps", type=int, default=None,
                   help="time steps to run (default: the config's num_steps)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--dtype", choices=("f32", "f64"), default=None,
                   help="default: f32 on cuda, f64 on cpu")
    p.add_argument("--config", default=None,
                   help="SolverConfig JSON (default: the reference scenario)")
    p.add_argument("--chunk", type=int, default=None,
                   help="assembly chunk size (elements per range; the gather tier)")
    p.add_argument("--scenario", choices=("reference", "cavity", "melt-pool", "coupled"),
                   default="reference",
                   help="reference channel flow / lid-driven cavity / moving-laser melt "
                   "pool / coupled FEM-DEM powder settling")
    p.add_argument("--fixed-newton", type=int, default=None, metavar="K",
                   help="K Newton iterations a step (step_fixed) instead of the adaptive loop")
    p.add_argument("--pc", choices=("fieldsplit", "simple", "mg"), default=None,
                   help="Krylov preconditioner (default: the config's): fieldsplit = the "
                   "reference's block-Jacobi split; simple = SIMPLE pressure-Schur; mg = SIMPLE "
                   "with a multigrid Schur solve (geometric on the lattice, AMG on WinELL)")
    p.add_argument("--precision", choices=("state", "f64", "ir"), default=None,
                   help="linear-solve precision (default: the config's): state = the state "
                   "dtype; f64 = float64 Krylov; ir = float32 GMRES + float64 iterative "
                   "refinement to 1e-10 relative linear residuals")
    p.add_argument("--particles", type=int, default=1000,
                   help="particle count for --scenario coupled")
    p.add_argument("--particle-radius", type=float, default=None,
                   help="particle radius (default: ~5%% solids fraction)")
    p.add_argument("--dem-substeps", type=int, default=10,
                   help="DEM substeps per fluid step (coupled scenario)")
    p.add_argument("--no-dem-grid", action="store_true",
                   help="use the candidate-list DEM path instead of the dense "
                   "grid-resident one")
    p.add_argument("--out", default=".", help="output directory (snapshots, metrics)")
    p.add_argument("--save-every", type=int, default=None,
                   help="write sol.<step>.h5 every S steps (default: the config's save_every)")
    p.add_argument("--resume", type=int, default=0, metavar="N",
                   help="resume from out/sol.<N>.h5")
    p.add_argument("--metrics", default=None,
                   help="JSONL metrics file (default out/metrics.jsonl)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="torch.profiler trace directory")
    p.add_argument("--log-level", default="info")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="ranks of a decomposed run (z-slabs of a box, else RCB parts)")
    return p


def load_mesh(args, log, read_mesh=read_mesh_h5):
    """(mesh, node permutation old -> new or None) of the parsed arguments:
    the --mesh file (read by `read_mesh`), recovered into lattice order
    unless --no-lattice-recover, or the box (8, 8, 8 by default); log lines
    describe it, as the JAX CLI's do."""
    if not args.mesh:
        box = tuple(args.box)
        mesh = box_mesh(*box)
        log.info("box mesh %dx%dx%d: %d nodes, %d tets", *box, mesh.num_node, mesh.num_tet)
        return mesh, None
    mesh = read_mesh(args.mesh)
    log.info("mesh %s: %d nodes, %d tets", args.mesh, mesh.num_node, mesh.num_tet)
    if mesh.lattice is not None or args.no_lattice_recover:
        return mesh, None
    rec = recover_lattice(mesh)
    if rec is None:
        log.info("no structured lattice recovered")
        return mesh, None
    mesh, perm = rec
    nx, ny, nz = mesh.lattice
    log.info("recovered %dx%dx%d lattice (%d tets/cell); solution files keep the file's "
             "node order", nx, ny, nz, len(mesh.lattice_tets))
    return mesh, perm


def _h5py_missing() -> str | None:
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        return str(e)
    return None


def main(argv=None, files: RunFiles | None = None) -> int:
    args = _parser().parse_args(argv)
    log = get_logger(level=args.log_level)
    files = files or RunFiles()
    if args.scenario == "coupled" and args.mesh:
        log.error("--scenario coupled runs on generated boxes only (--box)")
        return 2
    # every run writes sol.0.h5 or reads the snapshot it resumes from
    missing = _h5py_missing() if files.needs_h5py else None
    if missing:
        log.error("the solution files (%s/sol.<step>.h5) need h5py, which does not import "
                  "(%s)", args.out, missing)
        return 2
    device = resolve_device(args.device)
    log.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if args.devices > 1:
        from dedflow_tpu_torch.parallel import launch
        from dedflow_tpu_torch.parallel.sharded import KERNEL_LIBRARIES

        log.info("%d ranks, backend %s", args.devices, launch.backend_for(args.devices,
                                                                         device.type))
        if device.type == "cuda":
            from dedflow_tpu_torch.utils import nvcc

            nvcc.load(KERNEL_LIBRARIES)
        return launch.spawn(_rank_run, args.devices, device.type, args=(args, files))[0]
    return run(args, files, log, device)


def _rank_run(device: str, args, files: RunFiles) -> int:
    """One rank of a --devices run (parallel.launch.spawn's function)."""
    import torch.distributed as dist

    level = args.log_level if dist.get_rank() == 0 else "warning"
    return run(args, files, get_logger(level=level), torch.device(device))


def run(args, files: RunFiles, log, device: torch.device) -> int:
    """The run of the parsed arguments on `device`: one process, or this
    rank of a --devices run (its process group started)."""
    import torch.distributed as dist

    sharded = args.devices > 1
    rank0 = not sharded or dist.get_rank() == 0
    os.makedirs(args.out, exist_ok=True)
    # ir = a float32 state with float64 refinement (the JAX CLI's rule)
    dtype = torch.float32 if args.precision == "ir" and args.dtype is None else parse_dtype(
        args.dtype, device)
    mesh, node_perm = load_mesh(args, log, files.read_mesh)
    scenario_config, initial_state = {
        "cavity": (lid_driven_cavity_config, lid_driven_cavity_initial_state),
        "melt-pool": (melt_pool_scenario_config, melt_pool_initial_state),
    }.get(args.scenario, (reference_scenario_config, reference_initial_state))
    cfg = load_config(args.config) if args.config else scenario_config()
    overrides = {k: v for k, v in (("num_steps", args.steps), ("save_every", args.save_every),
                                   ("assembly_chunk", args.chunk)) if v is not None}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    krylov = {k: v for k, v in (("pc", args.pc), ("precision", args.precision)) if v}
    if krylov:
        cfg = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, **krylov))
    coupled = args.scenario == "coupled"
    if coupled:
        ccfg, pstate = coupled_scenario_setup(
            mesh, num_particles=args.particles, radius=args.particle_radius,
            substeps=args.dem_substeps, use_grid=not args.no_dem_grid,
            device=device, dtype=dtype,
        )
        csolver = CoupledSolver(mesh, cfg, ccfg, device=device, dtype=dtype, sharded=sharded)
        solver = csolver.fluid
        log.info("coupled FEM-DEM: %d particles r=%.4g, %d DEM substeps/step, grid path=%s",
                 pstate.num_particle, float(pstate.radius[0]), args.dem_substeps,
                 not args.no_dem_grid)
    elif sharded:
        from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver

        solver = ShardedNSSolver(mesh, cfg, device=device, dtype=dtype)
        log.info("rank 0 of %d: %s mode, %d own nodes, backend %s", solver.comm.world,
                 solver.mode, len(solver.own), solver.comm.backend)
    else:
        solver = NSSolver(mesh, cfg, device=device, dtype=dtype)
    log.info("assembly fastpath: %s", solver.fastpath)

    # a recovered lattice's files keep the input mesh's node order
    if node_perm is not None:
        inv_perm = np.argsort(node_perm)
        from_file_order = lambda a: np.asarray(a)[inv_perm]
        to_file_order = lambda a: np.asarray(a)[node_perm]
    else:
        from_file_order = to_file_order = lambda a: a
    to_host = lambda t: t.detach().cpu().numpy()
    t_max = lambda wg: float(wg[:, 5].max())
    if sharded:  # collectives: every rank calls them, rank 0 gets the state
        to_host = solver.gather_state
        t_max = lambda wg: float(solver.comm.allreduce_max(wg[:, 5].max()))

    dt, laser = cfg.time.dt, cfg.physics.laser
    step0 = args.resume
    if step0:
        snap = files.read_solution(os.path.join(args.out, f"sol.{step0}.h5"))
        wg_np, dwg_np = from_file_order(snap["wg"]), from_file_order(snap["dwg"])
        dwgold_np = dwg_np.copy()  # the reference resumes with dwgold = dwg
        log.info("resumed from step %d", step0)
    else:
        wg_np, dwgold_np, dwg_np = initial_state(mesh)
        if rank0:
            files.write_solution(os.path.join(args.out, "sol.0.h5"), to_file_order(wg_np),
                                 to_file_order(dwg_np), step=0, time=0.0)
    if sharded:
        wg, dwgold, dwg = (solver.shard_state(a) for a in (wg_np, dwgold_np, dwg_np))
    else:
        wg, dwgold, dwg = state_from_numpy(wg_np, dwgold_np, dwg_np, device, dtype)

    metrics = MetricsWriter(args.metrics or os.path.join(args.out, "metrics.jsonl")) if rank0 \
        else None
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with trace(args.profile if rank0 else None, cuda=device.type == "cuda"):
        for step in range(step0 + 1, step0 + cfg.num_steps + 1):
            src = None
            if laser is not None:
                # the moving source at the generalized-alpha level
                t_alpha = (step - 1 + cfg.time.alpha_f) * dt
                src = laser_source(laser, mesh.xg, t_alpha)
                src = torch.as_tensor(src[solver.own] if sharded else src, dtype=dtype,
                                      device=device)
            sync()
            t0 = time.perf_counter()
            stats = None
            if coupled:
                wg, dwgold, dwg, pstate, stats = csolver.step(wg, dwgold, dwg, pstate)
            elif args.fixed_newton:
                wg, dwgold, dwg = solver.step_fixed(
                    wg, dwgold, dwg, num_newton=args.fixed_newton, source=src
                )
            else:
                wg, dwgold, dwg, stats = solver.step(wg, dwgold, dwg, source=src)
            sync()
            wall = time.perf_counter() - t0
            line = {
                "step": step,
                "scenario": args.scenario,
                "fastpath": solver.fastpath,
                "wall_s": wall,
                "t_max": t_max(wg),
            }
            rec = {"step": step, "t": step * dt, "step_wall_s": round(wall, 4)}
            if sharded:
                line["ranks"] = rec["ranks"] = solver.comm.world
                rec["backend"] = solver.comm.backend
            if stats is not None:
                line.update(
                    newton_iters=len(stats.rnorms),
                    krylov_iters=stats.krylov_iters,
                    field_norms=[float(v) for v in stats.rnorms[-1]],
                    converged=stats.converged,
                )
                rec.update(newton_iters=len(stats.rnorms), converged=bool(stats.converged))
                if stats.rnorms:
                    rec["rnorm"] = [float(v) for v in stats.rnorms[-1]]
                rec["krylov_iters"] = stats.krylov_iters
                if stats.linear_rels:
                    rec["linear_rel"] = [float(v) for v in stats.linear_rels]
            if rank0:
                metrics.write(**rec)
                print(json.dumps(line), flush=True)
            finite = line.get("field_norms", []) + [line["t_max"]]
            if not all(map(math.isfinite, finite)):
                log.error("non-finite residual or temperature at step %d; aborting", step)
                if rank0:
                    metrics.close()
                return 2
            log.info("step %d  t=%.4f  wall=%.3fs%s", step, step * dt, wall,
                     f"  newton={rec['newton_iters']}" if stats else "")
            if step % cfg.save_every == 0:
                wg_host, dwg_host = to_host(wg), to_host(dwg)
                if rank0:
                    files.write_solution(os.path.join(args.out, f"sol.{step}.h5"),
                                         to_file_order(wg_host), to_file_order(dwg_host),
                                         step=step, time=step * dt)
                if coupled and rank0:
                    files.save_particles(os.path.join(args.out, f"particles.{step}.h5"), "ptc",
                                         pstate)
    if rank0:
        metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
