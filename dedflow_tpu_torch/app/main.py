"""Command-line driver of the port: the reference, lid-driven cavity,
moving-laser melt-pool or coupled FEM-DEM powder-settling scenario on a box
mesh.

    python -m dedflow_tpu_torch.app.main [--box NX NY NZ] [--steps K] \\
        --device cuda|cpu --dtype f32|f64 [--config cfg.json] [--chunk E] \\
        [--scenario reference|cavity|melt-pool] [--fixed-newton K] \\
        [--pc fieldsplit|simple|mg] [--precision state|f64|ir]
    python -m dedflow_tpu_torch.app.main --scenario coupled --box 55 55 55 \\
        --particles 100000 [--particle-radius R] [--dem-substeps 10] [--no-dem-grid]

`--box` defaults to 8 8 8, as the JAX CLI's. `--steps K` runs K time
steps; without it the run takes the config's `num_steps` (4000 for the
built-in scenarios), as the JAX CLI does. `--config` loads a SolverConfig
from JSON in place of the reference scenario's (config.load_config, as the
JAX CLI's --config). It replaces the scenario as a whole, BCs included, so
start from the reference scenario's own JSON:
`config.save_config(reference_scenario_config(use_lattice="winell"),
path)` runs the box on the windowed irregular tier, `use_lattice="gather"`
on the general gather tier. `--chunk E` sets the assembly chunk (E
elements per range, as the JAX CLI's --chunk), which puts the run on the
general gather tier. `--scenario cavity` is the lid-driven cavity
(BASELINE config #2), `--scenario melt-pool` the moving-laser melt pool
(BASELINE config #3: the phi/T equations active with their implicit
tangents; each step evaluates the laser source at the generalized-alpha
time level (step - 1 + alpha_f) dt, as the JAX CLI does,
app/main.py:331-351). `--fixed-newton K` steps with K Newton iterations
each (`step_fixed`, the JAX CLI's production loop) instead of the adaptive
loop. `--scenario coupled` releases `--particles` particles in the upper
half of the box (app.scenarios.coupled_scenario_setup, the JAX CLI's
defaults) and steps app.coupled.CoupledSolver: drag exchange, the fluid
step with the drag reaction as a nodal load, then the DEM substeps (the
grid-resident path with kernel K11 unless --no-dem-grid). `--pc` picks the
Krylov preconditioner and `--precision` the linear solve's precision, with
the JAX CLI's meanings (config.KrylovConfig): fieldsplit = the reference's
block-Jacobi split; simple = the SIMPLE pressure-Schur split (lattice and
gather tiers; fieldsplit on WinELL); mg = SIMPLE with a multigrid Schur
solve (geometric on the lattice, algebraic on WinELL, SIMPLE on the gather
tier). state = solve in the state dtype; f64 = the whole Krylov solve in
float64; ir = float32 GMRES with float64 iterative refinement to 1e-10
relative linear residuals. `--precision ir` without `--dtype` runs a
float32 state on either device. Prints one JSON line per time step: step,
the scenario, the assembly tier (`fastpath`), wall seconds (after a device
synchronize), the largest temperature (`t_max`) and, from the adaptive
loop, Newton iterations, Krylov iterations per Newton iteration, the last
field norms and whether Newton converged. Other flags of the JAX CLI
(restarts, HDF5 snapshots, sharding) are not ported yet (ROADMAP queues
A16, A17). """

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

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
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.mesh.gen import box_mesh
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.utils.dtypes import parse_dtype, resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--box", type=int, nargs=3, default=(8, 8, 8),
                   metavar=("NX", "NY", "NZ"), help="box cells per axis (default 8 8 8)")
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
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    # ir = a float32 state with float64 refinement (the JAX CLI's rule)
    dtype = torch.float32 if args.precision == "ir" and args.dtype is None else parse_dtype(
        args.dtype, device)
    mesh = box_mesh(*args.box)
    scenario_config, initial_state = {
        "cavity": (lid_driven_cavity_config, lid_driven_cavity_initial_state),
        "melt-pool": (melt_pool_scenario_config, melt_pool_initial_state),
    }.get(args.scenario, (reference_scenario_config, reference_initial_state))
    cfg = load_config(args.config) if args.config else scenario_config()
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, num_steps=args.steps)
    if args.chunk is not None:
        cfg = dataclasses.replace(cfg, assembly_chunk=args.chunk)
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
        csolver = CoupledSolver(mesh, cfg, ccfg, device=device, dtype=dtype)
        solver = csolver.fluid
    else:
        solver = NSSolver(mesh, cfg, device=device, dtype=dtype)
    wg, dwgold, dwg = state_from_numpy(*initial_state(mesh), device, dtype)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    dt, laser = cfg.time.dt, cfg.physics.laser
    for step in range(1, cfg.num_steps + 1):
        src = None
        if laser is not None:
            # the moving source at the generalized-alpha level
            t_alpha = (step - 1 + cfg.time.alpha_f) * dt
            src = torch.as_tensor(laser_source(laser, mesh.xg, t_alpha), dtype=dtype, device=device)
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
        rec = {
            "step": step,
            "scenario": args.scenario,
            "fastpath": solver.fastpath,
            "wall_s": time.perf_counter() - t0,
            "t_max": float(wg[:, 5].max()),
        }
        if stats is not None:
            rec.update(
                newton_iters=len(stats.rnorms),
                krylov_iters=stats.krylov_iters,
                field_norms=[float(v) for v in stats.rnorms[-1]],
                converged=stats.converged,
            )
        print(json.dumps(rec), flush=True)
        finite = rec.get("field_norms", []) + [rec["t_max"]]
        if not all(map(math.isfinite, finite)):
            print(f"non-finite residual or temperature at step {step}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
