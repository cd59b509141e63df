"""Command-line driver of the port: the reference scenario, or the coupled
FEM-DEM powder-settling scenario, on a box mesh.

    python -m dedflow_tpu_torch.app.main --box NX NY NZ --steps K \\
        --device cuda|cpu --dtype f32|f64 [--config cfg.json] [--chunk E]
    python -m dedflow_tpu_torch.app.main --scenario coupled --box 55 55 55 \\
        --particles 100000 [--particle-radius R] [--dem-substeps 10] [--no-dem-grid]

`--config` loads a SolverConfig from JSON in place of the reference
scenario's (config.load_config, as the JAX CLI's --config). It replaces
the scenario as a whole, BCs included, so start from the reference
scenario's own JSON: `config.save_config(reference_scenario_config(
use_lattice="winell"), path)` runs the box on the windowed irregular tier,
`use_lattice="gather"` on the general gather tier. `--chunk E` sets the
assembly chunk (E elements per range, as the JAX CLI's --chunk), which
puts the run on the general gather tier.
`--scenario coupled` releases `--particles` particles in the upper half of
the box (app.scenarios.coupled_scenario_setup, the JAX CLI's defaults) and
steps app.coupled.CoupledSolver: drag exchange, the fluid step with the
drag reaction as a nodal load, then the DEM substeps (the grid-resident
path with kernel K11 unless --no-dem-grid).
Prints one JSON line per time step: step, the scenario, the assembly tier (`fastpath`),
wall seconds (after a device synchronize), Newton iterations, Krylov
iterations per Newton iteration, the last field norms and whether Newton
converged. Other flags of the JAX CLI (the melt-pool and cavity
scenarios, restarts, HDF5 snapshots, sharding) are not ported yet (ROADMAP
queues A12, A16, A17).
"""

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
    p.add_argument("--box", type=int, nargs=3, default=(10, 10, 10),
                   metavar=("NX", "NY", "NZ"), help="box cells per axis")
    p.add_argument("--steps", type=int, default=2, help="time steps to run")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--dtype", choices=("f32", "f64"), default=None,
                   help="default: f32 on cuda, f64 on cpu")
    p.add_argument("--config", default=None,
                   help="SolverConfig JSON (default: the reference scenario)")
    p.add_argument("--chunk", type=int, default=None,
                   help="assembly chunk size (elements per range; the gather tier)")
    p.add_argument("--scenario", choices=("reference", "coupled"), default="reference",
                   help="reference channel flow / coupled FEM-DEM powder settling")
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
    dtype = parse_dtype(args.dtype, device)
    mesh = box_mesh(*args.box)
    cfg = load_config(args.config) if args.config else reference_scenario_config()
    if args.chunk is not None:
        cfg = dataclasses.replace(cfg, assembly_chunk=args.chunk)
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
    wg, dwgold, dwg = state_from_numpy(*reference_initial_state(mesh), device, dtype)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for step in range(1, args.steps + 1):
        sync()
        t0 = time.perf_counter()
        if coupled:
            wg, dwgold, dwg, pstate, stats = csolver.step(wg, dwgold, dwg, pstate)
        else:
            wg, dwgold, dwg, stats = solver.step(wg, dwgold, dwg)
        sync()
        rec = {
            "step": step,
            "scenario": args.scenario,
            "fastpath": solver.fastpath,
            "wall_s": time.perf_counter() - t0,
            "newton_iters": len(stats.rnorms),
            "krylov_iters": stats.krylov_iters,
            "field_norms": [float(v) for v in stats.rnorms[-1]],
            "converged": stats.converged,
        }
        print(json.dumps(rec), flush=True)
        if not all(map(math.isfinite, rec["field_norms"])):
            print(f"non-finite residual at step {step}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
