"""Command-line driver of the port: the reference scenario on a box mesh.

    python -m dedflow_tpu_torch.app.main --box NX NY NZ --steps K \\
        --device cuda|cpu --dtype f32|f64

Prints one JSON line per time step: step, wall seconds (after a device
synchronize), Newton iterations, Krylov iterations per Newton iteration,
the last field norms and whether Newton converged. Other flags of the JAX
CLI (scenarios, restarts, HDF5 snapshots, sharding) are not ported yet
(ROADMAP queue A17).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from dedflow_tpu_torch.app.scenarios import (
    reference_initial_state,
    reference_scenario_config,
)
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
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = parse_dtype(args.dtype, device)
    mesh = box_mesh(*args.box)
    solver = NSSolver(mesh, reference_scenario_config(), device=device, dtype=dtype)
    wg, dwgold, dwg = state_from_numpy(*reference_initial_state(mesh), device, dtype)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for step in range(1, args.steps + 1):
        sync()
        t0 = time.perf_counter()
        wg, dwgold, dwg, stats = solver.step(wg, dwgold, dwg)
        sync()
        rec = {
            "step": step,
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
