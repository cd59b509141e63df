"""Nonlinear parity of the card's float32 steps with a float64 oracle
(counterpart of the JAX package's tools/nonlinear_f64_check.py).

    python -m dedflow_tpu_torch.tools.nonlinear_f64_check [box_n=31] [steps=2] \\
        [--device cuda|cpu] [--out PATH]

The reference is float64 end to end (common.h:21-59). The JAX tool runs
the same generalized-alpha Newton solves in float64 on its accelerator
through its XLA lattice pipeline (`lattice_backend="xla"`) and on its host
CPU, and the float32 fast path with precision "ir" beside them. The port
has no float64 mode on the card: its element kernels (K1, K2, K4-K6) are
float32 by design (fem/element_kernels.py), and `lattice_backend` is the
JAX package's A9 option, which the port does not carry. So the oracle
here is the port's own float64 step on the CPU (the plain versions, held
against the JAX package at 1e-9 by the CPU tests), and against it run, on
`device`, the float32 step with precision "ir" (float32 GMRES in float64
iterative refinement) and with the default precision ("state"). Each run
takes `steps` adaptive steps of the reference scenario on
box_mesh(box_n, box_n, box_n) from its initial state.

Prints one JSON line: per run the last Newton iteration's four field
norms each step, the Newton and Krylov counts, the final state's relative
difference from the oracle's (max |x - x64| / max |x64| over wgold) and
the wall seconds of each step (synchronised; on a fresh process the first
card step includes the kernels' build); `device_f64` is null and
`device_f64_absent` says why. `--out` also writes the line to PATH.
`--device cpu` runs the float32 steps on the CPU (plain versions,
host-clock seconds, no device metric).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

DEVICE_F64_ABSENT = (
    "the port's element kernels are float32 on the card and the JAX package's "
    "lattice_backend='xla' (ROADMAP A9) has no counterpart, so there is no float64 "
    "step on the card; the oracle is the port's float64 step on the CPU"
)


def run_steps(mesh, cfg, device, dtype, steps: int) -> dict:
    """`steps` adaptive steps from the reference initial state: the final
    wgold on the CPU, and per step the last field norms, the Newton and
    Krylov counts and the wall seconds."""
    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import NSSolver

    solver = NSSolver(mesh, cfg, device=device, dtype=dtype)
    state = state_from_numpy(*reference_initial_state(mesh), solver.device, dtype)
    sync = torch.cuda.synchronize if solver.device.type == "cuda" else (lambda: None)
    out = {"fastpath": solver.fastpath, "field_norms": [], "newton_iters": [],
           "krylov_iters": [], "wall_s": []}
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        *state, stats = solver.step(*state)
        sync()
        out["wall_s"].append(time.perf_counter() - t0)
        out["field_norms"].append([float(v) for v in stats.rnorms[-1]])
        out["newton_iters"].append(len(stats.rnorms))
        out["krylov_iters"].append(stats.krylov_iters)
    out["wgold"] = state[0].double().cpu()
    return out


def nonlinear_check(box_n: int = 31, steps: int = 2, device="cuda") -> dict:
    """The runs of the module docstring; the JSON record."""
    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.tools.timing import card_line
    from dedflow_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    mesh = box_mesh(box_n, box_n, box_n)
    cfg = reference_scenario_config()
    ir = dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, precision="ir"))
    runs = {"cpu_f64": run_steps(mesh, cfg, "cpu", torch.float64, steps),
            "device_ir": run_steps(mesh, ir, device, torch.float32, steps),
            "device_f32": run_steps(mesh, cfg, device, torch.float32, steps)}
    ref = runs["cpu_f64"]["wgold"]
    scale = max(float(ref.abs().max()), 1e-30)
    doc = {"metric": "nonlinear_f64_parity", "device": device.type,
           "card": card_line() if device.type == "cuda" else None, "box": box_n,
           "num_tet": mesh.num_tet, "steps": steps,
           "device_f64": None, "device_f64_absent": DEVICE_F64_ABSENT}
    for name, r in runs.items():
        doc[name] = {k: v for k, v in r.items() if k != "wgold"}
        if name != "cpu_f64":
            doc[name]["rel_state_diff_vs_cpu_f64"] = float((r["wgold"] - ref).abs().max()) / scale
    return doc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("box_n", type=int, nargs="?", default=31, help="box cells a side")
    p.add_argument("steps", type=int, nargs="?", default=2, help="adaptive steps")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON line to this path")
    args = p.parse_args(argv)
    line = json.dumps(nonlinear_check(args.box_n, args.steps, args.device))
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
