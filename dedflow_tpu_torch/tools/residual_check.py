"""The 1e-10 relative-residual bar of BASELINE.md on the card (counterpart
of the JAX package's tools/residual_check.py).

    python -m dedflow_tpu_torch.tools.residual_check [n] [--device cuda|cpu] [--out PATH]

The reference is float64 end to end (common.h:21-59, krylov.c:56-334);
the card's fast path assembles in float32. This tool assembles one
reference-scenario system on box_mesh(n, n, n) (n = 15 by default: 20,250
tets) in float64 on the CPU with the plain versions, as the JAX tool
assembles it on its host (:60-84), moves J and F to `device` and solves
them two ways there:

1. float64 GMRES with the field-split preconditioner: J's products go
   through K3's float64 instance on the card (rtol 1e-12, maxit 400; 200
   at n >= 40, where the float64 solve is a timing yardstick and not part
   of the bar, as in the JAX tool);
2. "ir": float32 GMRES inner solves (K3 in float32) inside float64
   iterative refinement (solver.refine.gmres_ir_device: tol 1e-12, inner
   maxit 150, inner rtol 1e-5).

Each solve runs once untimed (the kernels' build, the BLAS handles) and
once timed on the host clock, synchronised. Prints one JSON line: both
true relative residuals ||F - J x|| / ||F|| (float64 products), iteration
counts, wall seconds, the device (on the card its name and power limit)
and `pass`: both <= 1e-10 (the refinement alone at n >= 40); the exit
code is 1 without it. `--out` also writes the line to PATH. `--device
cpu` runs the plain versions: host-clock seconds, no device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

BAR = 1e-10


def assemble_f64(n: int):
    """(J, F, mesh) of the reference scenario's initial state on
    box_mesh(n, n, n), float64 on the CPU (the lattice tier's plain
    versions): J the masked field-split DIA matrix, F (6, N)."""
    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.fem.lattice import assemble_jacobian_t, assemble_residual_t
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = box_mesh(n, n, n)
    cfg = reference_scenario_config()
    s = NSSolver(mesh, cfg, device="cpu", dtype=torch.float64)
    wa, dwa = alpha_states(*state_from_numpy(*reference_initial_state(mesh), "cpu",
                                             torch.float64), cfg.time)
    args = (s.lctx, s.face_ctxs, s.mask_t, wa, dwa, cfg.physics, cfg.time)
    return assemble_jacobian_t(*args), assemble_residual_t(*args), mesh


def _timed(fn, device):
    """(result, wall seconds) of the second of two calls, synchronised."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def residual_check(n: int = 15, device="cuda") -> dict:
    """Both solves of the module docstring on `device`; the JSON record."""
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT
    from dedflow_tpu_torch.solver.refine import gmres_ir_device
    from dedflow_tpu_torch.tools.timing import card_line
    from dedflow_tpu_torch.utils.dtypes import resolve_device

    device = resolve_device(device)
    j_cpu, f_cpu, mesh = assemble_f64(n)
    j64 = dataclasses.replace(j_cpu, data=j_cpu.data.to(device), scal=j_cpu.scal.to(device))
    f64 = f_cpu.to(device)
    j32 = dataclasses.replace(j64, data=j64.data.float(), scal=j64.scal.float())
    pc64 = NSFieldSplitPCT.from_diag_rows(j64.diag_rows())
    pc32 = NSFieldSplitPCT.from_diag_rows(j32.diag_rows())
    bnorm = float(torch.linalg.vector_norm(f64))
    large = n >= 40

    def true_rel(x) -> float:
        return float(torch.linalg.vector_norm(f64 - j64.matvec_t(x))) / bnorm

    sol64, t64 = _timed(lambda: gmres(j64.matvec_t, f64, maxit=200 if large else 400, atol=0.0,
                                      rtol=1e-12, pc=pc64), device)
    info, t_ir = _timed(lambda: gmres_ir_device(j64.matvec_t, j32.matvec_t, f64, pc=pc32,
                                                tol=1e-12, inner_maxit=150, inner_rtol=1e-5),
                        device)
    r64, r_ir = true_rel(sol64.x), true_rel(info.x)
    return {
        "metric": "krylov_relative_residual",
        "bar": BAR,
        "device": device.type,
        "card": card_line() if device.type == "cuda" else None,
        "box": n,
        "num_tet": mesh.num_tet,
        "f64_gmres_rel_residual": r64,
        "f64_gmres_iters": int(sol64.iters),
        "f64_gmres_wall_s": t64,
        "ir_rel_residual": r_ir,
        "ir_cycles": int(info.cycles),
        "ir_inner_f32_iters": int(info.inner_iters),
        "ir_wall_s": t_ir,
        # at n >= 40 the capped float64 run is a timing yardstick: the
        # refinement carries the bar
        "pass": bool(r_ir <= BAR and (large or r64 <= BAR)),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=15, help="box cells a side")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON line to this path")
    args = p.parse_args(argv)
    doc = residual_check(args.n, args.device)
    line = json.dumps(doc)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
