"""Time the lattice kernels K1 (residual, no source) and K2 (Jacobian,
frozen-scalar mode, masked with the facet band) of the dedflow_tpu_torch
package found under ROOT, on the card, at box_mesh(55, 55, 55) with the
reference scenario and chip_smoke.py's perturbed state (seed 0).

    python dedflow_tpu_torch/app/kernel_ab.py --root CHECKOUT [--reps 5]

Two checkouts (say a parent commit unpacked beside the working tree) are
compared on one card by running this once per checkout, in turns: parent,
change, change, parent. Each run builds that checkout's kernels, imports
only that checkout's package, and prints one JSON line: the root, the card
(`nvidia-smi` name and power limit) and, per kernel, the CUDA-event times
of `reps` blocks of launches after warm-up.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="checkout whose dedflow_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=5, help="timed blocks per kernel")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import dedflow_tpu_torch
    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver, predict
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    if root not in Path(dedflow_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported {dedflow_tpu_torch.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the kernels run only there")
    mesh = box_mesh(55, 55, 55)
    cfg = reference_scenario_config()
    solver = NSSolver(mesh, cfg, device="cuda")
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, "cuda", torch.float32)
    wa, dwa = alpha_states(wg, dwgold, predict(dwg, cfg.time), cfg.time)
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    phys, scheme, lctx = cfg.physics, cfg.time, solver.lctx
    keep = keep_pc_rows(solver.mask_t, torch.float32)
    add = diag_add_rows(solver.mask_t, torch.float32)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, len(lctx.offsets), keep)
    keep16, add16 = keep[:16].contiguous(), add[:16].contiguous()
    kernels = {
        "K1": (lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme), 20),
        "K2": (lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, band, lo), 10),
    }
    out = {"root": str(root)}
    for name, (fn, n) in kernels.items():
        for _ in range(2):
            fn()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        out[f"{name}_ms"] = times
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
