"""Time the lattice kernels K1 (residual, no source) and K2 (Jacobian,
frozen-scalar mode, masked with the facet band) of the dedflow_tpu_torch
package found under ROOT, on the card, at box_mesh(55, 55, 55) with the
reference scenario and chip_smoke.py's perturbed state (seed 0); with
`--reduces` also the segmented reduces K8 (6 rows) and K9 (16 rows) on the
WinELL plans of delaunay_mesh(56**3) + RCM and on the gather tier's plans
of the same mesh in its generated order, over seeded random element rows
(about 50 s of host set-up on top).

    python dedflow_tpu_torch/app/kernel_ab.py --root CHECKOUT [--reps 5] [--reduces]

Two checkouts (say a parent commit unpacked beside the working tree) are
compared on one card by running this once per checkout, in turns: parent,
change, change, parent. Each run builds that checkout's kernels, imports
only that checkout's package, and prints one JSON line: the root, the card
(`nvidia-smi` name and power limit) and, per kernel, the median CUDA-event
time of `reps` blocks of launches after warm-up. The clock and the card
line are this script's own checkout's (tools/timing.py, loaded by path, so
that any ROOT can be timed by the same clock). Each kernel's output also
gets a digest (the first 16 hex digits of the SHA-256 of its bytes), so
that two checkouts' results can be compared bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path


def _timing():
    """tools/timing.py of the checkout this script is in."""
    path = Path(__file__).resolve().parents[1] / "tools" / "timing.py"
    spec = importlib.util.spec_from_file_location("_kernel_ab_timing", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # the dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


def _reduce_kernels():
    """{name: (call, reps)} of K8 and K9 on the WinELL and the gather plans
    of delaunay_mesh(56**3) (chip_smoke.py's phases 6 and 12)."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.fem.win_assembly import JAC_COMPS
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce

    raw = delaunay_mesh(56**3, seed=0)
    rcm = reorder_mesh(raw, rcm_order(raw.ien, raw.num_node))
    wsolver = NSSolver(rcm, reference_scenario_config(bcs=(), pin_pressure=True), device="cuda")
    gsolver = NSSolver(raw, reference_scenario_config(
        bcs=(), pin_pressure=True, scatter_method="tiered", elements_kernel="pallas"),
        device="cuda")
    if (wsolver.fastpath, gsolver.fastpath) != ("winell", "gather"):
        raise RuntimeError(f"tiers {wsolver.fastpath}, {gsolver.fastpath}: not winell, gather")
    wctx, gctx = wsolver.wctx, gsolver.gctx
    (grange,) = gctx.ranges
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for tier, ne, res_plan, jac_plan in (
        ("winell", wctx.num_elem, wctx.res_plan, wctx.jac_plan),
        ("gather", gctx.num_elem, grange.res_plan, grange.jac_plan),
    ):
        rows24 = torch.randn((24, ne), generator=gen, device="cuda")
        rows288 = torch.randn((288, ne), generator=gen, device="cuda")
        out[f"K8_{tier}"] = (lambda p=res_plan, x=rows24, m=ne: stream_reduce(p, x, range(6), m), 50)
        out[f"K9_{tier}"] = (lambda p=jac_plan, x=rows288, m=ne: ring_reduce(p, x, JAC_COMPS, m), 20)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="checkout whose dedflow_tpu_torch is timed")
    p.add_argument("--reps", type=int, default=5, help="timed blocks per kernel")
    p.add_argument("--reduces", action="store_true",
                   help="also K8 and K9 on the WinELL and gather plans of delaunay_mesh(56**3)")
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
    if args.reduces:
        kernels.update(_reduce_kernels())
    timing = _timing()
    out = {"root": str(root)}
    for name, (fn, n) in kernels.items():
        out[f"{name}_ms"] = timing.time_ms(fn, n, samples=args.reps)
        got = fn().contiguous().cpu()
        out[f"{name}_digest"] = hashlib.sha256(got.numpy().tobytes()).hexdigest()[:16]
    out["card"] = timing.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
