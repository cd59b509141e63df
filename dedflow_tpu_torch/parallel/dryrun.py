"""The multi-device dry run (counterpart of
__graft_entry__.py::dryrun_multichip, :47-93): the reference scenario
and one step_fixed(num_newton=2) of ShardedNSSolver on n ranks.

    python -m dedflow_tpu_torch.parallel.dryrun 2 [--device cpu] [--mode rcb]

The JAX dry run steps box_mesh(2n, 3, 3), cut along x into n lane shards.
Its 4 node layers along z cannot give 4 ranks 2 layers each under the
port's z-slab cut, so this one steps box_mesh(3, 3, 2n): the same cells
with z long. `mode` "slab" (the default) runs it on z-slabs; "rcb" runs
the same box with use_lattice "gather", which ShardedNSSolver
RCB-partitions onto the gather tier. On "cuda" the ranks take one card
each where there are n (NCCL), else they share card 0 (gloo;
parallel.launch); on "cpu" they run gloo on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


MODES = {"slab": {}, "rcb": {"use_lattice": "gather"}}  # the reference scenario's overrides


def _dryrun_rank(device: str, n: int, mode: str = "slab"):
    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver

    mesh = box_mesh(3, 3, 2 * n)
    solver = ShardedNSSolver(mesh, reference_scenario_config(**MODES[mode]), device=device)
    if solver.mode != mode:
        raise RuntimeError(f"dryrun: ShardedNSSolver took mode {solver.mode!r}, not {mode!r}")
    state = [solver.shard_state(a) for a in reference_initial_state(mesh)]
    out = solver.step_fixed(*state, num_newton=2)
    return [solver.gather_state(t) for t in out]


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0,
                     mode: str = "slab") -> tuple:
    """One sharded step_fixed(num_newton=2) of the reference scenario on
    box_mesh(3, 3, 2 * n_devices) over n_devices ranks in `mode` ("slab"
    or "rcb"); returns the gathered (wgold, dwgold, dwg), checked finite."""
    if mode not in MODES:
        raise ValueError(f"dryrun mode must be one of {tuple(MODES)}, got {mode!r}")
    from dedflow_tpu_torch.parallel.launch import spawn
    from dedflow_tpu_torch.parallel.sharded import KERNEL_LIBRARIES
    from dedflow_tpu_torch.utils.dtypes import resolve_device

    if resolve_device(device).type == "cuda":
        from dedflow_tpu_torch.utils import nvcc

        nvcc.load(KERNEL_LIBRARIES)
    state = spawn(_dryrun_rank, n_devices, device, args=(n_devices, mode), timeout=timeout)[0]
    if not all(np.isfinite(a).all() for a in state):
        raise RuntimeError("dryrun_multichip: non-finite state")
    return tuple(state)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--mode", choices=tuple(MODES), default="slab")
    args = p.parse_args(argv)
    wg, _, dwg = dryrun_multichip(args.n, args.device, mode=args.mode)
    print(json.dumps({"ranks": args.n, "device": args.device, "mode": args.mode,
                      "num_node": int(wg.shape[0]), "max_abs_dwg": float(np.abs(dwg).max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
