"""On-card numerics self-check of the lattice tier's kernels against their
plain versions (counterpart of the JAX package's tools/tpu_selfcheck.py).

    python -m dedflow_tpu_torch.tools.selfcheck [n] [--device cuda|cpu] [--out PATH]

The CPU tests hold the kernels' plain versions against the JAX package;
only the card runs the kernels. At box_mesh(n, n - 2, n - 1) (n = 8 by
default, the JAX tool's mesh) with the reference scenario, float32, from
the reference initial state with a seeded perturbation of dwg, it runs:

1. K1 (csrc/lattice_residual.cu: the volume residual) against its plain
   version;
2. K2 (csrc/lattice_jacobian.cu) with the solver's Dirichlet mask and
   facet band, and K2' (the unmasked mode: keep 1, add 0, no band),
   against their plain versions,

each twice (the two kernel runs must be equal bit for bit: no atomics),
at chip_smoke.py's tolerances: relative error max|kernel - plain| /
max|plain| <= 2e-5 (the JAX package's own fused-vs-unfused bar,
lattice.py:749-750). chip_smoke.py's phase 3 takes the same pairs
(`lattice_pairs`) at box 55. Prints one JSON line; `--out` also writes it
to PATH. `--device cpu` runs the plain versions on both sides (a dry run
of the tool, no device metric).
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Callable

import torch

TOL_K1 = 2e-5  # the JAX package's fused-vs-unfused bar (lattice.py:749)
TOL_K2 = 2e-5
SEED = 0


@dataclass
class Pair:
    """A kernel call and its plain version on the same inputs, with the
    tolerance that holds them together."""

    kernel: Callable
    plain: Callable
    tol: float


@dataclass
class LatticePairs:
    """The lattice tier's kernels on one state: K1, K2 masked (the
    solver's mask and facet band) and K2' (unmasked), and the inputs they
    read (for byte counts)."""

    k1: Pair
    k2: Pair
    k2u: Pair
    inputs: dict


def perturbed_state(mesh, device, dtype, seed: int = SEED):
    """The reference initial state with dwg + 0.1 N(0, 1) (a seeded
    numpy generator, so every input row of the element bodies is
    non-zero), advanced by one predict: (wgold, dwgold, dwg)."""
    import numpy as np

    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import predict

    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(seed).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, device, dtype)
    return wg, dwgold, predict(dwg, reference_scenario_config().time)


def lattice_pairs(solver, wa, dwa) -> LatticePairs:
    """K1, K2 and K2' of a lattice-tier `solver` at the alpha states
    (wa, dwa) (N, 6)."""
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

    phys, scheme = solver.cfg.physics, solver.cfg.time
    lctx, mask_t = solver.lctx, solver.mask_t
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    keep_pc = keep_pc_rows(mask_t, solver.dtype)
    add18 = diag_add_rows(mask_t, solver.dtype)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme,
                                     len(lctx.offsets), keep_pc)
    keep16, add16 = keep_pc[:16].contiguous(), add18[:16].contiguous()
    ones16, zeros16 = torch.ones_like(keep16), torch.zeros_like(add16)

    def k2(f, keep, add, *banded):
        return lambda: f(lctx, wa_t, phys, scheme, keep, add, *banded)

    return LatticePairs(
        k1=Pair(lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme),
                lambda: lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme), TOL_K1),
        k2=Pair(k2(lat.jacobian_volume, keep16, add16, band, lo),
                k2(lat.jacobian_volume_plain, keep16, add16, band, lo), TOL_K2),
        k2u=Pair(k2(lat.jacobian_volume, ones16, zeros16),
                 k2(lat.jacobian_volume_plain, ones16, zeros16), TOL_K2),
        inputs=dict(wa_t=wa_t, dwa_t=dwa_t, keep16=keep16, add16=add16, band=band, lo=lo,
                    ones16=ones16, zeros16=zeros16, keep_pc=keep_pc, add18=add18),
    )


def check_pair(pair: Pair) -> dict:
    """Two kernel runs and one plain run: finite, bit-identical runs, the
    max abs and relative errors, and whether the relative error is within
    the pair's tolerance."""
    got, again, ref = pair.kernel(), pair.kernel(), pair.plain()
    err = float((got.double() - ref.double()).abs().max())
    rel = err / max(float(ref.double().abs().max()), 1e-300)
    finite, repeat = bool(torch.isfinite(got).all()), torch.equal(got, again)
    return {"max_abs_err": err, "rel": rel, "tol": pair.tol, "finite": finite,
            "repeat_bitwise": repeat, "pass": finite and repeat and rel <= pair.tol}


def selfcheck(n: int = 8, device="cuda") -> dict:
    """The checks of the module docstring on `device`; the JSON record."""
    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver
    from dedflow_tpu_torch.tools.timing import card_line

    mesh = box_mesh(n, n - 2, n - 1)
    solver = NSSolver(mesh, reference_scenario_config(), device=device, dtype=torch.float32)
    wg, dwgold, dwg = perturbed_state(mesh, solver.device, torch.float32)
    pairs = lattice_pairs(solver, *alpha_states(wg, dwgold, dwg, solver.cfg.time))
    checks = {"K1": check_pair(pairs.k1), "K2": check_pair(pairs.k2),
              "K2'": check_pair(pairs.k2u)}
    on_card = solver.device.type == "cuda"
    return {"metric": "selfcheck", "device": solver.device.type,
            "card": card_line() if on_card else None, "num_tet": mesh.num_tet,
            "fastpath": solver.fastpath, "checks": checks,
            "pass": all(c["pass"] for c in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=8, help="box_mesh(n, n - 2, n - 1)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON line to this path")
    args = p.parse_args(argv)
    doc = selfcheck(args.n, args.device)
    line = json.dumps(doc)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0 if doc["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
