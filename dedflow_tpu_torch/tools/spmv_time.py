"""Time K3 (sparse/dia_kernels.py::dia_matvec) alone on the card.

    python -m dedflow_tpu_torch.tools.spmv_time [--box 55] [--planes 15] [--dtype f32]
    python -m dedflow_tpu_torch.tools.spmv_time --digest [--box 55]

The matrix is random, (D, 16, N) + (2D, N) with N the node count of the
(box, box, box) lattice; `--planes 15` takes the Kuhn lattice's offsets
(fem/lattice.py::lattice_tables), `--planes 27` every corner difference
of its cell. Prints one JSON line: the card's name and power limit, D, N,
the dtype and the kernel's milliseconds (tools/timing.py::time_ms, 100
chained calls, the median of 5 runs) beside its bytes bound. Run from two
checkouts in turns, it compares two versions of the kernel on one card.

`--digest` prints instead the SHA-256 of K3's products (`k3_digests`) on
numpy-seeded inputs at the box: the whole matrix in float32 and float64
at 15 and 27 planes, and the banded entry on the first, a middle and the
last slab of a 3-rank z-slab cut (float32, and float64 where the checkout
has it). Two checkouts' digests, equal key by key, show their kernels'
products bit-equal.
"""

from __future__ import annotations

import argparse
import json


def k3_inputs(box: int, planes: int, dtype, device="cuda") -> tuple:
    """(data, scal, x, offsets) of the (box, box, box) lattice's 15 planes or
    the cell's 27 corner differences, numpy-seeded (the same on any torch)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.fem.lattice import lattice_tables

    sy, sz, _, offs, _ = lattice_tables(box, box, box)
    if planes == 27:
        offs = tuple(sorted(dx + sy * dy + sz * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)))
    n = (box + 1) ** 3
    rng = np.random.default_rng(planes)
    t = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    return t(len(offs), 16, n), t(2 * len(offs), n), t(6, n), offs


def k3_digests(dk, box: int, device="cuda") -> dict:
    """{product: SHA-256 of its output bytes} of K3 through the module `dk`
    (a checkout's sparse.dia_kernels): dia_matvec / dia_matvec_f64 on the
    whole matrix (15 and 27 planes), dia_matvec_banded on the rows of the
    first, a middle and the last of 3 z-slabs with a node layer of each
    neighbour around them (float32, and float64 where dk has
    dia_matvec_banded_f64)."""
    import hashlib

    import torch

    from dedflow_tpu_torch.fem.lattice import slab_layers

    digest = lambda y: hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    out = {}
    sz, n = (box + 1) ** 2, (box + 1) ** 3
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        whole = dk.dia_matvec if dtype == torch.float32 else dk.dia_matvec_f64
        for planes in (15, 27):
            data, scal, x, offs = k3_inputs(box, planes, dtype, device)
            out[f"whole {tag} {planes}"] = digest(whole(data, scal, x, offs))
            if planes != 15 or (tag == "f64" and not hasattr(dk, "dia_matvec_banded_f64")):
                continue
            bounds = slab_layers(box + 1, 3)
            for r, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
                a, b = lo * sz, hi * sz
                xa, xb = max(a - sz, 0), min(b + sz, n)
                y = dk.dia_matvec_banded(data[..., a:b].contiguous(), scal[:, a:b].contiguous(),
                                         x[:, xa:xb].contiguous(), offs, a - xa)
                out[f"banded {tag} {planes} slab {r}"] = digest(y)
    return out


def main(argv=None) -> int:
    import torch

    from dedflow_tpu_torch.fem.lattice import lattice_tables
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec
    from dedflow_tpu_torch.tools.timing import HBM_BYTES_PER_S, card_line, nbytes, time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, default=55)
    ap.add_argument("--planes", type=int, choices=(15, 27), default=15)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--digest", action="store_true",
                    help="print the SHA-256 of K3's products (k3_digests) instead of times")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmv_time: needs a CUDA card")
    if args.digest:
        from dedflow_tpu_torch.sparse import dia_kernels

        print(json.dumps({"card": card_line(), "box": args.box,
                          "digests": k3_digests(dia_kernels, args.box)}))
        return 0
    b = args.box
    sy, sz, _, offs, _ = lattice_tables(b, b, b)
    if args.planes == 27:
        offs = tuple(sorted(dx + sy * dy + sz * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)))
    n = (b + 1) ** 3
    dtype = torch.float32 if args.dtype == "f32" else torch.float64
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = torch.randn((len(offs), 16, n), generator=gen, device="cuda", dtype=dtype)
    scal = torch.randn((2 * len(offs), n), generator=gen, device="cuda", dtype=dtype)
    x = torch.randn((6, n), generator=gen, device="cuda", dtype=dtype)
    ms = time_ms(lambda: dia_matvec(data, scal, x, offs), reps=100, samples=5)
    print(json.dumps({"card": card_line(), "planes": len(offs), "rows": n, "dtype": args.dtype,
                      "ms": ms, "bound_ms": nbytes(data, scal, x, x) / HBM_BYTES_PER_S * 1e3}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
