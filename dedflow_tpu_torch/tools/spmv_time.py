"""Time K3 (sparse/dia_kernels.py::dia_matvec) alone on the card.

    python -m dedflow_tpu_torch.tools.spmv_time [--box 55] [--planes 15] [--dtype f32]

The matrix is random, (D, 16, N) + (2D, N) with N the node count of the
(box, box, box) lattice; `--planes 15` takes the Kuhn lattice's offsets
(fem/lattice.py::lattice_tables), `--planes 27` every corner difference
of its cell. Prints one JSON line: the card's name and power limit, D, N,
the dtype and the kernel's milliseconds (tools/timing.py::time_ms, 100
chained calls, the median of 5 runs) beside its bytes bound. Run from two
checkouts in turns, it compares two versions of the kernel on one card.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    import torch

    from dedflow_tpu_torch.fem.lattice import lattice_tables
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec
    from dedflow_tpu_torch.tools.timing import HBM_BYTES_PER_S, card_line, nbytes, time_ms

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--box", type=int, default=55)
    ap.add_argument("--planes", type=int, choices=(15, 27), default=15)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("spmv_time: needs a CUDA card")
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
