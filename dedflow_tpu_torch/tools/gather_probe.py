"""K13: the element gather probe on the card (counterpart of the JAX
package's tools/gather_probe.py).

    python -m dedflow_tpu_torch.tools.gather_probe [W] [--device cuda|cpu]

The element gather

    out[a * C + c, m] = win[idx[a, m], c]        -> (4 C, M)

of the C = 16 state rows of the 4 nodes of each of M = 64 x 1024 elements
(4 x 1024 on the CPU, as the JAX tool off the device) from a (W, C) node
window (W = 4096), by two idioms of the hand-written
kernel csrc/gather_probe.cu: "global" (each node row read through L1/L2,
as K10 and K4/K5 gather) and "staged" (the window copied into shared
memory first, in passes of columns that fit a block). One line each, as
the JAX tool reports (ms, rows/s, effective GB/s, max|err| against the
plain gather), where ms is the kernel's time with its launches queued
ahead of the card (tools/timing.py), then the share of the bound (bytes:
idx, the window rows the ids select and out once, at 3.35 TB/s; a few
microseconds), the paced time (the launches as the host issues them,
which at this size set the time), the plain version's time and the
launches. Then the library rows: `win[idx]` on the same inputs, and the
tool's XLA baseline's counterpart, `x[gidx]` of (65,536, 4) rows from a
(200,000, 16) table. The device line names the card and its power limit;
`--device cpu` runs the plain version (host-clock times, no device metric).
The JAX tool's `interpret` argument has no counterpart.

`element_gather` launches the kernel on CUDA tensors (replacing the TPU
kernels tools/gather_probe.py::_onehot_kernel, pallas_call at :60, and
::_tala_kernel, :76) and runs `element_gather_plain` on CPU tensors; it
counts its launches. A gather is exact: kernel and plain agree bit for
bit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dedflow_tpu_torch.tools.timing import (
    Probe,
    device_line,
    measure,
    nbytes,
    sector_bytes,
    time_ms,
)
from dedflow_tpu_torch.utils import nvcc
from dedflow_tpu_torch.utils.dtypes import resolve_device

E = 1024  # elements a block (tools/gather_probe.py:28)
W = 4096  # nodes of the window (:29)
C = 16  # state rows gathered a node (:30)
NB = 64  # blocks (:121): M = NB * E elements
LIB_NODES = 200_000  # rows of the XLA baseline's table (:163)
MAX_SMEM = 232448  # a block's shared memory on sm_90 (the staged idiom's table)
REPS = 10  # chained calls a timing sample (the tool's r2 - r1, :107)


def staged_passes(w: int) -> int:
    """Column passes of the staged idiom: the fewest of 1, 2, 4 whose
    (w, 16 / passes) float32 table fits a block."""
    for npass in (1, 2, 4):
        if w * (C // npass) * 4 <= MAX_SMEM:
            return npass
    raise ValueError(f"element_gather staged idiom: a window of at most "
                     f"{MAX_SMEM // (C // 4 * 4)} nodes, got {w}")


def element_gather_plain(idx: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """(4 C, M): out[a * C + c, m] = win[idx[a, m], c], 0 for an id outside
    [0, W)."""
    ok = (idx >= 0) & (idx < win.shape[0])
    g = win[torch.where(ok, idx, 0).long()]  # (4, M, C)
    g = torch.where(ok[..., None], g, torch.zeros((), dtype=win.dtype, device=win.device))
    return g.permute(0, 2, 1).reshape(4 * win.shape[1], idx.shape[1])


def element_gather(idx: torch.Tensor, win: torch.Tensor, idiom: str = "global") -> torch.Tensor:
    """The element gather: the kernel by the "global" or "staged" idiom on
    CUDA tensors (int32 (4, M) idx, float32 (W, 16) win), the plain version
    on CPU tensors."""
    if idiom not in ("global", "staged"):
        raise ValueError(f"element_gather: idiom 'global' or 'staged', got {idiom!r}")
    if not win.is_cuda:
        return element_gather_plain(idx, win)
    if (idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != 4 or idx.shape[1] == 0
            or not idx.is_contiguous() or idx.device != win.device):
        raise ValueError(f"element_gather kernel: contiguous int32 (4, M) ids on win's card, "
                         f"got {idx.dtype} {tuple(idx.shape)}")
    if (win.dtype != torch.float32 or win.dim() != 2 or win.shape[1] != C
            or not win.is_contiguous() or win.data_ptr() % 16):
        raise ValueError(f"element_gather kernel: a contiguous, 16-byte aligned float32 "
                         f"(W, {C}) window, got {win.dtype} {tuple(win.shape)}")
    npass = staged_passes(win.shape[0]) if idiom == "staged" else 0
    fn = nvcc.function("gather_probe", "dedflow_element_gather",
                       [nvcc.P, nvcc.P, nvcc.P, nvcc.I, nvcc.I, nvcc.I, nvcc.P])
    m = idx.shape[1]
    out = torch.empty((4 * C, m), dtype=torch.float32, device=win.device)
    nvcc.check(fn(idx.data_ptr(), win.data_ptr(), out.data_ptr(), m, win.shape[0],
                  npass, torch.cuda.current_stream(win.device).cuda_stream),
               "element_gather")
    element_gather.launches += 1
    return out


element_gather.launches = 0


def window_bytes(idx: torch.Tensor, win: torch.Tensor) -> int:
    """Bytes of the window's 32-byte sectors that the ids select: the
    (64-byte) rows of the nodes in [0, W) they name."""
    rows = idx[(idx >= 0) & (idx < win.shape[0])].long() * C
    return sector_bytes(torch.cat([rows, rows + C // 2]), win.element_size())


def probes(idx: torch.Tensor, win: torch.Tensor) -> list:
    """The two idioms on (idx, win); the library call `win[idx]` (int64 ids
    made here, outside its timing) gives (4, M, C), the kernel's output
    read as (4, C, M) and transposed."""
    m = idx.shape[1]
    idx64 = idx.long()
    out = torch.empty((4 * C, m), dtype=win.dtype, device=win.device)
    moved = nbytes(idx, out) + window_bytes(idx, win)
    res = []
    for idiom in ("global", "staged"):
        kern = lambda idiom=idiom: element_gather(idx, win, idiom)
        res.append(Probe(idiom, f"element gather, {idiom}", kern,
                         lambda: element_gather_plain(idx, win),
                         (lambda: win[idx64],
                          lambda kern=kern: kern().view(4, C, m).permute(0, 2, 1)),
                         moved, 0, element_gather))
    return res


def inputs(w: int, device, seed: int = 0, nb: int = NB) -> tuple:
    """idx int32 (4, nb E) uniform in [0, w), win float32 (w, C) standard
    normal, from a seeded generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, w, (4, nb * E), generator=gen, device=device, dtype=torch.int32)
    win = torch.randn((w, C), generator=gen, device=device, dtype=torch.float32)
    return idx, win


def report(name: str, ms: float, rows: int, extra: str = "") -> str:
    """The JAX tool's report line (tools/gather_probe.py:112-118)."""
    return (f"{name:8s} ok  {ms:8.4f} ms  {rows / ms / 1e6:8.2f} G rows/s  "
            f"{rows * C * 4 / ms / 1e6:8.1f} GB/s effective {extra}")


def run(w: int, device) -> list:
    """Time both idioms at a window of w nodes on `device` and print the
    lines; one record an idiom (tools.timing.measure, with its launches)."""
    nb = NB if device.type == "cuda" else 4  # the JAX tool's 4 blocks off the device (:121)
    idx, win = inputs(w, device, nb=nb)
    m = idx.shape[1]
    print(device_line(device), flush=True)
    print(f"W = {w}, C = {C}, M = {m} elements ({nb} blocks of {E}), "
          f"{staged_passes(w)} staged pass(es)", flush=True)
    recs = []
    for p in probes(idx, win):
        rec = measure(p, device, REPS)
        recs.append(rec)
        extra = f" max|err| {rec['max_abs_err']:.1e}"
        if rec["paced_ms"] is not None:
            extra += (f"  {rec['bound_ms'] / rec['ms']:6.1%} of bound ({rec['bound_ms']:.4f} ms)"
                      f"  paced {rec['paced_ms']:.4f} ms")
        print(report(p.name, rec["ms"], 4 * m, extra + f"  plain {rec['plain_ms']:.4f} ms  "
                     f"launches {rec['launches']}"), flush=True)
    print(report("win[idx]", recs[0]["library_ms"], 4 * m, " (library, the same inputs)"),
          flush=True)
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((LIB_NODES, C), generator=gen, device=device, dtype=torch.float32)
    gidx = torch.randint(0, LIB_NODES, (m, 4), generator=gen, device=device)
    print(report("x[gidx]", time_ms(lambda: x[gidx], REPS, device=device), 4 * m,
                 f" (library, ({m}, 4) rows of a ({LIB_NODES}, {C}) table: the tool's xla line)"),
          flush=True)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("w", type=int, nargs="?", default=W, help="nodes of the window")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    run(args.w, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
