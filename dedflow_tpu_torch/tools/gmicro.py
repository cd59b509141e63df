"""K12: the irregular-tier primitive probes on the card (counterpart of
the JAX package's tools/gmicro.py).

    python -m dedflow_tpu_torch.tools.gmicro [n] [--device cuda|cpu]

Times, over an (8, n) float32 stream x and an int32 index stream idx of
the same shape in blocks of 512 lanes (n = 2**23 by default, a multiple
of 512), the functions the JAX tool times (one line each, in its order and
under its names):

- `copy*2`: o = 2 x, the stream yardstick (`copy2`);
- `take_along (8,128) x4` and `take_along (32,128) x1`: one function,
  o[r, 128t + l] = x[r, 128t + (idx[r, 128t + l] & 127)] (`lane_gather`;
  a (32, 128) reshape of an (8, 512) block keeps each row's tiles), by the
  warp-shuffle idiom under the first name and the shared-memory idiom
  under the second;
- `win_body emul nwin=1/2/4` and `OH-matmul gather 512-win x4`: the
  window gather of row 0's ids (`window_gather`; the one-hot row is
  nwin = 1 on ids & 511);
- `OH seg-reduce quad HB=16/8/4/1`: the segment reduce of each block's
  512 sources x 8 rows, collapsed to 128 bins by idx's lane bits
  (`segment_reduce`): the JAX kernel's (8 hb, 128) bins summed over h and
  rows, which is the same function for every hb; the kernel sums the rows
  first, then bins the 512 column sums.

Each line gives the kernel's time (CUDA events, its launches queued
ahead of the card: tools/timing.py) and ns a block, GB/s and the share of
its bound (bytes: each input read once, where a gather reads only the
32-byte sectors its ids select, and the output written once, at 3.35
TB/s), its paced time (the launches as the host issues them), the times
of the plain version and of the library call (one PyTorch call of the
same function), max|err| against the plain version and the wrapper
launches the line made. The device line names the
card and its power limit. `--device cpu` runs the plain versions
(host-clock times, no device metric).

The wrappers launch the hand-written kernels of csrc/gmicro.cu on CUDA
tensors and run their plain versions (`*_plain`) on CPU tensors; each
counts its launches. The kernels replace the TPU kernels timed by
tools/gmicro.py::_run (pallas_call at :47). Copies and gathers equal their
plain versions bit for bit; the segment reduce adds in another order
(warp sums into shared-memory atomics), float32 roundoff of at most 512
column sums a bin.
"""

from __future__ import annotations

import argparse
import sys

import torch

from dedflow_tpu_torch.tools.timing import Probe, device_line, line, measure, nbytes, sector_bytes
from dedflow_tpu_torch.utils import nvcc
from dedflow_tpu_torch.utils.dtypes import resolve_device

ROWS = 8  # rows of the stream
BLOCK = 512  # lanes a block (tools/gmicro.py:_B)
TILE = 128  # lanes a tile
HBS = (16, 8, 4, 1)  # the segment reduce's sweep (tools/gmicro.py:208)
NWINS = (1, 2, 4)  # the window gather's window counts (:173)
REPS = 8  # chained calls a timing sample (the tool's reps, :33)


# ---- plain versions --------------------------------------------------------


def copy2_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """o[r, 128t + l] = x[r, 128t + (idx[r, 128t + l] & 127)]."""
    lane = torch.arange(x.shape[1], device=x.device)
    src = (lane - lane % TILE) + (idx & (TILE - 1)).long()
    return torch.gather(x, 1, src)


def window_gather_plain(x: torch.Tensor, idx: torch.Tensor, nwin: int,
                        wrap: bool = False) -> torch.Tensor:
    """o[r, 512b + j] = x[r, 512b + (id & 511)] where 0 <= id >> 9 < nwin,
    else 0, with id = idx[0, 512b + j] (id & 511 with `wrap`)."""
    ids = idx[0].long()
    if wrap:
        ids = ids & (BLOCK - 1)
    lane = torch.arange(x.shape[1], device=x.device)
    src = (lane - lane % BLOCK) + (ids & (BLOCK - 1))
    win = ids >> 9
    hit = (win >= 0) & (win < nwin)
    return torch.where(hit, x[:, src], torch.zeros((), dtype=x.dtype, device=x.device))


def bin_index(idx: torch.Tensor) -> torch.Tensor:
    """For each lane j of the stream, the flat index of its bin in the
    (n / 512, 128) collapsed bins: block j // 512, lane idx[0, j] & 127."""
    n = idx.shape[1]
    blk = torch.arange(n, device=idx.device) // BLOCK
    return blk * TILE + (idx[0] & (TILE - 1)).long()


def broadcast_bins(bins: torch.Tensor, n: int) -> torch.Tensor:
    """o (8, n) from the (n / 512, 128) bins: o[., 512b + 128q + l] = bins[b, l]."""
    return bins.reshape(n // BLOCK, 1, TILE).expand(n // BLOCK, BLOCK // TILE, TILE).reshape(
        1, n).expand(ROWS, n).contiguous()


def segment_reduce_plain(x: torch.Tensor, idx: torch.Tensor, hb: int) -> torch.Tensor:
    """o (8, n): o[., 512b + 128q + l] = the sum over the columns j of block
    b with (idx[0, 512b + j] & 127) = l of x's 8 rows at j, rows summed
    first, then the columns in order (hb does not enter)."""
    n = x.shape[1]
    bins = torch.zeros((n // BLOCK) * TILE, dtype=x.dtype, device=x.device)
    bins.index_add_(0, bin_index(idx), x.sum(0))
    return broadcast_bins(bins, n)


# ---- wrappers --------------------------------------------------------------


def _check_stream(x: torch.Tensor, idx: torch.Tensor | None = None) -> int:
    """n of a contiguous float32 (8, n) x (and int32 (R, n) idx) on the card."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != ROWS or not x.is_contiguous():
        raise ValueError(f"gmicro kernels: a contiguous float32 ({ROWS}, n) stream, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[1]
    if n == 0 or n % BLOCK:
        raise ValueError(f"gmicro kernels: n a positive multiple of {BLOCK}, got {n}")
    tensors = [x]
    if idx is not None:
        if (idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != n
                or not idx.is_contiguous() or idx.device != x.device):
            raise ValueError("gmicro kernels: a contiguous int32 (R, n) index stream on x's card")
        tensors.append(idx)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("gmicro kernels: 16-byte aligned streams (float4 loads)")
    return n


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def copy2(x: torch.Tensor) -> torch.Tensor:
    """o = 2 x: the kernel on a CUDA tensor, the plain version on a CPU one."""
    if not x.is_cuda:
        return copy2_plain(x)
    _check_stream(x)
    fn = nvcc.function("gmicro", "dedflow_gm_copy2", [nvcc.P, nvcc.P, nvcc.LL, nvcc.P])
    o = torch.empty_like(x)
    nvcc.check(fn(x.data_ptr(), o.data_ptr(), x.numel(), _stream(x)), "gmicro copy2")
    copy2.launches += 1
    return o


def lane_gather(x: torch.Tensor, idx: torch.Tensor, idiom: str = "smem") -> torch.Tensor:
    """The in-tile lane gather, by the shared-memory ("smem") or the
    warp-shuffle ("shuffle") idiom on CUDA tensors (idx (8, n)); the plain
    version on CPU tensors."""
    if idiom not in ("smem", "shuffle"):
        raise ValueError(f"lane_gather: idiom 'smem' or 'shuffle', got {idiom!r}")
    if not x.is_cuda:
        return lane_gather_plain(x, idx)
    n = _check_stream(x, idx)
    if idx.shape[0] != ROWS:
        raise ValueError(f"lane_gather kernel: idx ({ROWS}, n), got {tuple(idx.shape)}")
    fn = nvcc.function("gmicro", "dedflow_gm_lane_gather",
                       [nvcc.P, nvcc.P, nvcc.P, nvcc.LL, nvcc.I, nvcc.P])
    o = torch.empty_like(x)
    nvcc.check(fn(x.data_ptr(), idx.data_ptr(), o.data_ptr(), n, int(idiom == "shuffle"),
                  _stream(x)), "gmicro lane_gather")
    lane_gather.launches += 1
    return o


def window_gather(x: torch.Tensor, idx: torch.Tensor, nwin: int,
                  wrap: bool = False) -> torch.Tensor:
    """The window gather of idx's row 0: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if not x.is_cuda:
        return window_gather_plain(x, idx, nwin, wrap)
    n = _check_stream(x, idx)
    if nwin < 0:
        raise ValueError(f"window_gather: nwin >= 0, got {nwin}")
    fn = nvcc.function("gmicro", "dedflow_gm_window_gather",
                       [nvcc.P, nvcc.P, nvcc.P, nvcc.LL, nvcc.I, nvcc.I, nvcc.P])
    o = torch.empty_like(x)
    nvcc.check(fn(x.data_ptr(), idx.data_ptr(), o.data_ptr(), n, nwin, int(wrap), _stream(x)),
               "gmicro window_gather")
    window_gather.launches += 1
    return o


def segment_reduce(x: torch.Tensor, idx: torch.Tensor, hb: int) -> torch.Tensor:
    """The segment reduce of idx's row 0, collapsed to 128 bins a block
    (hb 1, 2, 4, 8 or 16, the JAX kernel's parameter, which does not enter
    the function): the kernel on CUDA tensors (rows, then bins), the plain
    version on CPU tensors."""
    if not x.is_cuda:
        return segment_reduce_plain(x, idx, hb)
    n = _check_stream(x, idx)
    if hb not in (1, 2, 4, 8, 16):
        raise ValueError(f"segment_reduce kernel: hb 1, 2, 4, 8 or 16, got {hb}")
    fn = nvcc.function("gmicro", "dedflow_gm_seg_reduce", [nvcc.P, nvcc.P, nvcc.P, nvcc.LL, nvcc.P])
    o = torch.empty_like(x)
    nvcc.check(fn(x.data_ptr(), idx.data_ptr(), o.data_ptr(), n, _stream(x)),
               "gmicro segment_reduce")
    segment_reduce.launches += 1
    return o


copy2.launches = 0
lane_gather.launches = 0
window_gather.launches = 0
segment_reduce.launches = 0


# ---- the probes ------------------------------------------------------------


def lane_gather_bytes(x: torch.Tensor, idx: torch.Tensor) -> int:
    """Bytes the lane gather must move: idx and o once, and the 32-byte
    sectors of x that the ids select (row by row)."""
    n = x.shape[1]
    lane = torch.arange(n, device=x.device)
    tile = lane - lane % TILE
    read = sum(sector_bytes(r * n + tile + (idx[r] & (TILE - 1)).long()) for r in range(ROWS))
    return read + nbytes(idx, x)  # o is x's size


def window_gather_bytes(x: torch.Tensor, idx: torch.Tensor, nwin: int, wrap: bool) -> int:
    """Bytes the window gather must move: idx's row 0 and o once, and the
    32-byte sectors of x that its hits select (the same in each row, n
    being a multiple of 8)."""
    n = x.shape[1]
    ids = idx[0].long()
    if wrap:
        ids = ids & (BLOCK - 1)
    lane = torch.arange(n, device=x.device)
    hit = ((ids >> 9) >= 0) & ((ids >> 9) < nwin)
    src = (lane - lane % BLOCK) + (ids & (BLOCK - 1))
    return ROWS * sector_bytes(src[hit]) + nbytes(idx[0], x)


def probes(x: torch.Tensor, idx: torch.Tensor) -> list:
    """The JAX tool's eleven variants on (x, idx), in its order. Each
    library call's inputs (int64 indices) are made here, outside its
    timing; the window gather's library call (a torch.gather of
    512b + (id & 511)) computes the function only where every id is a hit
    (0 <= id >> 9 < nwin), as in the tool's data (ids < 128); the segment
    reduce's times `index_add` of the column sums x.sum(0) into the blocks'
    128 bins, then the broadcast to the 8 rows. The bytes of the gathers
    count the sectors of x that these ids read."""
    n = x.shape[1]
    o = torch.empty_like(x)
    lane_idx = (idx & (TILE - 1)).long().view(ROWS, n // TILE, TILE)
    lane = torch.arange(n, device=x.device)
    win_idx = ((lane - lane % BLOCK) + (idx[0].long() & (BLOCK - 1))).expand(ROWS, n)
    xt = x.view(ROWS, n // TILE, TILE)
    lane_bytes = lane_gather_bytes(x, idx)
    out = [
        Probe("copy*2", "copy", lambda: copy2(x), lambda: copy2_plain(x),
              (lambda: torch.mul(x, 2.0, out=o), lambda: copy2(x)), nbytes(x, o), x.numel(),
              copy2),
    ]
    for name, idiom in (("take_along (8,128) x4", "shuffle"), ("take_along (32,128) x1", "smem")):
        kern = lambda idiom=idiom: lane_gather(x, idx, idiom)
        out.append(Probe(name, f"lane gather, {idiom}", kern, lambda: lane_gather_plain(x, idx),
                         (lambda: torch.gather(xt, 2, lane_idx), kern), lane_bytes, 0,
                         lane_gather))
    lib_win = (lambda: torch.gather(x, 1, win_idx), lambda: window_gather(x, idx, 1, True))
    for nw in NWINS:
        out.append(Probe(f"win_body emul nwin={nw}", f"window gather, nwin={nw}",
                         lambda nw=nw: window_gather(x, idx, nw),
                         lambda nw=nw: window_gather_plain(x, idx, nw), lib_win,
                         window_gather_bytes(x, idx, nw, False), 0, window_gather))
    out.append(Probe("OH-matmul gather 512-win x4", "window gather, ids & 511",
                     lambda: window_gather(x, idx, 1, True),
                     lambda: window_gather_plain(x, idx, 1, True), lib_win,
                     window_gather_bytes(x, idx, 1, True), 0, window_gather))
    bins = torch.zeros((n // BLOCK) * TILE, dtype=x.dtype, device=x.device)
    where = bin_index(idx)
    # index_add_ of the column sums into the blocks' 128 bins, then the broadcast
    library = (lambda: broadcast_bins(torch.index_add(bins, 0, where, x.sum(0)), n),
               lambda: segment_reduce(x, idx, HBS[0]))
    for hb in HBS:
        # 7 adds a column for its 8 rows, one add a column into its bin
        out.append(Probe(f"OH seg-reduce quad HB={hb}", f"segment reduce, hb={hb}",
                         lambda hb=hb: segment_reduce(x, idx, hb),
                         lambda hb=hb: segment_reduce_plain(x, idx, hb), library,
                         nbytes(x, idx[0], o), x.numel(), segment_reduce, exact=False))
    return out


def inputs(n: int, device, seed: int = 0) -> tuple:
    """x (8, n) standard normal and idx (8, n) in [0, 128) (the tool's
    indices, tools/gmicro.py:121-123), from a seeded generator on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((ROWS, n), generator=gen, device=device, dtype=torch.float32)
    idx = torch.randint(0, TILE, (ROWS, n), generator=gen, device=device, dtype=torch.int32)
    return x, idx


def run(n: int, device) -> list:
    """Time every probe at n lanes on `device` and print its line; one
    record a probe (tools.timing.measure): the times of the kernel, of its
    plain version and of the library call, max|err| against the plain
    version, the bound and the wrapper launches the probe made."""
    x, idx = inputs(n, device)
    print(device_line(device), flush=True)
    print(f"n = {n}: x float32 (8, n), idx int32 (8, n) in [0, 128), "
          f"{n // BLOCK} blocks of {BLOCK} lanes", flush=True)
    recs = []
    for p in probes(x, idx):
        recs.append(measure(p, device, REPS))
        print(line(recs[-1], f"{recs[-1]['ms'] * 1e6 / (n // BLOCK):8.1f} ns/block"), flush=True)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=1 << 23, help="lanes a row")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    run(args.n, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
