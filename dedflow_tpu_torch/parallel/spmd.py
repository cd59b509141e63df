"""Neighbour exchanges and sums of the z-slab decomposition over
torch.distributed (counterpart of dedflow_tpu/parallel/spmd.py's
`dot_shardmap` / `norm_shardmap` (:213-227) and of fem/lattice.py's
`_band_from_right` / `_carry_from_left` (:1201-1221) there).

Rank r of N owns a contiguous range of node layers, node axis last
(component-major vectors (6, n), DIA data (D, 16, n)). `SlabComm` moves a
band of `width` nodes (one node layer) between neighbours and sums small
vectors over every rank:

- `band_from_right` / `band_from_left`: the right neighbour's first or the
  left neighbour's last `width` nodes (None at the ends of the chain);
  `bands` both in one exchange.
- `carry_to_right`: each rank's rows past its own (the halo layer, where
  its cells' contributions to the right neighbour's first layer landed)
  go to that neighbour, which adds them into its first own layer.
- `allreduce_sum`: the sum over every rank, the same on each (Krylov inner
  products and norms).

Every exchange posts all its sends and receives in one
`dist.batch_isend_irecv`, so no pair of neighbours waits on the other in
the wrong order. Gloo's send / recv and all-reduce are a CPU transport:
with gloo, CUDA tensors are staged through pinned host buffers here,
explicitly, and copied back (each exchange then synchronises the card).
NCCL takes the device tensors themselves. `stats` counts the exchanges,
their bytes and their host seconds.

The gather tier's halo plan for irregular matrices (`build_halo_plan`,
`fsbsr_matvec_halo`, `fsbsr_matvec_shardmap` of the JAX package) belongs
to the RCB mode of ROADMAP A16 and is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass
class CommStats:
    """Counts and host seconds of a SlabComm's exchanges."""

    exchanges: int = 0  # band / carry exchanges (one batch_isend_irecv each)
    sent_bytes: int = 0  # bytes this rank sent in them
    exchange_s: float = 0.0  # host seconds in them, staging included
    allreduces: int = 0
    allreduce_s: float = 0.0  # host seconds in them, staging included
    # of those seconds, the device-to-host staging copies: the wait for the
    # card's queued work, then the copy (gloo with CUDA tensors only)
    stage_s: float = 0.0

    def reset(self) -> None:
        self.exchanges = self.sent_bytes = self.allreduces = 0
        self.exchange_s = self.allreduce_s = self.stage_s = 0.0


class SlabComm:
    """The process group of a z-slab decomposition: this rank, the world
    size and the two neighbours (None at the ends of the chain). Staging
    through pinned host memory is on for gloo with CUDA tensors."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.left = self.rank - 1 if self.rank > 0 else None
        self.right = self.rank + 1 if self.rank < self.world - 1 else None
        self.backend = str(dist.get_backend(group))
        self.stats = CommStats()
        self._pinned: dict = {}

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _stage(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def _host(self, key, shape, dtype) -> torch.Tensor:
        """A pinned host buffer kept for reuse (every exchange waits for its
        transfers and copies back before it returns)."""
        k = (key, tuple(shape), dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _to_host(self, key, t: torch.Tensor) -> torch.Tensor:
        """t copied into its pinned staging buffer (the copy waits for the
        card's queued work)."""
        t0 = time.perf_counter()
        buf = self._host(key, t.shape, t.dtype)
        buf.copy_(t)
        self.stats.stage_s += time.perf_counter() - t0
        return buf

    def _exchange(self, sends: dict, recvs: dict, like: torch.Tensor) -> dict:
        """One batch_isend_irecv: `sends` {peer: tensor}, `recvs` {peer:
        shape}; returns {peer: received tensor} on `like`'s device."""
        t0 = time.perf_counter()
        stage = self._stage(like)
        ops, wire = [], {}
        for peer, t in sends.items():
            t = t.contiguous()
            if stage:
                buf = self._to_host(("send", peer), t)
                t = buf
            self.stats.sent_bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, self._peer(peer), self.group))
        for peer, shape in recvs.items():
            if stage:
                buf = self._host(("recv", peer), shape, like.dtype)
            else:
                buf = torch.empty(shape, dtype=like.dtype, device=like.device)
            wire[peer] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(peer), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = {p: (b.to(like.device) if stage else b) for p, b in wire.items()}
        self.stats.exchanges += 1
        self.stats.exchange_s += time.perf_counter() - t0
        return out

    def band_from_right(self, x: torch.Tensor, width: int):
        """The right neighbour's first `width` nodes of x (..., n) (None on
        the last rank); this rank's first `width` go to its left."""
        return self.bands(x, width, left=False)[1]

    def band_from_left(self, x: torch.Tensor, width: int):
        """The left neighbour's last `width` nodes of x (..., n) (None on
        rank 0); this rank's last `width` go to its right."""
        return self.bands(x, width, right=False)[0]

    def bands(self, x: torch.Tensor, width: int, left: bool = True, right: bool = True):
        """(left neighbour's last `width` nodes, right neighbour's first
        `width` nodes) of x (..., n), None where there is no neighbour, in
        one exchange."""
        shape = x.shape[:-1] + (width,)
        sends, recvs = {}, {}
        if right and self.left is not None:
            sends[self.left] = x[..., :width]
        if right and self.right is not None:
            recvs[self.right] = shape
        if left and self.right is not None:
            sends[self.right] = x[..., -width:]
        if left and self.left is not None:
            recvs[self.left] = shape
        got = self._exchange(sends, recvs, x)
        return (got.get(self.left) if left else None), (got.get(self.right) if right else None)

    def carry_to_right(self, y: torch.Tensor, width: int, scale: torch.Tensor | None = None):
        """y (..., n) holds this rank's own rows and, on every rank but the
        last, a halo layer of `width` rows last: its contributions to the
        right neighbour's first layer. They go to that neighbour; the left
        neighbour's arrive and are added, times `scale` (..., width) where
        given, into the first own layer. Returns the own rows, a new
        tensor."""
        n_own = y.shape[-1] - (width if self.right is not None else 0)
        out = y[..., :n_own].contiguous()
        sends, recvs = {}, {}
        if self.right is not None:
            sends[self.right] = y[..., n_own:]
        if self.left is not None:
            recvs[self.left] = y.shape[:-1] + (width,)
        got = self._exchange(sends, recvs, y)
        if self.left is not None:
            carry = got[self.left]
            out[..., :width] += carry if scale is None else scale * carry
        return out

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over every rank, as a new tensor (the same bits on
        each rank)."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest value of t over every rank, as a new tensor."""
        return self._allreduce(t, dist.ReduceOp.MAX)

    def _allreduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        if self._stage(t):
            buf = self._to_host("allreduce", t)
            dist.all_reduce(buf, op=op, group=self.group)
            out = buf.to(t.device)
        else:
            out = t.clone()
            dist.all_reduce(out, op=op, group=self.group)
        self.stats.allreduces += 1
        self.stats.allreduce_s += time.perf_counter() - t0
        return out
