"""Neighbour exchanges and sums of the multi-device modes over
torch.distributed (counterpart of dedflow_tpu/parallel/spmd.py's
`dot_shardmap` / `norm_shardmap` (:213-227), `build_halo_plan` (:84-151)
and `fsbsr_matvec_halo` (:154-210), and of fem/lattice.py's
`_band_from_right` / `_carry_from_left` (:1201-1221) there).

`GroupComm` is the process group: this rank, the world size, the exchange
of `dist.batch_isend_irecv` and the sums over every rank (`allreduce_sum`,
`allreduce_max`, `allreduce_min`: Krylov inner products and norms, the
multigrid's agreed level count, the same bits on each rank). Two
decompositions build on it:

- `SlabComm` (the z-slab mode): rank r of N owns a contiguous range of node
  layers, node axis last (component-major vectors (6, n), DIA data
  (D, 16, n)). `band_from_right` / `band_from_left`: the right neighbour's
  first or the left neighbour's last `width` nodes (None at the ends of
  the chain), `bands` both in one exchange, `banded` x with both bands
  around it (zeros where there is no neighbour); `carry_to_right`: each
  rank's rows past its own (the halo layer, where its cells' contributions
  to the right neighbour's first layer landed) go to that neighbour, which
  adds them into its first own layer.
- `HaloComm` (the RCB mode): a rank's vectors hold its own nodes, and its
  local vectors its ghosts after them ([own | ghosts], parallel.partition
  .part_layout). `build_halo_plan` lists, per neighbour rank, the own
  nodes it needs and the ghost slots it fills; `exchange` fills the ghosts
  of x in one exchange, and `reverse_add`, its reverse on the same plan,
  sends the ghost columns of a local vector back to their owners, which
  add them (the coupled solver's drag reaction). The JAX plan is keyed per hop between equal
  padded blocks (`send_idx[s]`, (P, H_s) padded with 0); this one per
  neighbour rank, unpadded, each owner's ghosts one contiguous block. It
  moves O(surface) values: no rank sends more than the ghosts its
  neighbours hold, and nothing gathers a whole vector.

Every exchange posts all its sends and receives in one
`dist.batch_isend_irecv`, so no pair of neighbours waits on the other in
the wrong order. Gloo's send / recv and all-reduce are a CPU transport:
with gloo, CUDA tensors are staged through pinned host buffers here,
explicitly, and copied back (each exchange then synchronises the card).
NCCL takes the device tensors themselves. `stats` counts the exchanges,
their bytes and their host seconds.

`fsbsr_matvec_shardmap` (spmd.py:43, the O(N) all-gather product) is not
ported: no solver path of the JAX package calls it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class CommStats:
    """Counts and host seconds of a GroupComm's exchanges and sums."""

    exchanges: int = 0  # band / carry / halo exchanges (one batch_isend_irecv each)
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


class GroupComm:
    """A process group: this rank, the world size, its exchanges and sums.
    Staging through pinned host memory is on for gloo with CUDA tensors."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
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

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over every rank, as a new tensor (the same bits on
        each rank)."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The largest value of t over every rank, as a new tensor."""
        return self._allreduce(t, dist.ReduceOp.MAX)

    def allreduce_min(self, t: torch.Tensor) -> torch.Tensor:
        """The smallest value of t over every rank, as a new tensor."""
        return self._allreduce(t, dist.ReduceOp.MIN)

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


class SlabComm(GroupComm):
    """The process group of a z-slab decomposition, with the two
    neighbours of this rank (None at the ends of the chain)."""

    def __init__(self, group=None):
        super().__init__(group)
        self.left = self.rank - 1 if self.rank > 0 else None
        self.right = self.rank + 1 if self.rank < self.world - 1 else None

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

    def banded(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x (..., n) with the left neighbour's last and the right
        neighbour's first `width` nodes around it, zeros where there is no
        neighbour: (..., n + 2 width), the own rows from column `width`
        (one exchange)."""
        left, right = self.bands(x, width)
        pad = x.new_zeros(x.shape[:-1] + (width,))
        return torch.cat([pad if left is None else left, x, pad if right is None else right],
                         dim=-1)

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


@dataclass(frozen=True)
class HaloPlan:
    """One rank's ghost exchange: its local vectors are [own | ghosts]
    (n_own + n_ghost nodes); `send[q]` the sorted local indices of the own
    nodes rank q holds as ghosts, `recv[q]` the slots [lo, hi) of the ghost
    block (local ids n_own + lo .. n_own + hi - 1) that rank q's values
    fill, in q's send order."""

    n_own: int
    n_ghost: int
    send: dict  # peer -> (k,) int64
    recv: dict  # peer -> (lo, hi)

    @property
    def n_x(self) -> int:
        return self.n_own + self.n_ghost


def build_halo_plan(ien, lay) -> HaloPlan:
    """Rank `lay.rank`'s HaloPlan for the elements `ien` (ne, 4) of the
    whole mesh and its partition.PartLayout `lay`. The ghosts are the
    layout's: sorted by partitioned id, so in blocks of ascending owner.
    The rank sends part q each own node that shares an element with a node
    of q, in ascending local index, which is partitioned-id order: the
    order of q's ghosts."""
    ien = np.asarray(ien, dtype=np.int64)
    part, rank, n_own = lay.node_part, lay.rank, lay.n_own
    owner = part[ien]
    cross = (owner == rank).any(axis=1) & (owner != rank).any(axis=1)
    ien, owner = ien[cross], owner[cross]
    own_local = np.full(part.size, -1, dtype=np.int64)
    own_local[lay.nodes[:n_own]] = np.arange(n_own)
    pairs = np.unique(np.concatenate([
        owner[sel, b] * n_own + own_local[ien[sel, a]]
        for a in range(4) for b in range(4)
        for sel in [(owner[:, a] == rank) & (owner[:, b] != rank)]]))
    ghost_owner = part[lay.nodes[n_own:]]  # non-decreasing
    send, recv = {}, {}
    for q in range(lay.num_parts):
        if q == rank:
            continue
        lo, hi = np.searchsorted(pairs, [q * n_own, (q + 1) * n_own])
        if hi > lo:
            send[q] = pairs[lo:hi] - q * n_own
        lo, hi = np.searchsorted(ghost_owner, [q, q + 1])
        if hi > lo:
            recv[q] = (int(lo), int(hi))
    return HaloPlan(n_own=n_own, n_ghost=int(ghost_owner.size), send=send, recv=recv)


class HaloComm(GroupComm):
    """The process group of an RCB decomposition with this rank's halo
    plan (`build_halo_plan`); the send indices live on `device`."""

    def __init__(self, plan: HaloPlan, group=None, device="cuda"):
        super().__init__(group)
        self.plan = plan
        self._send = {q: torch.as_tensor(i, dtype=torch.long, device=device)
                      for q, i in plan.send.items()}
        self._buffers: dict = {}

    def buffer(self, rows: int, like: torch.Tensor) -> torch.Tensor:
        """A persistent (rows, n_x) local vector of x's dtype and device,
        kept for reuse: what one `exchange` fills is read in stream order
        before the next one overwrites it."""
        k = (rows, like.dtype, like.device)
        buf = self._buffers.get(k)
        if buf is None:
            buf = torch.empty((rows, self.plan.n_x), dtype=like.dtype, device=like.device)
            self._buffers[k] = buf
        return buf

    def exchange(self, x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """x (C, n_own) -> the local vector (C, n_x): x's own columns, then
        the ghosts' values from their owners (one exchange). Into `out`
        where given, else a new tensor."""
        plan = self.plan
        if x.dim() != 2 or x.shape[1] != plan.n_own:
            raise ValueError(f"halo exchange: x must be (C, {plan.n_own}), got {tuple(x.shape)}")
        if out is None:
            out = torch.empty((x.shape[0], plan.n_x), dtype=x.dtype, device=x.device)
        out[:, : plan.n_own] = x
        sends = {q: x[:, i] for q, i in self._send.items()}
        recvs = {q: (x.shape[0], hi - lo) for q, (lo, hi) in plan.recv.items()}
        got = self._exchange(sends, recvs, x)
        for q, (lo, hi) in plan.recv.items():
            out[:, plan.n_own + lo : plan.n_own + hi] = got[q]
        return out

    def reverse_add(self, y: torch.Tensor) -> torch.Tensor:
        """y (C, n_x), a local vector -> its own columns (C, n_own) with the
        other ranks' ghost columns of this rank's nodes added (one exchange,
        the reverse of `exchange`: each ghost block goes back to its owner).
        The arrivals are added in ascending order of the sending rank, each
        at the own nodes this rank sends it in `exchange` (unique within a
        rank), so the sums repeat bit for bit. A new tensor."""
        plan = self.plan
        if y.dim() != 2 or y.shape[1] != plan.n_x:
            raise ValueError(f"reverse add: y must be (C, {plan.n_x}), got {tuple(y.shape)}")
        out = y[:, : plan.n_own].clone()
        sends = {q: y[:, plan.n_own + lo : plan.n_own + hi] for q, (lo, hi) in plan.recv.items()}
        recvs = {q: (y.shape[0], i.numel()) for q, i in self._send.items()}
        got = self._exchange(sends, recvs, y)
        for q in sorted(got):
            out[:, self._send[q]] += got[q]
        return out
