"""K8: the residual's permute-reduce, y[c, tgt(k)] += x[c, src(k)]
(counterpart of dedflow_tpu/sparse/win_stream.py).

The host plan (`build_reduce_plan`, NumPy) sorts the contributions by
(target, source), or takes them presorted by target
(`reduce_plan_from_sorted`), and keeps, per target, the range of its
contributions: `ptr` (num_tgt + 1,) and `src` (K,). A source index addresses a flat
tensor; output row r reads source component comps[r] at
src[k] + comps[r] * cstride. For a plain (C, M) source that is
comps = 0..C-1 and cstride = M; for the element residual rows (24, ne)
the contribution (e, a) has src = a*6*ne + e and cstride = ne, so the
reduce reads the element kernel's output where it lies.

The plan also keeps the kernel's staging order: `stage_src`, the source
offsets sorted ascending, and `stage_pos`, the plan position of each
(src[stage_pos[i]] == stage_src[i]), made by a stable sort on the plan's
device. A plan over an element kernel's output rows, whose source of
contribution (e, j) is j*rows*m + e, also keeps `elem_pos`
(`with_element_positions`): the plan position of (e, j) at j*m + e, where
the staged element kernels store that contribution's rows. With every
contribution present it is `stage_pos` itself, the sorted sources being
the element order.

`stream_reduce` is the K8 wrapper: on a CUDA tensor it launches the
hand-written kernels of csrc/seg_reduce.cu (C <= 8), which replace the
TPU kernel dedflow_tpu/sparse/win_stream.py::_stream_kernel: a staging
pass that reads the sources in ascending order into a (K, W) buffer at
their plan positions (W = C rounded up to 8), then a segment sum of each
target's contiguous rows in plan order. On a CPU tensor it runs
`stream_reduce_plain`. The Jacobian's reduce (K9, sparse.win_ring) is the
same computation with C <= 16 and its own wrapper.

Also here: `stream_window_counts`, the per-vreg window count of the JAX
package's stream plan (win_stream.py:84-215, the same arithmetic), which
the solver's "auto" tier gate reads (solver/newton.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.utils import nvcc
from dedflow_tpu_torch.utils.dtypes import resolve_device


@dataclass
class ReducePlan:
    """y[r, t] = sum_{k in [ptr[t], ptr[t+1])} x[src[k] + comps[r] * cstride]."""

    num_tgt: int
    src_max: int  # largest source offset (-1 without contributions)
    ptr: torch.Tensor  # (num_tgt + 1,) int32
    src: torch.Tensor  # (K,) int32, grouped by target, in summation order
    stage_src: torch.Tensor  # (K,) int32, src sorted ascending: the staging pass's read order
    stage_pos: torch.Tensor  # (K,) int32, the plan position of each: src[stage_pos] == stage_src
    # (slots * m,) int32: the plan position of element contribution (e, j)
    # at j*m + e, -1 where the plan has none; None: not an element plan
    elem_pos: torch.Tensor | None = None


def build_reduce_plan(tgt, src, num_tgt: int, device="cuda") -> ReducePlan:
    """Plan y[., tgt[k]] += x[., src[k]] over contributions k, each
    target's contributions in source order. On the card unless `device`
    says otherwise."""
    tgt = np.asarray(tgt, dtype=np.int64).reshape(-1)
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    if tgt.shape != src.shape:
        raise ValueError("tgt and src must have the same length")
    order = np.lexsort((src, tgt))
    return reduce_plan_from_sorted(tgt[order], src[order], num_tgt, device)


def reduce_plan_from_sorted(tgt, src, num_tgt: int, device="cuda") -> ReducePlan:
    """The plan of contributions already sorted by target (non-decreasing
    `tgt`); each target keeps its contributions in the given order."""
    dev = resolve_device(device)
    tgt = np.asarray(tgt, dtype=np.int64).reshape(-1)
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    if tgt.shape != src.shape:
        raise ValueError("tgt and src must have the same length")
    if tgt.size and (tgt.min() < 0 or tgt.max() >= num_tgt):
        raise ValueError("reduce plan: a target lies outside [0, num_tgt)")
    if np.any(np.diff(tgt) < 0):
        raise ValueError("reduce plan: targets must be sorted")
    if src.size and (src.min() < 0 or src.max() >= 2**31):
        raise ValueError("reduce plan: source offsets must lie in [0, 2**31)")
    ptr = np.zeros(num_tgt + 1, dtype=np.int64)
    np.cumsum(np.bincount(tgt, minlength=num_tgt), out=ptr[1:])
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    src_t = as_t(src, torch.int32)
    stage_src, stage_pos = torch.sort(src_t, stable=True)
    return ReducePlan(
        num_tgt=int(num_tgt),
        src_max=int(src.max()) if src.size else -1,
        ptr=as_t(ptr, torch.int32),
        src=src_t,
        stage_src=stage_src,
        stage_pos=stage_pos.to(torch.int32),
    )


def with_element_positions(plan: ReducePlan, m: int, slots: int, rows: int) -> ReducePlan:
    """The plan with `elem_pos`, for sources j*rows*m + e (slot j < slots,
    element e < m: row j*rows + c, column e, of (slots*rows, m) element
    rows). Contributions the plan leaves out (an assembly chunk's pad
    elements) get -1. Raises if a source is not of that form or repeats."""
    s = plan.stage_src.long()
    j, e = s // (rows * m), s % (rows * m)
    if s.numel() and (bool((e >= m).any()) or int(j.max()) >= slots
                      or not bool((torch.diff(s) > 0).all())):
        raise ValueError(f"reduce plan: sources are not distinct j*{rows}*m + e with j < "
                         f"{slots}, e < m = {m}")
    if s.numel() == slots * m:  # every (e, j) once: the sorted sources are the element order
        pos = plan.stage_pos
    else:
        pos = torch.full((slots * m,), -1, dtype=torch.int32, device=s.device)
        pos[j * m + e] = plan.stage_pos
    return dataclasses.replace(plan, elem_pos=pos)


def source_layout(x: torch.Tensor, comps, cstride):
    """(comps, cstride) defaulting to a plain (C, M) source."""
    if comps is None:
        if x.dim() != 2:
            raise ValueError("a source without comps/cstride must be (C, M)")
        return tuple(range(x.shape[0])), x.shape[1]
    return tuple(int(c) for c in comps), int(cstride)


def seg_reduce_plain(plan: ReducePlan, x: torch.Tensor, comps, cstride) -> torch.Tensor:
    """The plain version of K8 and K9: per output row, one flat gather and
    one index_add_ into the targets (rebuilt from `ptr`; the plan keeps
    only the kernel's int32 indices)."""
    flat = x.reshape(-1)
    tgt = torch.repeat_interleave(torch.diff(plan.ptr.long()))
    src = plan.src.long()
    out = torch.zeros((len(comps), plan.num_tgt), dtype=x.dtype, device=x.device)
    for r, c in enumerate(comps):
        out[r].index_add_(0, tgt, flat[src + c * cstride])
    return out


def seg_reduce_kernel(
    what: str, symbol: str, max_rows: int, plan: ReducePlan, x: torch.Tensor, comps, cstride
) -> torch.Tensor:
    """Launch csrc/seg_reduce.cu's entry `symbol`: its staging pass and its
    segment sum (checks, the staging buffer and the output)."""
    if x.dtype != torch.float32 or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{what} kernel: x must be a contiguous float32 CUDA tensor")
    if not 1 <= len(comps) <= max_rows:
        raise ValueError(f"{what} kernel: 1 to {max_rows} output rows, got {len(comps)}")
    if plan.ptr.device != x.device:
        raise ValueError(f"{what} kernel: the plan lives on another device")
    if min(comps) < 0 or max(comps) * cstride + plan.src_max >= x.numel():
        raise ValueError(f"{what} kernel: a source offset lies outside x")
    out = torch.empty((len(comps), plan.num_tgt), dtype=torch.float32, device=x.device)
    if plan.num_tgt == 0:
        return out
    fn = nvcc.function(
        "seg_reduce", symbol,
        [nvcc.P, nvcc.LL, nvcc.P, nvcc.P, nvcc.P, nvcc.I, nvcc.P, nvcc.I,
         nvcc.P, nvcc.I, nvcc.P, nvcc.I, nvcc.P],
    )
    k = plan.stage_src.numel()
    width = stage_width(len(comps))
    stage = torch.empty((k, width), dtype=torch.float32, device=x.device)
    nvcc.check(
        fn(x.data_ptr(), cstride, plan.ptr.data_ptr(), plan.stage_src.data_ptr(),
           plan.stage_pos.data_ptr(), k, nvcc.int_array(comps), len(comps),
           stage.data_ptr(), width, out.data_ptr(), plan.num_tgt,
           torch.cuda.current_stream(x.device).cuda_stream),
        what,
    )
    return out


def stage_width(num_rows: int) -> int:
    """Floats a staged contribution takes: its rows rounded up to a whole
    32-byte sector."""
    return -(-num_rows // 8) * 8


def stream_reduce_plain(plan: ReducePlan, x: torch.Tensor, comps=None, cstride=None) -> torch.Tensor:
    """K8's plain version: (C, num_tgt), C <= 8."""
    return seg_reduce_plain(plan, x, *source_layout(x, comps, cstride))


def stream_reduce(plan: ReducePlan, x: torch.Tensor, comps=None, cstride=None) -> torch.Tensor:
    """K8: (C, num_tgt) = the permute-reduce of x over the plan, C <= 8
    output rows. The CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    comps, cstride = source_layout(x, comps, cstride)
    if len(comps) > 8:
        raise ValueError(f"stream_reduce takes at most 8 output rows, got {len(comps)}")
    if not x.is_cuda:
        return seg_reduce_plain(plan, x, comps, cstride)
    out = seg_reduce_kernel("stream_reduce", "dedflow_stream_reduce", 8, plan, x, comps, cstride)
    if plan.num_tgt:
        stream_reduce.launches += 1
    return out


stream_reduce.launches = 0


# ---------------------------------------------------------------------------
# the JAX package's stream-plan window statistic (tier gate)

SP = 2048  # targets per pack of the JAX stream plan
JUMP_CUT = 4096  # a source jump above this starts a new window run


def stream_window_counts(tgt, src, num_tgt: int, src_size: int) -> np.ndarray:
    """Per 128-contribution vreg, the number of 512-column source windows
    the JAX package's stream plan gives it (`build_stream_plan(...).vwin &
    1023`, win_stream.py:84-193: packs of SP targets, contributions
    sorted by source within a pack, split at source jumps > JUMP_CUT, each
    run padded to 512 with its last column, slab base per pack unless the
    source is VMEM-resident)."""
    tgt = np.asarray(tgt, dtype=np.int64).reshape(-1)
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    resident = src_size * 8 * 4 <= 24 * 1024 * 1024
    npk = -(-num_tgt // SP)
    order = np.lexsort((src, tgt // SP))
    tgt_s, src_s = tgt[order], src[order]
    counts = np.bincount(tgt_s // SP, minlength=npk)
    ends = np.cumsum(counts)
    starts = ends - counts
    parts = []
    for p in range(npk):
        s0, s1 = int(starts[p]), int(ends[p])
        bounds = [s0]
        if s1 > s0 + 1:
            bounds += list(np.nonzero(np.diff(src_s[s0:s1]) > JUMP_CUT)[0] + 1 + s0)
        bounds.append(s1)
        cols = [
            np.concatenate([src_s[g0:g1], np.full((-(g1 - g0)) % 512, src_s[g1 - 1])])
            for g0, g1 in zip(bounds[:-1], bounds[1:])
            if g1 > g0
        ]
        cols = np.concatenate(cols) if cols else np.zeros(0, dtype=np.int64)
        lo = (int(cols.min()) // 128) * 128 if cols.size and not resident else 0
        parts.append(cols - lo)
    w = (np.concatenate(parts) >> 9).reshape(-1, 128)
    return w.max(axis=1) - w.min(axis=1) + 1
