"""K9: the Jacobian's permute-reduce into WinELL entries (counterpart of
dedflow_tpu/sparse/win_ring.py).

The same computation as K8 (sparse.win_stream, whose plan it uses) with up
to 16 output rows: per WinELL entry, the sum of its element contributions
(mean 6.6 on a Delaunay mesh), read from the (288, ne) element Jacobian
rows ab*18+c where the element kernel (K6) left them: the contribution
(e, ab) has src = ab*18*ne + e and cstride = ne.

`ring_reduce` is the K9 wrapper: on a CUDA tensor it launches the
hand-written kernels of csrc/seg_reduce.cu (C <= 16; as K8's, the staging
pass and the segment sum for C > 1, the one pass with no staging buffer
for one row), which replace the TPU kernel
dedflow_tpu/sparse/win_ring.py::_ring_kernel; on a CPU tensor it runs
`ring_reduce_plain`. The TPU's ring of partial sums, its SMEM budget
and its fallback to the pull path do not exist here.

`ring_reduce_staged` is K9's segment sum alone, the solver's Jacobian
reduce: the staged element kernels (fem.element_kernels.lhs_rows_staged,
ns_lhs_gather_staged) write each contribution's rows straight into the
(K, 16) staging buffer at its plan position (and the implicit tangents
into a (K, 8) one), so the (288, ne) element rows and the staging pass
never exist. It counts its own launches; its plain twin is
`ring_reduce_staged_plain`.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.sparse.win_stream import (
    STAGED_WIDTHS,
    ReducePlan,
    check_staged,
    seg_reduce_kernel,
    seg_reduce_plain,
    segment_sum_kernel,
    segment_sum_plain,
    source_layout,
)


def ring_reduce_plain(plan: ReducePlan, x: torch.Tensor, comps=None, cstride=None) -> torch.Tensor:
    """K9's plain version: (C, num_tgt), C <= 16."""
    return seg_reduce_plain(plan, x, *source_layout(x, comps, cstride))


def ring_reduce(plan: ReducePlan, x: torch.Tensor, comps=None, cstride=None) -> torch.Tensor:
    """K9: (C, num_tgt) = the permute-reduce of x over the plan, C <= 16
    output rows. The CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    comps, cstride = source_layout(x, comps, cstride)
    if len(comps) > 16:
        raise ValueError(f"ring_reduce takes at most 16 output rows, got {len(comps)}")
    if not x.is_cuda:
        return seg_reduce_plain(plan, x, comps, cstride)
    out = seg_reduce_kernel("ring_reduce", "dedflow_ring_reduce", 16, plan, x, comps, cstride)
    if plan.num_tgt:
        ring_reduce.launches += 1
    return out


ring_reduce.launches = 0


def ring_reduce_staged_plain(plan: ReducePlan, stage: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The segment sum's plain twin (`win_stream.segment_sum_plain`)."""
    return segment_sum_plain(plan, stage, num_rows)


def ring_reduce_staged(plan: ReducePlan, stage: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K9's segment sum alone: (num_rows, num_tgt), target t the sum of the
    staging rows [ptr[t], ptr[t+1]) of the (K, W) buffer `stage` (W 16 or
    8) in plan order, columns 0..num_rows-1. The CUDA kernel on a CUDA
    tensor, the plain twin on a CPU tensor."""
    check_staged("ring_reduce_staged", plan, stage, num_rows, STAGED_WIDTHS)
    if not stage.is_cuda:
        return ring_reduce_staged_plain(plan, stage, num_rows)
    out = segment_sum_kernel("ring_reduce_staged", plan, stage, num_rows)
    if plan.num_tgt:
        ring_reduce_staged.launches += 1
    return out


ring_reduce_staged.launches = 0
