"""K9: the Jacobian's permute-reduce into WinELL entries (counterpart of
dedflow_tpu/sparse/win_ring.py).

The same computation as K8 (sparse.win_stream, whose plan it uses) with up
to 16 output rows: per WinELL entry, the sum of its element contributions
(mean 6.6 on a Delaunay mesh), read from the (288, ne) element Jacobian
rows ab*18+c where the element kernel (K6) left them: the contribution
(e, ab) has src = ab*18*ne + e and cstride = ne.

`ring_reduce` is the K9 wrapper: on a CUDA tensor it launches the
hand-written kernel csrc/seg_reduce.cu (C <= 16), which replaces the TPU
kernel dedflow_tpu/sparse/win_ring.py::_ring_kernel; on a CPU tensor it
runs `ring_reduce_plain`. The TPU's ring of partial sums, its SMEM budget
and its fallback to the pull path do not exist here.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.sparse.win_stream import (
    ReducePlan,
    seg_reduce_kernel,
    seg_reduce_plain,
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
    ring_reduce.launches += 1
    return out


ring_reduce.launches = 0
