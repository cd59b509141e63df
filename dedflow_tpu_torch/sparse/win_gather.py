"""K10: the nodal-state gather into element rows (counterpart of
dedflow_tpu/sparse/win_gather.py).

    out[rowmap[a][c], e] = x[c, ien_t[a, e]]        -> (out_rows, ne)

for a (C, N) state table (C <= 16) and a static row map per vertex a and
component c (-1 drops the pair; rows no pair maps to are zero). The
WinELL tier's element kernels always read their state rows this way
(fem.win_assembly), with the JAX row maps `RES_ROWMAP` (48 rows) and
`JAC_ROWMAP` (12 rows).

`win_gather` is the K10 wrapper: on a CUDA tensor it launches the
hand-written kernel csrc/win_gather.cu, which replaces the TPU kernel
dedflow_tpu/sparse/win_gather.py::_gather_kernel; on a CPU tensor it runs
`win_gather_plain` (the counterpart of `win_gather_xla`). A gather is
exact, so the two agree bit for bit. The TPU's window schedule
(`GatherPlan`: 512-column node windows per 128 elements, for its lane
gathers out of a VMEM-resident table) has no counterpart: a thread per
element loads what it needs.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.utils import nvcc

# state-table rows: 0-5 the w_alpha components, 6 the heat source, 8-13 the
# dw_alpha components (win_assembly.py:52-69); output rows are the K6
# residual input rows 19.. (u i*4+a, du, p from the rate state, phi, T,
# dphi, dT, source)
RES_ROWMAP = tuple(
    tuple(
        (c * 4 + a) if c < 3
        else (28 + a) if c == 4
        else (32 + a) if c == 5
        else (44 + a) if c == 6
        else (12 + (c - 8) * 4 + a) if 8 <= c <= 10
        else (24 + a) if c == 11
        else (36 + a) if c == 12
        else (40 + a) if c == 13
        else -1
        for c in range(16)
    )
    for a in range(4)
)
# the velocity rows i*4+a of the K6 Jacobian input (win_assembly.py:70-72)
JAC_ROWMAP = tuple(tuple((c * 4 + a) if c < 3 else -1 for c in range(8)) for a in range(4))

MAX_ROWS = 64


def row_sources(rowmap, out_rows: int, num_comp: int) -> list:
    """Per output row, (vertex << 8) | component of its source, or -1 for
    a zero row; where two pairs map to one row the later pair (vertex-major
    order) wins, as in the JAX lowering."""
    codes = [-1] * out_rows
    for a, row in enumerate(rowmap):
        for c, r in enumerate(row):
            r = int(r)
            if r < 0:
                continue
            if r >= out_rows or c >= num_comp:
                raise ValueError(f"rowmap maps ({a}, {c}) to row {r}: outside the "
                                 f"({num_comp}, N) table or the {out_rows} output rows")
            codes[r] = (a << 8) | c
    return codes


def win_gather_plain(ien_t, x, rowmap, out_rows: int) -> torch.Tensor:
    """K10's plain version (win_gather_xla): (out_rows, ne) in x's dtype."""
    row_sources(rowmap, out_rows, x.shape[0])
    out = torch.zeros((out_rows, ien_t.shape[1]), dtype=x.dtype, device=x.device)
    for a, row in enumerate(rowmap):
        ga = x[:, ien_t[a].long()]  # (C, ne)
        for c, r in enumerate(row):
            if r >= 0:
                out[r] = ga[c]
    return out


def win_gather(ien_t, x, rowmap, out_rows: int) -> torch.Tensor:
    """K10: out[rowmap[a][c], e] = x[c, ien_t[a, e]] -> (out_rows, ne).
    The CUDA kernel on a CUDA tensor (float32 x, int32 ien_t with a unit
    element stride), the plain version on a CPU tensor."""
    if not x.is_cuda:
        return win_gather_plain(ien_t, x, rowmap, out_rows)
    nvert, ne = ien_t.shape
    c, n = x.shape
    if c > 16 or not 1 <= nvert <= 4 or len(rowmap) != nvert or not 1 <= out_rows <= MAX_ROWS:
        raise ValueError(f"win_gather kernel: C <= 16 rows, 1-4 vertices and 1-{MAX_ROWS} "
                         f"output rows, got C={c}, V={nvert}, R={out_rows}")
    if x.dtype != torch.float32 or not x.is_contiguous() or ien_t.dtype != torch.int32:
        raise ValueError("win_gather kernel: contiguous float32 x and int32 ien_t")
    if ien_t.stride(1) != 1 or ne == 0 or ien_t.device != x.device:
        raise ValueError("win_gather kernel: ien_t (V, ne) with a unit element stride on x's card")
    codes = row_sources(rowmap, out_rows, c)
    fn = nvcc.function(
        "win_gather", "dedflow_win_gather",
        [nvcc.P, nvcc.LL, nvcc.I, nvcc.P, nvcc.I, nvcc.P, nvcc.I, nvcc.P, nvcc.I, nvcc.P],
    )
    out = torch.empty((out_rows, ne), dtype=torch.float32, device=x.device)
    nvcc.check(
        fn(ien_t.data_ptr(), ien_t.stride(0), nvert, x.data_ptr(), n, nvcc.int_array(codes),
           out_rows, out.data_ptr(), ne, torch.cuda.current_stream(x.device).cuda_stream),
        "win_gather",
    )
    win_gather.launches += 1
    return out


win_gather.launches = 0
