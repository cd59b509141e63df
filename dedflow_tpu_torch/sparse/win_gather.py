"""K10: the nodal-state gather into the WinELL tier's element input rows
(counterpart of dedflow_tpu/sparse/win_gather.py).

    out[row0 + rowmap[a][c], e] = T[ien_t[a, e], c]

where T is the node-major table the JAX row maps index (columns 0-5 the
(N, 6) w_alpha, 6 the (N,) heat source, 8-13 the (N, 6) dw_alpha; rows no
pair maps to are zero), with the JAX maps `RES_ROWMAP` (48 rows, K6's
residual input rows 19-66) and `JAC_ROWMAP` (12 rows, K6's Jacobian input
rows 12-23). The table is never built: the states are read where they
lie, and the rows are written into the caller's buffer, the one K6 reads
(fem.win_assembly). With the residual map, `geom` (the 19 residual
geometry rows) may be copied into the buffer's rows 0-18 in the same
pass.

`win_gather` is the K10 wrapper: on CUDA tensors it launches the
hand-written kernel csrc/win_gather.cu (one instance a row map, fixed at
compile time; a block's rows staged in shared memory and written in
aligned 16-byte quads), which replaces the TPU kernel
dedflow_tpu/sparse/win_gather.py::_gather_kernel; on CPU tensors it runs
`win_gather_plain`. Each launch counts in `win_gather.launches` and in
the count of its instance, `win_gather.instances[kind].launches`. A gather is exact, so the two agree bit for bit. The
TPU's window schedule (`GatherPlan`: 512-column node windows per 128
elements, for its lane gathers out of a VMEM-resident component-major
table) has no counterpart: a thread per element loads what it needs.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from dedflow_tpu_torch.utils import nvcc

# table columns: 0-5 the w_alpha components, 6 the heat source, 8-13 the
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

RES_ROWS, JAC_ROWS = 48, 12
GEOM_ROWS = 19  # the residual geometry rows (element_rows.res_geom_rows)
JACOBIAN_MAP, RESIDUAL_MAP, RESIDUAL_SOURCE_MAP = 0, 1, 2  # the kernel's instances


def _column(c: int, w_alpha, dw_alpha, source):
    """Column c of the node-major table: (N,) or None for a zero column."""
    if c < 6:
        return w_alpha[:, c]
    if c == 6:
        return source
    return dw_alpha[:, c - 8]


def _check_rows(out, row0: int, rows: int, geom, ne: int) -> None:
    if out.dim() != 2 or out.shape[1] != ne or not 0 <= row0 <= out.shape[0] - rows:
        raise ValueError(f"win_gather: rows {row0}..{row0 + rows} of a 2-D ({ne}-column) out, "
                         f"got {tuple(out.shape)}")
    if geom is not None and tuple(geom.shape) != (row0, ne):
        raise ValueError(f"win_gather: geom fills out rows 0..{row0}, got {tuple(geom.shape)}")


def win_gather_plain(ien_t, out, row0: int, w_alpha, dw_alpha=None, source=None,
                     geom=None) -> torch.Tensor:
    """K10's plain version (win_gather_xla on node-major states): out's
    rows row0.. get the residual map's 48 rows when `dw_alpha` is given,
    else the Jacobian map's 12; `geom` goes into rows 0..row0. Returns out."""
    rowmap, rows = (RES_ROWMAP, RES_ROWS) if dw_alpha is not None else (JAC_ROWMAP, JAC_ROWS)
    _check_rows(out, row0, rows, geom, ien_t.shape[1])
    if geom is not None:
        out[:row0] = geom
    dst = out[row0:row0 + rows]
    for a, row in enumerate(rowmap):
        nodes = ien_t[a].long()
        for c, r in enumerate(row):
            if r < 0:
                continue
            col = _column(c, w_alpha, dw_alpha, source)
            if col is None:
                dst[r] = 0
            else:
                dst[r] = col[nodes]
    return out


def _check_node_major(what: str, t, n: int, cols: int, device) -> None:
    shape = (n, cols) if cols else (n,)
    if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
            or t.device != device or t.data_ptr() % 8):
        raise ValueError(f"win_gather kernel: {what} must be a contiguous float32 {shape} "
                         f"tensor on the card, 8-byte aligned; got {t.dtype} "
                         f"{tuple(t.shape)}")


def win_gather(ien_t, out, row0: int, w_alpha, dw_alpha=None, source=None,
               geom=None) -> torch.Tensor:
    """K10: the element nodes' states into out's rows row0..: the residual
    map's 48 rows with `dw_alpha` (and the (N,) `source`, zero rows
    without), else the Jacobian map's 12 (from w_alpha's velocities); with
    `geom` (the residual map only) its rows go into rows 0..row0 in the
    same pass. The CUDA kernel on CUDA tensors (float32, node-major (N, 6)
    states, int32 (4, ne) ien_t, out and geom with unit element strides and
    a shared alignment), the plain version on CPU tensors. Returns out."""
    if not w_alpha.is_cuda:
        return win_gather_plain(ien_t, out, row0, w_alpha, dw_alpha, source, geom)
    residual = dw_alpha is not None
    ne = ien_t.shape[1] if ien_t.dim() == 2 else 0
    if ien_t.dim() != 2 or ien_t.shape[0] != 4 or ne == 0 or ien_t.dtype != torch.int32:
        raise ValueError(f"win_gather kernel: int32 (4, ne) ien_t, got {ien_t.dtype} "
                         f"{tuple(ien_t.shape)}")
    _check_rows(out, row0, RES_ROWS if residual else JAC_ROWS, geom, ne)
    if source is not None and not residual:
        raise ValueError("win_gather kernel: the source is a row of the residual map")
    if geom is not None and (not residual or row0 != GEOM_ROWS):
        raise ValueError(f"win_gather kernel: geom is the residual's {GEOM_ROWS} rows 0..19")
    dev, n = w_alpha.device, w_alpha.shape[0]
    for what, t, cols in (("w_alpha", w_alpha, 6), ("dw_alpha", dw_alpha, 6),
                          ("source", source, 0)):
        if t is not None:
            _check_node_major(what, t, n, cols, dev)
    for what, t in (("ien_t", ien_t), ("out", out), ("geom", geom)):
        if t is not None and (t.stride(1) != 1 or t.device != dev):
            raise ValueError(f"win_gather kernel: {what} needs a unit element stride on "
                             f"w_alpha's card")
    if out.dtype != torch.float32 or (geom is not None and geom.dtype != torch.float32):
        raise ValueError("win_gather kernel: float32 out and geom")
    if geom is not None and (geom.data_ptr() % 16 != out.data_ptr() % 16
                             or (geom.stride(0) - out.stride(0)) % 4):
        raise ValueError("win_gather kernel: geom and out must share their alignment (base "
                         "addresses equal modulo 16 bytes, row strides modulo 4): the geometry "
                         "rows are copied in 16-byte quads")
    kind = (JACOBIAN_MAP if not residual else
            RESIDUAL_SOURCE_MAP if source is not None else RESIDUAL_MAP)
    fn = nvcc.function(
        "win_gather", "dedflow_win_gather",
        [nvcc.P, nvcc.LL, nvcc.I, nvcc.P, nvcc.P, nvcc.P, nvcc.P, nvcc.LL, nvcc.P, nvcc.LL,
         nvcc.I, nvcc.I, nvcc.P],
    )
    ptr = lambda t: None if t is None else t.data_ptr()
    nvcc.check(
        fn(ien_t.data_ptr(), ien_t.stride(0), kind, w_alpha.data_ptr(), ptr(dw_alpha),
           ptr(source), ptr(geom), 0 if geom is None else geom.stride(0), out.data_ptr(),
           out.stride(0), row0, ne, torch.cuda.current_stream(dev).cuda_stream),
        "win_gather",
    )
    win_gather.launches += 1
    win_gather.instances[kind].launches += 1
    return out


win_gather.launches = 0
# the launches of each instance, indexed by JACOBIAN_MAP, RESIDUAL_MAP, RESIDUAL_SOURCE_MAP
win_gather.instances = tuple(
    SimpleNamespace(__name__=f"win_gather[{name}]", launches=0)
    for name in ("jacobian", "residual", "residual_source")
)
