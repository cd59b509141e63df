"""K3: the component-major DIA SpMV (counterpart of dedflow_tpu/sparse/dia_kernels.py).

`dia_matvec` is the wrapper the solver calls. On a CUDA tensor it launches
the hand-written kernel csrc/dia_spmv.cu, which replaces the TPU kernel
dedflow_tpu/sparse/dia_kernels.py::_mv_kernel; on a CPU tensor it runs
`dia_matvec_plain`, the shifted-slice product of FSDIAMatrixT.matvec_t
(fsbsr.py:407-442 of the JAX package). Nothing falls back: a CUDA tensor
the kernel cannot take raises.

On the card the product is bound by bytes: each row reads its 15 x 18
matrix entries once (about 190 MB at 175,616 rows) and x is reused from
cache; one thread per row keeps every read coalesced along the node axis.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.sparse.fsbsr import PP, PU, UP, UU
from dedflow_tpu_torch.utils import nvcc


def dia_matvec_plain(data, scal, x_t, offsets) -> torch.Tensor:
    """(6, N) = A x for data (D, 16, N), scal (2D, N), plain torch."""
    n = data.shape[2]
    m = max(max(abs(o) for o in offsets), 1)
    xpad = torch.nn.functional.pad(x_t, (m, m))
    xs = torch.stack([xpad[:, m + o : m + o + n] for o in offsets])  # (D, 6, N)
    d = data
    y = [
        (d[:, UU(i, 0)] * xs[:, 0] + d[:, UU(i, 1)] * xs[:, 1]
         + d[:, UU(i, 2)] * xs[:, 2] + d[:, UP(i)] * xs[:, 3]).sum(0)
        for i in range(3)
    ]
    y.append(
        (d[:, PU(0)] * xs[:, 0] + d[:, PU(1)] * xs[:, 1]
         + d[:, PU(2)] * xs[:, 2] + d[:, PP] * xs[:, 3]).sum(0)
    )
    sc = scal.reshape(len(offsets), 2, n)
    y.append((sc[:, 0] * xs[:, 4]).sum(0))
    y.append((sc[:, 1] * xs[:, 5]).sum(0))
    return torch.stack(y)


def _kernel(data, scal, x_t, offsets) -> torch.Tensor:
    nd, nc, n = data.shape
    for name, t, shape in (
        ("data", data, (nd, 16, n)), ("scal", scal, (2 * nd, n)), ("x", x_t, (6, n)),
    ):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"dia_matvec kernel: {name} must be a contiguous float32 CUDA tensor")
        if tuple(t.shape) != shape:
            raise ValueError(f"dia_matvec kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    fn = nvcc.function(
        "dia_spmv", "dedflow_dia_spmv",
        [nvcc.P, nvcc.P, nvcc.P, nvcc.P, nvcc.I, nvcc.I, nvcc.P, nvcc.P],
    )
    y = torch.empty((6, n), dtype=torch.float32, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    nvcc.check(
        fn(data.data_ptr(), scal.data_ptr(), x_t.data_ptr(), y.data_ptr(), n, nd,
           nvcc.int_array(offsets), stream),
        "dia_spmv",
    )
    dia_matvec.launches += 1
    return y


def dia_matvec(data, scal, x_t, offsets) -> torch.Tensor:
    """(6, N) = A x: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if x_t.is_cuda:
        return _kernel(data, scal, x_t.contiguous(), offsets)
    return dia_matvec_plain(data, scal, x_t, offsets)


dia_matvec.launches = 0
