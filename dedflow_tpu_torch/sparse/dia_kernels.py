"""K3: the component-major DIA SpMV (counterpart of dedflow_tpu/sparse/dia_kernels.py).

`dia_matvec` is the wrapper the solver calls. On a CUDA tensor it launches
the hand-written kernel csrc/dia_spmv.cu, which replaces the TPU kernel
dedflow_tpu/sparse/dia_kernels.py::_mv_kernel; on a CPU tensor it runs
`dia_matvec_plain`, the shifted-slice product of FSDIAMatrixT.matvec_t
(fsbsr.py:407-442 of the JAX package). Nothing falls back: a CUDA tensor
the kernel cannot take raises, and so does a mix of CUDA and CPU tensors.

The kernel is built for float32 and float64. A float64 product (the
operator of krylov.precision "f64" and the residual of "ir", which the JAX
package computes with its XLA matvec, newton.py:221-238) goes to
`dia_matvec_f64`, which launches the double instance and keeps its own
launch count: `dia_matvec.launches` counts the float32 launches only.
The kernel has one C entry per dtype, which takes x's length and the
column of row 0: the whole matrix passes (n, 0).

On the card the product is bound by bytes: each row reads its 15 x 18
matrix entries once (about 190 MB at 175,616 rows) and x is reused from
cache; one thread per row keeps every read coalesced along the node axis.
The kernel takes up to MAX_PLANES planes D, with the offsets by value: every
D the solver builds (the Kuhn lattice has 15, a class table of up to 8
slabs up to 97), as the JAX package's DIA SpMV takes any.

`dia_matvec_banded` is the product on one rank of the z-slab decomposition
(parallel.sharded; the JAX package's dia_matvec_pallas_shmap,
dia_kernels.py:232-290): its own rows, with x holding a band of each
neighbour's node layer around them. It is the same kernel and C entry,
given x's own length and the column of its first own node by argument;
a float64 slab product goes to `dia_matvec_banded_f64`, with its own
launch count.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.sparse.fsbsr import PP, PU, UP, UU
from dedflow_tpu_torch.utils import nvcc


def dia_matvec_plain(data, scal, x_t, offsets) -> torch.Tensor:
    """(6, N) = A x for data (D, 16, N), scal (2D, N), plain torch."""
    return dia_matvec_banded_plain(data, scal, x_t, offsets, 0)


def dia_matvec_banded_plain(data, scal, x_t, offsets, x_lo: int) -> torch.Tensor:
    """(6, n) = A x for data (D, 16, n), scal (2D, n) and x (6, m): row r
    reads x's column x_lo + r + offsets[k], zero outside [0, m) (a rank's
    own rows with a band of each neighbour's node layer around them in x;
    m = n, x_lo = 0 is the whole matrix), plain torch."""
    n, m = data.shape[2], x_t.shape[1]
    if x_lo < 0 or m < x_lo + n:
        raise ValueError(f"dia_matvec: x of {m} columns from {x_lo} does not cover {n} rows")
    reach = max(max(abs(o) for o in offsets), 1)
    xpad = torch.nn.functional.pad(x_t, (reach, reach))
    xs = torch.stack([xpad[:, reach + x_lo + o : reach + x_lo + o + n] for o in offsets])
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


_SYMBOLS = {torch.float32: "dedflow_dia_spmv", torch.float64: "dedflow_dia_spmv_f64"}
MAX_PLANES = 128  # csrc/dia_spmv.cu kMaxPlanesSpmv


def _kernel(data, scal, x_t, offsets, x_lo: int = 0) -> torch.Tensor:
    """The launch: the C entry of x's dtype, given x's length m and the
    column x_lo of row 0 (the whole matrix: x (6, n), x_lo 0)."""
    nd, nc, n = data.shape
    dtype = x_t.dtype
    m = x_t.shape[1]
    if x_lo < 0 or m < x_lo + n:
        raise ValueError(f"dia_matvec kernel: x must have at least x_lo + {n} columns "
                         f"(got {m} from {x_lo})")
    for name, t, shape in (
        ("data", data, (nd, 16, n)), ("scal", scal, (2 * nd, n)), ("x", x_t, (6, m)),
    ):
        if (t.dtype not in _SYMBOLS or t.dtype != dtype or not t.is_cuda
                or t.device != data.device or not t.is_contiguous()):
            raise ValueError(
                f"dia_matvec kernel: {name} must be a contiguous float32 or float64 CUDA "
                "tensor of the others' dtype and device"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"dia_matvec kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    if len(offsets) != nd or not 1 <= nd <= MAX_PLANES:
        raise ValueError(f"dia_matvec kernel: {len(offsets)} offsets for {nd} planes "
                         f"(it takes 1 to {MAX_PLANES})")
    fn = nvcc.function(
        "dia_spmv", _SYMBOLS[dtype],
        [nvcc.P, nvcc.P, nvcc.P, nvcc.P] + [nvcc.I] * 4 + [nvcc.P, nvcc.P],
    )
    y = torch.empty((6, n), dtype=dtype, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    nvcc.check(
        fn(data.data_ptr(), scal.data_ptr(), x_t.data_ptr(), y.data_ptr(), n, m, x_lo, nd,
           nvcc.int_array(offsets), stream),
        "dia_spmv",
    )
    return y


def _on_card(*ts) -> bool:
    return any(t.is_cuda for t in ts)


def _whole(data, x_t) -> None:
    """The whole matrix's product takes x of its own (6, N) shape only."""
    if tuple(x_t.shape) != (6, data.shape[2]):
        raise ValueError(f"dia_matvec kernel: x has shape {tuple(x_t.shape)}, expected "
                         f"(6, {data.shape[2]})")


def dia_matvec(data, scal, x_t, offsets) -> torch.Tensor:
    """(6, N) = A x: the CUDA kernel when any operand is a CUDA tensor (a
    float64 product through dia_matvec_f64), the plain version on CPU
    tensors."""
    if not _on_card(data, scal, x_t):
        return dia_matvec_plain(data, scal, x_t, offsets)
    if x_t.dtype == torch.float64:
        return dia_matvec_f64(data, scal, x_t, offsets)
    _whole(data, x_t)
    y = _kernel(data, scal, x_t.contiguous(), offsets)
    dia_matvec.launches += 1
    return y


def dia_matvec_f64(data, scal, x_t, offsets) -> torch.Tensor:
    """The float64 product: the kernel's double instance on CUDA tensors,
    the plain version on CPU tensors."""
    if not _on_card(data, scal, x_t):
        return dia_matvec_plain(data, scal, x_t, offsets)
    if x_t.dtype != torch.float64:
        raise ValueError("dia_matvec_f64 kernel: x must be a float64 CUDA tensor")
    _whole(data, x_t)
    y = _kernel(data, scal, x_t.contiguous(), offsets)
    dia_matvec_f64.launches += 1
    return y


def dia_matvec_banded(data, scal, x_t, offsets, x_lo: int) -> torch.Tensor:
    """(6, n) = A x on a rank's own rows with x (6, m) banded around them
    (dia_matvec_banded_plain's contract): the same CUDA kernel when any
    operand is a CUDA tensor (a float64 product through
    dia_matvec_banded_f64), with its own launch count, the plain version on
    CPU tensors."""
    if not _on_card(data, scal, x_t):
        return dia_matvec_banded_plain(data, scal, x_t, offsets, x_lo)
    if x_t.dtype == torch.float64:
        return dia_matvec_banded_f64(data, scal, x_t, offsets, x_lo)
    y = _kernel(data, scal, x_t.contiguous(), offsets, x_lo)
    dia_matvec_banded.launches += 1
    return y


def dia_matvec_banded_f64(data, scal, x_t, offsets, x_lo: int) -> torch.Tensor:
    """The float64 banded product (krylov.precision "f64" and the residual
    of "ir" on a rank's slab): the kernel's double instance on CUDA
    tensors, the plain version on CPU tensors."""
    if not _on_card(data, scal, x_t):
        return dia_matvec_banded_plain(data, scal, x_t, offsets, x_lo)
    if x_t.dtype != torch.float64:
        raise ValueError("dia_matvec_banded_f64 kernel: x must be a float64 CUDA tensor")
    y = _kernel(data, scal, x_t.contiguous(), offsets, x_lo)
    dia_matvec_banded_f64.launches += 1
    return y


dia_matvec.launches = 0  # float32 launches on the whole matrix
dia_matvec_banded.launches = 0  # float32 launches on a rank's slab
dia_matvec_f64.launches = 0
dia_matvec_banded_f64.launches = 0
