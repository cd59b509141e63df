"""K7: the WinELL SpMV (counterpart of dedflow_tpu/sparse/win_kernels.py).

`winell_matvec` is what WinELLMatrixT.matvec_t calls. On a CUDA tensor it
launches the hand-written kernel csrc/winell_spmv.cu, which replaces the
TPU kernel dedflow_tpu/sparse/win_kernels.py::_matvec_kernel: a pass that
copies x into a node-major (n_x, 8) scratch, then the product with 16
lanes a row: two device launches from one C entry, one launch count; on
a CPU tensor it runs `winell_matvec_plain`, the flat gather + row sum of
the JAX package's reference lowering (WinELLMatrix._matvec_xla, winell.py:276-300).
Nothing falls back: a CUDA tensor the kernel cannot take raises, and so
does a CPU vector with a matrix on the card.

The kernel is built for float32 and float64. A float64 product (the
operator of krylov.precision "f64" and the residual of "ir") goes to
`winell_matvec_f64`, which launches the double instance and keeps its own
launch count: `winell_matvec.launches` counts the float32 launches only.

`winell_matvec_halo` is the product of a rank's own rows of an RCB
partition (parallel.sharded): x is the rank's extended (6, n_x) vector,
its own columns first and the ghosts its halo plan receives after them,
n_x >= n. The same kernel and entry (x's length is the kernel's stride;
the whole matrix passes n_x = n), its own launch count.
"""

from __future__ import annotations


import torch

from dedflow_tpu_torch.utils import nvcc


def winell_matvec_plain(mat, x_t: torch.Tensor, n_x: int | None = None) -> torch.Tensor:
    """(6, N) = A x, plain torch: per entry the 4x4 vel/p block product and
    the two scalar diagonals, summed into its row. x is (6, N), or (6, n_x)
    with `n_x` given (the halo product's extended vector)."""
    n_x = mat.plan.num_node if n_x is None else n_x
    if tuple(x_t.shape) != (6, n_x) or n_x < mat.plan.num_node:
        raise ValueError(f"winell_matvec: x has shape {tuple(x_t.shape)}, expected (6, {n_x}) "
                         f"with {n_x} >= {mat.plan.num_node} columns")
    plan, v = mat.plan, mat.vals
    xe = x_t[:, plan.col_t]  # (6, S)
    y = [v[i] * xe[0] + v[4 + i] * xe[1] + v[8 + i] * xe[2] + v[12 + i] * xe[3] for i in range(4)]
    contrib = torch.stack(y + [v[16] * xe[4], v[17] * xe[5]])
    out = torch.zeros((6, plan.num_node), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(1, plan.grow_t, contrib)


_SYMBOLS = {torch.float32: "dedflow_winell_spmv", torch.float64: "dedflow_winell_spmv_f64"}


def _kernel(mat, x_t: torch.Tensor) -> torch.Tensor:
    """The launch on a (6, n_x) vector, n_x >= n (n_x = n: the whole
    matrix): one C entry runs the node-major pass into an (n_x, 8) scratch
    and the product."""
    plan, vals = mat.plan, mat.vals
    n, s, n_x = plan.num_node, plan.S, x_t.shape[-1]
    dtype = x_t.dtype
    if n_x < n:
        raise ValueError(f"winell_matvec kernel: x has {n_x} < {n} columns")
    for name, t, shape in (("vals", vals, (18, s)), ("x", x_t, (6, n_x))):
        if (t.dtype not in _SYMBOLS or t.dtype != dtype or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError(
                f"winell_matvec kernel: {name} must be a contiguous float32 or float64 CUDA "
                "tensor of the other's dtype"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"winell_matvec kernel: {name} has shape {tuple(t.shape)}, expected {shape}")
    if plan.row_ptr_t.device != x_t.device or vals.device != x_t.device:
        raise ValueError("winell_matvec kernel: the plan or the values live on another device")
    fn = nvcc.function("winell_spmv", _SYMBOLS[dtype],
                       [nvcc.P] * 6 + [nvcc.I, nvcc.LL, nvcc.LL, nvcc.P])
    xn = torch.empty((n_x, 8), dtype=dtype, device=x_t.device)
    y = torch.empty((6, n), dtype=dtype, device=x_t.device)
    nvcc.check(
        fn(vals.data_ptr(), plan.row_ptr_t.data_ptr(), plan.col_t.data_ptr(), x_t.data_ptr(),
           xn.data_ptr(), y.data_ptr(), n, n_x, s,
           torch.cuda.current_stream(x_t.device).cuda_stream),
        "winell_spmv",
    )
    return y


def _on_card(mat, x_t) -> bool:
    return x_t.is_cuda or mat.vals.is_cuda or mat.plan.row_ptr_t.is_cuda


def _whole_shape(mat, x_t) -> None:
    """The whole matrix's product takes x of its own (6, N) shape only."""
    if tuple(x_t.shape) != (6, mat.plan.num_node):
        raise ValueError(f"winell_matvec kernel: x has shape {tuple(x_t.shape)}, expected "
                         f"(6, {mat.plan.num_node})")


def winell_matvec(mat, x_t: torch.Tensor) -> torch.Tensor:
    """(6, N) = A x: the CUDA kernel when the vector, the values or the
    plan lie on the card (a float64 product through winell_matvec_f64),
    the plain version on CPU tensors."""
    if not _on_card(mat, x_t):
        return winell_matvec_plain(mat, x_t)
    if x_t.dtype == torch.float64:
        return winell_matvec_f64(mat, x_t)
    _whole_shape(mat, x_t)
    y = _kernel(mat, x_t.contiguous())
    winell_matvec.launches += 1
    return y


def winell_matvec_f64(mat, x_t: torch.Tensor) -> torch.Tensor:
    """The float64 product: the kernel's double instance on the card, the
    plain version on CPU tensors."""
    if not _on_card(mat, x_t):
        return winell_matvec_plain(mat, x_t)
    if x_t.dtype != torch.float64:
        raise ValueError("winell_matvec_f64 kernel: x must be a float64 CUDA tensor")
    _whole_shape(mat, x_t)
    y = _kernel(mat, x_t.contiguous())
    winell_matvec_f64.launches += 1
    return y


def winell_matvec_halo(mat, x_t: torch.Tensor) -> torch.Tensor:
    """(6, n) = A x of a rank's own rows, x (6, n_x) its extended vector
    (n_x >= n: own columns, then ghosts): the kernel on the card (float32
    or float64), the plain version on CPU tensors."""
    if not _on_card(mat, x_t):
        return winell_matvec_plain(mat, x_t, x_t.shape[-1])
    y = _kernel(mat, x_t.contiguous())
    winell_matvec_halo.launches += 1
    return y


winell_matvec.launches = 0  # float32 launches
winell_matvec_f64.launches = 0
winell_matvec_halo.launches = 0
