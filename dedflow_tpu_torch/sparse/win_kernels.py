"""K7: the WinELL SpMV (counterpart of dedflow_tpu/sparse/win_kernels.py).

`winell_matvec` is what WinELLMatrixT.matvec_t calls. On a CUDA tensor it
launches the hand-written kernel csrc/winell_spmv.cu, which replaces the
TPU kernel dedflow_tpu/sparse/win_kernels.py::_matvec_kernel; on a CPU
tensor it runs `winell_matvec_plain`, the flat gather + row sum of the JAX
package's reference lowering (WinELLMatrix._matvec_xla, winell.py:276-300).
Nothing falls back: a CUDA tensor the kernel cannot take raises, and so
does a CPU vector with a matrix on the card.

The kernel is built for float32 and float64. A float64 product (the
operator of krylov.precision "f64" and the residual of "ir") goes to
`winell_matvec_f64`, which launches the double instance and keeps its own
launch count: `winell_matvec.launches` counts the float32 launches only.
"""

from __future__ import annotations


import torch

from dedflow_tpu_torch.utils import nvcc


def winell_matvec_plain(mat, x_t: torch.Tensor) -> torch.Tensor:
    """(6, N) = A x, plain torch: per entry the 4x4 vel/p block product and
    the two scalar diagonals, summed into its row."""
    plan, v = mat.plan, mat.vals
    xe = x_t[:, plan.col_t]  # (6, S)
    y = [v[i] * xe[0] + v[4 + i] * xe[1] + v[8 + i] * xe[2] + v[12 + i] * xe[3] for i in range(4)]
    contrib = torch.stack(y + [v[16] * xe[4], v[17] * xe[5]])
    out = torch.zeros((6, plan.num_node), dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(1, plan.grow_t, contrib)


_SYMBOLS = {torch.float32: "dedflow_winell_spmv", torch.float64: "dedflow_winell_spmv_f64"}


def _kernel(mat, x_t: torch.Tensor) -> torch.Tensor:
    plan, vals = mat.plan, mat.vals
    n, s = plan.num_node, plan.S
    dtype = x_t.dtype
    for name, t, shape in (("vals", vals, (18, s)), ("x", x_t, (6, n))):
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
    fn = nvcc.function(
        "winell_spmv", _SYMBOLS[dtype],
        [nvcc.P] * 5 + [nvcc.I, nvcc.LL, nvcc.P],
    )
    y = torch.empty((6, n), dtype=dtype, device=x_t.device)
    nvcc.check(
        fn(vals.data_ptr(), plan.row_ptr_t.data_ptr(), plan.col_t.data_ptr(), x_t.data_ptr(),
           y.data_ptr(), n, s, torch.cuda.current_stream(x_t.device).cuda_stream),
        "winell_spmv",
    )
    return y


def _on_card(mat, x_t) -> bool:
    return x_t.is_cuda or mat.vals.is_cuda or mat.plan.row_ptr_t.is_cuda


def winell_matvec(mat, x_t: torch.Tensor) -> torch.Tensor:
    """(6, N) = A x: the CUDA kernel when the vector, the values or the
    plan lie on the card (a float64 product through winell_matvec_f64),
    the plain version on CPU tensors."""
    if not _on_card(mat, x_t):
        return winell_matvec_plain(mat, x_t)
    if x_t.dtype == torch.float64:
        return winell_matvec_f64(mat, x_t)
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
    y = _kernel(mat, x_t.contiguous())
    winell_matvec_f64.launches += 1
    return y


winell_matvec.launches = 0  # float32 launches
winell_matvec_f64.launches = 0
