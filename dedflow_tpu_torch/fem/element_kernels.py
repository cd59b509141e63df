"""K6: the element-row kernels (counterpart of the row entry points of
dedflow_tpu/fem/pallas_kernels.py: `res_rows_call` and `lhs_rows_call`).

`res_rows_call` maps (67, M) packed residual inputs to (24, M) element
residual rows a*6+c; `lhs_rows_call` maps (27, M) packed Jacobian inputs
to (288, M) rows ab*18+c, as in the JAX package. Both also take the
slab-major (S, R, M) form. On a CUDA tensor they launch the hand-written
kernel csrc/element_rows.cu, which replaces the TPU kernel
dedflow_tpu/fem/pallas_kernels.py::_pallas_rows_call running `_res_kernel`
/ `_lhs_kernel`; on a CPU tensor they run the plain bodies
`element_rows.res_rows` / `element_rows.lhs_rows`. Nothing falls back: a
CUDA tensor the kernel cannot take raises.

The 33-row implicit-scalar Jacobian (melt-pool tangents) and the
`comp_major` output order are not ported (ROADMAP queue A12).
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem.element_rows import lhs_rows, res_rows
from dedflow_tpu_torch.utils import nvcc


def res_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), cp=float(phys.cp),
        kappa=float(phys.kappa), fb=tuple(float(v) for v in phys.body_force),
        dt=float(scheme.dt),
    )


def lhs_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), f1=float(scheme.fact_dw),
        f2=float(scheme.fact_w), dt=float(scheme.dt),
    )


def _check_input(what: str, inp: torch.Tensor, rows: int) -> tuple[int, int]:
    """(slabs, M) of a (rows, M) or (S, rows, M) float32 CUDA input."""
    if inp.dtype != torch.float32 or not inp.is_contiguous():
        raise ValueError(
            f"{what} kernel: input must be a contiguous float32 CUDA tensor "
            f"(got {inp.dtype}, contiguous={inp.is_contiguous()})"
        )
    if inp.dim() not in (2, 3) or inp.shape[-2] != rows or inp.shape[-1] == 0:
        raise ValueError(f"{what} kernel: input must be ({rows}, M) or (S, {rows}, M), got {tuple(inp.shape)}")
    return (inp.shape[0] if inp.dim() == 3 else 1), inp.shape[-1]


def res_rows_call(inp: torch.Tensor, phys: Physics, scheme: TimeScheme) -> torch.Tensor:
    """K6 (residual): (67, M) -> (24, M) element residual rows."""
    a = res_args(phys, scheme)
    if not inp.is_cuda:
        return res_rows(inp, **a)
    slabs, m = _check_input("res_rows", inp, 67)
    fn = nvcc.function(
        "element_rows", "dedflow_res_rows", [nvcc.P, nvcc.P, nvcc.I, nvcc.I] + [nvcc.D] * 8 + [nvcc.P]
    )
    out = torch.empty((*inp.shape[:-2], 24, m), dtype=torch.float32, device=inp.device)
    nvcc.check(
        fn(inp.data_ptr(), out.data_ptr(), m, slabs, a["rho"], a["mu"], a["cp"],
           a["kappa"], *a["fb"], a["dt"], torch.cuda.current_stream(inp.device).cuda_stream),
        "res_rows",
    )
    res_rows_call.launches += 1
    return out


res_rows_call.launches = 0


def lhs_rows_call(
    inp: torch.Tensor, phys: Physics, scheme: TimeScheme, scalar_implicit: bool = False,
) -> torch.Tensor:
    """K6 (Jacobian): (27, M) -> (288, M) element Jacobian rows ab*18+c
    (frozen-scalar mode)."""
    if scalar_implicit:
        raise NotImplementedError(
            "dedflow_tpu_torch does not port scalar_implicit element Jacobians "
            "(33 input rows, melt-pool tangents) yet (ROADMAP queue A12)"
        )
    a = lhs_args(phys, scheme)
    if not inp.is_cuda:
        return lhs_rows(inp, **a)
    slabs, m = _check_input("lhs_rows", inp, 27)
    fn = nvcc.function(
        "element_rows", "dedflow_lhs_rows", [nvcc.P, nvcc.P, nvcc.I, nvcc.I] + [nvcc.D] * 5 + [nvcc.P]
    )
    out = torch.empty((*inp.shape[:-2], 288, m), dtype=torch.float32, device=inp.device)
    nvcc.check(
        fn(inp.data_ptr(), out.data_ptr(), m, slabs, a["rho"], a["mu"], a["f1"],
           a["f2"], a["dt"], torch.cuda.current_stream(inp.device).cuda_stream),
        "lhs_rows",
    )
    lhs_rows_call.launches += 1
    return out


lhs_rows_call.launches = 0
