"""K6, K4 and K5: the element kernels (counterparts of
dedflow_tpu/fem/pallas_kernels.py's row entry points `res_rows_call` /
`lhs_rows_call` and of its gather entry points `ns_residual_pallas` /
`ns_lhs_packed_pallas`).

`res_rows_call` maps (67, M) packed residual inputs to (24, M) element
residual rows a*6+c; `lhs_rows_call` maps (27, M) packed Jacobian inputs
to (288, M) rows ab*18+c, as in the JAX package, and with
`scalar_implicit` (melt-pool runs) (33, M) inputs, the last 6 rows the
metric entries, to the same rows with the consistent phi/T transport
tangents in components 16/17. Both also take the slab-major (S, R, M)
form. On a CUDA tensor they launch the hand-written
kernel csrc/element_rows.cu, which replaces the TPU kernel
dedflow_tpu/fem/pallas_kernels.py::_pallas_rows_call running `_res_kernel`
/ `_lhs_kernel`; on a CPU tensor they run the plain bodies
`element_rows.res_rows` / `element_rows.lhs_rows`. Nothing falls back: a
CUDA tensor the kernel cannot take raises.

K4 `ns_residual_gather` and K5 `ns_lhs_gather` are the general gather
tier's element passes: they take the static geometry rows (19, ne) /
(15, ne), the connectivity ien_t (4, ne) and the component-major (6, N)
alpha states, and return the same (24, ne) / (288, ne) rows as K6. On a
CUDA tensor they launch csrc/gather_elements.cu, which gathers each
element's nodal states into registers and runs K6's element body
(csrc/element_body.cuh), so the packed (67, ne) / (27, ne) inputs of the
TPU entry points are never written; on a CPU tensor they run their plain twins,
an index gather (`res_gather_inputs`, `lhs_gather_inputs`) followed by
`res_rows` / `lhs_rows`. Geometry and connectivity may be column slices
of a larger context (a row-strided view): the kernels read them in place.
Given the 6 metric rows (`metric`, a view of the residual geometry's rows
13-18), K5 emits the implicit phi/T tangents; the JAX package computes
those on this tier in XLA (fem/ns.py:184-235), the port in K5.

The `comp_major` output order is not ported: it is a TPU relayout, and
the reduces read rows ab*18+c in place.

The solver's Jacobian runs the staged entries instead, `lhs_rows_staged`
(K6) and `ns_lhs_gather_staged` (K5): the same inputs, the same element
body, but each element's 16 vel/p contributions go straight into K9's
(K, 16) staging buffer at their plan positions (`ReducePlan.elem_pos`),
in WinELL row order (`JAC_COMPS`), and in the implicit mode its phi/T
tangents into a (K, 8) buffer (columns 0-1, zeros in 2-7); K9's segment
sum alone (`sparse.win_ring.ring_reduce_staged`) then adds them up. The
(288, ne) rows and K9's staging pass never exist. Their plain twins run
the column body and place its rows with `stage_rows`.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem.element_rows import lhs_rows, res_rows
from dedflow_tpu_torch.sparse.win_stream import ReducePlan
from dedflow_tpu_torch.sparse.winell import WIN2COMP
from dedflow_tpu_torch.utils import nvcc

JAC_COMPS = tuple(int(c) for c in WIN2COMP[:16])  # WinELL row r <- element Jacobian comp


def res_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), cp=float(phys.cp),
        kappa=float(phys.kappa), fb=tuple(float(v) for v in phys.body_force),
        dt=float(scheme.dt),
    )


def lhs_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), f1=float(scheme.fact_dw),
        f2=float(scheme.fact_w), dt=float(scheme.dt), cp=float(phys.cp),
        kappa=float(phys.kappa),
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
    """K6 (Jacobian): (27, M) -> (288, M) element Jacobian rows ab*18+c,
    the frozen-scalar mode; with `scalar_implicit` (33, M) -> (288, M), the
    implicit phi/T tangents in components 16/17."""
    a = lhs_args(phys, scheme)
    if not inp.is_cuda:
        return lhs_rows(inp, scalar_implicit=scalar_implicit, **a)
    slabs, m = _check_input("lhs_rows", inp, 33 if scalar_implicit else 27)
    fn = nvcc.function(
        "element_rows", "dedflow_lhs_rows",
        [nvcc.P, nvcc.P, nvcc.I, nvcc.I] + [nvcc.D] * 7 + [nvcc.I, nvcc.P],
    )
    out = torch.empty((*inp.shape[:-2], 288, m), dtype=torch.float32, device=inp.device)
    nvcc.check(
        fn(inp.data_ptr(), out.data_ptr(), m, slabs, a["rho"], a["mu"], a["f1"],
           a["f2"], a["dt"], a["cp"], a["kappa"], int(scalar_implicit),
           torch.cuda.current_stream(inp.device).cuda_stream),
        "lhs_rows",
    )
    lhs_rows_call.launches += 1
    return out


lhs_rows_call.launches = 0


# ---------------------------------------------------------------------------
# K4 / K5: element passes fused with the nodal-state gather


def res_gather_inputs(res_geom, ien_t, w_t, dw_t, source=None) -> torch.Tensor:
    """(67, ne) K6 residual input rows: geometry, then the element nodes'
    u, du (rows i*4+a), p (dw slot 3), phi, T, dphi, dT and the heat
    source (zeros without one). States are (6, N); ien_t (4, ne)."""
    ne = ien_t.shape[1]
    idx = ien_t.long()
    gw, gd = w_t[:, idx], dw_t[:, idx]  # (6, 4, ne)
    src = (torch.zeros((4, ne), dtype=w_t.dtype, device=w_t.device)
           if source is None else source[idx])
    return torch.cat([
        res_geom, gw[:3].reshape(12, ne), gd[:3].reshape(12, ne),
        gd[3], gw[4], gw[5], gd[4], gd[5], src,
    ])


def lhs_gather_inputs(lhs_geom, ien_t, w_t, metric=None) -> torch.Tensor:
    """(27, ne) K6 Jacobian input rows: shape gradients, the element
    nodes' velocity (rows i*4+a), det, gg, tr; (33, ne) with the 6 metric
    rows `metric` appended (the implicit mode's input)."""
    u = w_t[:3][:, ien_t.long()].reshape(12, ien_t.shape[1])
    return torch.cat([lhs_geom[:12], u, lhs_geom[12:], *([] if metric is None else [metric])])


def ns_residual_gather_plain(res_geom, ien_t, w_t, dw_t, phys, scheme, source=None):
    """K4's plain twin: (24, ne) rows a*6+c."""
    return res_rows(res_gather_inputs(res_geom, ien_t, w_t, dw_t, source), **res_args(phys, scheme))


def ns_lhs_gather_plain(lhs_geom, ien_t, w_t, phys, scheme, metric=None):
    """K5's plain twin: (288, ne) rows ab*18+c; implicit with `metric`."""
    return lhs_rows(lhs_gather_inputs(lhs_geom, ien_t, w_t, metric),
                    scalar_implicit=metric is not None, **lhs_args(phys, scheme))


def _check_gather(what: str, geom, rows: int, ien_t, states) -> tuple[int, int]:
    """(N, ne) of float32 CUDA inputs the gather kernels take: geometry
    (rows, ne) and ien_t (4, ne) int32 with unit element stride (a column
    slice is fine), contiguous (C, N) states on the same card."""
    ne = ien_t.shape[-1]
    if geom.dim() != 2 or geom.shape != (rows, ne) or ien_t.dim() != 2 or ien_t.shape[0] != 4 or ne == 0:
        raise ValueError(f"{what} kernel: geometry ({rows}, ne) and ien_t (4, ne), "
                         f"got {tuple(geom.shape)} and {tuple(ien_t.shape)}")
    if geom.dtype != torch.float32 or ien_t.dtype != torch.int32:
        raise ValueError(f"{what} kernel: float32 geometry and int32 ien_t, got {geom.dtype}, {ien_t.dtype}")
    if geom.stride(1) != 1 or ien_t.stride(1) != 1:
        raise ValueError(f"{what} kernel: geometry and ien_t need a unit element stride")
    n = states[0].shape[1]
    for s in states:
        if s is None:
            continue
        if s.dtype != torch.float32 or not s.is_contiguous() or s.shape[-1] != n:
            raise ValueError(f"{what} kernel: states must be contiguous float32 (C, N)")
    if any(t is not None and t.device != geom.device for t in (ien_t, *states)):
        raise ValueError(f"{what} kernel: inputs on different devices")
    return n, ne


def ns_residual_gather(res_geom, ien_t, w_t, dw_t, phys: Physics, scheme: TimeScheme, source=None):
    """K4: (24, ne) element residual rows a*6+c of the gathered (6, N)
    alpha states (`source` (N,) or None). The CUDA kernel on CUDA tensors,
    the plain twin on CPU tensors."""
    if not w_t.is_cuda:
        return ns_residual_gather_plain(res_geom, ien_t, w_t, dw_t, phys, scheme, source)
    if w_t.shape[0] != 6 or dw_t.shape != w_t.shape or (source is not None and source.shape != w_t.shape[1:]):
        raise ValueError("res_gather kernel: states (6, N) and a source (N,) or None")
    n, ne = _check_gather("res_gather", res_geom, 19, ien_t, (w_t, dw_t, source))
    a = res_args(phys, scheme)
    fn = nvcc.function(
        "gather_elements", "dedflow_res_gather",
        [nvcc.P, nvcc.LL, nvcc.P, nvcc.LL, nvcc.P, nvcc.P, nvcc.P, nvcc.I, nvcc.I]
        + [nvcc.D] * 8 + [nvcc.P, nvcc.P],
    )
    out = torch.empty((24, ne), dtype=torch.float32, device=w_t.device)
    nvcc.check(
        fn(res_geom.data_ptr(), res_geom.stride(0), ien_t.data_ptr(), ien_t.stride(0),
           w_t.data_ptr(), dw_t.data_ptr(), None if source is None else source.data_ptr(),
           n, ne, a["rho"], a["mu"], a["cp"], a["kappa"], *a["fb"], a["dt"],
           out.data_ptr(), torch.cuda.current_stream(w_t.device).cuda_stream),
        "res_gather",
    )
    ns_residual_gather.launches += 1
    return out


ns_residual_gather.launches = 0


def ns_lhs_gather(lhs_geom, ien_t, w_t, phys: Physics, scheme: TimeScheme, metric=None):
    """K5: (288, ne) packed element Jacobian rows ab*18+c of the gathered
    (6, N) state w (its velocity rows): the frozen-scalar mode, or with the
    (6, ne) metric rows `metric` (a view of the residual geometry's rows
    13-18) the implicit phi/T tangents. The CUDA kernel on CUDA tensors,
    the plain twin on CPU tensors."""
    if not w_t.is_cuda:
        return ns_lhs_gather_plain(lhs_geom, ien_t, w_t, phys, scheme, metric)
    if w_t.shape[0] < 3:
        raise ValueError("lhs_gather kernel: the state needs its 3 velocity rows")
    n, ne = _check_gather("lhs_gather", lhs_geom, 15, ien_t, (w_t,))
    if metric is not None:
        _check_gather("lhs_gather", metric, 6, ien_t, (w_t,))
    a = lhs_args(phys, scheme)
    fn = nvcc.function(
        "gather_elements", "dedflow_lhs_gather",
        [nvcc.P, nvcc.LL, nvcc.P, nvcc.LL, nvcc.P, nvcc.LL, nvcc.P, nvcc.I, nvcc.I]
        + [nvcc.D] * 7 + [nvcc.P, nvcc.P],
    )
    out = torch.empty((288, ne), dtype=torch.float32, device=w_t.device)
    nvcc.check(
        fn(lhs_geom.data_ptr(), lhs_geom.stride(0),
           None if metric is None else metric.data_ptr(), 0 if metric is None else metric.stride(0),
           ien_t.data_ptr(), ien_t.stride(0), w_t.data_ptr(), n, ne, a["rho"], a["mu"], a["f1"],
           a["f2"], a["dt"], a["cp"], a["kappa"], out.data_ptr(),
           torch.cuda.current_stream(w_t.device).cuda_stream),
        "lhs_gather",
    )
    ns_lhs_gather.launches += 1
    return out


ns_lhs_gather.launches = 0


# ---------------------------------------------------------------------------
# K5 / K6 staged: the element Jacobian straight into K9's staging rows


def element_positions(plan: ReducePlan, m: int) -> torch.Tensor:
    """(16 * m,) plan positions of the contributions (e, ab) of m elements
    at ab*m + e, -1 where the plan has none: the plan's `elem_pos`.
    Raises for a plan without it or built for another element count."""
    pos = plan.elem_pos
    if pos is None or pos.numel() != 16 * m:
        raise ValueError(
            f"staged element Jacobian: the plan has no element positions for {m} elements "
            f"(elem_pos {None if pos is None else pos.numel()}, expected {16 * m}): build it "
            "with sparse.win_stream.with_element_positions"
        )
    return pos


def stage_rows(plan: ReducePlan, rows: torch.Tensor, scalar_implicit: bool = False):
    """K9's staging rows of (288, m) element Jacobian rows ab*18+c: (K, 16),
    row k the contribution at plan position k, its components JAC_COMPS
    (WinELL row order); with `scalar_implicit` also (K, 8), the phi/T
    tangents 16/17 in columns 0-1 and zeros (else None). The staged
    kernels' placement, in torch."""
    m = rows.shape[-1]
    pos = element_positions(plan, m).long()
    k = plan.src.numel()
    blocks = rows.reshape(16, 18, m)
    keep = pos >= 0
    at = pos[keep]
    stage = rows.new_empty((k, 16))
    stage[at] = blocks[:, list(JAC_COMPS)].permute(0, 2, 1).reshape(16 * m, 16)[keep]
    if not scalar_implicit:
        return stage, None
    tang = rows.new_zeros((k, 8))
    tang[at, :2] = blocks[:, 16:18].permute(0, 2, 1).reshape(16 * m, 2)[keep]
    return stage, tang


def lhs_rows_staged_plain(inp, phys, scheme, plan: ReducePlan, scalar_implicit: bool = False):
    """The staged K6's plain twin: `lhs_rows`, then `stage_rows`."""
    rows = lhs_rows(inp, scalar_implicit=scalar_implicit, **lhs_args(phys, scheme))
    return stage_rows(plan, rows, scalar_implicit)


def ns_lhs_gather_staged_plain(lhs_geom, ien_t, w_t, phys, scheme, plan: ReducePlan,
                               metric=None):
    """The staged K5's plain twin: `ns_lhs_gather_plain`, then `stage_rows`."""
    rows = ns_lhs_gather_plain(lhs_geom, ien_t, w_t, phys, scheme, metric)
    return stage_rows(plan, rows, metric is not None)


def _staged_buffers(k: int, implicit: bool, device):
    """The staged kernels' outputs: (K, 16) and, implicit, (K, 8). Every row
    is stored (the plan's positions are distinct and cover [0, K))."""
    stage = torch.empty((k, 16), dtype=torch.float32, device=device)
    tang = torch.empty((k, 8), dtype=torch.float32, device=device) if implicit else None
    return stage, tang


def lhs_rows_staged(inp: torch.Tensor, phys: Physics, scheme: TimeScheme, plan: ReducePlan,
                    scalar_implicit: bool = False):
    """K6 staged: (27, m) Jacobian inputs (33 with `scalar_implicit`) ->
    K9's staging rows of `plan`, (K, 16) and the tangents' (K, 8) or None
    (as `stage_rows` of `lhs_rows_call`'s rows). The CUDA kernel on a CUDA
    tensor, the plain twin on a CPU tensor."""
    m = inp.shape[-1]
    pos = element_positions(plan, m)
    if not inp.is_cuda:
        return lhs_rows_staged_plain(inp, phys, scheme, plan, scalar_implicit)
    if inp.dim() != 2:
        raise ValueError(f"lhs_rows_staged kernel: input must be 2-D, got {tuple(inp.shape)}")
    _check_input("lhs_rows_staged", inp, 33 if scalar_implicit else 27)
    if pos.device != inp.device:
        raise ValueError("lhs_rows_staged kernel: the plan lives on another device")
    a = lhs_args(phys, scheme)
    fn = nvcc.function(
        "element_rows", "dedflow_lhs_rows_staged",
        [nvcc.P, nvcc.P, nvcc.I] + [nvcc.D] * 7 + [nvcc.I, nvcc.P, nvcc.P, nvcc.P],
    )
    stage, tang = _staged_buffers(plan.src.numel(), scalar_implicit, inp.device)
    nvcc.check(
        fn(inp.data_ptr(), pos.data_ptr(), m, a["rho"], a["mu"], a["f1"], a["f2"], a["dt"],
           a["cp"], a["kappa"], int(scalar_implicit), stage.data_ptr(),
           None if tang is None else tang.data_ptr(),
           torch.cuda.current_stream(inp.device).cuda_stream),
        "lhs_rows_staged",
    )
    lhs_rows_staged.launches += 1
    return stage, tang


lhs_rows_staged.launches = 0


def ns_lhs_gather_staged(lhs_geom, ien_t, w_t, phys: Physics, scheme: TimeScheme,
                         plan: ReducePlan, metric=None):
    """K5 staged: the gathered element Jacobian of `ns_lhs_gather` (implicit
    with `metric`) straight into K9's staging rows of `plan`: (K, 16) and
    the tangents' (K, 8) or None. The CUDA kernel on CUDA tensors, the
    plain twin on CPU tensors."""
    pos = element_positions(plan, ien_t.shape[-1])
    if not w_t.is_cuda:
        return ns_lhs_gather_staged_plain(lhs_geom, ien_t, w_t, phys, scheme, plan, metric)
    if w_t.shape[0] < 3:
        raise ValueError("lhs_gather_staged kernel: the state needs its 3 velocity rows")
    n, ne = _check_gather("lhs_gather_staged", lhs_geom, 15, ien_t, (w_t,))
    if metric is not None:
        _check_gather("lhs_gather_staged", metric, 6, ien_t, (w_t,))
    if pos.device != w_t.device:
        raise ValueError("lhs_gather_staged kernel: the plan lives on another device")
    a = lhs_args(phys, scheme)
    fn = nvcc.function(
        "gather_elements", "dedflow_lhs_gather_staged",
        [nvcc.P, nvcc.LL, nvcc.P, nvcc.LL, nvcc.P, nvcc.LL, nvcc.P, nvcc.P, nvcc.I, nvcc.I]
        + [nvcc.D] * 7 + [nvcc.P, nvcc.P, nvcc.P],
    )
    stage, tang = _staged_buffers(plan.src.numel(), metric is not None, w_t.device)
    nvcc.check(
        fn(lhs_geom.data_ptr(), lhs_geom.stride(0),
           None if metric is None else metric.data_ptr(), 0 if metric is None else metric.stride(0),
           ien_t.data_ptr(), ien_t.stride(0), w_t.data_ptr(), pos.data_ptr(), n, ne, a["rho"],
           a["mu"], a["f1"], a["f2"], a["dt"], a["cp"], a["kappa"], stage.data_ptr(),
           None if tang is None else tang.data_ptr(),
           torch.cuda.current_stream(w_t.device).cuda_stream),
        "lhs_gather_staged",
    )
    ns_lhs_gather_staged.launches += 1
    return stage, tang


ns_lhs_gather_staged.launches = 0
