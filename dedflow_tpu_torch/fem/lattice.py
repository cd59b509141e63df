"""Gather-free structured-lattice path for box meshes (counterpart of
dedflow_tpu/fem/lattice.py, single device).

On the Kuhn-subdivided box lattice (mesh.gen.box_mesh) every element-node
access is a fixed index offset: cell id = the node id of its lowest corner,
`ix + Sy*iy + Sz*iz`; vertex a of Kuhn tet ("slab") t of cell c is node
c + delta[t][a]. Cells on the far faces (ix == nx, iy == ny or iz == nz) are
dead: their geometry is zero, so their contributions are exactly zero and no
masking is needed. Geometry is slab-major (6, rows, N) with column = cell,
vectors travel component-major (6, N), and the Jacobian lands directly in
component-major DIA storage (sparse.fsbsr.FSDIAMatrixT).

Two kernels carry the path, each behind a wrapper with a launch counter:

- K1 `residual_volume`: the volume residual (6, N). On CUDA the kernel
  csrc/lattice_residual.cu, which replaces fem/lattice.py::_res_t8_kernel of
  the JAX package; on the CPU `residual_volume_plain`, the unfused pipeline
  (shifted-slice inputs -> element_rows.res_rows -> 24 shifted adds).
- K2 `jacobian_volume`: the finished (D, 16, N) velocity/pressure DIA data,
  Dirichlet-masked, unit diagonal on the zero-offset plane, facet band
  added. On CUDA csrc/lattice_jacobian.cu, which replaces
  fem/lattice.py::_lhs_fused_body (masked mode); on the CPU
  `jacobian_volume_plain` (inputs -> element_rows.lhs_rows(ncomp=16) -> 96
  shifted adds -> the mask epilogue).

A CUDA tensor always goes to the kernel (or raises); only a CPU tensor takes
the plain version. The phi-phi / T-T components are state independent and
come from the node multiplicity `mult`, outside the kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem.element import tet_geometry
from dedflow_tpu_torch.fem.element_rows import (  # noqa: F401 (field_norms_t re-exported)
    field_norms_t,
    lhs_geom_rows,
    lhs_rows,
    res_geom_rows,
    res_rows,
)
from dedflow_tpu_torch.fem.face import (
    face_dia_band,
    face_lhs_packed,
    face_residual_elements,
    face_residual_scatter,
)
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT, diag_add_rows, keep_pc_rows
from dedflow_tpu_torch.utils import nvcc


@dataclass
class LatticeContext:
    """Per-slab geometry rows + static shift tables."""

    res_geom: torch.Tensor  # (6, 19, N) element_rows.res_geom_rows, column = cell
    lhs_geom: torch.Tensor  # (6, 15, N) element_rows.lhs_geom_rows, column = cell
    # (N,) live-element multiplicity per node: the phi-phi/T-T identity
    # components of the Jacobian summed over incident live tets
    mult: torch.Tensor
    num_node: int
    dmax: int  # largest vertex offset, 1 + Sy + Sz
    deltas: tuple  # (6, 4) node offsets
    offsets: tuple  # sorted DIA column offsets
    plane_tab: tuple  # (6, 4, 4) -> plane
    # K2's plane pass: the 96 (t, a, b) entries sorted by plane, as
    # (element row t*256 + (a*4+b)*16, shift delta[t][a], plane)
    plane_entries: tuple


def _lattice_tables(nx: int, ny: int, nz: int):
    tets = _KUHN_TETS
    nt = len(tets)
    sy, sz = nx + 1, (nx + 1) * (ny + 1)
    corner = [(o & 1) + sy * ((o >> 1) & 1) + sz * ((o >> 2) & 1) for o in range(8)]
    deltas = tuple(tuple(int(corner[c]) for c in tets[t]) for t in range(nt))
    offs = sorted(
        {deltas[t][b] - deltas[t][a] for t in range(nt) for a in range(4) for b in range(4)}
    )
    plane_of = {o: d for d, o in enumerate(offs)}
    plane_tab = tuple(
        tuple(
            tuple(plane_of[deltas[t][b] - deltas[t][a]] for b in range(4))
            for a in range(4)
        )
        for t in range(nt)
    )
    return sy, sz, deltas, tuple(offs), plane_tab


def build_lattice_context(mesh: Mesh, device, dtype) -> LatticeContext:
    """Build from a box mesh carrying `mesh.lattice = (nx, ny, nz)`."""
    if mesh.lattice is None:
        raise ValueError("mesh has no lattice metadata")
    nx, ny, nz = mesh.lattice
    sy, sz, deltas, offs, plane_tab = _lattice_tables(nx, ny, nz)
    n = mesh.num_node
    if n != (nx + 1) * (ny + 1) * (nz + 1):
        raise ValueError("node count does not match the lattice")
    cells = np.arange(n, dtype=np.int64)
    ix, iy, iz = cells % sy, (cells // sy) % (ny + 1), cells // sz
    live = (ix < nx) & (iy < ny) & (iz < nz)
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    lr, rr = [], []
    for t in range(len(deltas)):
        idx = cells[:, None] + np.asarray(deltas[t], dtype=np.int64)[None, :]
        idx = np.where(live[:, None], idx, 0)  # dead cells: degenerate
        geom = tet_geometry(xg[torch.as_tensor(idx, device=device)])
        lr.append(lhs_geom_rows(geom.shgrad, geom.det_j, geom.metric))
        rr.append(res_geom_rows(geom.shgrad, geom.det_j, geom.metric))
    lc = cells[live]
    vidx = np.concatenate([lc + deltas[t][a] for t in range(len(deltas)) for a in range(4)])
    mult = np.bincount(vidx, minlength=n).astype(np.float64)
    entries = sorted(
        (plane_tab[t][a][b], t, a, b)
        for t in range(len(deltas)) for a in range(4) for b in range(4)
    )
    plane_entries = tuple(
        (t * 256 + (a * 4 + b) * 16, deltas[t][a], p) for p, t, a, b in entries
    )
    return LatticeContext(
        res_geom=torch.stack(rr).contiguous(),
        lhs_geom=torch.stack(lr).contiguous(),
        mult=torch.as_tensor(mult, dtype=dtype, device=device),
        num_node=n,
        dmax=max(max(d) for d in deltas),
        deltas=deltas,
        offsets=offs,
        plane_tab=plane_tab,
        plane_entries=plane_entries,
    )


# ---------------------------------------------------------------------------
# plain versions: shifted-slice input build / output reduction


def _res_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), cp=float(phys.cp),
        kappa=float(phys.kappa), fb=tuple(float(v) for v in phys.body_force),
        dt=float(scheme.dt),
    )


def _lhs_args(phys: Physics, scheme: TimeScheme) -> dict:
    return dict(
        rho=float(phys.rho), mu=float(phys.mu), f1=float(scheme.fact_dw),
        f2=float(scheme.fact_w), dt=float(scheme.dt),
    )


def _residual_inputs(lctx: LatticeContext, wa_t, dwa_t) -> torch.Tensor:
    """(6, 67, N) slab-major rows for element_rows.res_rows: column c reads
    node c + delta[t][a]; nodes past N read zero."""
    n = lctx.num_node
    wpad = F.pad(wa_t, (0, lctx.dmax))
    dwpad = F.pad(dwa_t, (0, lctx.dmax))
    zeros = torch.zeros((4, n), dtype=wa_t.dtype, device=wa_t.device)
    parts = []
    for t, d in enumerate(lctx.deltas):
        sh = lambda row, a, p: p[row : row + 1, d[a] : d[a] + n]
        rows = [lctx.res_geom[t]]
        rows += [sh(i, a, wpad) for i in range(3) for a in range(4)]  # u
        rows += [sh(i, a, dwpad) for i in range(3) for a in range(4)]  # du
        rows += [sh(3, a, dwpad) for a in range(4)]  # p (rate slot)
        rows += [sh(4, a, wpad) for a in range(4)]  # phi
        rows += [sh(5, a, wpad) for a in range(4)]  # T
        rows += [sh(4, a, dwpad) for a in range(4)]  # dphi
        rows += [sh(5, a, dwpad) for a in range(4)]  # dT
        rows.append(zeros)  # heat source (not on this path)
        parts.append(torch.cat(rows, dim=0))
    return torch.stack(parts)


def _lhs_inputs(lctx: LatticeContext, wa_t) -> torch.Tensor:
    """(6, 27, N) slab-major rows for element_rows.lhs_rows."""
    n = lctx.num_node
    upad = F.pad(wa_t[:3], (0, lctx.dmax))
    parts = []
    for t, d in enumerate(lctx.deltas):
        geom = lctx.lhs_geom[t]
        rows = [geom[:12]]
        rows += [upad[i : i + 1, d[a] : d[a] + n] for i in range(3) for a in range(4)]
        rows.append(geom[12:15])
        parts.append(torch.cat(rows, dim=0))
    return torch.stack(parts)


def _reduce_residual(lctx: LatticeContext, out) -> torch.Tensor:
    """(6, 24, N) element residual rows -> (6, N): node n receives slab t,
    vertex a from cell n - delta[t][a] (24 shifted adds, (t, a) order)."""
    n = lctx.num_node
    acc = torch.zeros((6, n), dtype=out.dtype, device=out.device)
    for t, dt_ in enumerate(lctx.deltas):
        for a in range(4):
            d = dt_[a]
            acc[:, d:] += out[t, a * 6 : a * 6 + 6, : n - d]
    return acc


def _reduce_lhs_planes(lctx: LatticeContext, out, ncomp: int) -> list:
    """(6, 16*ncomp, N) element Jacobians -> D x (ncomp, N) DIA planes (96
    shifted adds, (t, a, b) order)."""
    n = lctx.num_node
    planes = [
        torch.zeros((ncomp, n), dtype=out.dtype, device=out.device)
        for _ in lctx.offsets
    ]
    for t, dt_ in enumerate(lctx.deltas):
        for a in range(4):
            d = dt_[a]
            for b in range(4):
                r = (a * 4 + b) * ncomp
                planes[lctx.plane_tab[t][a][b]][:, d:] += out[t, r : r + ncomp, : n - d]
    return planes


def residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme) -> torch.Tensor:
    """K1's plain version: (6, N) volume residual."""
    out = res_rows(_residual_inputs(lctx, wa_t, dwa_t), **_res_args(phys, scheme))
    return _reduce_residual(lctx, out)


def jacobian_volume_plain(
    lctx, wa_t, phys, scheme, keep16, add16, band=None, band_lo=0
) -> torch.Tensor:
    """K2's plain version: finished (D, 16, N) data = raw planes * keep16,
    + add16 on the zero-offset plane, + the pre-masked facet band
    (D, 16, span) over rows [band_lo, band_lo + span)."""
    out = lhs_rows(_lhs_inputs(lctx, wa_t), ncomp=16, **_lhs_args(phys, scheme))
    data = torch.stack(_reduce_lhs_planes(lctx, out, 16)) * keep16[None]
    data[lctx.offsets.index(0)] += add16
    if band is not None:
        data[:, :, band_lo : band_lo + band.shape[2]] += band
    return data


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_f32_cuda(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous float32 CUDA tensor "
                f"(got {t.dtype}, {t.device}, contiguous={t.is_contiguous()})"
            )


def _flat_deltas(lctx):
    return nvcc.int_array(v for d in lctx.deltas for v in d)


def residual_volume(lctx: LatticeContext, wa_t, dwa_t, phys, scheme) -> torch.Tensor:
    """K1: (6, N) volume residual from the alpha states (6, N)."""
    if not wa_t.is_cuda:
        return residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme)
    n = lctx.num_node
    _check_f32_cuda("lattice_residual", wa_t=wa_t, dwa_t=dwa_t, res_geom=lctx.res_geom)
    if wa_t.shape != (6, n) or dwa_t.shape != (6, n):
        raise ValueError("lattice_residual kernel: states must be (6, N)")
    fn = nvcc.function(
        "lattice_residual", "dedflow_lattice_residual",
        [nvcc.P] * 5 + [nvcc.I, nvcc.P] + [nvcc.D] * 8 + [nvcc.P],
    )
    elem = torch.empty((6, 24, n), dtype=torch.float32, device=wa_t.device)
    out = torch.empty((6, n), dtype=torch.float32, device=wa_t.device)
    a = _res_args(phys, scheme)
    nvcc.check(
        fn(lctx.res_geom.data_ptr(), wa_t.data_ptr(), dwa_t.data_ptr(),
           elem.data_ptr(), out.data_ptr(), n, _flat_deltas(lctx),
           a["rho"], a["mu"], a["cp"], a["kappa"], *a["fb"], a["dt"],
           torch.cuda.current_stream(wa_t.device).cuda_stream),
        "lattice_residual",
    )
    residual_volume.launches += 1
    return out


residual_volume.launches = 0


def jacobian_volume(
    lctx: LatticeContext, wa_t, phys, scheme, keep16, add16, band=None, band_lo=0
) -> torch.Tensor:
    """K2: finished (D, 16, N) velocity/pressure DIA data (see
    jacobian_volume_plain for the contract)."""
    if not wa_t.is_cuda:
        return jacobian_volume_plain(
            lctx, wa_t, phys, scheme, keep16, add16, band, band_lo
        )
    n, nd = lctx.num_node, len(lctx.offsets)
    _check_f32_cuda(
        "lattice_jacobian", wa_t=wa_t, keep16=keep16, add16=add16,
        lhs_geom=lctx.lhs_geom, **({} if band is None else {"band": band}),
    )
    if wa_t.shape != (6, n) or keep16.shape != (16, n) or add16.shape != (16, n):
        raise ValueError("lattice_jacobian kernel: shape mismatch")
    if len(lctx.plane_entries) != 96:
        raise ValueError("lattice_jacobian kernel: needs the 6-tet Kuhn lattice")
    span = 0
    if band is not None:
        span = band.shape[2]
        if band.shape[:2] != (nd, 16) or band_lo < 0 or band_lo + span > n:
            raise ValueError("lattice_jacobian kernel: band outside the matrix")
    fn = nvcc.function(
        "lattice_jacobian", "dedflow_lattice_jacobian",
        [nvcc.P] * 6 + [nvcc.I, nvcc.I, nvcc.P, nvcc.I, nvcc.P, nvcc.P, nvcc.I]
        + [nvcc.D] * 5 + [nvcc.P],
    )
    elem = torch.empty((6, 256, n), dtype=torch.float32, device=wa_t.device)
    out = torch.empty((nd, 16, n), dtype=torch.float32, device=wa_t.device)
    a = _lhs_args(phys, scheme)
    nvcc.check(
        fn(lctx.lhs_geom.data_ptr(), wa_t.data_ptr(), elem.data_ptr(),
           keep16.data_ptr(), add16.data_ptr(),
           None if band is None else band.data_ptr(), int(band_lo), span,
           out.data_ptr(), n, _flat_deltas(lctx),
           nvcc.int_array(v for e in lctx.plane_entries for v in e),
           lctx.offsets.index(0), a["rho"], a["mu"], a["f1"], a["f2"], a["dt"],
           torch.cuda.current_stream(wa_t.device).cuda_stream),
        "lattice_jacobian",
    )
    jacobian_volume.launches += 1
    return out


jacobian_volume.launches = 0


# ---------------------------------------------------------------------------
# assembly entry points


def assemble_residual_t(
    lctx: LatticeContext,
    face_ctxs: tuple,
    mask_t: torch.Tensor,  # (6, N) boolean
    w_alpha: torch.Tensor,  # (N, 6)
    dw_alpha: torch.Tensor,  # (N, 6)
    phys: Physics,
    scheme: TimeScheme,
    freeze_phi_temperature: bool = True,
) -> torch.Tensor:
    """Global residual F as (6, N) (AssembleSystem, main.c:31-75)."""
    f = residual_volume(
        lctx, w_alpha.T.contiguous(), dw_alpha.T.contiguous(), phys, scheme
    ).to(w_alpha.dtype)
    for fctx in face_ctxs:
        face_residual_scatter(fctx, f, face_residual_elements(fctx, w_alpha, dw_alpha, phys))
    if freeze_phi_temperature:
        f[4:] = 0.0  # main.c:64
    return f.masked_fill(mask_t, 0.0)


def _masked_face_band(
    face_ctxs: tuple, w_alpha, dw_alpha, phys, scheme, num_planes, keep_pc
):
    """The facet Jacobian of every weak boundary, pre-masked by the keep
    factors of its rows and merged into one (D, 16, span) band over
    [lo, lo + span); (None, 0) without weak boundaries. The phi/T rows
    (components 16/17) are identically zero there."""
    if not face_ctxs:
        return None, 0
    lo = min(f.dia_row_lo for f in face_ctxs)
    hi = max(f.dia_row_lo + f.dia_row_span for f in face_ctxs)
    band = torch.zeros(
        (num_planes, 16, hi - lo), dtype=w_alpha.dtype, device=w_alpha.device
    )
    for fctx in face_ctxs:
        blk = face_dia_band(
            fctx, face_lhs_packed(fctx, w_alpha, dw_alpha, phys, scheme), num_planes
        )
        r0, span = fctx.dia_row_lo, fctx.dia_row_span
        blk = blk[:, :16] * keep_pc[None, :16, r0 : r0 + span]
        band[:, :, r0 - lo : r0 - lo + span] += blk
    return band, lo


def assemble_jacobian_t(
    lctx: LatticeContext,
    face_ctxs: tuple,
    mask_t: torch.Tensor,  # (6, N) boolean
    w_alpha: torch.Tensor,  # (N, 6)
    dw_alpha: torch.Tensor,  # (N, 6)
    phys: Physics,
    scheme: TimeScheme,
) -> FSDIAMatrixT:
    """Global field-split Jacobian in component-major DIA storage
    (frozen-scalar mode), Dirichlet rows zeroed with a unit diagonal."""
    dtype = w_alpha.dtype
    nd = len(lctx.offsets)
    d0 = lctx.offsets.index(0)
    keep_pc = keep_pc_rows(mask_t, dtype)
    add18 = diag_add_rows(mask_t, dtype)
    band, lo = _masked_face_band(
        face_ctxs, w_alpha, dw_alpha, phys, scheme, nd, keep_pc
    )
    data = jacobian_volume(
        lctx, w_alpha.T.contiguous(), phys, scheme,
        keep_pc[:16].contiguous(), add18[:16].contiguous(), band, lo,
    )
    # phi-phi / T-T identity components: state-independent nodal
    # multiplicity on the zero-offset plane
    scal = torch.zeros((2 * nd, lctx.num_node), dtype=dtype, device=w_alpha.device)
    scal[2 * d0 : 2 * d0 + 2] = lctx.mult.to(dtype) * keep_pc[16:18] + add18[16:18]
    return FSDIAMatrixT(data=data.to(dtype), scal=scal, offsets=lctx.offsets)
