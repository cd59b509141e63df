"""Weak (Nitsche-type) boundary terms with backflow stabilization (subset
of dedflow_tpu/fem/face.py the lattice step runs).

Facet quadrature-point fields use the parent element's nodal values with
the facet shape table SHLB[forn]; the velocity comes from w_alpha and the
pressure from dw_alpha slot 3. The Nanson normal nv is not unit length:
its magnitude carries the facet area Jacobian.

Facet terms land on the boundary's contiguous row range [lo, lo + span).
Each (facet, a) has one target row of the residual band and, on the
lattice tier, each (facet, a, b) one target row of the (D, span) DIA band.
On the WinELL tier (fem.win_assembly.attach_face_win_plans) each
(facet, a, b) targets one of the boundary's unique matrix entries instead.
Every scatter is a gather through a host-built slot plan (per target, its
sources in ascending order, padded with an index to a zero row) followed
by a sum: unlike `index_add_`, which sums with atomics on CUDA, it gives
the same float32 result on every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem import quadrature as quad
from dedflow_tpu_torch.fem.element import face_normals, tet_geometry
from dedflow_tpu_torch.mesh.mesh import Mesh


@dataclass
class FaceContext:
    """Per-boundary facet tables, parent geometry and scatter indices."""

    ien: torch.Tensor  # (nf, 4) parent element connectivity
    f2e: np.ndarray  # (nf,) parent element ids
    inv_j: torch.Tensor  # (nf, 3, 3)
    shgrad: torch.Tensor  # (nf, 4, 3)
    nv: torch.Tensor  # (nf, 3) Nanson normals
    shlb: torch.Tensor  # (nf, NQRB, 4) facet shape values SHLB[forn]
    # slot plans: row r of the band sums sources slots[r, :] (pad = a zero row)
    node_slots: torch.Tensor  # (span, Kn) into the nf*4 (f, a) residual rows
    band_slots: torch.Tensor | None  # (D*span, Km) into the nf*16 (f, a, b) updates
    num_facet: int
    dia_row_lo: int  # the boundary's contiguous row range [lo, lo + span)
    dia_row_span: int
    # WinELL tier: per unique matrix entry of the boundary (win_uniq), its
    # (f, a, b) sources (fem.win_assembly.attach_face_win_plans)
    win_slots: torch.Tensor | None = None  # (nu, Kw)
    win_uniq: torch.Tensor | None = None  # (nu,) entry ids, ascending


def slot_plan(targets: np.ndarray, num_slots: int) -> np.ndarray:
    """(num_slots, K) source indices per target, ascending; pad entries
    point at len(targets), the zero row the caller appends. Sources with a
    negative target (another rank's rows) are left out."""
    m = targets.size
    live = np.flatnonzero(targets >= 0)
    t = targets[live]
    counts = np.bincount(t, minlength=num_slots)
    k = max(int(counts.max()) if t.size else 0, 1)
    order = np.argsort(t, kind="stable")
    start = np.zeros(num_slots, dtype=np.int64)
    start[1:] = np.cumsum(counts)[:-1]
    slot = np.full((num_slots, k), m, dtype=np.int64)
    slot[t[order], np.arange(t.size) - start[t[order]]] = live[order]
    return slot


def build_face_context(
    mesh: Mesh, boundary: int, offsets: tuple | None, device, dtype, own: int | None = None
) -> FaceContext:
    """Facet context of one boundary (face.py::build_face_context); the
    parent geometry is computed for the facets' elements only. With
    `offsets` None (no DIA stencil: the WinELL tier) no band plan is
    built. With `own` (a rank's local submesh, parallel.sharded) the
    residual plan keeps only the contributions to rows below `own`."""
    b = mesh.boundaries[boundary]
    f2e = np.asarray(b.f2e, dtype=np.int64)
    ien_np = np.asarray(mesh.ien, dtype=np.int64)[f2e]  # (nf, 4)
    xe = torch.as_tensor(mesh.xg[ien_np], dtype=dtype, device=device)
    geom = tet_geometry(xe)
    forn = torch.as_tensor(np.asarray(b.forn, dtype=np.int64), device=device)
    nv = face_normals(geom.inv_j, geom.det_j, forn)
    shlb = torch.as_tensor(quad.SHLB, dtype=dtype, device=device)[forn]
    nf = ien_np.shape[0]
    vert = ien_np.reshape(-1)  # the (f, a) residual contributions' rows
    kept = vert if own is None else vert[vert < own]
    if kept.size:
        lo = int(kept.min())
        span = int(kept.max()) - lo + 1
    else:
        lo, span = 0, 1
    node_tgt = vert - lo if own is None else np.where(vert < own, vert - lo, -1)
    as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
    band_slots = None
    if offsets is not None:
        uniq = np.asarray(offsets, dtype=np.int64)
        diff = ien_np[:, None, :] - ien_np[:, :, None]  # [f, a, b] = col - row
        plane = np.searchsorted(uniq, diff)
        if nf and not np.array_equal(uniq[np.minimum(plane, len(uniq) - 1)], diff):
            raise ValueError("facet couplings outside the DIA offsets")
        rows = np.broadcast_to(ien_np[:, :, None], diff.shape) - lo
        band_target = (plane * span + rows).reshape(-1)
        band_slots = as_long(slot_plan(band_target, len(uniq) * span))
    return FaceContext(
        ien=as_long(ien_np),
        f2e=f2e,
        inv_j=geom.inv_j,
        shgrad=geom.shgrad,
        nv=nv,
        shlb=shlb,
        node_slots=as_long(slot_plan(node_tgt, span)),
        band_slots=band_slots,
        num_facet=nf,
        dia_row_lo=lo,
        dia_row_span=span,
    )


def _facet_fields(fctx: FaceContext, w_alpha, dw_alpha):
    """(nf,4,3) parent u gather, (nf,4) parent p gather, qp values."""
    u_e = w_alpha[fctx.ien, :3]  # (nf, 4, 3)
    p_e = dw_alpha[fctx.ien, 3]  # (nf, 4)
    u_qb = torch.einsum("fqa,fai->fqi", fctx.shlb, u_e)
    p_qb = torch.einsum("fqa,fa->fq", fctx.shlb, p_e)
    grad_u = torch.einsum("fai,faj->fij", u_e, fctx.shgrad)
    return u_qb, p_qb, grad_u


def _tau_b(fctx: FaceContext, mu: float) -> torch.Tensor:
    """Penalty tau_B = 4*mu*|J^-1 nv| (assemble.cu:1054-1064)."""
    a = torch.einsum("fin,fn->fi", fctx.inv_j, fctx.nv)
    return 4.0 * mu * torch.linalg.vector_norm(a, dim=-1)


def face_residual_elements(
    fctx: FaceContext, w_alpha, dw_alpha, phys: Physics
) -> torch.Tensor:
    """(nf, 4, 6) facet residual contributions (assemble.cu:1068-1126)."""
    gwb = torch.as_tensor(quad.GWB, dtype=w_alpha.dtype, device=w_alpha.device)
    rho, mu = phys.rho, phys.mu
    nv = fctx.nv
    u_qb, p_qb, grad_u = _facet_fields(fctx, w_alpha, dw_alpha)
    tau_b = _tau_b(fctx, mu)
    unor = torch.einsum("fqi,fi->fq", u_qb, nv)
    uneg = 0.5 * (unor - unor.abs())
    ngrad = torch.einsum("fj,fij->fi", nv, grad_u)  # n_j du_i/dx_j
    ngrad_t = torch.einsum("fj,fji->fi", nv, grad_u)  # n_j du_j/dx_i
    tmp0 = (
        nv[:, None, :] * p_qb[..., None]
        - mu * (ngrad + ngrad_t)[:, None, :]
        - rho * uneg[..., None] * u_qb
        + tau_b[:, None, None] * u_qb
    )
    tmp1 = -mu * (
        torch.einsum("fi,fqj->fqij", nv, u_qb)
        + torch.einsum("fj,fqi->fqij", nv, u_qb)
    )
    f_m = torch.einsum("q,fqa,fqi->fai", gwb, fctx.shlb, tmp0) + torch.einsum(
        "q,faj,fqij->fai", gwb, fctx.shgrad, tmp1
    )
    f_c = -torch.einsum("q,fqa,fq->fa", gwb, fctx.shlb, unor)
    zeros = torch.zeros(f_c.shape + (2,), dtype=f_c.dtype, device=f_c.device)
    return torch.cat([f_m, f_c[..., None], zeros], dim=-1)


def face_lhs_packed(
    fctx: FaceContext, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme
) -> torch.Tensor:
    """(nf*16, 18) packed facet Jacobian contributions (face_lhs_packed /
    _face_lhs_packed_from; assemble.cu:1127-1193). Only the uu/up/pu
    components are touched."""
    gwb = torch.as_tensor(quad.GWB, dtype=w_alpha.dtype, device=w_alpha.device)
    rho, mu, f2 = phys.rho, phys.mu, scheme.fact_w
    nv, shlb = fctx.nv, fctx.shlb
    u_qb, _, _ = _facet_fields(fctx, w_alpha, dw_alpha)
    unor = torch.einsum("fqi,fi->fq", u_qb, nv)
    uneg = 0.5 * (unor - unor.abs())
    # backflow stabilization: the only state-dependent facet LHS term
    t_uneg = -rho * torch.einsum("q,fqa,fqb,fq->fab", gwb, shlb, shlb, uneg)
    tau_b = _tau_b(fctx, mu)
    shnorm = torch.einsum("fai,fi->fa", fctx.shgrad, nv)
    t_diag = (
        -mu
        * (
            torch.einsum("q,fb,fqa->fab", gwb, shnorm, shlb)
            + torch.einsum("q,fa,fqb->fab", gwb, shnorm, shlb)
        )
        + tau_b[:, None, None] * torch.einsum("q,fqa,fqb->fab", gwb, shlb, shlb)
    ) + t_uneg
    g = [
        torch.einsum("q,fqa,fb->fab", gwb, shlb, fctx.shgrad[:, :, i])
        for i in range(3)
    ]
    t_ab = torch.einsum("q,fqa,fqb->fab", gwb, shlb, shlb)
    comps = []
    for i in range(3):
        for j in range(3):
            c = -mu * (
                g[i] * nv[:, j][:, None, None]
                + g[j].transpose(1, 2) * nv[:, i][:, None, None]
            )
            if i == j:
                c = c + t_diag
            comps.append(f2 * c)
    for i in range(3):  # up: dRM/dP (no fact2)
        comps.append(t_ab * nv[:, i][:, None, None])
    for j in range(3):  # pu: dRC/dU
        comps.append(-f2 * t_ab * nv[:, j][:, None, None])
    zero = torch.zeros_like(t_ab)
    comps += [zero, zero, zero]  # pp, phiphi, TT untouched by facet terms
    return torch.stack(comps, dim=-1).reshape(fctx.num_facet * 16, 18)


def gather_sum(slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Per target row, the sum of its slot-plan sources (fixed order)."""
    zero = torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, zero])[slots].sum(dim=1)


def face_residual_scatter(fctx: FaceContext, f_t: torch.Tensor, fe: torch.Tensor) -> None:
    """f_t (6, N) += the (nf, 4, 6) facet residuals, in place."""
    band = gather_sum(fctx.node_slots, fe.reshape(-1, fe.shape[-1]))  # (span, 6)
    lo = fctx.dia_row_lo
    f_t[:, lo : lo + fctx.dia_row_span] += band.T


def face_dia_band(fctx: FaceContext, upd: torch.Tensor, num_planes: int) -> torch.Tensor:
    """(nf*16, 18) packed facet updates -> dense (D, 18, span) band over
    the boundary's rows [dia_row_lo, dia_row_lo + span)."""
    rows = gather_sum(fctx.band_slots, upd)  # (D*span, 18)
    return rows.reshape(num_planes, fctx.dia_row_span, upd.shape[1]).permute(0, 2, 1)
