"""VMS/SUPG-stabilized Navier-Stokes weak form on whole-mesh element
batches (the NS parts of dedflow_tpu/fem/weakform.py, in plain torch).

This is the element-major form of the element bodies: states (N, 6) with
columns [u0, u1, u2, p, phi, T], element residuals (ne, 4, 6), packed
element Jacobians (ne*16, 18) in the fsbsr component order. On the CPU it
is the body of the general gather tier under elements_kernel="xla" and,
in float64, the oracle the row bodies (fem.element_rows) and the kernels
K4/K5 are held to.

The reference's quirks are kept exactly as the JAX module keeps them
(weakform.py:12-23):
- the element kernels read the pressure from the rate vector dw_alpha,
  not from w_alpha (main.c:111-118, assemble.cu:1606-1609);
- the residual's tau uses u.G.u with G = inv(J) inv(J)^T, the Jacobian's
  tau |J^-1 u|^2 through the shape convection of vertices 1..3
  (assemble.cu:592-601);
- the Jacobian is the reference's inexact Picard tangent (no dtau/du, no
  derivative of the advection velocity), and dRM/dP takes the sign of
  the shared-memory kernel the reference runs (assemble.cu:647-648);
- the phi/phi and T/T blocks are the frozen identities (assemble.cu:757-758),
  gated off on degenerate (det_j == 0) padding elements, unless the
  implicit phi/T tangents (`scalar_lhs_blocks`, melt-pool runs) replace
  them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem import quadrature as quad


class ElemGeom(NamedTuple):
    """Per-element geometry the weak form reads (fem.assembly.elem_geom)."""

    shgrad: torch.Tensor  # (ne, 4, 3)
    det_j: torch.Tensor  # (ne,)
    metric: torch.Tensor  # (ne, 3, 3)


class ElementFields(NamedTuple):
    """Per-element nodal field gathers (assemble.cu:1599-1678)."""

    u: torch.Tensor  # (ne, 4, 3) velocity from w_alpha
    p: torch.Tensor  # (ne, 4) pressure from dw_alpha (see module docstring)
    phi: torch.Tensor  # (ne, 4) from w_alpha
    temp: torch.Tensor  # (ne, 4) from w_alpha
    du: torch.Tensor  # (ne, 4, 3) from dw_alpha
    dphi: torch.Tensor  # (ne, 4)
    dtemp: torch.Tensor  # (ne, 4)


def gather_fields(ien: torch.Tensor, w_alpha: torch.Tensor, dw_alpha: torch.Tensor) -> ElementFields:
    """ien (ne, 4) integer, states (N, 6)."""
    idx = ien.long()
    we, dwe = w_alpha[idx], dw_alpha[idx]  # (ne, 4, 6)
    return ElementFields(
        u=we[..., :3], p=dwe[..., 3], phi=we[..., 4], temp=we[..., 5],
        du=dwe[..., :3], dphi=dwe[..., 4], dtemp=dwe[..., 5],
    )


def _tables(like: torch.Tensor):
    shl = torch.as_tensor(quad.SHL, dtype=like.dtype, device=like.device)  # (q, a)
    gw = torch.as_tensor(quad.GW, dtype=like.dtype, device=like.device)  # (q,)
    return shl, gw


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(x)


def stab_tau(metric: torch.Tensor, u_q: torch.Tensor, phys: Physics, dt: float):
    """GetStabTau (assemble.cu:444-484): (tauM, tauC, tauPhi, tauT), each
    (ne, q)."""
    rho, mu, cp, kappa = phys.rho, phys.mu, phys.cp, phys.kappa
    t0 = 4.0 / (dt * dt)
    t1 = torch.einsum("eij,eqi,eqj->eq", metric, u_q, u_q)
    t2 = torch.einsum("eij,eij->e", metric, metric)[:, None]
    tr = torch.einsum("eii->e", metric)[:, None]
    nu = mu / rho
    alpha_th = kappa / (rho * cp)
    tau_m = _rsqrt(t0 + t1 + 3.0 * nu * nu * t2) / rho
    # tr == 0 only on degenerate padding elements, annihilated by det_j = 0
    tr = torch.where(tr > 0.0, tr, torch.ones_like(tr))
    tau_c = torch.sqrt(t1 + 3.0 * nu * nu * t2) / tr
    tau_phi = _rsqrt(t0 + t1)
    tau_t = _rsqrt(t0 + t1 + 3.0 * alpha_th * alpha_th * t2) / (rho * cp)
    return tau_m, tau_c, tau_phi, tau_t


def ns_residual_elements(
    geom: ElemGeom, ef: ElementFields, phys: Physics, scheme: TimeScheme, src_e=None,
) -> torch.Tensor:
    """(ne, 4, 6) element residuals (AssembleWeakFormKernel<TENSOR=1>,
    assemble.cu:761-924). `src_e` (ne, 4): the nodal heat source gather,
    entering the T row as -int(N_a q)."""
    shl, gw = _tables(ef.u)
    rho, mu, cp, kappa = phys.rho, phys.mu, phys.cp, phys.kappa
    fb = torch.as_tensor(phys.body_force, dtype=ef.u.dtype, device=ef.u.device)
    shgrad, det_j, metric = geom.shgrad, geom.det_j, geom.metric
    ein = torch.einsum

    u_q = ein("qa,eai->eqi", shl, ef.u)
    du_q = ein("qa,eai->eqi", shl, ef.du)
    p_q = ein("qa,ea->eq", shl, ef.p)
    dphi_q = ein("qa,ea->eq", shl, ef.dphi)
    dtemp_q = ein("qa,ea->eq", shl, ef.dtemp)
    grad_u = ein("eai,eaj->eij", ef.u, shgrad)  # du_i/dx_j
    grad_p = ein("ea,eai->ei", ef.p, shgrad)
    grad_phi = ein("ea,eai->ei", ef.phi, shgrad)
    grad_t = ein("ea,eai->ei", ef.temp, shgrad)
    divu = ein("eii->e", grad_u)

    conv = ein("eqj,eij->eqi", u_q, grad_u)
    r_l = rho * (du_q - fb[None, None, :] + conv) + grad_p[:, None, :]
    tau_m, tau_c, tau_phi, tau_t = stab_tau(metric, u_q, phys, scheme.dt)

    u_corr = u_q - tau_m[..., None] * r_l
    tmp0 = rho * (du_q - fb[None, None, :] + ein("eqj,eij->eqi", u_corr, grad_u))
    sym_grad = mu * (grad_u + grad_u.transpose(-1, -2))
    tmp1 = (
        sym_grad[:, None]
        + rho * tau_m[..., None, None] * ein("eqi,eqj->eqij", r_l, u_q)
        - rho * (tau_m**2)[..., None, None] * ein("eqi,eqj->eqij", r_l, r_l)
    )
    diag = -p_q + rho * tau_c * divu[:, None]
    eye3 = torch.eye(3, dtype=ef.u.dtype, device=ef.u.device)
    tmp1 = tmp1 + diag[..., None, None] * eye3[None, None]

    f_m = ein("q,qa,eqi->eai", gw, shl, tmp0) + ein("q,eaj,eqij->eai", gw, shgrad, tmp1)
    f_c = ein("q,qa,e->ea", gw, shl, divu) + ein("q,eq,eqi,eai->ea", gw, tau_m, r_l, shgrad)
    shconv = ein("eqi,eai->eqa", u_q, shgrad)
    adv_phi = dphi_q + ein("eqi,ei->eq", u_q, grad_phi)
    f_phi = ein("q,eq,eqa->ea", gw, adv_phi, shl[None] + tau_phi[..., None] * shconv)
    adv_t = rho * cp * (dtemp_q + ein("eqi,ei->eq", u_q, grad_t))
    test_t = shl[None] + rho * cp * tau_t[..., None] * shconv
    f_t = ein("q,eq,eqa->ea", gw, adv_t, test_t) + gw.sum() * ein(
        "ei,eai->ea", kappa * grad_t, shgrad
    )
    if src_e is not None:
        src_q = ein("qa,ea->eq", shl, src_e)
        f_t = f_t - ein("q,eq,eqa->ea", gw, src_q, test_t)
    f = torch.cat([f_m, f_c[..., None], f_phi[..., None], f_t[..., None]], dim=-1)
    return f * det_j[:, None, None]


def scalar_lhs_blocks(geom: ElemGeom, ef: ElementFields, phys: Physics, scheme: TimeScheme):
    """Consistent (Picard) phi/T Jacobian blocks, each (ne, 4, 4)
    (weakform.py:205-244): d(adv)/d(dwg_b) = f1 N_b + f2 u.grad(N_b),
    SUPG-tested with the residual's own taus (stab_tau: tau depends only on
    u, which these columns hold fixed), plus f2 times the T diffusion."""
    shl, gw = _tables(ef.u)
    rho, cp, kappa = phys.rho, phys.cp, phys.kappa
    f1, f2 = scheme.fact_dw, scheme.fact_w
    ein = torch.einsum
    u_q = ein("qa,eai->eqi", shl, ef.u)
    shconv = ein("eqi,eai->eqa", u_q, geom.shgrad)
    _, _, tau_phi, tau_t = stab_tau(geom.metric, u_q, phys, scheme.dt)
    e_k = ein("eai,ebi->eab", geom.shgrad, geom.shgrad)
    dj = geom.det_j[:, None, None]
    trial = f1 * shl[None] + f2 * shconv  # (ne, q, b)
    test_phi = shl[None] + tau_phi[..., None] * shconv
    j_phi = ein("q,eqa,eqb->eab", gw, test_phi, trial) * dj
    test_t = shl[None] + rho * cp * tau_t[..., None] * shconv
    j_t = (rho * cp * ein("q,eqa,eqb->eab", gw, test_t, trial)
           + f2 * kappa * gw.sum() * e_k) * dj
    return j_phi, j_t


def _lhs_taus(geom: ElemGeom, shconv, phys: Physics, dt: float):
    """The Jacobian's (tau0, tau1), each (ne, q): |J^-1 u|^2 from the
    shape convection of vertices 1..3 (assemble.cu:592-602)."""
    rho, mu = phys.rho, phys.mu
    adv2 = (shconv[..., 1:] ** 2).sum(dim=-1)
    gg = torch.einsum("eij,eij->e", geom.metric, geom.metric)[:, None]
    tr = torch.einsum("eii->e", geom.metric)[:, None]
    knu = mu / rho
    tau0 = _rsqrt(4.0 / (dt * dt) + adv2 + 3.0 * knu * knu * gg) / rho
    tr = torch.where(tr > 0.0, tr, torch.ones_like(tr))  # degenerate padding
    tau1 = torch.sqrt(adv2 + 3.0 * knu * knu * gg) / tr
    return tau0, tau1


def _vel_diag_block(geom, shl, gw, shconv, tau0, phys, f1, f2):
    """(ne, 4, 4) velocity diagonal scalar block (assemble.cu:618-624)."""
    rho, mu = phys.rho, phys.mu
    ein = torch.einsum
    e_k = ein("eai,ebi->eab", geom.shgrad, geom.shgrad)
    return (
        f1 * rho * ein("q,qa,qb->ab", gw, shl, shl)[None]
        + f1 * rho * rho * ein("q,eq,eqa,qb->eab", gw, tau0, shconv, shl)
        + f2 * rho * ein("q,qa,eqb->eab", gw, shl, shconv)
        + f2 * rho * rho * ein("q,eq,eqa,eqb->eab", gw, tau0, shconv, shconv)
        + f2 * mu * gw.sum() * e_k
    ), e_k


def ns_lhs_packed(
    geom: ElemGeom, ef: ElementFields, phys: Physics, scheme: TimeScheme,
    scalar_implicit: bool = False,
) -> torch.Tensor:
    """(ne*16, 18) packed element Jacobians, rows e*16 + a*4 + b, the 18
    structurally nonzero components of each 6x6 block (fsbsr order);
    `scalar_implicit` puts the consistent transport tangents
    (scalar_lhs_blocks) in place of the frozen phi/T identities."""
    shl, gw = _tables(ef.u)
    rho, mu = phys.rho, phys.mu
    f1, f2 = scheme.fact_dw, scheme.fact_w
    shgrad, det_j = geom.shgrad, geom.det_j
    ne = shgrad.shape[0]
    ein = torch.einsum

    u_q = ein("qa,eai->eqi", shl, ef.u)
    shconv = ein("eqi,eai->eqa", u_q, shgrad)
    tau0, tau1 = _lhs_taus(geom, shconv, phys, scheme.dt)
    tmp, e_k = _vel_diag_block(geom, shl, gw, shconv, tau0, phys, f1, f2)
    gw_sum = gw.sum()
    c_grad2 = f2 * rho * ein("q,eq->e", gw, tau1)
    tau0_sum = ein("q,eq->e", gw, tau0)
    gs_conv = ein("q,eq,eqa->ea", gw, tau0, shconv)
    gs_shl = ein("q,eq,qa->ea", gw, tau0, shl)

    dj = det_j[:, None, None]
    valid = (det_j > 0.0).to(ef.u.dtype)
    eye_ab = torch.eye(4, dtype=ef.u.dtype, device=ef.u.device)[None] * valid[:, None, None]
    g = lambda i: shgrad[..., i]  # (ne, 4)
    comps = [None] * 18
    for i in range(3):
        for j in range(3):
            c = (f2 * mu * gw_sum * ein("ea,eb->eab", g(j), g(i))
                 + c_grad2[:, None, None] * ein("ea,eb->eab", g(i), g(j)))
            if i == j:
                c = c + tmp
            comps[i * 3 + j] = c * dj
    for i in range(3):
        up = -ein("q,ea,qb->eab", gw, g(i), shl) + rho * ein("ea,eb->eab", gs_conv, g(i))
        comps[9 + i] = up * dj  # dRM/dP (assemble.cu:646-649)
        pu = (f1 * rho * ein("ea,eb->eab", g(i), gs_shl)
              + f2 * ein("q,qa,eb->eab", gw, shl, g(i))
              + f2 * rho * ein("ea,eb->eab", g(i), gs_conv))
        comps[12 + i] = pu * dj  # dRC/dU (assemble.cu:653-657)
    comps[15] = tau0_sum[:, None, None] * e_k * dj
    if scalar_implicit:
        comps[16], comps[17] = scalar_lhs_blocks(geom, ef, phys, scheme)
    else:
        comps[16] = comps[17] = eye_ab
    return torch.stack([c.reshape(ne * 16) for c in comps], dim=-1)


def ns_lhs_elements(
    geom: ElemGeom, ef: ElementFields, phys: Physics, scheme: TimeScheme,
    scalar_implicit: bool = False,
) -> torch.Tensor:
    """(ne, 4, 4, 6, 6) approximate element Jacobians
    (AssembleWeakFormLHSKernel, assemble.cu:495-759)."""
    shl, gw = _tables(ef.u)
    rho, mu = phys.rho, phys.mu
    f1, f2 = scheme.fact_dw, scheme.fact_w
    shgrad, det_j = geom.shgrad, geom.det_j
    ne = shgrad.shape[0]
    dtype, dev = ef.u.dtype, ef.u.device
    ein = torch.einsum

    u_q = ein("qa,eai->eqi", shl, ef.u)
    shconv = ein("eqi,eai->eqa", u_q, shgrad)
    tau0, tau1 = _lhs_taus(geom, shconv, phys, scheme.dt)
    tmp, e_k = _vel_diag_block(geom, shl, gw, shconv, tau0, phys, f1, f2)
    visc = f2 * mu * gw.sum() * ein("eaj,ebi->eabij", shgrad, shgrad)
    grad2 = (f2 * rho * ein("q,eq->e", gw, tau1)[:, None, None, None, None]
             * ein("eai,ebj->eabij", shgrad, shgrad))
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    j_uu = tmp[..., None, None] * eye3[None, None, None] + visc + grad2
    j_up = (-ein("q,eai,qb->eabi", gw, shgrad, shl)
            + rho * ein("q,eq,eqa,ebi->eabi", gw, tau0, shconv, shgrad))
    j_pu = (f1 * rho * ein("q,eq,eai,qb->eabi", gw, tau0, shgrad, shl)
            + f2 * ein("q,qa,ebi->eabi", gw, shl, shgrad)
            + f2 * rho * ein("q,eq,eai,eqb->eabi", gw, tau0, shgrad, shconv))
    j_pp = ein("q,eq->e", gw, tau0)[:, None, None] * e_k

    j = torch.zeros((ne, 4, 4, 6, 6), dtype=dtype, device=dev)
    j[..., :3, :3] = j_uu
    j[..., :3, 3] = j_up
    j[..., 3, :3] = j_pu
    j[..., 3, 3] = j_pp
    j = j * det_j[:, None, None, None, None]
    if scalar_implicit:
        j[..., 4, 4], j[..., 5, 5] = scalar_lhs_blocks(geom, ef, phys, scheme)
        return j
    eye_ab = torch.eye(4, dtype=dtype, device=dev)[None] * (det_j > 0.0).to(dtype)[:, None, None]
    j[..., 4, 4] += eye_ab
    j[..., 5, 5] += eye_ab
    return j
