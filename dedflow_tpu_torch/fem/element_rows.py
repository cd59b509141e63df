"""Element bodies on row layouts (counterpart of dedflow_tpu/fem/pallas_kernels.py).

The JAX package writes its element residual and element Jacobian as pure
row functions (`_res_rows`, `_lhs_rows`) shared by its Pallas kernels and
its plain-XLA path. These are the same functions on torch tensors, in any
dtype: the element axis is the LAST axis, quantities are rows, and any
leading axes (the six Kuhn slabs of the lattice) are batch axes. They are
the plain versions that the lattice kernels (fem.lattice, csrc/) are held
against.

Also here: the geometry-row builders (`res_geom_rows`, `lhs_geom_rows`)
and the generalized-alpha states and field norms of dedflow_tpu/fem/ns.py.
"""

from __future__ import annotations

import numpy as np
import torch

from dedflow_tpu_torch.config import TimeScheme
from dedflow_tpu_torch.fem import quadrature as quad

_SHL = np.asarray(quad.SHL, dtype=np.float64)  # (q, a)
_GW = np.asarray(quad.GW, dtype=np.float64)  # (q,)
_GWSUM = float(_GW.sum())
_MASS = np.einsum("q,qa,qb->ab", _GW, _SHL, _SHL)  # (4, 4)
_GWSHL = np.einsum("q,qa->a", _GW, _SHL)  # (4,)


def _pair_const(fn, like: torch.Tensor) -> torch.Tensor:
    """(16, 1) with value fn(a, b) at row a*4+b."""
    vals = [[float(fn(a, b))] for a in range(4) for b in range(4)]
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def _node_const(vals, like: torch.Tensor) -> torch.Tensor:
    """(4, 1) with vals[a] at row a."""
    return torch.tensor(
        [[float(v)] for v in vals], dtype=like.dtype, device=like.device
    )


def _rep_a(x: torch.Tensor) -> torch.Tensor:
    """(..., 4, E) a-indexed -> (..., 16, E) at row a*4+b."""
    e = x.shape[-1]
    return x.unsqueeze(-2).expand(*x.shape[:-2], 4, 4, e).reshape(
        *x.shape[:-2], 16, e
    )


def _rep_b(x: torch.Tensor) -> torch.Tensor:
    """(..., 4, E) b-indexed -> (..., 16, E) at row a*4+b."""
    e = x.shape[-1]
    return x.unsqueeze(-3).expand(*x.shape[:-2], 4, 4, e).reshape(
        *x.shape[:-2], 16, e
    )


def res_rows(inp: torch.Tensor, *, rho, mu, cp, kappa, fb, dt) -> torch.Tensor:
    """(..., 67, E) -> (..., 24, E) element residual rows a*6+c
    (pallas_kernels._res_rows). Input rows: [0:12) sh (i*4+a), 12 det,
    [13:19) metric6, [19:31) u, [31:43) du, [43:47) p, [47:51) phi,
    [51:55) T, [55:59) dphi, [59:63) dT, [63:67) src."""
    r = lambda lo, hi: inp[..., lo:hi, :]
    sh = [r(4 * i, 4 * i + 4) for i in range(3)]
    det = r(12, 13)
    m00, m01, m02, m11, m12, m22 = (r(13 + k, 14 + k) for k in range(6))
    u = [r(19 + 4 * i, 23 + 4 * i) for i in range(3)]
    du = [r(31 + 4 * i, 35 + 4 * i) for i in range(3)]
    p, phi, temp = r(43, 47), r(47, 51), r(51, 55)
    dphi, dtemp, src = r(55, 59), r(59, 63), r(63, 67)

    gg = (
        m00 * m00 + m11 * m11 + m22 * m22
        + 2.0 * (m01 * m01 + m02 * m02 + m12 * m12)
    )
    tr = m00 + m11 + m22
    tr = torch.where(tr > 0.0, tr, torch.ones_like(tr))
    nu = mu / rho
    alpha_th = kappa / (rho * cp)
    t0 = 4.0 / (dt * dt)

    def rows_dot(nodal, grad_i):  # sum_a nodal[a] * grad_i[a] -> (..., 1, E)
        return (nodal * grad_i).sum(dim=-2, keepdim=True)

    grad_u = [[rows_dot(u[i], sh[j]) for j in range(3)] for i in range(3)]
    grad_p = [rows_dot(p, sh[i]) for i in range(3)]
    grad_phi = [rows_dot(phi, sh[i]) for i in range(3)]
    grad_t = [rows_dot(temp, sh[i]) for i in range(3)]
    divu = grad_u[0][0] + grad_u[1][1] + grad_u[2][2]

    fm = [torch.zeros_like(sh[0]) for _ in range(3)]
    fc = torch.zeros_like(sh[0])
    fphi = torch.zeros_like(sh[0])
    ft = torch.zeros_like(sh[0])
    for q in range(4):
        wq = float(_GW[q])
        shl_a = _node_const(_SHL[q], inp)  # (4, 1)
        qval = lambda nodal: (shl_a * nodal).sum(dim=-2, keepdim=True)
        uq = [qval(u[i]) for i in range(3)]
        duq = [qval(du[i]) for i in range(3)]
        pq, dphiq, dtempq, srcq = qval(p), qval(dphi), qval(dtemp), qval(src)

        t1 = (
            m00 * uq[0] * uq[0] + m11 * uq[1] * uq[1] + m22 * uq[2] * uq[2]
            + 2.0 * (m01 * uq[0] * uq[1] + m02 * uq[0] * uq[2]
                     + m12 * uq[1] * uq[2])
        )
        tau_m = torch.rsqrt(t0 + t1 + 3.0 * nu * nu * gg) / rho
        tau_c = torch.sqrt(t1 + 3.0 * nu * nu * gg) / tr
        tau_phi = torch.rsqrt(t0 + t1)
        tau_t = torch.rsqrt(t0 + t1 + 3.0 * alpha_th * alpha_th * gg) / (rho * cp)

        conv = [
            uq[0] * grad_u[i][0] + uq[1] * grad_u[i][1] + uq[2] * grad_u[i][2]
            for i in range(3)
        ]
        r_l = [rho * (duq[i] - fb[i] + conv[i]) + grad_p[i] for i in range(3)]
        ucor = [uq[i] - tau_m * r_l[i] for i in range(3)]
        tmp0 = [
            rho * (duq[i] - fb[i]
                   + ucor[0] * grad_u[i][0] + ucor[1] * grad_u[i][1]
                   + ucor[2] * grad_u[i][2])
            for i in range(3)
        ]
        diag = -pq + rho * tau_c * divu
        for i in range(3):
            acc = shl_a * tmp0[i]
            for j in range(3):
                t1ij = (
                    mu * (grad_u[i][j] + grad_u[j][i])
                    + rho * tau_m * r_l[i] * uq[j]
                    - rho * tau_m * tau_m * r_l[i] * r_l[j]
                )
                if i == j:
                    t1ij = t1ij + diag
                acc = acc + sh[j] * t1ij
            fm[i] = fm[i] + wq * acc
        fc = fc + wq * (
            shl_a * divu
            + tau_m * (sh[0] * r_l[0] + sh[1] * r_l[1] + sh[2] * r_l[2])
        )
        shconv = uq[0] * sh[0] + uq[1] * sh[1] + uq[2] * sh[2]
        adv_phi = dphiq + (uq[0] * grad_phi[0] + uq[1] * grad_phi[1]
                           + uq[2] * grad_phi[2])
        fphi = fphi + wq * adv_phi * (shl_a + tau_phi * shconv)
        adv_t = rho * cp * (dtempq + uq[0] * grad_t[0] + uq[1] * grad_t[1]
                            + uq[2] * grad_t[2])
        ft = ft + wq * (adv_t - srcq) * (shl_a + rho * cp * tau_t * shconv)

    ft = ft + _GWSUM * kappa * (
        sh[0] * grad_t[0] + sh[1] * grad_t[1] + sh[2] * grad_t[2]
    )
    comps = torch.stack(fm + [fc, fphi, ft], dim=-2)  # (..., 4, 6, E)
    out = comps * det.unsqueeze(-2)
    return out.reshape(*out.shape[:-3], 24, out.shape[-1])


def lhs_rows(inp: torch.Tensor, *, rho, mu, f1, f2, dt, ncomp=18, cp=1.0, kappa=1.0,
             scalar_implicit=False) -> torch.Tensor:
    """(..., 27|33, E) -> (..., 16*ncomp, E) element Jacobian, rows
    ab*ncomp+c (pallas_kernels._lhs_rows). Input rows: [0:12) sh (i*4+a),
    [12:24) nodal velocity (i*4+a), 24 det, 25 gg, 26 tr, and with
    `scalar_implicit` [27:33) the 6 packed metric entries.
    Frozen-scalar mode: components 16/17 are the state-independent
    phi-phi/T-T identities, and ncomp=16 drops them (the lattice restores
    them from the node multiplicity). `scalar_implicit` (ncomp 18) puts
    the consistent phi/T transport tangents there instead
    (weakform.scalar_lhs_blocks), their taus from the residual's metric
    form t1 = u.G.u."""
    if ncomp not in (16, 18) or (scalar_implicit and ncomp != 18):
        raise ValueError(f"ncomp must be 16 or 18 (18 with scalar_implicit), got {ncomp}")
    r = lambda lo, hi: inp[..., lo:hi, :]
    sh = [r(4 * i, 4 * i + 4) for i in range(3)]
    u = [r(12 + 4 * i, 16 + 4 * i) for i in range(3)]
    det, gg, tr = r(24, 25), r(25, 26), r(26, 27)
    e = inp.shape[-1]
    pair_shape = (*inp.shape[:-2], 16, e)

    knu = mu / rho
    visc2 = 3.0 * knu * knu
    tr_safe = torch.where(tr > 0.0, tr, torch.ones_like(tr))

    if scalar_implicit:
        m6 = [r(27 + k, 28 + k) for k in range(6)]
        alpha_th = kappa / (rho * cp)
        jphi = torch.zeros(pair_shape, dtype=inp.dtype, device=inp.device)
        jt = torch.zeros(pair_shape, dtype=inp.dtype, device=inp.device)

    mass16 = _pair_const(lambda a, b: _MASS[a, b], inp)
    tmp = (f1 * rho * mass16).expand(pair_shape)
    gs_conv = torch.zeros_like(sh[0])
    gs_shl = torch.zeros_like(sh[0])
    tau0_sum = torch.zeros_like(det)
    c_grad2 = torch.zeros_like(det)
    for q in range(4):
        uq = [
            sum(float(_SHL[q][a]) * u[i][..., a : a + 1, :] for a in range(4))
            for i in range(3)
        ]
        shconv = uq[0] * sh[0] + uq[1] * sh[1] + uq[2] * sh[2]  # (..., 4, E)
        # vertices 1..3 only, as in the reference body
        adv2 = (shconv[..., 1:4, :] ** 2).sum(dim=-2, keepdim=True)
        tau0 = torch.rsqrt(4.0 / (dt * dt) + adv2 + visc2 * gg) / rho
        tau1 = torch.sqrt(adv2 + visc2 * gg) / tr_safe
        gwq = float(_GW[q])
        shl_b = _node_const(_SHL[q], inp)
        conv_a = _rep_a(shconv)
        conv_b = _rep_b(shconv)
        shl16_a = _pair_const(lambda a, b: _SHL[q][a], inp)
        shl16_b = _pair_const(lambda a, b: _SHL[q][b], inp)
        tmp = tmp + (
            (f1 * rho * rho * gwq) * tau0 * conv_a * shl16_b
            + (f2 * rho * gwq) * shl16_a * conv_b
            + (f2 * rho * rho * gwq) * tau0 * conv_a * conv_b
        )
        gs_conv = gs_conv + gwq * tau0 * shconv
        gs_shl = gs_shl + gwq * tau0 * shl_b
        tau0_sum = tau0_sum + gwq * tau0
        c_grad2 = c_grad2 + (f2 * rho * gwq) * tau1
        if scalar_implicit:
            t0c = 4.0 / (dt * dt)
            t1 = (
                m6[0] * uq[0] * uq[0] + m6[3] * uq[1] * uq[1] + m6[5] * uq[2] * uq[2]
                + 2.0 * (m6[1] * uq[0] * uq[1] + m6[2] * uq[0] * uq[2]
                         + m6[4] * uq[1] * uq[2])
            )
            tau_phi = torch.rsqrt(t0c + t1)
            tau_t = torch.rsqrt(t0c + t1 + 3.0 * alpha_th * alpha_th * gg) / (rho * cp)
            trial16 = f1 * shl16_b + f2 * conv_b
            jphi = jphi + gwq * (shl16_a + tau_phi * conv_a) * trial16
            jt = jt + (rho * cp * gwq) * (shl16_a + (rho * cp) * tau_t * conv_a) * trial16

    sh_a = [_rep_a(sh[i]) for i in range(3)]
    sh_b = [_rep_b(sh[i]) for i in range(3)]
    e_k = sh_a[0] * sh_b[0] + sh_a[1] * sh_b[1] + sh_a[2] * sh_b[2]
    tmp = tmp + (f2 * mu * _GWSUM) * e_k
    gsconv_a = _rep_a(gs_conv)
    gsconv_b = _rep_b(gs_conv)
    gsshl_b = _rep_b(gs_shl)
    gwshl_a = _pair_const(lambda a, b: _GWSHL[a], inp)
    gwshl_b = _pair_const(lambda a, b: _GWSHL[b], inp)

    comps = [None] * ncomp
    for i in range(3):
        for j in range(3):
            c = (f2 * mu * _GWSUM) * sh_a[j] * sh_b[i] + c_grad2 * sh_a[i] * sh_b[j]
            if i == j:
                c = c + tmp
            comps[i * 3 + j] = c * det
    for i in range(3):
        comps[9 + i] = (-sh_a[i] * gwshl_b + rho * gsconv_a * sh_b[i]) * det
        comps[12 + i] = (
            (f1 * rho) * sh_a[i] * gsshl_b
            + f2 * gwshl_a * sh_b[i]
            + (f2 * rho) * sh_a[i] * gsconv_b
        ) * det
    comps[15] = tau0_sum * e_k * det
    if scalar_implicit:
        comps[16] = jphi * det
        comps[17] = (jt + (f2 * kappa * _GWSUM) * e_k) * det
    elif ncomp == 18:
        eye16 = _pair_const(lambda a, b: 1.0 if a == b else 0.0, inp)
        ident = (eye16 * (det > 0.0).to(inp.dtype)).expand(pair_shape)
        comps[16] = ident
        comps[17] = ident
    stacked = torch.stack(comps, dim=-2)  # (..., 16, ncomp, E)
    return stacked.reshape(*inp.shape[:-2], 16 * ncomp, e)


def res_geom_rows(shgrad, det_j, metric) -> torch.Tensor:
    """(19, ne): 12 transposed shape gradients (row i*4+a), det_j, and the
    6 unique metric entries (m00, m01, m02, m11, m12, m22)."""
    ne = shgrad.shape[0]
    sh_t = shgrad.permute(2, 1, 0).reshape(12, ne)
    m = metric
    m6 = torch.stack(
        [m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1], m[:, 1, 2], m[:, 2, 2]]
    )
    return torch.cat([sh_t, det_j[None, :], m6])


def lhs_geom_rows(shgrad, det_j, metric) -> torch.Tensor:
    """(15, ne): 12 transposed shape gradients (row i*4+a), det_j,
    gg = |G|^2, tr(G)."""
    ne = shgrad.shape[0]
    sh_t = shgrad.permute(2, 1, 0).reshape(12, ne)
    gg = (metric * metric).sum(dim=(1, 2))[None, :]
    tr = metric.diagonal(dim1=1, dim2=2).sum(-1)[None, :]
    return torch.cat([sh_t, det_j[None, :], gg, tr])


def alpha_states(wgold, dwgold, dwg, scheme: TimeScheme):
    """Generalized-alpha evaluation states on (N, 6) (fem/ns.py):
    dw_alpha = (1-am) dwgold + am dwg with the pressure slot = dwg pressure;
    w_alpha = wgold + dt af ((1-g) dwgold + g dwg) with pressure slot 0."""
    am, af, g, dt = scheme.alpha_m, scheme.alpha_f, scheme.gamma, scheme.dt
    dwa = (1.0 - am) * dwgold + am * dwg
    dwa[:, 3] = dwg[:, 3]
    wa = wgold + dt * af * ((1.0 - g) * dwgold + g * dwg)
    wa[:, 3] = 0.0
    return wa, dwa


def field_norms_t(f_t: torch.Tensor) -> torch.Tensor:
    """Per-field residual norms [velocity, pressure, phi, T] of a (6, N)
    residual (main.c:127-130)."""
    return torch.stack(
        [
            torch.linalg.vector_norm(f_t[:3]),
            torch.linalg.vector_norm(f_t[3]),
            torch.linalg.vector_norm(f_t[4]),
            torch.linalg.vector_norm(f_t[5]),
        ]
    )


def field_norms(f: torch.Tensor) -> torch.Tensor:
    """field_norms_t of an (N, 6) residual."""
    return field_norms_t(f.T)
