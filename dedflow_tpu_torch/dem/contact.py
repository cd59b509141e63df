"""Pairwise spring-dashpot contact forces over padded candidate lists
(counterpart of dedflow_tpu/dem/contact.py; same model and op order).

For particle i with candidate j:
  n      = (x_i - x_j) / |x_i - x_j|          (away from j)
  delta  = r_i + r_j - |x_i - x_j|            (>0 when touching)
  v_rel  = v_i - v_j
  F_n    = ( k_n * delta - gamma_n * (v_rel . n) ) n
  v_t    = v_rel - (v_rel . n) n
  F_t    = -min(mu * |F_n|, gamma_t * |v_t|) * v_t / |v_t|

Wall contacts treat the six box faces as half-space springs with the same
parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ContactParams:
    k_n: float = 1.0e4  # normal stiffness
    gamma_n: float = 10.0  # normal damping
    mu: float = 0.0  # Coulomb friction coefficient (0 = frictionless)
    gamma_t: float = 0.0  # tangential damping
    eps: float = 1.0e-12


def pair_forces(x, v, radius, cand, prm: ContactParams) -> torch.Tensor:
    """(P, 3) net contact force per particle; `cand` (P, M) candidate
    indices with P = empty slot. Component-wise, every array (P, M)."""
    p = x.shape[0]
    idx = torch.arange(p, dtype=cand.dtype, device=cand.device)
    valid = (cand < p) & (cand != idx[:, None])  # (P, M)
    j = torch.clamp(cand, max=p - 1).long()  # safe gather index

    d = [x[:, c][:, None] - x[:, c][j] for c in range(3)]  # away from j
    v_rel = [v[:, c][:, None] - v[:, c][j] for c in range(3)]
    rj = radius[j]
    dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    dist = torch.sqrt(torch.clamp(dist2, min=prm.eps))
    n = [d[c] / dist for c in range(3)]
    delta = radius[:, None] + rj - dist
    af = (valid & (delta > 0.0)).to(x.dtype)

    vn = v_rel[0] * n[0] + v_rel[1] * n[1] + v_rel[2] * n[2]  # (P, M)
    fn_mag = prm.k_n * delta - prm.gamma_n * vn
    w = af * fn_mag
    f = [w * n[c] for c in range(3)]

    if prm.mu > 0.0 and prm.gamma_t > 0.0:
        vt = [v_rel[c] - vn * n[c] for c in range(3)]
        vt2 = vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2]
        vt_norm = torch.sqrt(torch.clamp(vt2, min=prm.eps))
        ft = af * torch.minimum(prm.mu * torch.abs(fn_mag), prm.gamma_t * vt_norm)
        f = [f[c] - ft / vt_norm * vt[c] for c in range(3)]
    return torch.stack([torch.sum(f[c], dim=1) for c in range(3)], dim=-1)


def wall_forces(x, v, radius, lo, hi, prm: ContactParams) -> torch.Tensor:
    """(P, 3) forces from the six planes of the box [lo, hi]."""
    lo = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.tensor(hi, dtype=x.dtype, device=x.device)
    f = torch.zeros_like(x)
    for axis in range(3):
        e = torch.zeros((3,), dtype=x.dtype, device=x.device)
        e[axis] = 1.0
        # lower wall: outward normal +e
        delta_lo = radius - (x[:, axis] - lo[axis])
        act = (delta_lo > 0).to(x.dtype)
        fmag = prm.k_n * delta_lo - prm.gamma_n * v[:, axis]
        f = f + (act * fmag)[:, None] * e[None]
        # upper wall: outward normal -e
        delta_hi = radius - (hi[axis] - x[:, axis])
        act = (delta_hi > 0).to(x.dtype)
        fmag = prm.k_n * delta_hi + prm.gamma_n * v[:, axis]
        f = f - (act * fmag)[:, None] * e[None]
    return f


def brute_force_pairs(x, v, radius, prm: ContactParams) -> torch.Tensor:
    """O(P^2) oracle for tests: candidates = everyone."""
    p = x.shape[0]
    cand = torch.arange(p, dtype=torch.int32, device=x.device)[None].expand(p, p)
    return pair_forces(x, v, radius, cand, prm)
