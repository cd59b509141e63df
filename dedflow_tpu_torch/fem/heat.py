"""Scalar heat / Poisson element kernels and assembly (counterpart of
dedflow_tpu/fem/heat.py, the JAX package's M1 slice).

Parity target: AssemleWeakFormKernelHeat (assemble.cu:377-443) - the
reference's scalar transient heat weak form under generalized-alpha:

    F_a   = sum_q gw_q detJ dT(q) N_a(q)  +  (1/6) detJ grad(T).grad(N_a)
    J_ab  = alpha_m detJ sum_q gw_q N_a N_b
          + dt alpha_f gamma (1/6) detJ grad(N_a).grad(N_b)

(1/6 = sum_q gw_q = reference-tet volume; gradients of P1 fields are
constant per element, so the diffusion term needs no quadrature loop.)
Optional rho*cp (capacity) and kappa (conductivity) generalize the
reference's unit coefficients. `assemble_poisson` is the steady Poisson
system (stiffness + load) of BASELINE config #1 ("steady thermal Poisson,
GMRES+Jacobi").

The element terms are plain torch, as the JAX package's are jnp; the
element-to-node and element-to-entry sums run K8 and K9 with one output
row (fem.assembly.scatter_residual / scatter_matrix) on a context built
with `scalar_plans=True`: one pass each over the (ne, 4) / (ne, 4, 4)
element arrays where they lie (sources the flat (e, slot) indices), with
no transposing copy and no staging buffer.
"""

from __future__ import annotations

import torch

from dedflow_tpu_torch.fem import quadrature as quad
from dedflow_tpu_torch.fem.assembly import (
    FEMContext,
    bsr_from_data,
    elem_geom,
    gather_nodal,
    scatter_matrix,
    scatter_residual,
)
from dedflow_tpu_torch.sparse.bsr import BSRMatrix

_V_REF = 1.0 / 6.0  # reference tet volume = sum of quadrature weights


def _quad(like: torch.Tensor):
    """(SHL (q, a), GW (q,)) in `like`'s dtype and device."""
    as_t = lambda a: torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return as_t(quad.SHL), as_t(quad.GW)


def _stiffness(ctx: FEMContext, kappa: float) -> torch.Tensor:
    """(ne, 4, 4) kappa (1/6) detJ grad(N_a).grad(N_b)."""
    g = elem_geom(ctx)
    return (kappa * _V_REF * g.det_j[:, None, None]
            * torch.einsum("eai,ebi->eab", g.shgrad, g.shgrad))


def heat_element_residual(
    ctx: FEMContext,
    t_alpha: torch.Tensor,
    dt_alpha: torch.Tensor,
    rho_cp: float = 1.0,
    kappa: float = 1.0,
) -> torch.Tensor:
    """(ne, 4) element residual vectors (assemble.cu:402-412)."""
    shl, gw = _quad(t_alpha)
    g = elem_geom(ctx)
    te = gather_nodal(ctx, t_alpha)  # (ne, 4)
    dte = gather_nodal(ctx, dt_alpha)
    dt_q = dte @ shl.T  # (ne, q)
    grad_t = torch.einsum("ea,eai->ei", te, g.shgrad)  # (ne, 3)
    mass = torch.einsum("q,eq,qa->ea", gw, dt_q, shl) * g.det_j[:, None] * rho_cp
    diff = torch.einsum("ei,eai->ea", grad_t, g.shgrad) * (_V_REF * kappa) * g.det_j[:, None]
    return mass + diff


def heat_element_jacobian(
    ctx: FEMContext,
    alpha_m: float,
    dt_alpha_f_gamma: float,
    rho_cp: float = 1.0,
    kappa: float = 1.0,
) -> torch.Tensor:
    """(ne, 4, 4) element Jacobians (assemble.cu:418-441)."""
    det_j = elem_geom(ctx).det_j
    shl, gw = _quad(det_j)
    mass_ref = torch.einsum("q,qa,qb->ab", gw, shl, shl)  # (4, 4)
    mass = alpha_m * rho_cp * det_j[:, None, None] * mass_ref[None]
    return mass + dt_alpha_f_gamma * _stiffness(ctx, kappa)


def assemble_heat(
    ctx: FEMContext,
    t_alpha: torch.Tensor,
    dt_alpha: torch.Tensor,
    alpha_m: float,
    dt_alpha_f_gamma: float,
    rho_cp: float = 1.0,
    kappa: float = 1.0,
) -> tuple[torch.Tensor, BSRMatrix]:
    """Global residual (N,) and scalar-block BSR Jacobian."""
    f = scatter_residual(ctx, heat_element_residual(ctx, t_alpha, dt_alpha, rho_cp, kappa))
    ej = heat_element_jacobian(ctx, alpha_m, dt_alpha_f_gamma, rho_cp, kappa)
    return f, bsr_from_data(ctx, scatter_matrix(ctx, ej[..., None, None]))


def assemble_poisson(
    ctx: FEMContext,
    source: torch.Tensor,
    kappa: float = 1.0,
) -> tuple[BSRMatrix, torch.Tensor]:
    """Steady Poisson: K phi = b with K_ab = kappa int grad(N_a).grad(N_b)
    and b_a = int f N_a (f given nodally, interpolated to quadrature)."""
    shl, gw = _quad(source)
    k = bsr_from_data(ctx, scatter_matrix(ctx, _stiffness(ctx, kappa)[..., None, None]))
    f_q = gather_nodal(ctx, source) @ shl.T  # (ne, q)
    eb = torch.einsum("q,eq,qa->ea", gw, f_q, shl) * elem_geom(ctx).det_j[:, None]
    return k, scatter_residual(ctx, eb)
