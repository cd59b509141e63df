"""Preconditioners on component-major (6, N) vectors (counterpart of
dedflow_tpu/solver/pc.py).

- NSFieldSplitPCT: the reference's hard-coded decomposition
  (krylov.c:440-452): block-Jacobi 3x3 on velocity, Jacobi on pressure,
  phi and T. The 3x3 velocity-block inverse is stored as 9 row-major
  component rows (9, N), so setup and apply are dense row operations.
- SIMPLEPCT (lattice tier, pc.py:186-271) and SIMPLEPC (gather tier,
  pc.py:274-329): the SIMPLE pressure-Schur split. Velocity predictor,
  an approximate Schur solve for the pressure, velocity corrector, the
  phi/T diagonals; the Schur solve is damped Jacobi on the exact S_hat
  diagonal (lattice) or on diag(A_pp) (gather tier, as the JAX package).
  `schur_split_apply` is the split shared with the multigrid Schur
  preconditioners (solver.mg, solver.amg); each takes an object with
  `matvec_up`, `matvec_pu` and `matvec_pp_up` (sparse.fsbsr.SchurBandsT,
  sparse.winell.WinELLMatrixT, solver.amg's entry products).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dedflow_tpu_torch.sparse.fsbsr import PHIPHI, PP, TT


@dataclass
class NSFieldSplitPCT:
    inv_vel_rows: torch.Tensor  # (9, N) row-major [i*3+j]
    inv_p_diag: torch.Tensor  # (N,)
    inv_phi_diag: torch.Tensor  # (N,)
    inv_t_diag: torch.Tensor  # (N,)

    @staticmethod
    def from_diag_rows(rows: torch.Tensor) -> "NSFieldSplitPCT":
        """rows: (18, N) packed diagonal-block rows (FSDIAMatrixT.diag_rows)."""
        r = rows[:9]
        c00 = r[4] * r[8] - r[5] * r[7]
        c01 = r[5] * r[6] - r[3] * r[8]
        c02 = r[3] * r[7] - r[4] * r[6]
        det = r[0] * c00 + r[1] * c01 + r[2] * c02
        inv_det = 1.0 / det
        inv = torch.stack(
            [
                c00,
                r[2] * r[7] - r[1] * r[8],
                r[1] * r[5] - r[2] * r[4],
                c01,
                r[0] * r[8] - r[2] * r[6],
                r[2] * r[3] - r[0] * r[5],
                c02,
                r[1] * r[6] - r[0] * r[7],
                r[0] * r[4] - r[1] * r[3],
            ]
        ) * inv_det
        return NSFieldSplitPCT(
            inv_vel_rows=inv,
            inv_p_diag=1.0 / rows[PP],
            inv_phi_diag=1.0 / rows[PHIPHI],
            inv_t_diag=1.0 / rows[TT],
        )

    def __call__(self, x_t: torch.Tensor) -> torch.Tensor:
        """x_t: (6, N) -> (6, N)."""
        v = self.inv_vel_rows
        y = [
            v[i * 3 + 0] * x_t[0] + v[i * 3 + 1] * x_t[1] + v[i * 3 + 2] * x_t[2]
            for i in range(3)
        ]
        return torch.stack(
            y
            + [
                x_t[3] * self.inv_p_diag,
                x_t[4] * self.inv_phi_diag,
                x_t[5] * self.inv_t_diag,
            ]
        )


def duinv(inv_vel_rows: torch.Tensor, xu: torch.Tensor) -> torch.Tensor:
    """(3, N) = inv(D_u) xu, with the (9, N) row-major inverse blocks."""
    return (inv_vel_rows.view(3, 3, -1) * xu[None]).sum(1)


def schur_apply(ops, inv_vel_rows: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """S_hat p = A_pp p - A_pu inv(D_u) A_up p, matrix-free."""
    pp, up = ops.matvec_pp_up(p)
    return pp - ops.matvec_pu(duinv(inv_vel_rows, up))


def schur_split_apply(ops, inv_vel_rows, inv_phi_diag, inv_t_diag, x_t, schur_solve):
    """The SIMPLE split on (6, N) x_t: u* = inv(D_u) x_u, r_p = x_p - A_pu u*,
    dp = schur_solve(r_p), u = u* - inv(D_u) A_up dp; phi/T by their
    diagonal inverses."""
    ustar = duinv(inv_vel_rows, x_t[:3])
    rp = x_t[3] - ops.matvec_pu(ustar)
    dp = schur_solve(rp)
    u = ustar - duinv(inv_vel_rows, ops.matvec_up(dp))
    return torch.stack([u[0], u[1], u[2], dp, x_t[4] * inv_phi_diag, x_t[5] * inv_t_diag])


def _jacobi_schur_solve(ops, inv_vel_rows, inv_s_diag, omega: float, sweeps: int):
    """`sweeps` damped-Jacobi sweeps on S_hat from zero (pc.py:263-265)."""

    def solve(rp):
        ws = omega * inv_s_diag
        dp = ws * rp
        for _ in range(sweeps - 1):
            dp = dp + ws * (rp - schur_apply(ops, inv_vel_rows, dp))
        return dp

    return solve


def _guarded_inverse(d: torch.Tensor) -> torch.Tensor:
    """1 / d, with 1 where |d| <= 1e-30 (degenerate constrained rows)."""
    return 1.0 / torch.where(d.abs() > 1e-30, d, torch.ones_like(d))


@dataclass
class SIMPLEPCT:
    """SIMPLE pressure-Schur preconditioner on the lattice tier (counterpart
    of dedflow_tpu/solver/pc.py::SIMPLEPCT): the Schur sweeps use the
    compact A_pp / A_pu / A_up bands (FSDIAMatrixT.schur_bands, extracted
    once at set-up) and the exact S_hat diagonal (FSDIAMatrixT.schur_diag).
    The JAX package measured 106 -> ~40 GMRES iterations against
    block-Jacobi on the lid-driven cavity (pc.py:205-206)."""

    bands: object  # sparse.fsbsr.SchurBandsT
    inv_vel_rows: torch.Tensor  # (9, N)
    inv_s_diag: torch.Tensor  # (N,) 1 / diag(S_hat)
    inv_phi_diag: torch.Tensor  # (N,)
    inv_t_diag: torch.Tensor  # (N,)
    sweeps: int = 6
    omega: float = 0.8

    @staticmethod
    def from_matrix(mat, sweeps: int = 6, omega: float = 0.8) -> "SIMPLEPCT":
        base = NSFieldSplitPCT.from_diag_rows(mat.diag_rows())
        return SIMPLEPCT(
            bands=mat.schur_bands(),
            inv_vel_rows=base.inv_vel_rows,
            inv_s_diag=_guarded_inverse(mat.schur_diag(base.inv_vel_rows)),
            inv_phi_diag=base.inv_phi_diag,
            inv_t_diag=base.inv_t_diag,
            sweeps=sweeps,
            omega=omega,
        )

    def __call__(self, x_t: torch.Tensor) -> torch.Tensor:
        solve = _jacobi_schur_solve(self.bands, self.inv_vel_rows, self.inv_s_diag,
                                    self.omega, self.sweeps)
        return schur_split_apply(self.bands, self.inv_vel_rows, self.inv_phi_diag,
                                 self.inv_t_diag, x_t, solve)


@dataclass
class SIMPLEPC:
    """SIMPLE pressure-Schur preconditioner on the gather tier (counterpart
    of dedflow_tpu/solver/pc.py::SIMPLEPC, there on (N, 6) vectors of the
    ELL matrix): the same algorithm on (6, N) vectors of the CSR-entry
    WinELLMatrixT, its Schur sweeps damped Jacobi on diag(A_pp) as in the
    JAX package (the exact Schur diagonal needs a transpose slot map). The
    block products are K7 launches (WinELLMatrixT.matvec_up/pu/pp)."""

    mat: object  # sparse.winell.WinELLMatrixT
    inv_vel_rows: torch.Tensor  # (9, N)
    inv_s_diag: torch.Tensor  # (N,) 1 / diag(A_pp)
    inv_phi_diag: torch.Tensor  # (N,)
    inv_t_diag: torch.Tensor  # (N,)
    sweeps: int = 6
    omega: float = 0.8

    @staticmethod
    def from_matrix(mat, sweeps: int = 6, omega: float = 0.8) -> "SIMPLEPC":
        base = NSFieldSplitPCT.from_diag_rows(mat.diag_rows())
        return SIMPLEPC(
            mat=mat,
            inv_vel_rows=base.inv_vel_rows,
            inv_s_diag=_guarded_inverse(mat.diag_p()),
            inv_phi_diag=base.inv_phi_diag,
            inv_t_diag=base.inv_t_diag,
            sweeps=sweeps,
            omega=omega,
        )

    def __call__(self, x_t: torch.Tensor) -> torch.Tensor:
        solve = _jacobi_schur_solve(self.mat, self.inv_vel_rows, self.inv_s_diag,
                                    self.omega, self.sweeps)
        return schur_split_apply(self.mat, self.inv_vel_rows, self.inv_phi_diag,
                                 self.inv_t_diag, x_t, solve)
