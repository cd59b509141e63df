"""Field-split preconditioner on component-major vectors (counterpart of
dedflow_tpu/solver/pc.py::NSFieldSplitPCT).

The reference's hard-coded decomposition (krylov.c:440-452): block-Jacobi
3x3 on velocity, Jacobi on pressure, phi and T. The 3x3 velocity-block
inverse is stored as 9 row-major component rows (9, N), so setup and
apply are dense row operations."""

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
