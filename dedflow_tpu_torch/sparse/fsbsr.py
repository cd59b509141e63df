"""Component-major DIA field-split matrix (subset of dedflow_tpu/sparse/fsbsr.py).

The 6x6 nodal blocks of the coupled system carry 18 structurally nonzero
packed components (velocity 3x3, velocity-pressure, pressure-velocity,
pressure-pressure, and the phi-phi / T-T diagonals). On the lattice the
matrix is stored per DIA offset plane, node axis last:

    data (D, 16, N)  the 16 velocity/pressure components of plane k
    scal (2*D, N)    row 2k = phi-phi, row 2k+1 = T-T of plane k

Plane k couples row n to column n + offsets[k]. The TPU layout's 128-lane
width padding and 8-row scal padding are tiling artefacts and are not
carried over: the width is exactly N and scal has exactly 2*D rows.

Component order:
    0..8   uu[i*3+j]   d y_u[i] / d x_u[j]
    9..11  up[i]       d y_u[i] / d x_p
    12..14 pu[j]       d y_p    / d x_u[j]
    15     pp
    16     phiphi
    17     TT
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NUM_COMP = 18
UU = lambda i, j: i * 3 + j
UP = lambda i: 9 + i
PU = lambda j: 12 + j
PP = 15
PHIPHI = 16
TT = 17

# (component, block-row, block-col) of each packed slot
COMP_SLOTS = (
    [(UU(i, j), i, j) for i in range(3) for j in range(3)]
    + [(UP(i), i, 3) for i in range(3)]
    + [(PU(j), 3, j) for j in range(3)]
    + [(PP, 3, 3), (PHIPHI, 4, 4), (TT, 5, 5)]
)
# solution component whose equation each packed component lives in
COMP_ROW = np.array([bi for _, bi, _ in COMP_SLOTS])
# the 6 packed components on the block diagonal, by solution component
DIAG_COMPS = np.array([UU(0, 0), UU(1, 1), UU(2, 2), PP, PHIPHI, TT])


def keep_pc_rows(mask_t: torch.Tensor, dtype) -> torch.Tensor:
    """(18, N) per-packed-component row-keep factors from a (6, N) mask."""
    keep = 1.0 - mask_t.to(dtype)
    return keep[torch.as_tensor(COMP_ROW, device=mask_t.device)]


def diag_add_rows(mask_t: torch.Tensor, dtype) -> torch.Tensor:
    """(18, N) unit-diagonal additions (nonzero only on the 6 diagonal
    packed components) from a (6, N) mask."""
    add = mask_t.to(dtype)
    out = torch.zeros((NUM_COMP, add.shape[1]), dtype=dtype, device=add.device)
    out[torch.as_tensor(DIAG_COMPS, device=add.device)] = add
    return out


@dataclass
class FSDIAMatrixT:
    """Component-major DIA field-split matrix (see module docstring)."""

    data: torch.Tensor  # (D, 16, N) velocity/pressure components
    scal: torch.Tensor  # (2*D, N) phi-phi / T-T rows per plane
    offsets: tuple

    @property
    def _d0(self) -> int:
        return self.offsets.index(0)

    def matvec_t(self, x_t: torch.Tensor) -> torch.Tensor:
        """(6, N) -> (6, N) SpMV (sparse.dia_kernels: the hand-written
        kernel on CUDA, its plain version on the CPU)."""
        from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

        return dia_matvec(self.data, self.scal, x_t, self.offsets)

    def diag_rows(self) -> torch.Tensor:
        """(18, N) packed diagonal-block rows (PC setup)."""
        d0 = self._d0
        return torch.cat([self.data[d0], self.scal[2 * d0 : 2 * d0 + 2]], dim=0)

    def zero_rows_t(self, mask_t: torch.Tensor) -> "FSDIAMatrixT":
        """Zero constrained rows (mask_t (6, N) boolean, True = constrained)
        and put a unit diagonal on them (dirichlet.c:47-61)."""
        dtype = self.data.dtype
        keep = keep_pc_rows(mask_t, dtype)
        add = diag_add_rows(mask_t, dtype)
        d0 = self._d0
        data = self.data * keep[None, :16]
        data[d0] += add[:16]
        scal = self.scal * keep[16:18].repeat(self.data.shape[0], 1)
        scal[2 * d0 : 2 * d0 + 2] += add[16:18]
        return FSDIAMatrixT(data=data, scal=scal, offsets=self.offsets)

    def to_block_dense(self) -> np.ndarray:
        """Test helper: expand to dense (N*6, N*6) float64."""
        d = self.data.detach().cpu().double().numpy()
        s = self.scal.detach().cpu().double().numpy()
        nd, _, n = d.shape
        d18 = np.concatenate([d, s.reshape(nd, 2, n)], axis=1)
        dense = np.zeros((n * 6, n * 6))
        rows = np.arange(n)
        for k, o in enumerate(self.offsets):
            cols = rows + o
            ok = (cols >= 0) & (cols < n)
            for comp, bi, bj in COMP_SLOTS:
                np.add.at(
                    dense,
                    (rows[ok] * 6 + bi, cols[ok] * 6 + bj),
                    d18[k, comp, rows[ok]],
                )
        return dense
