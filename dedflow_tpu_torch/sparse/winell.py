"""WinELL field-split matrix for irregular meshes (counterpart of
dedflow_tpu/sparse/winell.py: the plan and the matrix contract).

The 6x6 nodal blocks of the coupled system are stored per nonzero node
pair ("entry") as 18 packed component rows in the JAX package's WinELL
component order (COMP2WIN, winell.py:56-67):

    vals (18, S)   row 4k+i (i<3): d y_u[i] / d x_[k]  (k<3 uu[i,k], k=3 up[i])
                   row 4k+3:       d y_p    / d x_[k]  (k<3 pu[k],   k=3 pp)
                   rows 16 / 17:   phi-phi / T-T

On Hopper the entries are numbered in CSR order (row-major, columns
ascending within a row): S = nnz and `entry_of_nnz` is the identity. The
TPU layout (1024-row superpacks, column-sorted entries, 512-entry padding,
bitcast index rows 18/19, the vmax tail and the window schedule) exists
for the TPU's lane gather and MXU one-hot reductions and is not carried
over. Tests compare the two layouts through `entry_of_nnz` and
`to_block_dense`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.sparse.fsbsr import COMP_SLOTS, DIAG_COMPS, PHIPHI, PP, TT, PU, UP, UU
from dedflow_tpu_torch.utils.dtypes import resolve_device

NUM_ROWS = 18
COMP2WIN = np.zeros(18, dtype=np.int64)  # fsbsr comp -> winell row
for _i in range(3):
    for _j in range(3):
        COMP2WIN[UU(_i, _j)] = 4 * _j + _i
    COMP2WIN[UP(_i)] = 12 + _i
    COMP2WIN[PU(_i)] = 4 * _i + 3
COMP2WIN[PP] = 15
COMP2WIN[PHIPHI] = 16
COMP2WIN[TT] = 17
WIN2COMP = np.argsort(COMP2WIN)  # winell row -> fsbsr comp
# winell row -> solution component of its equation (block row)
WIN_EQ = np.zeros(18, dtype=np.int64)
for _comp, _bi, _bj in COMP_SLOTS:
    WIN_EQ[COMP2WIN[_comp]] = _bi


@dataclass
class WinPlan:
    """Host plan (NumPy) plus its device index tensors. Entry s couples
    row `grow[s]` to column `col[s]`; the entries of row r are
    [row_ptr[r], row_ptr[r + 1])."""

    num_node: int
    S: int
    row_ptr: np.ndarray  # (N+1,) int64
    col: np.ndarray  # (S,) int64
    grow: np.ndarray  # (S,) int64
    entry_of_nnz: np.ndarray  # (nnz,) int64, the identity here
    diag_entry: np.ndarray  # (N,) int64
    # device copies
    row_ptr_t: torch.Tensor  # (N+1,) int32
    col_t: torch.Tensor  # (S,) int32
    grow_t: torch.Tensor  # (S,) int32
    diag_t: torch.Tensor  # (N,) int64


def build_winell_plan(row_ptr, col_ind, num_node: int, device="cuda") -> WinPlan:
    """The entry layout of a CSR pattern (sparse.topology.build_sparsity):
    one entry per nonzero, in CSR order; on the card unless `device` says
    otherwise."""
    dev = resolve_device(device)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col = np.asarray(col_ind, dtype=np.int64)
    n = int(num_node)
    s = col.size
    if s >= 2**31:
        raise ValueError("WinELL plan: more than 2**31 entries")
    grow = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    is_diag = np.nonzero(col == grow)[0]
    if is_diag.size != n:
        raise ValueError("every row needs a diagonal entry")
    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    return WinPlan(
        num_node=n, S=s, row_ptr=row_ptr, col=col, grow=grow,
        entry_of_nnz=np.arange(s, dtype=np.int64), diag_entry=is_diag,
        row_ptr_t=as_t(row_ptr, torch.int32), col_t=as_t(col, torch.int32),
        grow_t=as_t(grow, torch.int32), diag_t=as_t(is_diag, torch.long),
    )


@dataclass
class WinELLMatrixT:
    """WinELL field-split matrix on component-major vectors (see the
    module docstring). `vals` (18, S) in WinELL component order."""

    vals: torch.Tensor
    plan: WinPlan

    @property
    def num_node(self) -> int:
        return self.plan.num_node

    def matvec_t(self, x_t: torch.Tensor) -> torch.Tensor:
        """(6, N) -> (6, N) SpMV (sparse.win_kernels: the hand-written
        kernel on CUDA, its plain version on the CPU)."""
        from dedflow_tpu_torch.sparse.win_kernels import winell_matvec

        return winell_matvec(self, x_t)

    # -- component-restricted products (solver.pc.SIMPLEPC). K7 on a vector
    # that is zero outside the block's input component: the zero columns
    # add exact zeros, K7's row order is fixed, so the products repeat bit
    # for bit on the card and never scatter.
    def _product(self, rows: slice, x_part: torch.Tensor) -> torch.Tensor:
        x = torch.zeros((6, self.num_node), dtype=x_part.dtype, device=x_part.device)
        x[rows] = x_part
        return self.matvec_t(x)

    def matvec_up(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) pressure -> (3, N) velocity rows: the A_up block only."""
        return self._product(slice(3, 4), p[None])[:3]

    def matvec_pu(self, u: torch.Tensor) -> torch.Tensor:
        """(3, N) velocity -> (N,) pressure row: the A_pu block only."""
        return self._product(slice(0, 3), u)[3]

    def matvec_pp(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) -> (N,): the A_pp block only."""
        return self._product(slice(3, 4), p[None])[3]

    def matvec_pp_up(self, p: torch.Tensor) -> tuple:
        """(A_pp p, A_up p) from one product."""
        y = self._product(slice(3, 4), p[None])
        return y[3], y[:3]

    def diag_p(self) -> torch.Tensor:
        """(N,) pressure-pressure diagonal."""
        return self.vals[15, self.plan.diag_t]

    def diag_rows(self) -> torch.Tensor:
        """(18, N) packed diagonal-block rows in fsbsr component order
        (PC setup)."""
        idx = torch.as_tensor(COMP2WIN, device=self.vals.device)
        return self.vals[:, self.plan.diag_t][idx]

    def zero_rows_t(self, mask_t: torch.Tensor) -> "WinELLMatrixT":
        """Zero constrained rows (mask_t (6, N) boolean, True = constrained)
        and put a unit diagonal on them (dirichlet.c:47-61)."""
        dtype, dev = self.vals.dtype, self.vals.device
        keep6 = 1.0 - mask_t.to(dtype)
        keep = keep6[torch.as_tensor(WIN_EQ, device=dev)][:, self.plan.grow_t]  # (18, S)
        vals = self.vals * keep
        win_diag = torch.as_tensor(COMP2WIN[DIAG_COMPS], device=dev)
        de = self.plan.diag_t
        vals[win_diag[:, None], de[None, :]] += mask_t.to(dtype)  # unique entries
        return WinELLMatrixT(vals=vals, plan=self.plan)

    def to_block_dense(self) -> np.ndarray:
        """Test helper: dense (N*6, N*6) float64."""
        n = self.num_node
        v = self.vals.detach().cpu().double().numpy()
        dense = np.zeros((n * 6, n * 6))
        for comp, bi, bj in COMP_SLOTS:
            np.add.at(
                dense, (self.plan.grow * 6 + bi, self.plan.col * 6 + bj), v[COMP2WIN[comp]]
            )
        return dense
