"""Algebraic multigrid for the pressure Schur block on the WinELL tier
(counterpart of dedflow_tpu/solver/amg.py).

The reference's AmgX option preconditions any CSR matrix with no geometry
(pc.c:160-235). This is unsmoothed-aggregation AMG whose every set-up
product is a precomputed index map:

- Aggregation: meshes on the WinELL tier are RCM-ordered (mesh.reorder),
  so 8 consecutive rows are spatially adjacent and the aggregate of row i
  is i // 8. Restriction is a reshape-sum, prolongation a repeat.
- Galerkin R A P is one sorted segment sum: the fine-entry -> coarse-entry
  map depends only on the pattern, so `build_amg_plan` computes it once on
  the host (np.unique, a copy of amg.py:62-105) and each Newton
  assembly's coarsening is a gather of the values in that order and a
  segment sum over the sorted targets.
- A level's product is one gather of x at the column ids and one segment
  sum over the rows.

Every sum is `torch.segment_reduce` over sorted segments with their
offsets: on the card a fixed-order reduction, never an atomic scatter, so
the hierarchy and the V-cycle repeat bit for bit. The Schur wrapper
`AMGSchurPCT` mirrors solver.mg.MGSIMPLEPCT on the entry arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dedflow_tpu_torch.solver.pc import (
    NSFieldSplitPCT,
    _guarded_inverse,
    schur_apply,
    schur_split_apply,
)

_B = 8  # aggregate size (consecutive rows in RCM order)


# ---------------------------------------------------------------------------
# host-side plan


@dataclass(frozen=True, eq=False)
class AMGLevelPlan:
    """Static index maps of one level (host NumPy)."""

    n: int  # rows
    col: np.ndarray  # (E,) int32 column ids
    rowseg: np.ndarray  # (E,) int32 row ids, nondecreasing
    diag_mask: np.ndarray  # (E,) f32 1.0 where col == row
    # fine -> coarse entry map (None on the coarsest level)
    f2c_perm: np.ndarray | None  # (E,) int32 sort-by-coarse-entry order
    f2c_tgt: np.ndarray | None  # (E,) int32 coarse entry id, sorted
    nc: int = 0  # coarse rows
    ec: int = 0  # coarse entries


def build_amg_plan(row: np.ndarray, col: np.ndarray, n: int, min_nodes: int = 2048,
                   max_levels: int = 6) -> tuple[AMGLevelPlan, ...]:
    """Level plans from a flat entry list (row, col), `row` nondecreasing
    (CSR order). Duplicate (row, col) entries are additive, like the
    product (host copy of amg.py:62-105)."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    levels = []
    while True:
        last = n <= min_nodes or len(levels) + 1 >= max_levels
        lv = dict(
            n=n,
            col=col.astype(np.int32),
            rowseg=row.astype(np.int32),
            diag_mask=(row == col).astype(np.float32),
            f2c_perm=None,
            f2c_tgt=None,
        )
        if last:
            levels.append(AMGLevelPlan(**lv))
            break
        nc = -(-n // _B)
        key = (row // _B) * nc + (col // _B)
        uk, inv = np.unique(key, return_inverse=True)
        perm = np.argsort(inv, kind="stable")
        lv["f2c_perm"] = perm.astype(np.int32)
        lv["f2c_tgt"] = inv[perm].astype(np.int32)
        lv["nc"] = nc
        lv["ec"] = uk.size
        levels.append(AMGLevelPlan(**lv))
        row, col = uk // nc, uk % nc  # sorted row-major => rowseg sorted
        n = nc
    return tuple(levels)


def _segment_offsets(seg: np.ndarray, num: int) -> np.ndarray:
    """(num + 1,) offsets of the sorted segment ids `seg`."""
    return np.concatenate([[0], np.cumsum(np.bincount(seg, minlength=num))]).astype(np.int64)


# ---------------------------------------------------------------------------
# device-side hierarchy


@dataclass
class AMGIndices:
    """The plan's index maps on the device, shared across Newton
    assemblies (counterpart of amg.py:108-150): per level the column ids,
    the row segments' offsets and the diagonal entries, per non-coarsest
    level the fine-entry order and the coarse entries' offsets."""

    col: tuple  # per level (E,) int64
    row_off: tuple  # per level (n + 1,) int64
    diag_mask: tuple  # per level (E,) bool
    f2c_perm: tuple  # per non-coarsest level (E,) int64
    f2c_off: tuple  # per non-coarsest level (ec + 1,) int64
    ns: tuple  # rows per level
    ecs: tuple  # coarse entries per non-coarsest level

    @staticmethod
    def from_plan(plans: tuple, device="cpu") -> "AMGIndices":
        as_t = lambda a, dt=torch.long: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        coarse = [p for p in plans if p.f2c_perm is not None]
        return AMGIndices(
            col=tuple(as_t(p.col) for p in plans),
            row_off=tuple(as_t(_segment_offsets(p.rowseg, p.n)) for p in plans),
            diag_mask=tuple(as_t(p.diag_mask > 0, torch.bool) for p in plans),
            f2c_perm=tuple(as_t(p.f2c_perm) for p in coarse),
            f2c_off=tuple(as_t(_segment_offsets(p.f2c_tgt, p.ec)) for p in coarse),
            ns=tuple(p.n for p in plans),
            ecs=tuple(p.ec for p in coarse),
        )


def _segsum(vals: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sums of the sorted segments of `vals` (axis 0) in a fixed order."""
    return torch.segment_reduce(vals, "sum", offsets=offsets, unsafe=True)


def _matvec(idx: AMGIndices, li: int, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _segsum(vals * x[idx.col[li]], idx.row_off[li])


def _inv_diag(idx: AMGIndices, li: int, vals: torch.Tensor) -> torch.Tensor:
    d = _segsum(torch.where(idx.diag_mask[li], vals, torch.zeros_like(vals)), idx.row_off[li])
    return _guarded_inverse(d)


def build_values(idx: AMGIndices, app: torch.Tensor) -> tuple:
    """Per-level (vals, inv_diag) from the fine A_pp entry values, by
    repeated sorted segment sums (Galerkin R A P, P the 8-row indicator)."""
    out = []
    vals = app
    for li in range(len(idx.ns)):
        out.append((vals, _inv_diag(idx, li, vals)))
        if li < len(idx.f2c_perm):
            vals = _segsum(vals[idx.f2c_perm[li]], idx.f2c_off[li])
    return tuple(out)


def _restrict(r: torch.Tensor, nc: int) -> torch.Tensor:
    return F.pad(r, (0, nc * _B - r.shape[0])).reshape(nc, _B).sum(1)


def _prolong(xc: torch.Tensor, n: int) -> torch.Tensor:
    return xc[:, None].expand(xc.shape[0], _B).reshape(-1)[:n]


def vcycle(idx: AMGIndices, lv_vals: tuple, r: torch.Tensor, li: int = 0, omega: float = 0.7,
           coarse_sweeps: int = 12) -> torch.Tensor:
    """One V(1,1) damped-Jacobi cycle for A x = r at level li, x0 = 0."""
    vals, inv_diag = lv_vals[li]
    w = omega * inv_diag
    if li == len(idx.ns) - 1:
        x = w * r
        for _ in range(coarse_sweeps - 1):
            x = x + w * (r - _matvec(idx, li, vals, x))
        return x
    x = w * r
    rc = _restrict(r - _matvec(idx, li, vals, x), idx.ns[li + 1])
    x = x + _prolong(vcycle(idx, lv_vals, rc, li + 1, omega, coarse_sweeps), idx.ns[li])
    return x + w * (r - _matvec(idx, li, vals, x))


# ---------------------------------------------------------------------------
# Schur preconditioner (mirrors solver.mg.MGSIMPLEPCT on entry storage)


@dataclass
class AMGSchurPCT:
    """SIMPLE pressure-Schur preconditioner with an algebraic-multigrid
    Schur solve, for (6, N) systems stored per entry (counterpart of
    dedflow_tpu/solver/amg.py::AMGSchurPCT). `a_pu` (4, E) holds A_pp and
    the A_up columns, `apu` (3, E) the A_pu rows, gathered once from the
    assembled matrix; A_pp p and A_up p share one gather of p and one
    segment sum."""

    idx: AMGIndices
    lv_vals: tuple  # per level (vals, inv_diag)
    a_pu: torch.Tensor  # (E, 4): app, aup[0..2]
    apu: torch.Tensor  # (3, E)
    inv_vel_rows: torch.Tensor  # (9, N)
    inv_phi_diag: torch.Tensor  # (N,)
    inv_t_diag: torch.Tensor  # (N,)
    outer: int = 2
    omega: float = 0.7

    @staticmethod
    def from_winell(mat, idx: AMGIndices, entry_of_nnz: torch.Tensor, outer: int = 2,
                    omega: float = 0.7) -> "AMGSchurPCT":
        """mat = sparse.winell.WinELLMatrixT (assembled and masked);
        entry_of_nnz (E,) = the entry of each CSR entry (the level-0
        pattern order of the plan)."""
        base = NSFieldSplitPCT.from_diag_rows(mat.diag_rows())
        rows = torch.as_tensor([15, 12, 13, 14, 3, 7, 11], device=mat.vals.device)
        comp = mat.vals[rows][:, entry_of_nnz]  # WinELL rows pp, up[0..2], pu[0..2]
        return AMGSchurPCT(
            idx=idx,
            lv_vals=build_values(idx, comp[0]),
            a_pu=comp[:4].T.contiguous(),
            apu=comp[4:].contiguous(),
            inv_vel_rows=base.inv_vel_rows,
            inv_phi_diag=base.inv_phi_diag,
            inv_t_diag=base.inv_t_diag,
            outer=outer,
            omega=omega,
        )

    # the entry products (solver.pc.schur_split_apply's `ops`)
    def matvec_pp_up(self, p: torch.Tensor) -> tuple:
        y = _segsum(self.a_pu * p[self.idx.col[0]][:, None], self.idx.row_off[0])  # (N, 4)
        return y[:, 0], y[:, 1:].T

    def matvec_up(self, p: torch.Tensor) -> torch.Tensor:
        return self.matvec_pp_up(p)[1]

    def matvec_pu(self, u: torch.Tensor) -> torch.Tensor:
        uc = u[:, self.idx.col[0]]  # (3, E)
        return _segsum((self.apu * uc).sum(0), self.idx.row_off[0])

    def _schur_solve(self, rp: torch.Tensor) -> torch.Tensor:
        dp = vcycle(self.idx, self.lv_vals, rp, omega=self.omega)
        for _ in range(self.outer - 1):
            dp = dp + vcycle(self.idx, self.lv_vals,
                             rp - schur_apply(self, self.inv_vel_rows, dp), omega=self.omega)
        return dp

    def __call__(self, x_t: torch.Tensor) -> torch.Tensor:
        return schur_split_apply(self, self.inv_vel_rows, self.inv_phi_diag, self.inv_t_diag,
                                 x_t, self._schur_solve)
