"""Pressure-block geometric multigrid on the lattice tier (counterpart of
dedflow_tpu/solver/mg.py, unsharded).

The reference's optional PCAMGX (pc.c:160-235) wraps AmgX as an algebraic
multigrid solve of one field section. On the lattice the pressure block
A_pp is a <= 15-point stencil on the structured (gx, gy, gz) node grid, so
the hierarchy is geometric:

- `ScalarDIALevel`: one level's stencil as (K, N) plane rows with linear
  column offsets, and its inverse diagonal for damped Jacobi. Its product
  is sparse.fsbsr.shifted + one multiply + one sum: four launches
  whatever K.
- `build_hierarchy`: level l+1 is the Galerkin product R A P of level l
  with piecewise-constant aggregation over 2x2x2 node blocks. Per fine
  offset and node parity the contribution lands on the coarse offset
  ((p + o) // 2 per axis) (mg.py:155-193). Here the parity slices of all
  planes are one permuted copy, and each coarse plane the sum of its
  contributions, gathered through a host table built once per (offsets,
  dims): a fixed handful of launches per level and no scatter, so the
  coarse planes repeat bit for bit on the card.
- `vcycle`: V(1,1) damped Jacobi, the coarsest level with 12 sweeps.
- `MGSIMPLEPCT`: the SIMPLE split (solver.pc.schur_split_apply) with the
  Schur solve `outer` Richardson iterations on S_hat = A_pp - A_pu
  inv(D_u) A_up, each preconditioned by one V-cycle on the hierarchy of the
  plain A_pp stencil. The JAX package measured 24 against 111 GMRES
  iterations on the reference state at 16^3 (mg.py:372-376), an
  algorithmic count, not a device time.

A linear offset wraps at a grid border to an unrelated row, but the
lattice assembly makes every such entry exactly 0.0 and the Galerkin sums
keep it 0.0, so the flat linear-offset product is exact on every level.
The sharded variants (`shard=`, `shard_z`, `axis=`) belong to ROADMAP A16
and raise.
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
from dedflow_tpu_torch.sparse.fsbsr import shifted


def _refuse_sharded(what: str) -> None:
    raise NotImplementedError(
        f"dedflow_tpu_torch does not port {what} (sharded multigrid) yet (ROADMAP queue A16)"
    )


def decode_offsets(offsets, gx: int, gy: int) -> list[tuple[int, int, int]]:
    """Linear DIA offsets -> geometric (ox, oy, oz), each |o| <= 1 (host
    copy of mg.py:49-70). Raises ValueError for a non-lattice stencil."""
    sy, sz = gx, gx * gy
    out = []
    for o in offsets:
        oz = int(np.round(o / sz))
        rem = o - oz * sz
        oy = int(np.round(rem / sy))
        ox = rem - oy * sy
        if max(abs(ox), abs(oy), abs(oz)) > 1 or ox + sy * oy + sz * oz != o:
            raise ValueError(
                f"offset {o} does not decode to a 27-point stencil on "
                f"grid ({gx}, {gy}, ...)"
            )
        out.append((ox, oy, oz))
    return out


def infer_dims(offsets, num_rows: int) -> tuple[int, int, int] | None:
    """The node-grid shape (gx, gy, gz) from linear DIA offsets alone, or
    None when no consistent decode exists (host copy of mg.py:73-111)."""
    offs = sorted(int(o) for o in offsets)
    pos = [o for o in offs if o > 1]
    if not pos or num_rows <= 0:
        return None
    omax = pos[-1]
    sy_cands = sorted({p + d for p in pos[:3] for d in (-1, 0, 1) if p + d > 1})
    for sy in sy_cands:
        for dz in (-sy - 1, -sy, -sy + 1, -1, 0, 1, sy - 1, sy, sy + 1):
            sz = omax + dz
            if sz <= sy or sz % sy != 0:
                continue
            if num_rows % sz != 0:
                continue
            gx, gy, gz = sy, sz // sy, num_rows // sz
            if gy < 1 or gz < 1:
                continue
            try:
                decode_offsets(offs, gx, gy)
            except ValueError:
                continue
            return (gx, gy, gz)
    return None


@dataclass
class ScalarDIALevel:
    """One multigrid level: scalar DIA stencil + Jacobi inverse diagonal."""

    planes: torch.Tensor  # (K, N) plane rows
    inv_diag: torch.Tensor  # (N,)
    offsets: tuple  # linear
    dims: tuple  # (gx, gy, gz)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """(N,) -> (N,)."""
        return (self.planes * shifted(x, self.offsets)).sum(0)


def _coarse_dims(dims) -> tuple[int, int, int]:
    return tuple(-(-d // 2) for d in dims)


# Galerkin tables by (offsets, dims, device): they depend only on the
# stencil and the grid, so each Newton assembly reuses them.
_COARSE_PLANS: dict = {}


def _coarse_plan(offsets: tuple, dims: tuple, device):
    """(coarse offsets, (Kc, width) int64 table of source rows k*8 + parity,
    padded with the zero row K*8, on `device`) of the Galerkin product: the
    coarse planes in the JAX package's order (its dict's insertion order,
    sorted stably by linear offset)."""
    key = (offsets, dims, device)
    if key not in _COARSE_PLANS:
        gx, gy, _ = dims
        cgx, cgy, _ = _coarse_dims(dims)
        coarse: dict = {}
        for k, (ox, oy, oz) in enumerate(decode_offsets(offsets, gx, gy)):
            for pz in range(2):
                for py in range(2):
                    for px in range(2):
                        co = ((px + ox) // 2, (py + oy) // 2, (pz + oz) // 2)
                        coarse.setdefault(co, []).append(k * 8 + pz * 4 + py * 2 + px)
        csy, csz = cgx, cgx * cgy
        items = sorted(coarse.items(), key=lambda kv: kv[0][0] + csy * kv[0][1] + csz * kv[0][2])
        offs = tuple(ox + csy * oy + csz * oz for (ox, oy, oz), _ in items)
        width = max(len(src) for _, src in items)
        zero = len(offsets) * 8
        table = np.array([src + [zero] * (width - len(src)) for _, src in items], np.int64)
        _COARSE_PLANS[key] = (offs, torch.as_tensor(table, device=device))
    return _COARSE_PLANS[key]


def _galerkin_coarsen(level: ScalarDIALevel) -> ScalarDIALevel:
    """R A P with piecewise-constant 2x2x2 aggregation, on the device."""
    gx, gy, gz = level.dims
    cgx, cgy, cgz = _coarse_dims(level.dims)
    offs, table = _coarse_plan(tuple(level.offsets), tuple(level.dims), level.planes.device)
    k = level.planes.shape[0]
    p3 = F.pad(level.planes.reshape(k, gz, gy, gx),
               (0, 2 * cgx - gx, 0, 2 * cgy - gy, 0, 2 * cgz - gz))
    # rows k*8 + pz*4 + py*2 + px: the parity slices of every plane
    par = p3.reshape(k, cgz, 2, cgy, 2, cgx, 2).permute(0, 2, 4, 6, 1, 3, 5)
    par = par.reshape(k * 8, cgz * cgy * cgx)
    src = torch.cat([par, par.new_zeros((1, par.shape[1]))])
    planes = src[table].sum(1)
    return ScalarDIALevel(
        planes=planes,
        inv_diag=_guarded_inverse(planes[offs.index(0)]),
        offsets=offs,
        dims=(cgx, cgy, cgz),
    )


def build_hierarchy(
    planes: torch.Tensor,
    offsets: tuple,
    dims: tuple,
    diag_override: torch.Tensor | None = None,
    min_nodes: int = 1024,
    max_levels: int = 8,
    shard_z: bool = False,
) -> tuple[ScalarDIALevel, ...]:
    """The level tuple from the fine (K, N) stencil (mg.py:196-232):
    `diag_override` replaces the 0-offset plane; coarsening stops when a
    level has fewer than `min_nodes` rows or the grid can no longer
    halve."""
    if shard_z:
        _refuse_sharded("build_hierarchy(shard_z=True)")
    d0 = offsets.index(0)
    if diag_override is not None:
        planes = planes.clone()
        planes[d0] = diag_override
    levels = [ScalarDIALevel(planes=planes, inv_diag=_guarded_inverse(planes[d0]),
                             offsets=tuple(offsets), dims=tuple(dims))]
    while len(levels) < max_levels:
        lv = levels[-1]
        if lv.planes.shape[1] < min_nodes or max(lv.dims) < 3:
            break
        levels.append(_galerkin_coarsen(lv))
    return tuple(levels)


def _restrict(r: torch.Tensor, dims) -> torch.Tensor:
    """Aggregate sums (P^T) onto the 2x coarser grid."""
    gx, gy, gz = dims
    cgx, cgy, cgz = _coarse_dims(dims)
    r3 = F.pad(r.reshape(gz, gy, gx), (0, 2 * cgx - gx, 0, 2 * cgy - gy, 0, 2 * cgz - gz))
    return r3.reshape(cgz, 2, cgy, 2, cgx, 2).sum((1, 3, 5)).reshape(-1)


def _prolong(xc: torch.Tensor, dims) -> torch.Tensor:
    """Piecewise-constant injection (P) back to the finer grid."""
    gx, gy, gz = dims
    cgx, cgy, cgz = _coarse_dims(dims)
    x6 = xc.reshape(cgz, 1, cgy, 1, cgx, 1).expand(cgz, 2, cgy, 2, cgx, 2)
    return x6.reshape(2 * cgz, 2 * cgy, 2 * cgx)[:gz, :gy, :gx].reshape(-1)


def vcycle(levels: tuple, r: torch.Tensor, li: int = 0, omega: float = 0.85,
           coarse_sweeps: int = 12, axis=None) -> torch.Tensor:
    """One V(1,1) cycle for A x = r at level li from x = 0 (mg.py:257-290)."""
    if axis is not None:
        _refuse_sharded("vcycle(axis=...)")
    lv = levels[li]
    w = omega * lv.inv_diag
    if li == len(levels) - 1:
        x = w * r
        for _ in range(coarse_sweeps - 1):
            x = x + w * (r - lv.matvec(x))
        return x
    x = w * r  # pre-smooth, one damped-Jacobi sweep from zero
    xc = vcycle(levels, _restrict(r - lv.matvec(x), lv.dims), li + 1, omega, coarse_sweeps)
    x = x + _prolong(xc, lv.dims)
    return x + w * (r - lv.matvec(x))  # post-smooth


@dataclass
class MGSIMPLEPCT:
    """SIMPLE pressure-Schur preconditioner with a multigrid Schur solve on
    (6, N) vectors (counterpart of dedflow_tpu/solver/mg.py::MGSIMPLEPCT,
    unsharded; see the module docstring)."""

    bands: object  # sparse.fsbsr.SchurBandsT
    levels: tuple  # ScalarDIALevel hierarchy
    inv_vel_rows: torch.Tensor  # (9, N)
    inv_phi_diag: torch.Tensor  # (N,)
    inv_t_diag: torch.Tensor  # (N,)
    outer: int = 2
    omega: float = 0.85

    @staticmethod
    def from_matrix(mat, dims: tuple | None, outer: int = 2, omega: float = 0.85,
                    min_nodes: int = 1024, shard=None) -> "MGSIMPLEPCT":
        """dims = (gx, gy, gz), or None to infer it from the DIA offsets
        (ValueError when that fails); mat = FSDIAMatrixT. The hierarchy is
        built on the plain A_pp stencil: the JAX package measured the exact
        S_hat diagonal as the fine diagonal to wreck the cycle (111 against
        24 GMRES iterations, mg.py:372-376)."""
        if shard is not None:
            _refuse_sharded("MGSIMPLEPCT.from_matrix(shard=...)")
        base = NSFieldSplitPCT.from_diag_rows(mat.diag_rows())
        n = mat.num_rows
        if dims is None:
            dims = infer_dims(mat.offsets, n)
            if dims is None:
                raise ValueError(
                    "MGSIMPLEPCT: node grid could not be inferred from "
                    f"the DIA offsets {mat.offsets} at {n} rows"
                )
        assert n == dims[0] * dims[1] * dims[2], f"grid {dims} does not match {n} pressure rows"
        bands = mat.schur_bands()
        return MGSIMPLEPCT(
            bands=bands,
            levels=build_hierarchy(bands.app, mat.offsets, dims, min_nodes=min_nodes),
            inv_vel_rows=base.inv_vel_rows,
            inv_phi_diag=base.inv_phi_diag,
            inv_t_diag=base.inv_t_diag,
            outer=outer,
            omega=omega,
        )

    def _schur_solve(self, rp: torch.Tensor) -> torch.Tensor:
        dp = vcycle(self.levels, rp, omega=self.omega)
        for _ in range(self.outer - 1):
            dp = dp + vcycle(self.levels, rp - schur_apply(self.bands, self.inv_vel_rows, dp),
                             omega=self.omega)
        return dp

    def __call__(self, x_t: torch.Tensor) -> torch.Tensor:
        return schur_split_apply(self.bands, self.inv_vel_rows, self.inv_phi_diag,
                                 self.inv_t_diag, x_t, self._schur_solve)
