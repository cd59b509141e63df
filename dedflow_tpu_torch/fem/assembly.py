"""The general gather tier's context: hoisted geometry and deterministic
reduce plans (counterpart of dedflow_tpu/fem/assembly.py).

The tier for any tet mesh, in any node order: each element gathers its
nodes' states (K4/K5, fem.element_kernels), and sorted reduce plans sum
the element contributions into the nodes (residual) and into the matrix
entries (Jacobian), with no coloring and no atomics, as in the JAX
package (assembly.py:1-17).

- The geometry is a constant of the mesh, hoisted once into the kernels'
  static rows: `res_geom` (19, ne) and `lhs_geom` (15, ne)
  (pallas_kernels.py:238, :449). The weak form's per-element view
  (`elem_geom`) is read back from them.
- The residual plan is the JAX `node_perm` / `node_targets` (the stable
  sort of the flat (e, a) -> node map) and the matrix plan its `mat_perm`
  / `mat_targets` (the same for (e, ab) -> CSR nonzero), both carried as
  the port's ReducePlan over the element kernels' output rows: the
  contribution (e, a) reads (24, ne) row a*6+c at column e, (e, ab) the
  (288, ne) row ab*18+c. The matrix lives on the CSR entries of
  sparse.winell (FSBSRMatrix's ELL padding exists to avoid TPU gathers,
  fsbsr.py:11-22, and is not carried over).
- With `chunk`, element arrays are zero-padded to a multiple of it
  (assembly.py:108-116): pad elements are all-node-0 and degenerate, so
  every contribution they make is exactly zero. Each element range
  [lo, lo + chunk) then carries its own plans over the nodes and entries
  it touches (`ElementRange`), and fem.ns runs the ranges in turn through
  the same kernels and the same reduce.

Not carried over (TPU layouts; sparse/tiered.py:1-30 says why they exist):
the grouped gather plan, the prefix-scan offsets, the one-hot DIA planes
and the degree-tiered plan (assembly.py:134-191). Their `scatter_method`
names ("segment", "prefix", "grouped", "tiered") all select the one
reduce here, and a lattice mesh's DIA-detected matrix is the same
operator on the same CSR entries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.fem.element import tet_geometry
from dedflow_tpu_torch.fem.element_rows import lhs_geom_rows, res_geom_rows
from dedflow_tpu_torch.fem.weakform import ElemGeom
from dedflow_tpu_torch.fem.win_assembly import identity_rows
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.sparse.topology import Sparsity, build_sparsity, scatter_permutation
from dedflow_tpu_torch.sparse.win_stream import (
    ReducePlan,
    reduce_plan_from_sorted,
    with_element_positions,
)
from dedflow_tpu_torch.sparse.winell import WinPlan, build_winell_plan
from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device

SCATTER_METHODS = ("segment", "prefix", "grouped", "tiered")
ELEMENTS_KERNELS = ("xla", "pallas")


@dataclass
class ElementRange:
    """Elements [lo, hi) with their reduce plans. `res_tgt` / `jac_tgt`
    list the nodes / entries the plans' compact targets stand for (None:
    every node / entry, in order)."""

    lo: int
    hi: int
    res_plan: ReducePlan  # (e, a) -> node; source a*6*m + (e - lo), m = hi - lo
    jac_plan: ReducePlan  # (e, ab) -> entry; source ab*18*m + (e - lo); with elem_pos
    res_tgt: torch.Tensor | None = None
    jac_tgt: torch.Tensor | None = None


@dataclass
class FEMContext:
    """Device tables of the general gather tier."""

    res_geom: torch.Tensor  # (19, ne) element_rows.res_geom_rows
    lhs_geom: torch.Tensor  # (15, ne) element_rows.lhs_geom_rows
    ien_t: torch.Tensor  # (4, ne) int32
    ranges: tuple  # ElementRange per assembly chunk (one without chunking)
    mult_win: torch.Tensor  # (2, S) static phi-phi / T-T rows (frozen mode)
    win_plan: WinPlan  # the matrix's CSR entries
    num_node: int
    num_elem: int  # padded to a multiple of the assembly chunk
    # the CPU element body: "xla" fem.weakform, "pallas" the K4/K5 plain
    # twins (CUDA always runs K4/K5)
    elements_kernel: str = "xla"


def build_context(
    mesh: Mesh, sparsity: Sparsity | None = None, device="cuda", dtype=None,
    chunk: int | None = None, scatter_method: str = "segment", elements_kernel: str = "xla",
) -> FEMContext:
    """The general gather tier's context, on the card unless `device`
    says otherwise (dtype: the device's default). Every `scatter_method`
    name selects the one reduce; an unknown name raises."""
    if scatter_method not in SCATTER_METHODS:
        raise ValueError(f"scatter_method must be one of {SCATTER_METHODS}, got {scatter_method!r}")
    if elements_kernel not in ELEMENTS_KERNELS:
        raise ValueError(f"elements_kernel must be one of {ELEMENTS_KERNELS}, got {elements_kernel!r}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"assembly chunk must be positive, got {chunk}")
    if mesh.num_tet == 0:
        raise ValueError("the gather tier assembles tets: the mesh has none")
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if sparsity is None:
        sparsity = build_sparsity(mesh.ien, mesh.num_node)
    ien = np.asarray(mesh.ien, dtype=np.int64)
    elem_nnz = np.asarray(sparsity.elem_nnz, dtype=np.int64).reshape(-1, 16)
    ne_real, n = ien.shape[0], mesh.num_node
    ne = ne_real if chunk is None else -(-ne_real // chunk) * chunk
    ien_pad = np.concatenate([ien, np.zeros((ne - ne_real, 4), dtype=np.int64)])
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    ien_t = torch.as_tensor(np.ascontiguousarray(ien_pad.T), dtype=torch.int32, device=device)
    geom = tet_geometry(xg[ien_t.T.long()])
    win_plan = build_winell_plan(sparsity.row_ptr, sparsity.col_ind, n, device)

    node_plan = scatter_permutation(ien)  # node_perm, node_targets (assembly.py:120)
    mat_plan = scatter_permutation(elem_nnz)  # mat_perm, mat_targets (assembly.py:121)
    width = ne if chunk is None else chunk
    ranges = []
    for lo in range(0, ne_real, width):
        hi = min(lo + width, ne_real)  # pad elements contribute exact zeros: no plan entries
        res_plan, res_tgt = _range_plan(*node_plan, 4, 6, lo, hi, width, n, chunk, device)
        jac_plan, jac_tgt = _range_plan(*mat_plan, 16, 18, lo, hi, width, win_plan.S, chunk, device)
        jac_plan = with_element_positions(jac_plan, width, 16, 18)  # the staged K5's rows
        ranges.append(ElementRange(lo, lo + width, res_plan, jac_plan, res_tgt, jac_tgt))
    return FEMContext(
        res_geom=res_geom_rows(geom.shgrad, geom.det_j, geom.metric).contiguous(),
        lhs_geom=lhs_geom_rows(geom.shgrad, geom.det_j, geom.metric).contiguous(),
        ien_t=ien_t,
        ranges=tuple(ranges),
        mult_win=identity_rows(ien, win_plan, dtype, device),
        win_plan=win_plan,
        num_node=n,
        num_elem=ne,
        elements_kernel=elements_kernel,
    )


def _range_plan(perm, tgt, per, rows, lo, hi, width, num_tgt, chunk, device):
    """The plan of elements [lo, hi) cut from a whole-mesh sorted plan
    (perm over flat (e, slot) contributions, their targets tgt): the
    source of (e, slot) is row slot*rows + c, column e - lo, of the range's
    (per*rows, width) element rows. With a chunk, the plan runs over the
    range's own targets, returned beside it."""
    perm = perm.astype(np.int64)
    keep = (perm >= lo * per) & (perm < hi * per)
    t, p = tgt[keep], perm[keep]
    src = (p % per) * rows * width + (p // per - lo)
    if chunk is None:
        return reduce_plan_from_sorted(t, src, num_tgt, device), None
    uniq, inv = np.unique(t, return_inverse=True)
    return (reduce_plan_from_sorted(inv.reshape(-1), src, uniq.size, device),
            torch.as_tensor(uniq, dtype=torch.long, device=device))


def elem_geom(ctx: FEMContext, lo: int = 0, hi: int | None = None) -> ElemGeom:
    """The weak form's geometry of elements [lo, hi), read back from the
    static rows: shgrad (m, 4, 3), det_j (m,), metric (m, 3, 3)."""
    g = ctx.res_geom[:, lo:hi]
    m = g.shape[1]
    shgrad = g[:12].reshape(3, 4, m).permute(2, 1, 0)
    m00, m01, m02, m11, m12, m22 = g[13:19]
    metric = torch.stack([
        torch.stack([m00, m01, m02], -1),
        torch.stack([m01, m11, m12], -1),
        torch.stack([m02, m12, m22], -1),
    ], -2)
    return ElemGeom(shgrad=shgrad, det_j=g[12], metric=metric)
