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

With `own` (a rank's local submesh of an RCB partition, parallel.sharded:
its nodes [own | ghosts], its own rows first in the CSR), the plans keep
only the contributions to own targets, residual rows < own and matrix
entries < row_ptr[own]; the matrix is the own rows' CSR entries (their
columns index the whole local vector) and `mult_win` their static rows.
K8 and K9 then write only the rank's rows. The one-process context is
`own` = None, unchanged.

The scalar heat / Poisson slice (fem.heat) runs on the same context with
`scalar_plans=True`: `scatter_residual` and `scatter_matrix` (JAX
assembly.py:236, :281) sum (ne, 4, ...) element vectors into the nodes and
(ne, 4, 4, br, bc) element matrices into the CSR entries through K8
(`win_stream.stream_reduce`) and K9 (`win_ring.ring_reduce`), one output
row a trailing component, over the same sorted tables
(`scatter_permutation`) as the NS plans, taken as they are: the source of
a contribution is its flat (e, slot) index p = e*4 + a or e*16 + ab, the
JAX context's node_perm / mat_perm. One trailing component (every solver
path) is read where the element array lies, with no copy, by the
kernels' one-pass route (csrc/seg_reduce.cu, `dedflow_gather_sum`: no
staging buffer). C > 1 (tests only) passes a transposed (C, slots*ne)
copy, row c at c*slots*ne + p, and is the only route that still stages.
`gather_nodal` and `bsr_from_data` (JAX :409, :403) give the element
gathers and the BSR matrix on the CSR entries.

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
from dedflow_tpu_torch.sparse.bsr import BSRMatrix
from dedflow_tpu_torch.sparse.topology import Sparsity, build_sparsity, scatter_permutation
from dedflow_tpu_torch.sparse.win_ring import ring_reduce
from dedflow_tpu_torch.sparse.win_stream import (
    ReducePlan,
    reduce_plan_from_sorted,
    stream_reduce,
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
    res_plan: ReducePlan  # (e, a) -> node; source a*6*m + (e - lo), m = hi - lo; with elem_pos
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
    win_plan: WinPlan  # the matrix's CSR entries (with `own`, the own rows')
    num_node: int  # the rows assembled: every node, or the `own` ones
    num_elem: int  # padded to a multiple of the assembly chunk
    # the CPU element body: "xla" fem.weakform, "pallas" the K4/K5 plain
    # twins (CUDA always runs K4/K5)
    elements_kernel: str = "xla"
    # the scalar plans (build_context(scalar_plans=True)): (e, a) -> node
    # with source e*4 + a, and (e, ab) -> entry with source e*16 + ab (the
    # JAX context's node_perm / mat_perm)
    scalar_res_plan: ReducePlan | None = None
    scalar_jac_plan: ReducePlan | None = None


def build_context(
    mesh: Mesh, sparsity: Sparsity | None = None, device="cuda", dtype=None,
    chunk: int | None = None, scatter_method: str = "segment", elements_kernel: str = "xla",
    scalar_plans: bool = False, own: int | None = None,
) -> FEMContext:
    """The general gather tier's context, on the card unless `device`
    says otherwise (dtype: the device's default). Every `scatter_method`
    name selects the one reduce; an unknown name raises. `scalar_plans`
    adds the scalar scatters' plans (fem.heat). `own` restricts the plans
    and the matrix to the first `own` rows (a rank's local submesh)."""
    if scatter_method not in SCATTER_METHODS:
        raise ValueError(f"scatter_method must be one of {SCATTER_METHODS}, got {scatter_method!r}")
    if elements_kernel not in ELEMENTS_KERNELS:
        raise ValueError(f"elements_kernel must be one of {ELEMENTS_KERNELS}, got {elements_kernel!r}")
    if chunk is not None and chunk < 1:
        raise ValueError(f"assembly chunk must be positive, got {chunk}")
    if mesh.num_tet == 0:
        raise ValueError("the gather tier assembles tets: the mesh has none")
    if own is not None and scalar_plans:
        raise ValueError("scalar plans are whole-mesh plans: build them without `own`")
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    if sparsity is None:
        sparsity = build_sparsity(mesh.ien, mesh.num_node, extra_ien=mesh.extra_cells)
    ien = np.asarray(mesh.ien, dtype=np.int64)
    elem_nnz = np.asarray(sparsity.elem_nnz, dtype=np.int64).reshape(-1, 16)
    ne_real = ien.shape[0]
    n = mesh.num_node if own is None else int(own)
    ne = ne_real if chunk is None else -(-ne_real // chunk) * chunk
    ien_pad = np.concatenate([ien, np.zeros((ne - ne_real, 4), dtype=np.int64)])
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    ien_t = torch.as_tensor(np.ascontiguousarray(ien_pad.T), dtype=torch.int32, device=device)
    geom = tet_geometry(xg[ien_t.T.long()])
    s_own = int(sparsity.row_ptr[n])  # the own rows' entries come first
    win_plan = build_winell_plan(sparsity.row_ptr[: n + 1], sparsity.col_ind[:s_own], n, device)

    # node_perm, node_targets and mat_perm, mat_targets (assembly.py:120-121),
    # their sorted targets cut to the rows assembled
    node_plan = _own_targets(*scatter_permutation(ien), n)
    mat_plan = _own_targets(*scatter_permutation(elem_nnz), s_own)
    width = ne if chunk is None else chunk
    ranges = []
    for lo in range(0, ne_real, width):
        hi = min(lo + width, ne_real)  # pad elements contribute exact zeros: no plan entries
        res_plan, res_tgt = _range_plan(*node_plan, 4, 6, lo, hi, width, n, chunk, device)
        res_plan = with_element_positions(res_plan, width, 4, 6)  # the staged K4's rows
        jac_plan, jac_tgt = _range_plan(*mat_plan, 16, 18, lo, hi, width, win_plan.S, chunk, device)
        jac_plan = with_element_positions(jac_plan, width, 16, 18)  # the staged K5's rows
        ranges.append(ElementRange(lo, lo + width, res_plan, jac_plan, res_tgt, jac_tgt))
    scalar = (None, None)
    if scalar_plans:  # whole-mesh plans over the real elements: source = flat (e, slot) index
        scalar = (reduce_plan_from_sorted(node_plan[1], node_plan[0], n, device),
                  reduce_plan_from_sorted(mat_plan[1], mat_plan[0], win_plan.S, device))
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
        scalar_res_plan=scalar[0],
        scalar_jac_plan=scalar[1],
    )


def _own_targets(perm, tgt, num_tgt: int) -> tuple:
    """A sorted plan's contributions to targets below num_tgt (a prefix)."""
    k = int(np.searchsorted(tgt, num_tgt))
    return perm[:k], tgt[:k]


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


def _scalar_plan(ctx: FEMContext, which: str) -> ReducePlan:
    plan = getattr(ctx, f"scalar_{which}_plan")
    if plan is None:
        raise ValueError("the context has no scalar plans: build_context(..., scalar_plans=True)")
    return plan


def _component_rows(elem: torch.Tensor, slots: int, m: int) -> torch.Tensor:
    """(C, slots * m): row c holds trailing component c of every flat
    (e, slot), so the plan's source p reads it at c * slots * m + p. With
    one component that is the element array as it lies (a (1, M) view is
    contiguous: no copy); with more, a transposed copy."""
    return elem.reshape(slots * m, -1).T.contiguous()


def scatter_residual(ctx: FEMContext, elem_f: torch.Tensor) -> torch.Tensor:
    """(ne, 4, ...) element vectors -> (N, ...) nodal sums, up to 8 trailing
    components: K8 over the scalar residual plan, a deterministic sum in
    the plan's order (JAX assembly.py:236, a sorted segment sum)."""
    m, trail = ctx.num_elem, elem_f.shape[2:]
    out = stream_reduce(_scalar_plan(ctx, "res"), _component_rows(elem_f, 4, m))  # (C, N)
    return out.T.reshape((ctx.num_node,) + trail)


def scatter_matrix(ctx: FEMContext, elem_j: torch.Tensor) -> torch.Tensor:
    """(ne, 4, 4, br, bc) element matrices -> (nnz, br, bc) BSR data on the
    CSR entries, br * bc <= 16: K9 over the scalar matrix plan (JAX
    assembly.py:281)."""
    br, bc = elem_j.shape[-2:]
    out = ring_reduce(_scalar_plan(ctx, "jac"), _component_rows(elem_j, 16, ctx.num_elem))
    return out.T.reshape(-1, br, bc)  # out: (br * bc, nnz)


def bsr_from_data(ctx: FEMContext, data: torch.Tensor) -> BSRMatrix:
    """The BSR matrix of (nnz, br, bc) data on the context's CSR entries."""
    wp = ctx.win_plan
    return BSRMatrix(data=data, col_ind=wp.col_t, row_ids=wp.grow_t, diag_idx=wp.diag_t,
                     row_ptr=wp.row_ptr_t.long())


def gather_nodal(ctx: FEMContext, x: torch.Tensor) -> torch.Tensor:
    """(N, ...) nodal values -> (ne, 4, ...) element gathers
    (LoadElementValueKernel, assemble.cu:135-154)."""
    return x[ctx.ien_t.T.long()]
