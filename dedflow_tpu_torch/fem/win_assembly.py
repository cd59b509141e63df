"""Irregular-mesh (Delaunay-class) assembly on the WinELL tier
(counterpart of dedflow_tpu/fem/win_assembly.py).

The tier for meshes with no translation structure. The mesh is
RCM-reordered with its elements sorted by their minimum node
(mesh.reorder), so each element's nodes, and each target's contributions,
lie close together in memory.

  residual F:  K10 `win_gather`: the 19 geometry rows and the alpha
               states (and the heat source) of each element's 4 nodes,
               read node-major where they lie, into the (67, ne) input
               rows in one pass -> K6 `res_rows_call` -> (24, ne) rows
               a*6+c -> K8 `stream_reduce`: 4 contributions per element
               into the (6, N) nodes, read where K6 left them.
  jacobian J:  K10: the nodal velocities into rows 12-23 of the context's
               persistent (33, ne) input buffer, whose geometry rows are
               written once -> K6 staged, `lhs_rows_staged` on its first
               27 rows: each element's 16 contributions
               straight into K9's (K, 16) staging rows at their plan
               positions, in WinELL component order -> K9's segment sum
               `ring_reduce_staged`: the 16 velocity/pressure rows of the
               WinELL entries (sparse.winell); the phi/T identity rows are
               the static nodal multiplicity. With scalar_implicit
               (melt-pool runs) K6 reads all 33 rows (the 6 metric rows
               last), also stores the phi/T transport tangents into a (K, 8)
               staging buffer, and a second segment sum adds those.
  SpMV:        K7 `WinELLMatrixT.matvec_t` (sparse.win_kernels).
  pc="mg":     with `with_amg` the context carries the pattern-only
               algebraic-multigrid hierarchy of solver.amg (`build_win_amg`)
               that AMGSchurPCT reuses at every assembly.

Weak-BC facet terms ride the port's deterministic slot plans: the facet
residual through the node plan of fem.face, the facet Jacobian through
the compact per-boundary entry plan `attach_face_win_plans` builds.

The JAX module's TPU memory workarounds are not carried over: the (K, 16)
staging rows of 1.18M tets take 1.21 GB (the JAX package's (288, ne)
element output would be 1.36 GB), which an 80 GB card holds whole, so
there is no element-kernel chunking
(win_assembly.py:74-78, 485-498), no fallback from the ring plan to the
pull path for lack of SMEM (:242-250) and no edge-replicated pad columns
(:524-528). Every `win_jac_scatter` option ("ring", "pull", "stream",
"segment") runs the same reduce and gives the same result. The element
rows always come through K10, which the JAX package keeps opt-in
(`with_win_gather`, win_assembly.py:295-303) because its TPU kernel
measured slower than XLA's gather; on the card K10 is the faster gather,
and it needs no window schedule (`GatherPlan`, win_gather.py:42-72).
Nor are the JAX module's (14, N) state table and concatenations
(win_assembly.py:371-380, :450-471) made: K10 reads the node-major states
where they lie and writes the rows where K6 reads them. The Jacobian's
input is the context's persistent (33, ne) buffer (`jac_in`); the
residual's is a fresh (67, ne) array a call, geometry copied in by K10,
because a persistent one would keep its 48 state rows (227 MB at 1.18M
tets) alive through the Jacobian's (K, 16) staging buffer, the tier's
peak of device memory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem.element import tet_geometry
from dedflow_tpu_torch.fem.element_kernels import JAC_COMPS, lhs_rows_staged, res_rows_call
from dedflow_tpu_torch.fem.element_rows import lhs_geom_rows, res_geom_rows
from dedflow_tpu_torch.fem.face import (
    face_lhs_packed,
    face_residual_elements,
    face_residual_scatter,
    gather_sum,
    slot_plan,
)
from dedflow_tpu_torch.sparse.topology import Sparsity
from dedflow_tpu_torch.sparse.win_gather import win_gather
from dedflow_tpu_torch.sparse.win_ring import ring_reduce_staged
from dedflow_tpu_torch.sparse.win_stream import (
    ReducePlan,
    build_reduce_plan,
    stream_reduce,
    with_element_positions,
)
from dedflow_tpu_torch.sparse.winell import WinELLMatrixT, WinPlan, build_winell_plan
from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device

JAC_SCATTERS = ("ring", "pull", "stream", "segment")


@dataclass
class WinAssemblyContext:
    """Device tables and plans of the windowed irregular tier."""

    res_geom: torch.Tensor  # (19, ne) element_rows.res_geom_rows
    # (33, ne) K6 Jacobian input: lhs_geom_rows' 12 shape-gradient rows, K10's
    # 12 velocity rows (rewritten by every jacobian_inputs call), det, gg, tr
    # and the 6 metric rows of res_geom (the implicit mode's)
    jac_in: torch.Tensor
    ien_t: torch.Tensor  # (4, ne) int32
    # residual reduce: contribution (e, a) -> node ien[e, a], source a*6*ne + e
    res_plan: ReducePlan
    # jacobian reduce: contribution (e, ab) -> its entry, source ab*18*ne + e,
    # with the staged K6's element positions
    jac_plan: ReducePlan
    mult_win: torch.Tensor  # (2, S) static phi-phi / T-T rows (frozen mode)
    win_plan: WinPlan
    num_node: int
    num_elem: int
    # algebraic-multigrid plan for pc="mg" (solver.amg.AMGIndices) and the
    # entry of each CSR entry (the identity here: entries are CSR-ordered)
    amg_idx: object | None = None
    amg_eon: torch.Tensor | None = None


def jacobian_buffer(lhs_geom: torch.Tensor, res_geom: torch.Tensor) -> torch.Tensor:
    """The (33, ne) Jacobian input buffer with its geometry rows (the
    velocity rows 12-23 zero until K10 writes them)."""
    buf = torch.zeros((33, lhs_geom.shape[1]), dtype=lhs_geom.dtype, device=lhs_geom.device)
    buf[:12], buf[24:27], buf[27:33] = lhs_geom[:12], lhs_geom[12:15], res_geom[13:19]
    return buf


def build_win_amg(sparsity: Sparsity, win_plan: WinPlan, n: int, min_nodes: int = 2048,
                  device="cuda"):
    """(amg_idx, amg_eon) for pc="mg" on the WinELL tier (win_assembly.py:165
    of the JAX package): the pattern-only solver.amg hierarchy over the
    nodal sparsity, and the entry of each CSR entry (the level-0 value
    gather)."""
    from dedflow_tpu_torch.solver.amg import AMGIndices, build_amg_plan

    rp = np.asarray(sparsity.row_ptr, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    plans = build_amg_plan(rows, sparsity.col_ind, n, min_nodes=min_nodes)
    amg_eon = torch.as_tensor(win_plan.entry_of_nnz, dtype=torch.long, device=device)
    return AMGIndices.from_plan(plans, device), amg_eon


def build_win_context(
    mesh, sparsity: Sparsity, device="cuda", dtype=None, jac_scatter: str = "ring",
    with_amg: bool = False, amg_min_nodes: int = 2048,
) -> WinAssemblyContext:
    """`mesh` is expected RCM-reordered with elements sorted by min node
    (mesh.reorder.reorder_mesh); `sparsity` = build_sparsity(mesh.ien, N).
    On the card unless `device` says otherwise; the dtype defaults to the
    device's (utils.dtypes.default_dtype). `with_amg` builds the AMG plan
    of pc="mg" (NSSolver sets it, as the JAX package's does)."""
    if jac_scatter not in JAC_SCATTERS:
        raise ValueError(f"win_jac_scatter must be one of {JAC_SCATTERS}, got {jac_scatter!r}")
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    ien = np.asarray(mesh.ien, dtype=np.int64)
    ne, n = ien.shape[0], mesh.num_node
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    ien_t = torch.as_tensor(np.ascontiguousarray(ien.T), dtype=torch.int32, device=device)
    geom = tet_geometry(xg[ien_t.T.long()])
    win_plan = build_winell_plan(sparsity.row_ptr, sparsity.col_ind, n, device)

    e = np.arange(ne, dtype=np.int64)
    res_plan = build_reduce_plan(
        ien.T.reshape(-1), (np.arange(4)[:, None] * 6 * ne + e).reshape(-1), n, device
    )
    elem_nnz = np.asarray(sparsity.elem_nnz, dtype=np.int64).reshape(ne, 16)
    jac_plan = with_element_positions(build_reduce_plan(
        win_plan.entry_of_nnz[elem_nnz].reshape(-1),
        (e[:, None] + np.arange(16)[None, :] * 18 * ne).reshape(-1),
        win_plan.S, device,
    ), ne, 16, 18)
    amg_idx = amg_eon = None
    if with_amg:
        amg_idx, amg_eon = build_win_amg(sparsity, win_plan, n, amg_min_nodes, device)
    res_geom = res_geom_rows(geom.shgrad, geom.det_j, geom.metric).contiguous()
    return WinAssemblyContext(
        res_geom=res_geom,
        jac_in=jacobian_buffer(lhs_geom_rows(geom.shgrad, geom.det_j, geom.metric), res_geom),
        ien_t=ien_t,
        res_plan=res_plan,
        jac_plan=jac_plan,
        mult_win=identity_rows(ien, win_plan, dtype, device),
        win_plan=win_plan,
        num_node=n,
        num_elem=ne,
        amg_idx=amg_idx,
        amg_eon=amg_eon,
    )


def identity_rows(ien, win_plan: WinPlan, dtype, device) -> torch.Tensor:
    """(2, S) static phi-phi / T-T rows of the frozen mode: the nodal tet
    multiplicity at the diagonal entries (assemble.cu:757-758), of the
    plan's rows (a rank's own rows: every tet of an own node is local)."""
    n = win_plan.num_node
    mult = np.bincount(np.asarray(ien, dtype=np.int64).ravel(), minlength=n)[:n]
    mw = np.zeros((2, win_plan.S))
    mw[:, win_plan.diag_entry] = mult[None, :]
    return torch.as_tensor(mw, dtype=dtype, device=device)


def attach_face_win_plans(face_ctxs: tuple, sparsity: Sparsity, win_plan: WinPlan) -> tuple:
    """The facet contexts with their WinELL entry plans: each facet
    contribution (f, a, b) goes to the parent element's entry of the pair
    (a, b); per unique entry of the boundary (`win_uniq`) a slot plan
    lists its sources, so the facet Jacobian costs O(boundary), not
    O(matrix). A plan of the first rows of `sparsity` (a rank's own rows,
    fem.assembly.build_context's `own`) keeps the entries of those rows."""
    elem_nnz = np.asarray(sparsity.elem_nnz, dtype=np.int64).reshape(-1, 16)
    out = []
    for fctx in face_ctxs:
        nnz = elem_nnz[fctx.f2e].reshape(-1)
        live = nnz < win_plan.S
        uniq, inv = np.unique(win_plan.entry_of_nnz[nnz[live]], return_inverse=True)
        tgt = np.full(nnz.size, -1, dtype=np.int64)
        tgt[live] = inv.reshape(-1)
        dev = fctx.ien.device
        out.append(dataclasses.replace(
            fctx,
            win_slots=torch.as_tensor(slot_plan(tgt, uniq.size), device=dev),
            win_uniq=torch.as_tensor(uniq, dtype=torch.long, device=dev),
        ))
    return tuple(out)


def residual_inputs(ctx: WinAssemblyContext, w_alpha, dw_alpha, source=None) -> torch.Tensor:
    """(67, ne) K6 residual input rows, a fresh array: the geometry, then
    the element nodes' u, du (rows i*4+a), p (dw_alpha slot 3), phi, T,
    dphi, dT and the heat source `source` (N,) (zero without one), all
    written by one K10 launch with the residual's row map from the
    node-major (N, 6) states."""
    out = torch.empty((67, ctx.num_elem), dtype=ctx.res_geom.dtype, device=ctx.res_geom.device)
    return win_gather(ctx.ien_t, out, 19, w_alpha, dw_alpha, source, geom=ctx.res_geom)


def jacobian_inputs(ctx: WinAssemblyContext, w_alpha, scalar_implicit: bool = False) -> torch.Tensor:
    """(27, ne) K6 Jacobian input rows: shape gradients, the element
    nodes' velocity (rows i*4+a, written by K10 with the Jacobian's row map
    from the node-major (N, 6) w_alpha), det, gg, tr; (33, ne) with
    `scalar_implicit`, the 6 metric rows of the residual geometry appended
    (win_assembly.py:467-471). A view of the context's `jac_in`: the next
    call overwrites its velocity rows, in stream order, so a caller that
    keeps it across calls must clone it."""
    win_gather(ctx.ien_t, ctx.jac_in, 12, w_alpha)
    return ctx.jac_in if scalar_implicit else ctx.jac_in[:27]


def residual_win(
    ctx: WinAssemblyContext, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme,
    face_ctxs=(), source=None,
) -> torch.Tensor:
    """(6, N) residual: volume terms (K6 + K8) plus the weak-BC facet
    terms (assemble.cu:1068-1126) of `face_ctxs`. States are (N, 6),
    `source` the (N,) nodal heat source or None."""
    out24 = res_rows_call(residual_inputs(ctx, w_alpha, dw_alpha, source), phys, scheme)
    f = stream_reduce(ctx.res_plan, out24, comps=range(6), cstride=ctx.num_elem)
    for fctx in face_ctxs:
        face_residual_scatter(fctx, f, face_residual_elements(fctx, w_alpha, dw_alpha, phys))
    return f


def jacobian_win(
    ctx: WinAssemblyContext, w_alpha, phys: Physics, scheme: TimeScheme,
    dw_alpha=None, face_ctxs=(), scalar_implicit: bool = False,
) -> WinELLMatrixT:
    """WinELL field-split Jacobian: the element Jacobian (K6 staged) reduced
    into the entries (K9's segment sum), the phi/T rows, and the weak-BC
    facet blocks (assemble.cu:1127-1193) through the plans of
    attach_face_win_plans. The phi/T rows are the static identities
    (frozen-scalar mode) or, with `scalar_implicit`, the transport tangents
    of K6's 33-row mode, reduced by a second segment sum
    (win_assembly.py:540-556)."""
    inp = jacobian_inputs(ctx, w_alpha, scalar_implicit)
    ent = reduce_entries(ctx.jac_plan, *lhs_rows_staged(inp, phys, scheme, ctx.jac_plan,
                                                         scalar_implicit))
    vals = ent if scalar_implicit else torch.cat([ent, ctx.mult_win.to(ent.dtype)])
    add_face_entries(vals, face_ctxs, w_alpha, dw_alpha, phys, scheme)
    return WinELLMatrixT(vals=vals, plan=ctx.win_plan)


def reduce_entries(plan: ReducePlan, stage, tang=None) -> torch.Tensor:
    """K9's segment sum over the staging rows of the element Jacobian (the
    staged K5/K6, or element_kernels.stage_rows): the (16, S)
    velocity/pressure entry rows in WinELL order, and with the tangents'
    rows `tang` the phi-phi / T-T rows 16/17 from a second, 2-row sum."""
    ent = ring_reduce_staged(plan, stage, 16)
    if tang is not None:
        ent = torch.cat([ent, ring_reduce_staged(plan, tang, 2)])
    return ent


def add_face_entries(vals, face_ctxs, w_alpha, dw_alpha, phys, scheme) -> None:
    """vals (18, S) += the weak-BC facet blocks (assemble.cu:1127-1193), in
    place, through the plans of attach_face_win_plans."""
    for fctx in face_ctxs:
        if fctx.win_uniq is None:
            raise ValueError(
                "face context lacks a WinELL plan: call attach_face_win_plans at setup"
            )
        upd = face_lhs_packed(fctx, w_alpha, dw_alpha, phys, scheme)  # (nf*16, 18)
        compact = gather_sum(fctx.win_slots, upd)  # (nu, 18) fsbsr comps
        vals[:16, fctx.win_uniq] += compact[:, list(JAC_COMPS)].T  # unique entries
