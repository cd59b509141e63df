"""The general gather tier's system assembly: volume + weak boundary
terms + frozen rows + strong Dirichlet masking (counterpart of
dedflow_tpu/fem/ns.py::assemble_residual / assemble_jacobian).

  residual F:  K4 staged, `ns_residual_gather_staged`: each (element,
               vertex) pair's 6 components straight into K8's (K, 8)
               staging rows at their positions in the residual plan, from
               the node-major (N, 6) states -> K8's segment sum
               `stream_reduce_staged` into (6, N); the nodal momentum
               load, the facet terms, the frozen phi/T rows (main.c:64)
               and the mask.
  jacobian J:  K5 staged, `ns_lhs_gather_staged`: each element's 16
               contributions straight into K9's (K, 16) staging rows at
               their positions in the matrix plan -> K9's segment sum
               `ring_reduce_staged` into the CSR entries of a
               WinELLMatrixT (K7 is its SpMV); the static phi/T
               identities, the facet blocks and the mask. With
               scalar_implicit (melt-pool runs) K5 reads the 6 metric rows
               of the residual geometry and also stores the phi/T
               transport tangents into a (K, 8) staging buffer, which a
               second segment sum adds up; the JAX package computes this
               Jacobian in XLA (ns.py:184-235).

On the CPU the element pass is the weak form (fem.weakform) under
elements_kernel="xla" (its rows placed in the staging rows by
`stage_residual_rows` / `stage_rows`) and the staged K4/K5 plain twins
under "pallas"; on CUDA both run the staged K4/K5. The column K4
(`ns_residual_gather`, the JAX ns_residual_pallas's counterpart) and K8
with its staging pass run on no path here. States are (N, 6) as in the
JAX package; the residual is the port's component-major (6, N). With an
assembly chunk the context's element ranges run in turn through the same
kernels and the same reduce, each adding its sums into the nodes and
entries it touches (ns.py:60-98's streaming paths, deterministic: the
ranges' targets are unique).

A rank of an RCB partition (parallel.sharded) assembles on a
`PartContext`: the gather-tier context of its local submesh, built with
the own-target plans (fem.assembly.build_context's `own`), and its halo.
`assemble_residual_part` / `assemble_jacobian_part` exchange the ghost
nodes' alpha states (and the heat source) in one exchange, then run the
same kernels and reduces: K4 / K5 on every local element, K8 / K9 into
the own rows only. Its J is a sparse.winell.HaloWinELLMatrixT, whose
product exchanges the ghosts of x and runs K7's halo entry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem import weakform
from dedflow_tpu_torch.fem.assembly import FEMContext, elem_geom
from dedflow_tpu_torch.fem.element_kernels import (
    ns_lhs_gather_staged,
    ns_residual_gather_staged,
    stage_residual_rows,
    stage_rows,
)
from dedflow_tpu_torch.fem.face import face_residual_elements, face_residual_scatter
from dedflow_tpu_torch.fem.win_assembly import add_face_entries, reduce_entries
from dedflow_tpu_torch.sparse.win_stream import stream_reduce_staged
from dedflow_tpu_torch.sparse.winell import HaloWinELLMatrixT, WinELLMatrixT


def _xla_body(ctx: FEMContext, w_alpha) -> bool:
    """The CPU weak form (elements_kernel="xla") instead of K4/K5's path."""
    return ctx.elements_kernel == "xla" and not w_alpha.is_cuda


def _range_sum(out, tgt, part, num_tgt: int) -> torch.Tensor:
    """Add one element range's reduced sums (onto targets `tgt`, None =
    all in order) into `out`, which starts as None."""
    if tgt is None:
        return part
    if out is None:
        out = torch.zeros((part.shape[0], num_tgt), dtype=part.dtype, device=part.device)
    out[:, tgt] += part  # the range's targets are unique
    return out


def residual_volume(ctx: FEMContext, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme,
                    source=None) -> torch.Tensor:
    """(6, N) volume residual: the element residual of each range reduced
    into its nodes."""
    f = None
    w, dw = w_alpha.contiguous(), dw_alpha.contiguous()
    for rng in ctx.ranges:
        m = rng.hi - rng.lo
        ien_t = ctx.ien_t[:, rng.lo : rng.hi]
        if _xla_body(ctx, w_alpha):
            ef = weakform.gather_fields(ien_t.T, w_alpha, dw_alpha)
            src_e = None if source is None else source[ien_t.T.long()]
            fe = weakform.ns_residual_elements(
                elem_geom(ctx, rng.lo, rng.hi), ef, phys, scheme, src_e
            )
            stage = stage_residual_rows(rng.res_plan, fe.reshape(m, 24).T.contiguous())
        else:
            stage = ns_residual_gather_staged(
                ctx.res_geom[:, rng.lo : rng.hi], ien_t, w, dw, phys, scheme, rng.res_plan, source
            )
        f = _range_sum(f, rng.res_tgt, stream_reduce_staged(rng.res_plan, stage, 6), ctx.num_node)
    return f


def jacobian_entries(ctx: FEMContext, w_alpha, phys: Physics, scheme: TimeScheme,
                     scalar_implicit: bool = False) -> torch.Tensor:
    """(16, S) velocity/pressure entry values in WinELL row order: the
    element Jacobian of each range reduced into its entries; (18, S) with
    `scalar_implicit`, the phi-phi / T-T tangent rows last."""
    ent = None
    w_t = w_alpha.T.contiguous()
    for rng in ctx.ranges:
        m = rng.hi - rng.lo
        ien_t = ctx.ien_t[:, rng.lo : rng.hi]
        if _xla_body(ctx, w_alpha):
            ef = weakform.gather_fields(ien_t.T, w_alpha, w_alpha)  # the LHS reads u only
            upd = weakform.ns_lhs_packed(elem_geom(ctx, rng.lo, rng.hi), ef, phys, scheme,
                                         scalar_implicit)
            rows = upd.reshape(m, 288).T.contiguous()
            staged = stage_rows(rng.jac_plan, rows, scalar_implicit)
        else:
            metric = ctx.res_geom[13:19, rng.lo : rng.hi] if scalar_implicit else None
            staged = ns_lhs_gather_staged(ctx.lhs_geom[:, rng.lo : rng.hi], ien_t, w_t, phys,
                                          scheme, rng.jac_plan, metric)
        part = reduce_entries(rng.jac_plan, *staged)
        ent = _range_sum(ent, rng.jac_tgt, part, ctx.win_plan.S)
    return ent


def assemble_residual(
    ctx: FEMContext, face_ctxs, mask_t, w_alpha, dw_alpha, phys: Physics,
    scheme: TimeScheme, freeze_phi_temperature: bool = True, source=None, nodal_force=None,
) -> torch.Tensor:
    """Global residual F (6, N); `source` (N,) is a nodal volumetric heat
    source, `nodal_force` (N, 3) an integrated nodal momentum load."""
    f = residual_volume(ctx, w_alpha, dw_alpha, phys, scheme, source)
    if nodal_force is not None:
        f[:3] -= nodal_force.T
    for fctx in face_ctxs:
        face_residual_scatter(fctx, f, face_residual_elements(fctx, w_alpha, dw_alpha, phys))
    if freeze_phi_temperature:
        f[4:] = 0.0  # main.c:64
    return f.masked_fill(mask_t, 0.0)


def assemble_jacobian(
    ctx: FEMContext, face_ctxs, mask_t, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme,
    scalar_implicit: bool = False,
) -> WinELLMatrixT:
    """Global field-split Jacobian on the CSR entries, masked
    (dirichlet.c:47-61); the phi/T rows are the frozen identities or, with
    `scalar_implicit`, the consistent transport tangents."""
    ent = jacobian_entries(ctx, w_alpha, phys, scheme, scalar_implicit)
    vals = ent if scalar_implicit else torch.cat([ent, ctx.mult_win.to(ent.dtype)])
    add_face_entries(vals, face_ctxs, w_alpha, dw_alpha, phys, scheme)
    return WinELLMatrixT(vals=vals, plan=ctx.win_plan).zero_rows_t(mask_t)


@dataclass
class PartContext:
    """One rank's part of an RCB decomposition (parallel.sharded): `fem`
    the gather-tier context of its local submesh, nodes [own | ghosts],
    plans over its `n_own` rows; `comm` its parallel.spmd.HaloComm. Its
    vectors hold the own rows; every sum over the ranks goes through
    `comm`."""

    fem: FEMContext
    comm: object


def part_states(pctx: PartContext, w_alpha, dw_alpha, source=None) -> tuple:
    """The local (n_x, 6) alpha states and (n_x,) source of the rank's own
    rows: the ghosts' values from their owners, in one exchange."""
    rows = [w_alpha.T, dw_alpha.T] + ([] if source is None else [source[None]])
    x = pctx.comm.exchange(torch.cat(rows))
    return x[:6].T.contiguous(), x[6:12].T.contiguous(), None if source is None else x[12]


def _refuse_nodal_force(nodal_force) -> None:
    if nodal_force is not None:
        raise NotImplementedError("a nodal force on an RCB partition (the coupled solver sharded) "
                                  "is not ported yet (ROADMAP A16 (c))")


def assemble_residual_part(
    pctx: PartContext, face_ctxs, mask_t, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme,
    freeze_phi_temperature: bool = True, source=None, nodal_force=None,
) -> torch.Tensor:
    """The rank's own rows (6, n_own) of F; states and `source` are its own
    rows, `mask_t` (6, n_own)."""
    _refuse_nodal_force(nodal_force)
    wa, dwa, src = part_states(pctx, w_alpha, dw_alpha, source)
    return assemble_residual(pctx.fem, face_ctxs, mask_t, wa, dwa, phys, scheme,
                             freeze_phi_temperature, src)


def assemble_jacobian_part(
    pctx: PartContext, face_ctxs, mask_t, w_alpha, dw_alpha, phys: Physics, scheme: TimeScheme,
    scalar_implicit: bool = False,
) -> HaloWinELLMatrixT:
    """The rank's own rows of J, masked, as a HaloWinELLMatrixT."""
    wa, dwa, _ = part_states(pctx, w_alpha, dw_alpha)
    jm = assemble_jacobian(pctx.fem, face_ctxs, mask_t, wa, dwa, phys, scheme, scalar_implicit)
    return HaloWinELLMatrixT(vals=jm.vals, plan=jm.plan, halo=pctx.comm)
