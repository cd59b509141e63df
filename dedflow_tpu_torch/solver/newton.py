"""Newton + generalized-alpha time stepping, lattice tier (counterpart of
dedflow_tpu/solver/newton.py).

  predict:   dwg[vel,phi,T] *= (gamma-1)/gamma          (main.c:544-545)
  newton<=4: assemble J; GMRES(J) dx = F; dwg -= dx;
             rebuild alpha states; assemble F; converge
             when all 4 field rel-norms < 0.5e-3        (main.c:157-279)
  update:    wgold[vel,phi,T] += dt((1-g) dwgold + g dwg);
             dwgold = dwg                               (main.c:561-565)

Every assembly tier of the JAX package is ported, chosen by its ladder
(newton.py:560-672): the structured lattice of a box mesh, generated or
recovered from a file (fem.lattice, with the cells' own tet split), the
translation-class tier of a mesh without generator metadata
(fem.lattice.build_class_context), the windowed irregular tier
(fem.win_assembly) and the general gather tier (fem.assembly + fem.ns:
any mesh, any node order, and every `assembly_chunk` run). A mesh with
prism / hex tables (a converted mesh with a prism boundary layer) runs as
in the JAX package: only its tets are assembled, its mixed cells add
stencil entries (exact zeros in J), and the tier is the one whose stencil
holds them (`stencil_offsets`; the classes tier and lattice recovery
refuse such meshes). Every option
of the JAX package's Krylov layer runs (assemble_system, _solve_linear):
the field-split, SIMPLE and multigrid preconditioners (geometric on the
lattice, algebraic on WinELL), the linear solve in the state dtype, in
float64 or in float32 with float64 iterative refinement, and the lagged
Jacobian. Every tier takes a nodal
heat source (`source`, the moving laser of the melt-pool scenario) and the
implicit phi/T tangents (`implicit_scalars`), where the JAX package places
them (newton.py:57-222, 797-839). Every unported option raises
NotImplementedError naming the ROADMAP item that brings it; nothing
silently takes another path. The adaptive Newton loop reads the four field
norms to the host once per Newton iteration, the reference's own sync
granularity (main.c:262-265).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.config import SolverConfig
from dedflow_tpu_torch.fem import dirichlet as dbc
from dedflow_tpu_torch.fem import ns
from dedflow_tpu_torch.fem.assembly import FEMContext, build_context
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.fem.face import build_face_context
from dedflow_tpu_torch.fem.lattice import (
    LatticeContext,
    assemble_jacobian_t,
    assemble_residual_t,
    build_class_context,
    build_lattice_context,
    classes_tier_applies,
    field_norms_t,
    lattice_tables,
)
from dedflow_tpu_torch.fem.win_assembly import (
    WinAssemblyContext,
    attach_face_win_plans,
    build_win_context,
    jacobian_win,
    residual_win,
)
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.solver.amg import AMGSchurPCT
from dedflow_tpu_torch.solver.krylov import gmres
from dedflow_tpu_torch.solver.mg import MGSIMPLEPCT, infer_dims
from dedflow_tpu_torch.solver.pc import SIMPLEPC, SIMPLEPCT, NSFieldSplitPCT
from dedflow_tpu_torch.solver.refine import gmres_ir_device
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.sparse.win_stream import stream_window_counts
from dedflow_tpu_torch.utils.dtypes import cast_floats, default_dtype, disable_tf32, resolve_device

# ---------------------------------------------------------------------------
# stepping functions (contexts passed explicitly: a LatticeContext, a
# WinAssemblyContext or a FEMContext)


def residual(ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze,
             nodal_force=None, source=None):
    """(6, N) residual at the alpha states; `nodal_force` (N, 3) is a nodal
    momentum load subtracted from the momentum rows before freeze and
    mask (the JAX package's placement on every tier), `source` (N,) the
    nodal heat source of the T equation."""
    wa, dwa = alpha_states(wgold, dwgold, dwg, scheme)
    if isinstance(ctx, FEMContext):
        return ns.assemble_residual(
            ctx, face_ctxs, mask_t, wa, dwa, phys, scheme, freeze, source=source,
            nodal_force=nodal_force,
        )
    if isinstance(ctx, WinAssemblyContext):
        f = residual_win(ctx, wa, dwa, phys, scheme, face_ctxs, source)
        if nodal_force is not None:
            f[:3] -= nodal_force.T
        if freeze:
            f[4:] = 0.0  # main.c:64
        return f.masked_fill(mask_t, 0.0)
    return assemble_residual_t(
        ctx, face_ctxs, mask_t, wa, dwa, phys, scheme, freeze, nodal_force, source
    )


def assemble_system(ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme,
                    scalar_implicit=False, pc_type="fieldsplit", pc_sweeps=6, pc_omega=0.8,
                    pc_mg_outer=2):
    """The Jacobian and its preconditioner at the current state;
    `scalar_implicit` assembles the consistent phi/T tangents (a lattice
    context carries the flag it was built with, which must agree).

    `pc_type` picks the preconditioner per tier as the JAX package does
    (newton.py:90-218), with its fallbacks and warnings: "fieldsplit" the
    reference's block-Jacobi split everywhere; "simple" the SIMPLE
    pressure-Schur split on the lattice (SIMPLEPCT) and gather
    (SIMPLEPC) tiers, fieldsplit on WinELL; "mg" the multigrid Schur
    solve: geometric on the lattice (MGSIMPLEPCT; SIMPLE when no node grid
    can be found), algebraic on WinELL (AMGSchurPCT, with the context's AMG
    plan; fieldsplit without one), SIMPLE on the gather tier."""
    wa, dwa = alpha_states(wgold, dwgold, dwg, scheme)
    if isinstance(ctx, WinAssemblyContext):
        jmat = jacobian_win(
            ctx, wa, phys, scheme, dw_alpha=dwa, face_ctxs=face_ctxs,
            scalar_implicit=scalar_implicit,
        ).zero_rows_t(mask_t)
        if pc_type == "mg" and ctx.amg_idx is not None:
            return jmat, AMGSchurPCT.from_winell(jmat, ctx.amg_idx, ctx.amg_eon, outer=pc_mg_outer)
        if pc_type != "fieldsplit":
            warnings.warn(
                f"krylov.pc={pc_type!r} is not available on the windowed "
                "irregular path"
                + (" without an AMG plan (build_win_context with_amg)" if pc_type == "mg" else "")
                + "; using the fieldsplit (block-Jacobi) preconditioner",
                stacklevel=2,
            )
        return jmat, NSFieldSplitPCT.from_diag_rows(jmat.diag_rows())
    if isinstance(ctx, LatticeContext):
        if ctx.scalar_implicit != scalar_implicit:
            raise ValueError("scalar_implicit differs from the lattice context's")
        jmat = assemble_jacobian_t(ctx, face_ctxs, mask_t, wa, dwa, phys, scheme)
        dims = ctx.dims
        if pc_type == "mg" and dims is None:
            dims = infer_dims(ctx.offsets, ctx.num_node)
            if dims is None:
                warnings.warn(
                    "krylov.pc='mg' needs a structured node grid and none "
                    "could be inferred from the class stencil - falling "
                    "back to the SIMPLE preconditioner",
                    stacklevel=2,
                )
                pc_type = "simple"
        if pc_type == "mg":
            return jmat, MGSIMPLEPCT.from_matrix(jmat, dims=dims, outer=pc_mg_outer)
        if pc_type == "simple":
            return jmat, SIMPLEPCT.from_matrix(jmat, sweeps=pc_sweeps, omega=pc_omega)
        return jmat, NSFieldSplitPCT.from_diag_rows(jmat.diag_rows())
    jmat = ns.assemble_jacobian(ctx, face_ctxs, mask_t, wa, dwa, phys, scheme, scalar_implicit)
    if pc_type == "mg":
        warnings.warn(
            "krylov.pc='mg' requires the lattice fast path (structured "
            "node grid); falling back to the SIMPLE preconditioner",
            stacklevel=2,
        )
        pc_type = "simple"
    if pc_type == "simple":
        return jmat, SIMPLEPC.from_matrix(jmat, sweeps=pc_sweeps, omega=pc_omega)
    return jmat, NSFieldSplitPCT.from_diag_rows(jmat.diag_rows())


def _pc_kwargs(kcfg) -> dict:
    """assemble_system's preconditioner arguments from a KrylovConfig."""
    return dict(pc_type=kcfg.pc, pc_sweeps=kcfg.pc_schur_sweeps,
                pc_omega=kcfg.pc_schur_omega, pc_mg_outer=kcfg.pc_mg_outer)


def _solve_linear(jmat, pc, f, kcfg):
    """Right-preconditioned solve of J dx = F honoring kcfg.precision
    (newton.py:241-300 of the JAX package): "state" in the state dtype;
    "f64" the operator, the preconditioner and GMRES in float64; "ir"
    float32 GMRES with the float32 preconditioner inside float64 iterative
    refinement (solver.refine). Returns (dx, iters, rel_residual): for
    "ir" the inner iterations summed and the true float64 residual. The
    operator is cast by value (utils.dtypes.cast_floats): K3 and K7 take
    float32 and float64, so a cast matrix keeps its kernel."""
    prec = kcfg.precision
    if prec == "f64" and f.dtype != torch.float64:
        m64 = cast_floats(jmat, torch.float64)
        sol = gmres(
            m64.matvec_t, f.to(torch.float64), maxit=kcfg.max_iter, atol=kcfg.atol,
            rtol=kcfg.rtol, pc=cast_floats(pc, torch.float64), restart=kcfg.restart,
        )
        rel = sol.resnorm / torch.clamp(sol.resnorm0, min=1e-300)
        return sol.x.to(f.dtype), sol.iters, rel.to(f.dtype)
    if prec == "ir":
        m64 = cast_floats(jmat, torch.float64) if f.dtype != torch.float64 else jmat
        if f.dtype == torch.float32:
            mv_lo, pc_lo = jmat.matvec_t, pc
        else:
            mv_lo = cast_floats(jmat, torch.float32).matvec_t
            pc_lo = cast_floats(pc, torch.float32)
        sol = gmres_ir_device(
            m64.matvec_t, mv_lo, f.to(torch.float64), pc=pc_lo, tol=kcfg.ir_tol,
            max_cycles=kcfg.ir_cycles, inner_maxit=kcfg.max_iter,
            inner_rtol=kcfg.ir_inner_rtol,
        )
        return sol.x.to(f.dtype), sol.inner_iters, sol.rel_residual.to(f.dtype)
    sol = gmres(
        jmat.matvec_t, f, maxit=kcfg.max_iter, atol=kcfg.atol, rtol=kcfg.rtol,
        pc=pc, restart=kcfg.restart,
    )
    rel = sol.resnorm / torch.clamp(sol.resnorm0, min=torch.finfo(f.dtype).tiny)
    return sol.x, sol.iters, rel


def solve_update(
    ctx, face_ctxs, mask_t, jmat, pc, wgold, dwgold, dwg, f, phys, scheme, kcfg, freeze,
    nodal_force=None, source=None,
):
    """GMRES(J) dx = F; dwg -= dx; reassemble F (main.c:211-265)."""
    dx, iters, lin_rel = _solve_linear(jmat, pc, f, kcfg)
    dwg = dwg - dx.T
    f = residual(
        ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze, nodal_force, source
    )
    return dwg, f, field_norms_t(f), iters, lin_rel


def newton_iter(
    ctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg, freeze,
    nodal_force=None, source=None, scalar_implicit=False,
):
    """One Newton iteration: assemble J and the preconditioner kcfg names,
    solve, update dwg, reassemble F. Returns (dwg, f, field_norms,
    krylov_iters, linear_rel_residual)."""
    jmat, pc = assemble_system(
        ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, scalar_implicit,
        **_pc_kwargs(kcfg),
    )
    return solve_update(
        ctx, face_ctxs, mask_t, jmat, pc, wgold, dwgold, dwg, f, phys, scheme,
        kcfg, freeze, nodal_force, source,
    )


def predict(dwg, scheme):
    """Generalized-alpha same-rate predictor (main.c:544-545)."""
    fac = (scheme.gamma - 1.0) / scheme.gamma
    dwg = dwg.clone()
    dwg[:, :3] *= fac
    dwg[:, 4:] *= fac
    return dwg


def update(wgold, dwgold, dwg, scheme):
    """End-of-step state update (main.c:561-565); dwgold <- dwg."""
    g, dt = scheme.gamma, scheme.dt
    incr = dt * ((1.0 - g) * dwgold + g * dwg)
    wgold = wgold.clone()
    wgold[:, :3] += incr[:, :3]
    wgold[:, 4:] += incr[:, 4:]
    return wgold, dwg


def step_fixed(
    ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, kcfg, freeze,
    num_newton, nodal_force=None, source=None, scalar_implicit=False, lag_jacobian=False,
):
    """One time step with a fixed Newton iteration count; `lag_jacobian`
    assembles J and the preconditioner once, at the predicted state, and
    reuses them for every Newton iteration (newton.py:378-392 of the JAX
    package)."""
    dwg = predict(dwg, scheme)
    f = residual(
        ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze, nodal_force, source
    )
    lagged = None
    if lag_jacobian:
        lagged = assemble_system(
            ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, scalar_implicit,
            **_pc_kwargs(kcfg),
        )
    for _ in range(num_newton):
        if lagged is not None:
            dwg, f, _, _, _ = solve_update(
                ctx, face_ctxs, mask_t, *lagged, wgold, dwgold, dwg, f, phys, scheme, kcfg,
                freeze, nodal_force, source,
            )
        else:
            dwg, f, _, _, _ = newton_iter(
                ctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg,
                freeze, nodal_force, source, scalar_implicit,
            )
    new_wgold, new_dwgold = update(wgold, dwgold, dwg, scheme)
    return new_wgold, new_dwgold, dwg


def newton_adaptive(
    ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, kcfg, freeze,
    max_iter, newton_rtol, newton_atol, nodal_force=None, source=None, scalar_implicit=False,
    lag_jacobian=False,
):
    """The adaptive Newton loop (main.c:157-279): stop after the iteration
    whose four field norms all pass (rn < rtol*rnorm0) | (rn < atol);
    `lag_jacobian` as in step_fixed (newton.py:445-475 of the JAX package).
    Returns (dwg, rnorm0, rnorms, kits, lrels, converged), the norms as
    host tensors."""
    f = residual(
        ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze, nodal_force, source
    )
    rnorm0 = (field_norms_t(f) + 1e-16).cpu()  # main.c:152-155
    rnorms, kits, lrels = [], [], []
    conv = False
    lagged = None
    if lag_jacobian:
        lagged = assemble_system(
            ctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, scalar_implicit,
            **_pc_kwargs(kcfg),
        )
    for _ in range(max_iter):
        if lagged is not None:
            dwg, f, rn, kit, lrel = solve_update(
                ctx, face_ctxs, mask_t, *lagged, wgold, dwgold, dwg, f, phys, scheme, kcfg,
                freeze, nodal_force, source,
            )
        else:
            dwg, f, rn, kit, lrel = newton_iter(
                ctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg,
                freeze, nodal_force, source, scalar_implicit,
            )
        rn = rn.cpu()  # one host sync per Newton iteration
        rnorms.append(rn)
        kits.append(int(kit))
        lrels.append(float(lrel))
        conv = bool(torch.all((rn < newton_rtol * rnorm0) | (rn < newton_atol)))
        if conv:
            break
    return dwg, rnorm0, rnorms, kits, lrels, conv


# ---------------------------------------------------------------------------


@dataclass
class NewtonStats:
    rnorm0: np.ndarray  # (4,)
    rnorms: list  # list of (4,) per iteration
    krylov_iters: list
    converged: bool
    # estimated relative linear residual ||F - J dx|| / ||F|| of each solve
    linear_rels: list = None


def _refuse_unported(mesh: Mesh, cfg: SolverConfig) -> None:
    """NotImplementedError for every option the port lacks (the tier is
    chosen, or refused, by _choose_tier). `krylov.solver` is not among
    them: the JAX package's step ignores it and always runs GMRES
    (config.py:99-101), and so does the port's."""
    checks = [
        (cfg.lattice_backend is not None, f"lattice_backend={cfg.lattice_backend!r}", "A9"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"dedflow_tpu_torch does not port {what} yet (ROADMAP queue {item})"
            )


def _winell_gate(mesh: Mesh) -> bool:
    """The JAX package's "auto" gate onto the WinELL tier (newton.py:628-652):
    the mean window count of its four residual stream plans under 8
    (sparse.win_stream.stream_window_counts, the same planning arithmetic;
    a plan that would need 1024 or more windows fails to build there) and
    a median element node span under 0.4 of N (a locality-preserving
    order)."""
    ien = np.asarray(mesh.ien, dtype=np.int64)
    n, ne = mesh.num_node, ien.shape[0]
    span_ratio = float(np.median(ien.max(axis=1) - ien.min(axis=1))) / max(n, 1)
    if span_ratio >= 0.4:
        return False
    src = np.arange(ne, dtype=np.int64)
    nwin = np.concatenate([stream_window_counts(ien[:, a], src, n, ne) for a in range(4)])
    return int(nwin.max()) < 1024 and float(nwin.mean()) < 8.0


def stencil_offsets(mesh: Mesh) -> tuple:
    """The node-id offsets (col - row) of the mesh's sparsity, ascending:
    those of its tets' node pairs and of its prism / hex tables' (the mixed
    cells add stencil entries, sparse.topology.build_sparsity). The JAX
    solver compares these, its context's `dia_offsets`, with a lattice or
    class stencil (newton.py:596-603); () for a mesh without tets."""
    ien = np.asarray(mesh.ien, dtype=np.int64)
    if not ien.size:
        return ()
    offs = set()
    for t in (ien, *mesh.extra_cells):
        t = np.asarray(t, dtype=np.int64)
        offs.update(np.unique(t[:, None, :] - t[:, :, None]).tolist())
    return tuple(sorted(offs))


def _choose_tier(mesh: Mesh, cfg: SolverConfig) -> str:
    """The assembly tier the JAX package's ladder picks (newton.py:560-672):
    "lattice" for a mesh with lattice metadata (generated, or recovered with
    its `lattice_tets`) whose stencil offsets equal its sparsity's
    (`stencil_offsets`: a prism / hex table whose node pairs leave the
    lattice's stencil keeps the mesh off the lattice), unless
    use_lattice="off", which ignores the metadata; else "classes" when the
    mesh is translation-regular (fem.lattice.classes_tier_applies) on
    "auto", "off" or "on"; "on" raises when neither applies; else "winell"
    ("auto" only when its gate passes) or "gather" (forced by
    use_lattice="gather" or an assembly chunk, and the floor)."""
    mode = cfg.use_lattice
    if mode not in ("auto", "on", "off", "winell", "gather"):
        raise ValueError(f"unknown use_lattice={mode!r}")
    if mode == "gather" or cfg.assembly_chunk is not None:
        return "gather"
    mesh_offs = stencil_offsets(mesh)
    if mode != "winell":
        if mesh.lattice is not None and mode != "off":
            if lattice_tables(*mesh.lattice, mesh.lattice_tets)[3] == mesh_offs:
                return "lattice"
        elif classes_tier_applies(mesh, mesh_offs):
            return "classes"
        if mode == "on":
            raise ValueError(
                "use_lattice='on' but the mesh sparsity does not match the lattice/class stencil"
            )
    if mesh.num_tet > 0 and (mode == "winell" or (mode == "auto" and _winell_gate(mesh))):
        return "winell"
    return "gather"


class NSSolver:
    """Owns the assembly, facet and mask contexts for one mesh + config on
    one device. `device` is "cuda" unless the caller asks for "cpu" (as
    the JAX NSSolver runs on the accelerator); without a card a CUDA
    request raises. The dtype defaults to float64 on the CPU and float32
    on CUDA. `fastpath` names the tier: "lattice", "classes", "winell" or
    "gather"."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, device="cuda", dtype=None):
        _refuse_unported(mesh, cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.mesh = mesh
        self.cfg = cfg
        self.fastpath = _choose_tier(mesh, cfg)
        weak = [bc.boundary for bc in cfg.bcs if bc.weak]
        self.lctx = self.wctx = self.gctx = None
        if self.fastpath in ("lattice", "classes"):
            build = build_lattice_context if self.fastpath == "lattice" else build_class_context
            self.lctx = build(mesh, self.device, self.dtype, scalar_implicit=cfg.implicit_scalars)
            self.face_ctxs = tuple(
                build_face_context(mesh, b, self.lctx.offsets, self.device, self.dtype)
                for b in weak
            )
        else:
            # prism / hex tables add stencil entries only (newton.py:536-538
            # of the JAX package): exact zeros in J
            sparsity = build_sparsity(mesh.ien, mesh.num_node, extra_ien=mesh.extra_cells)
            if self.fastpath == "winell":
                # pc="mg" on this tier is AMG: its pattern-only plan is
                # built once here (newton.py:620-627 of the JAX package)
                self.wctx = build_win_context(
                    mesh, sparsity, self.device, self.dtype, cfg.win_jac_scatter,
                    with_amg=cfg.krylov.pc == "mg",
                )
            else:
                self.gctx = build_context(
                    mesh, sparsity, self.device, self.dtype, cfg.assembly_chunk,
                    cfg.scatter_method, cfg.elements_kernel,
                )
            self.face_ctxs = attach_face_win_plans(
                tuple(build_face_context(mesh, b, None, self.device, self.dtype) for b in weak),
                sparsity, self.solve_ctx.win_plan,
            )
        strong = [
            dbc.StrongBC(bc.boundary, tuple(bc.strong_components))
            for bc in cfg.bcs
            if bc.strong_components
        ]
        mask_np = dbc.build_mask(mesh, strong, 6)
        if cfg.pin_pressure:
            mask_np[0, 3] = True  # remove the constant-pressure null mode
        self.mask_t = torch.as_tensor(mask_np.T.copy(), device=self.device)

    @property
    def solve_ctx(self):
        """The assembly context the stepping functions take."""
        return next(c for c in (self.lctx, self.wctx, self.gctx) if c is not None)

    def _common(self):
        cfg = self.cfg
        return (self.solve_ctx, self.face_ctxs, self.mask_t), dict(
            phys=cfg.physics, scheme=cfg.time, kcfg=cfg.krylov,
            freeze=cfg.freeze_phi_temperature,
        )

    def newton_solve(self, wgold, dwgold, dwg, source=None, nodal_force=None):
        """Adaptive Newton loop (reference semantics, main.c:157-279);
        `source` (N,) is the nodal heat source (the melt-pool laser at the
        generalized-alpha time level), `nodal_force` (N, 3) a nodal
        momentum load (the DEM drag reaction of app.coupled)."""
        ctx, kw = self._common()
        newton = self.cfg.newton
        dwg, rnorm0, rns, kits, lrels, conv = newton_adaptive(
            *ctx, wgold, dwgold, dwg, kw["phys"], kw["scheme"], kw["kcfg"],
            kw["freeze"], newton.max_iter, newton.rtol, newton.atol, nodal_force, source,
            self.cfg.implicit_scalars, newton.lag_jacobian,
        )
        return dwg, NewtonStats(
            rnorm0=rnorm0.numpy(),
            rnorms=[r.numpy() for r in rns],
            krylov_iters=kits,
            converged=conv,
            linear_rels=lrels,
        )

    def step(self, wgold, dwgold, dwg, source=None, nodal_force=None):
        """One generalized-alpha time step (predict/newton/update)."""
        dwg = predict(dwg, self.cfg.time)
        dwg, stats = self.newton_solve(wgold, dwgold, dwg, source, nodal_force)
        wgold, dwgold = update(wgold, dwgold, dwg, self.cfg.time)
        return wgold, dwgold, dwg, stats

    def step_fixed(self, wgold, dwgold, dwg, num_newton: int = 4, source=None, nodal_force=None):
        """One step with a fixed Newton iteration count."""
        ctx, kw = self._common()
        return step_fixed(
            *ctx, wgold, dwgold, dwg, **kw, num_newton=num_newton, nodal_force=nodal_force,
            source=source, scalar_implicit=self.cfg.implicit_scalars,
            lag_jacobian=self.cfg.newton.lag_jacobian,
        )
