"""Newton + generalized-alpha time stepping, lattice tier (counterpart of
dedflow_tpu/solver/newton.py).

  predict:   dwg[vel,phi,T] *= (gamma-1)/gamma          (main.c:544-545)
  newton<=4: assemble J; GMRES(J) dx = F; dwg -= dx;
             rebuild alpha states; assemble F; converge
             when all 4 field rel-norms < 0.5e-3        (main.c:157-279)
  update:    wgold[vel,phi,T] += dt((1-g) dwgold + g dwg);
             dwgold = dwg                               (main.c:561-565)

Only the structured-lattice tier of a generated box mesh is ported, with
the field-split preconditioner and the linear solve in the state dtype.
Every other tier or option raises NotImplementedError naming the ROADMAP
item that brings it; nothing silently takes another path. The adaptive
Newton loop reads the four field norms to the host once per Newton
iteration, the reference's own sync granularity (main.c:262-265).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.config import SolverConfig
from dedflow_tpu_torch.fem import dirichlet as dbc
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.fem.face import build_face_context
from dedflow_tpu_torch.fem.lattice import (
    assemble_jacobian_t,
    assemble_residual_t,
    build_lattice_context,
    field_norms_t,
)
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.solver.krylov import gmres
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT
from dedflow_tpu_torch.utils.dtypes import default_dtype, disable_tf32, resolve_device

# ---------------------------------------------------------------------------
# stepping functions (contexts passed explicitly)


def residual(lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze):
    """(6, N) residual at the alpha states."""
    wa, dwa = alpha_states(wgold, dwgold, dwg, scheme)
    return assemble_residual_t(lctx, face_ctxs, mask_t, wa, dwa, phys, scheme, freeze)


def assemble_system(lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme):
    """The Jacobian and its field-split preconditioner at the current state."""
    wa, dwa = alpha_states(wgold, dwgold, dwg, scheme)
    jmat = assemble_jacobian_t(lctx, face_ctxs, mask_t, wa, dwa, phys, scheme)
    return jmat, NSFieldSplitPCT.from_diag_rows(jmat.diag_rows())


def _solve_linear(jmat, pc, f, kcfg):
    """Right-preconditioned solve of J dx = F in the state dtype. Returns
    (dx, iters, rel_residual)."""
    sol = gmres(
        jmat.matvec_t, f, maxit=kcfg.max_iter, atol=kcfg.atol, rtol=kcfg.rtol,
        pc=pc, restart=kcfg.restart,
    )
    rel = sol.resnorm / torch.clamp(sol.resnorm0, min=torch.finfo(f.dtype).tiny)
    return sol.x, sol.iters, rel


def solve_update(
    lctx, face_ctxs, mask_t, jmat, pc, wgold, dwgold, dwg, f, phys, scheme, kcfg, freeze
):
    """GMRES(J) dx = F; dwg -= dx; reassemble F (main.c:211-265)."""
    dx, iters, lin_rel = _solve_linear(jmat, pc, f, kcfg)
    dwg = dwg - dx.T
    f = residual(lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze)
    return dwg, f, field_norms_t(f), iters, lin_rel


def newton_iter(
    lctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg, freeze
):
    """One Newton iteration: assemble J, solve, update dwg, reassemble F.
    Returns (dwg, f, field_norms, krylov_iters, linear_rel_residual)."""
    jmat, pc = assemble_system(
        lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme
    )
    return solve_update(
        lctx, face_ctxs, mask_t, jmat, pc, wgold, dwgold, dwg, f, phys, scheme,
        kcfg, freeze,
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
    lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, kcfg, freeze,
    num_newton,
):
    """One time step with a fixed Newton iteration count."""
    dwg = predict(dwg, scheme)
    f = residual(lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze)
    for _ in range(num_newton):
        dwg, f, _, _, _ = newton_iter(
            lctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg,
            freeze,
        )
    new_wgold, new_dwgold = update(wgold, dwgold, dwg, scheme)
    return new_wgold, new_dwgold, dwg


def newton_adaptive(
    lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, kcfg, freeze,
    max_iter, newton_rtol, newton_atol,
):
    """The adaptive Newton loop (main.c:157-279): stop after the iteration
    whose four field norms all pass (rn < rtol*rnorm0) | (rn < atol).
    Returns (dwg, rnorm0, rnorms, kits, lrels, converged), the norms as
    host tensors."""
    f = residual(lctx, face_ctxs, mask_t, wgold, dwgold, dwg, phys, scheme, freeze)
    rnorm0 = (field_norms_t(f) + 1e-16).cpu()  # main.c:152-155
    rnorms, kits, lrels = [], [], []
    conv = False
    for _ in range(max_iter):
        dwg, f, rn, kit, lrel = newton_iter(
            lctx, face_ctxs, mask_t, wgold, dwgold, dwg, f, phys, scheme, kcfg,
            freeze,
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
    """NotImplementedError for every tier and option the port lacks."""
    checks = [
        (cfg.assembly_chunk is not None, "assembly_chunk (streaming assembly)", "A13"),
        (cfg.use_lattice in ("off", "gather", "winell"),
         f"use_lattice={cfg.use_lattice!r}", "A10/A13/A14"),
        (mesh.lattice is None or mesh.lattice_tets is not None,
         "a mesh without box-generator lattice metadata (classes tier)", "A10"),
        (mesh.extra_cells != [], "prism/hex stencil cells", "A13"),
        (cfg.lattice_backend is not None, f"lattice_backend={cfg.lattice_backend!r}", "A9"),
        (cfg.implicit_scalars, "implicit_scalars (melt-pool tangents, K6)", "A12"),
        (cfg.physics.laser is not None, "a laser heat source", "A12"),
        (cfg.krylov.pc != "fieldsplit", f"krylov.pc={cfg.krylov.pc!r}", "A11"),
        (cfg.krylov.precision != "state", f"krylov.precision={cfg.krylov.precision!r}", "A11"),
        (cfg.krylov.solver != "gmres", f"krylov.solver={cfg.krylov.solver!r}", "A11"),
        (cfg.newton.lag_jacobian, "newton.lag_jacobian", "A11"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"dedflow_tpu_torch does not port {what} yet (ROADMAP queue {item})"
            )


class NSSolver:
    """Owns the lattice, facet and mask contexts for one mesh + config on
    one device. `device` is explicit ("cpu" or "cuda"); the dtype defaults
    to float64 on the CPU and float32 on CUDA."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, device="cpu", dtype=None):
        _refuse_unported(mesh, cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.mesh = mesh
        self.cfg = cfg
        self.lctx = build_lattice_context(mesh, self.device, self.dtype)
        # the lattice stencil must be the mesh's own sparsity stencil
        ien = np.asarray(mesh.ien, dtype=np.int64)
        mesh_offs = tuple(
            int(o) for o in np.unique(ien[:, None, :] - ien[:, :, None])
        ) if ien.size else ()
        if mesh_offs != self.lctx.offsets:
            raise NotImplementedError(
                "mesh sparsity does not match the lattice stencil (classes "
                "tier, ROADMAP queue A10)"
            )
        self.face_ctxs = tuple(
            build_face_context(mesh, bc.boundary, self.lctx.offsets, self.device, self.dtype)
            for bc in cfg.bcs
            if bc.weak
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

    def _common(self):
        cfg = self.cfg
        return (self.lctx, self.face_ctxs, self.mask_t), dict(
            phys=cfg.physics, scheme=cfg.time, kcfg=cfg.krylov,
            freeze=cfg.freeze_phi_temperature,
        )

    def _check_inputs(self, source, nodal_force) -> None:
        if source is not None:
            raise NotImplementedError("heat sources (ROADMAP queue A12)")
        if nodal_force is not None:
            raise NotImplementedError("nodal forces / DEM coupling (ROADMAP queue A15)")

    def newton_solve(self, wgold, dwgold, dwg, source=None, nodal_force=None):
        """Adaptive Newton loop (reference semantics, main.c:157-279)."""
        self._check_inputs(source, nodal_force)
        ctx, kw = self._common()
        newton = self.cfg.newton
        dwg, rnorm0, rns, kits, lrels, conv = newton_adaptive(
            *ctx, wgold, dwgold, dwg, kw["phys"], kw["scheme"], kw["kcfg"],
            kw["freeze"], newton.max_iter, newton.rtol, newton.atol,
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
        self._check_inputs(source, nodal_force)
        ctx, kw = self._common()
        return step_fixed(*ctx, wgold, dwgold, dwg, **kw, num_newton=num_newton)
