"""The Navier-Stokes solver on N ranks that each own a z-slab of a box
(counterpart of dedflow_tpu/parallel/sharded.py::ShardedNSSolver, :74-341,
its mode for the lattice tier with the kernels, :155-202).

A box's node order (x fastest, z last) is already a slab decomposition:
rank r of N owns the contiguous node layers [a_r, a_{r+1}) of
fem.lattice.slab_layers (as even as possible, at least 2 a rank) and the
cells of the same layers. Each rank runs the one-process step functions of
solver.newton on its own rows with a fem.lattice.SlabContext:

- F: K1 on the rank's sub-box, its facets, the halo layer's rows carried
  to the right neighbour (assemble_residual_slab);
- J: K2 on the sub-box with the Dirichlet epilogue, the unmasked halo layer
  carried likewise (assemble_jacobian_slab), the field-split
  preconditioner from the rank's own diagonal rows (node-local);
- GMRES: K3's banded entry on the own rows with a band of each neighbour's
  layer (sparse.fsbsr.SlabDIAMatrixT), every inner product and norm
  all-reduced, so every rank takes the same branch at each host sync; the
  Newton norms are all-reduced too.

States enter and leave in the mesh's own node order (`shard_state` /
`gather_state`). The JAX package's other two modes (the lattice under
GSPMD, an XLA CPU variant with no counterpart here, and the RCB partition
onto the gather tier) and every option outside this slice raise
NotImplementedError naming their ROADMAP item; nothing falls back to one
process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dedflow_tpu_torch.config import SolverConfig
from dedflow_tpu_torch.fem import dirichlet as dbc
from dedflow_tpu_torch.fem.lattice import build_slab_context, is_kuhn_split
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.parallel.spmd import SlabComm
from dedflow_tpu_torch.solver.newton import NSSolver, residual
from dedflow_tpu_torch.utils.dtypes import default_dtype, disable_tf32, resolve_device

# the kernel libraries of the slab path (K1, K2, K3): built before ranks
# start (parallel.launch)
KERNEL_LIBRARIES = ("lattice_residual", "lattice_jacobian", "dia_spmv")


def _refuse_unported(mesh: Mesh, cfg: SolverConfig) -> None:
    """NotImplementedError, naming its ROADMAP item, for every mesh or
    option outside the z-slab lattice slice."""
    k, n = cfg.krylov, cfg.newton
    checks = [
        (mesh.lattice is None or mesh.extra_cells or cfg.use_lattice in ("gather", "winell")
         or cfg.assembly_chunk is not None,
         "a mesh off the box lattice, a mixed mesh, use_lattice 'gather' / 'winell' or an "
         "assembly chunk (the RCB partition onto the gather tier)", "A16 (b')"),
        (mesh.lattice is not None and (not is_kuhn_split(mesh.lattice_tets)
                                       or cfg.use_lattice == "off"),
         "a lattice of another tet split or use_lattice 'off' (the classes tier sharded)",
         "A16 (b')"),
        (cfg.implicit_scalars, "implicit_scalars (the melt pool)", "A16 (b')"),
        (k.pc != "fieldsplit", f"krylov.pc={k.pc!r}", "A16 (d')"),
        (k.precision != "state", f"krylov.precision={k.precision!r}", "A16 (d')"),
        (n.lag_jacobian, "newton.lag_jacobian", "A16 (d')"),
        (cfg.lattice_backend is not None, f"lattice_backend={cfg.lattice_backend!r}", "A9"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"ShardedNSSolver does not port {what} yet (ROADMAP {item})"
            )


class ShardedNSSolver(NSSolver):
    """NSSolver on a z-slab decomposed box: this process is rank
    `comm.rank` of the process group `group` (the default group when None,
    parallel.launch starts it). Every rank builds the same host mesh and
    configuration; its tensors hold its own node rows on `device` ("cuda"
    unless the caller asks for the CPU). `step`, `step_fixed` and
    `newton_solve` are NSSolver's, run on the rank's SlabContext, and must
    be called on every rank together."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, group=None, device="cuda", dtype=None):
        _refuse_unported(mesh, cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.mesh, self.cfg = mesh, cfg
        self.fastpath = "lattice"
        self.comm = SlabComm(group)
        weak = tuple(bc.boundary for bc in cfg.bcs if bc.weak)
        self.sctx, self.face_ctxs = build_slab_context(mesh, self.comm, weak, self.device,
                                                       self.dtype)
        self.lctx = self.wctx = self.gctx = None
        strong = [dbc.StrongBC(bc.boundary, tuple(bc.strong_components))
                  for bc in cfg.bcs if bc.strong_components]
        mask_np = dbc.build_mask(mesh, strong, 6)
        if cfg.pin_pressure:
            mask_np[0, 3] = True  # remove the constant-pressure null mode
        lo, n = self.sctx.node_lo, self.sctx.n_own
        self.own = slice(lo, lo + n)  # the rank's rows of the mesh's node order
        self.mask_t = torch.as_tensor(mask_np[self.own].T.copy(), device=self.device)

    @property
    def solve_ctx(self):
        return self.sctx

    def shard_state(self, state) -> torch.Tensor:
        """(N, ...) nodal array in the mesh's node order -> this rank's own
        rows, on its device in its dtype."""
        return torch.as_tensor(np.asarray(state)[self.own], dtype=self.dtype, device=self.device)

    def gather_state(self, state: torch.Tensor, broadcast: bool = False):
        """Every rank's own rows -> the (N, ...) host array in the mesh's
        node order on rank 0 (None on the others), or on every rank with
        `broadcast`. A collective: every rank calls it."""
        part = state.detach().cpu().numpy()
        comm = self.comm
        if broadcast:
            parts = [None] * comm.world
            dist.all_gather_object(parts, part, group=comm.group)
            return np.concatenate(parts)
        parts = [None] * comm.world if comm.rank == 0 else None
        dist.gather_object(part, parts, dst=comm._peer(0), group=comm.group)
        return np.concatenate(parts) if comm.rank == 0 else None

    def residual(self, wgold, dwgold, dwg, source=None, nodal_force=None):
        """The rank's own rows (6, n_own) of F at the alpha states."""
        cfg = self.cfg
        return residual(self.sctx, self.face_ctxs, self.mask_t, wgold, dwgold, dwg, cfg.physics,
                        cfg.time, cfg.freeze_phi_temperature, nodal_force, source)
