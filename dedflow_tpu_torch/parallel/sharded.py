"""The Navier-Stokes solver on N ranks (counterpart of
dedflow_tpu/parallel/sharded.py::ShardedNSSolver, :74-341). It routes a
mesh the way the JAX constructor does (:121-150, `sharded_mode`):

- "slab" (the JAX lattice mode with its kernels, :155-202): a mesh that the
  JAX package puts on its lattice mode, a box or a translation-regular
  mesh with `use_lattice` not "gather", no assembly chunk and no
  `implicit_scalars`. The port takes the Kuhn box (a generated box, or a
  recovered one with the generator's split): its node order (x fastest, z
  last) is already a slab decomposition, and rank r of N owns the
  contiguous node layers [a_r, a_{r+1}) of fem.lattice.slab_layers (as
  even as possible, at least 2 a rank) and the cells of the same layers.
  F is K1 on the rank's sub-box with its halo layer's rows carried to the
  right neighbour; J is K2 with the Dirichlet epilogue, its halo layer
  carried likewise; GMRES runs K3's banded entry on the own rows with a
  band of each neighbour's layer (sparse.fsbsr.SlabDIAMatrixT). The
  classes tier and the other lattice splits on z-slabs raise, naming
  ROADMAP A16 (b'').
- "rcb" (the JAX RCB mode, :238-262): every other mesh (Delaunay and
  converted meshes, mixed meshes, `use_lattice` "gather" / "winell",
  assembly chunks, the melt pool's `implicit_scalars`). The mesh is
  RCB-partitioned (parallel.partition.part_layout, the padding dropped):
  rank r owns the nodes of part r and assembles on its local submesh,
  every element with an own node, numbered [own | ghosts], on the gather
  tier (fem.assembly.build_context with the own-target plans, so K8 and K9
  write only its rows; fem.ns.PartContext). One halo plan
  (parallel.spmd.HaloComm) fills the ghosts of the alpha states (and the
  heat source) before each F and J, and of x before every GMRES product
  (K7's halo entry, sparse.winell.HaloWinELLMatrixT); nothing gathers a
  whole vector. Pressure is pinned on the rank that owns the mesh's node
  0, as in one process. A mixed mesh's prism / hex tables are dropped, as
  the JAX partition drops them: their stencil entries are exact zeros.

In both modes each rank runs the one-process step functions of
solver.newton on its own rows: the field-split preconditioner from the
rank's own diagonal rows (node-local), every GMRES inner product and norm
and the Newton norms all-reduced, so every rank takes the same branch at
each host sync. States enter and leave in the mesh's own node order
(`shard_state` / `gather_state`). Options outside the port's slices raise
NotImplementedError naming their ROADMAP item; nothing falls back to one
process. A nodal momentum load comes as the rank's own rows in either
mode: app.coupled.CoupledSolver(sharded=True) runs the coupled FEM-DEM
step on this solver, its drag reaction the load.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from dedflow_tpu_torch.config import SolverConfig
from dedflow_tpu_torch.fem import dirichlet as dbc
from dedflow_tpu_torch.fem.assembly import build_context
from dedflow_tpu_torch.fem.face import build_face_context
from dedflow_tpu_torch.fem.lattice import _mesh_classes, build_slab_context, is_kuhn_split
from dedflow_tpu_torch.fem.ns import PartContext
from dedflow_tpu_torch.fem.win_assembly import attach_face_win_plans
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.parallel.partition import part_layout
from dedflow_tpu_torch.parallel.spmd import HaloComm, SlabComm, build_halo_plan
from dedflow_tpu_torch.solver.newton import NSSolver, _choose_tier, residual
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.utils.dtypes import default_dtype, disable_tf32, resolve_device

# the kernel libraries of both modes and of the coupled solver, built
# before ranks start (parallel.launch): K1, K2, K3 (slab); K4 / K5, K7,
# K8 / K9 (rcb); K11 (the DEM's halo entry)
KERNEL_LIBRARIES = ("lattice_residual", "lattice_jacobian", "dia_spmv", "gather_elements",
                    "winell_spmv", "seg_reduce", "dem_contact")


def sharded_mode(mesh: Mesh, cfg: SolverConfig) -> str:
    """"slab" where the JAX ShardedNSSolver takes its lattice mode
    (sharded.py:121-150: `use_lattice` not "gather", no assembly chunk, no
    implicit_scalars, a lattice or translation-regular mesh, and a solver
    tier of "lattice" or "classes"), else "rcb"."""
    maybe_fast = (cfg.use_lattice != "gather" and cfg.assembly_chunk is None
                  and not cfg.implicit_scalars)
    regular = ((mesh.lattice is not None and cfg.use_lattice != "off")
               or _mesh_classes(mesh) is not None)
    if maybe_fast and regular and _choose_tier(mesh, cfg) in ("lattice", "classes"):
        return "slab"
    return "rcb"


def _refuse_unported(mesh: Mesh, cfg: SolverConfig) -> str:
    """NotImplementedError, naming its ROADMAP item, for every mesh or
    option outside the ported modes; else the mode (`sharded_mode`)."""
    k, n = cfg.krylov, cfg.newton
    checks = [
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
    mode = sharded_mode(mesh, cfg)
    if mode == "slab" and not (_choose_tier(mesh, cfg) == "lattice"
                               and is_kuhn_split(mesh.lattice_tets)):
        raise NotImplementedError(
            "ShardedNSSolver does not port the classes tier or a lattice of another tet split on "
            "z-slabs yet (ROADMAP A16 (b''))"
        )
    return mode


class ShardedNSSolver(NSSolver):
    """NSSolver on a decomposed mesh (`mode` "slab" or "rcb", see the
    module docstring): this process is rank `comm.rank` of the process
    group `group` (the default group when None, parallel.launch starts
    it). Every rank builds the same host mesh and configuration; its
    tensors hold its own node rows on `device` ("cuda" unless the caller
    asks for the CPU). `step`, `step_fixed` and `newton_solve` are
    NSSolver's, run on the rank's context, and must be called on every
    rank together."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, group=None, device="cuda", dtype=None):
        self.mode = _refuse_unported(mesh, cfg)
        self.device = resolve_device(device)
        self.dtype = dtype or default_dtype(self.device)
        if self.device.type == "cuda":
            disable_tf32()
        self.mesh, self.cfg = mesh, cfg
        self.lctx = self.wctx = self.gctx = self.sctx = self.pctx = None
        weak = tuple(bc.boundary for bc in cfg.bcs if bc.weak)
        if self.mode == "slab":
            self.fastpath = "lattice"
            self.comm = SlabComm(group)
            self.sctx, self.face_ctxs = build_slab_context(mesh, self.comm, weak, self.device,
                                                           self.dtype)
            lo, n = self.sctx.node_lo, self.sctx.n_own
            self.own = np.arange(lo, lo + n)  # the rank's rows of the mesh's node order
            self.order = np.arange(mesh.num_node)  # the ranks' rows, concatenated
        else:
            self.fastpath = "gather"
            self._build_rcb(group, weak)
        strong = [dbc.StrongBC(bc.boundary, tuple(bc.strong_components))
                  for bc in cfg.bcs if bc.strong_components]
        mask_np = dbc.build_mask(mesh, strong, 6)
        if cfg.pin_pressure:
            mask_np[0, 3] = True  # remove the constant-pressure null mode
        self.mask_t = torch.as_tensor(mask_np[self.own].T.copy(), device=self.device)

    def _build_rcb(self, group, weak: tuple) -> None:
        """The rank's local submesh, halo plan and gather-tier context."""
        mesh, cfg = self.mesh, self.cfg
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        lay = part_layout(mesh, world, rank)
        plan = build_halo_plan(mesh.ien, lay)
        self.layout = lay
        self.comm = HaloComm(plan, group, self.device)
        sub, n_own = lay.mesh, lay.n_own
        sparsity = build_sparsity(sub.ien, sub.num_node)
        self.gctx = build_context(sub, sparsity, self.device, self.dtype, cfg.assembly_chunk,
                                  cfg.scatter_method, cfg.elements_kernel, own=n_own)
        self.face_ctxs = attach_face_win_plans(
            tuple(build_face_context(sub, b, None, self.device, self.dtype, own=n_own)
                  for b in weak if sub.boundaries[b].num_facet),
            sparsity, self.gctx.win_plan,
        )
        self.pctx = PartContext(fem=self.gctx, comm=self.comm)
        self.own = lay.nodes[:n_own]  # the rank's own nodes, original ids, local order
        self.order = np.concatenate([lay.owned(r) for r in range(world)])

    @property
    def solve_ctx(self):
        return self.sctx if self.sctx is not None else self.pctx

    def shard_state(self, state) -> torch.Tensor:
        """(N, ...) nodal array in the mesh's node order -> this rank's own
        rows, on its device in its dtype."""
        return torch.as_tensor(np.asarray(state)[self.own], dtype=self.dtype, device=self.device)

    def shard_nodal(self, x, ghosts: bool = False) -> torch.Tensor:
        """(N, ...) nodal array in the mesh's node order -> this rank's own
        rows, or with `ghosts` (RCB mode) its local rows [own | ghosts]: what
        a halo exchange of the own rows gives."""
        if not ghosts:
            return self.shard_state(x)
        if self.mode != "rcb":
            raise ValueError("shard_nodal(ghosts=True): the slab mode has no ghost nodes")
        return torch.as_tensor(np.asarray(x)[self.layout.nodes], dtype=self.dtype,
                               device=self.device)

    def gather_state(self, state: torch.Tensor, broadcast: bool = False):
        """Every rank's own rows -> the (N, ...) host array in the mesh's
        node order on rank 0 (None on the others), or on every rank with
        `broadcast`. A collective: every rank calls it."""
        part = state.detach().cpu().numpy()
        comm = self.comm
        if broadcast:
            parts = [None] * comm.world
            dist.all_gather_object(parts, part, group=comm.group)
        else:
            parts = [None] * comm.world if comm.rank == 0 else None
            dist.gather_object(part, parts, dst=comm._peer(0), group=comm.group)
            if comm.rank != 0:
                return None
        flat = np.concatenate(parts)
        out = np.empty_like(flat)
        out[self.order] = flat
        return out

    def residual(self, wgold, dwgold, dwg, source=None, nodal_force=None):
        """The rank's own rows (6, n_own) of F at the alpha states."""
        cfg = self.cfg
        return residual(self.solve_ctx, self.face_ctxs, self.mask_t, wgold, dwgold, dwg,
                        cfg.physics, cfg.time, cfg.freeze_phi_temperature, nodal_force, source)
