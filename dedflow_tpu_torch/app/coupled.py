"""Coupled FEM-DEM stepping (counterpart of dedflow_tpu/app/coupled.py).

Per fluid step:
  1. locate the particles in the mesh, interpolate the fluid velocity,
     compute the Stokes drag on each particle and the equal-and-opposite
     nodal reaction (dem.coupling.locate_lattice on a lattice mesh, with
     the table of each cell's elements (`lattice_cells`) that finds a
     recovered mesh's elements too, dem.coupling.locate elsewhere),
  2. advance the fluid one generalized-alpha step with the reaction as a
     nodal momentum load (NSSolver.step / step_fixed, nodal_force=),
  3. advance the DEM `substeps` explicit substeps with the drag held fixed
     (dem.grid.dem_run_grid, whose contact sweep is kernel K11, or the
     candidate-list dem.integrate.dem_run).

With `sharded=True` this process is one rank of N (the JAX package's
`device_mesh`): the fluid is parallel.sharded.ShardedNSSolver in either
of its modes, and its states are the rank's own rows; the particles are
the same on every rank. Each rank locates every particle on the whole
mesh; the rank that owns a particle's element computes its drag from its
local velocity rows (z-slabs: the own layers and the right neighbour's
first, `SlabComm.band_from_right`; RCB parts: the own nodes and the
ghosts, `HaloComm.exchange`), one all-reduce of disjoint rows gives every
rank the whole drag (dem.coupling.owned_exchange), and the reaction lands
on the owner's local rows, whose halo layer or ghosts go back to their
owners (`carry_to_right` / `reverse_add`). The DEM runs on cell slabs of
the flat cell axis (dem_run_grid(shard=), its own SlabComm on the same
process group: the two decompositions differ), or replicated on every
rank with `use_grid=False`, as the JAX package runs it. The fluid takes
every Krylov option ShardedNSSolver takes (the preconditioners, the
precisions, the lagged Jacobian).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.config import SolverConfig
from dedflow_tpu_torch.dem import coupling
from dedflow_tpu_torch.dem.grid import dem_run_grid
from dedflow_tpu_torch.dem.integrate import DEMConfig, dem_run
from dedflow_tpu_torch.dem.particles import ParticleState
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.solver.newton import NSSolver


@dataclass
class CoupledConfig:
    dem: DEMConfig
    drag_mu: float = 1.0e-3  # fluid viscosity for the Stokes drag law
    substeps: int = 10  # DEM substeps per fluid step
    # the dense grid-resident DEM path (dem.grid); requires uniform mass
    use_grid: bool = True


class CoupledSolver:
    """Staggered FEM-DEM solver: NS solver + DEM + drag exchange, on one
    device ("cuda" unless the caller asks for "cpu"; the dtype follows the
    device as in NSSolver). With `sharded=True` it is rank
    `dist.get_rank(group)` of the process group `group` (module docstring;
    every rank builds it with the same mesh and configuration, and calls
    `step` together)."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, ccfg: CoupledConfig,
                 device="cuda", dtype=None, sharded: bool = False, group=None):
        self.ccfg = ccfg
        self.rows = self.dem_comm = None
        if sharded:
            from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
            from dedflow_tpu_torch.parallel.spmd import SlabComm

            self.fluid = ShardedNSSolver(mesh, cfg, group=group, device=device, dtype=dtype)
            self.dem_comm = SlabComm(group)  # the DEM's chain of cell slabs
        else:
            self.fluid = NSSolver(mesh, cfg, device=device, dtype=dtype)
        self.device, self.dtype = self.fluid.device, self.fluid.dtype
        self.geom = coupling.coupling_geometry(mesh.xg, mesh.ien, self.device, self.dtype)
        self._lattice = mesh.lattice
        if self._lattice is not None:
            # closed-form cell lookup on lattice meshes (locate_lattice),
            # through a table of each cell's T elements: box_mesh's 6 Kuhn
            # tets, or a recovered mesh's file order and split
            lo = np.asarray(mesh.xg).min(axis=0)
            hi = np.asarray(mesh.xg).max(axis=0)
            self._lat_origin = lo
            self._lat_spacing = (hi - lo) / np.asarray(self._lattice, float)
            tets = 6 if mesh.lattice_tets is None else len(mesh.lattice_tets)
            cells = coupling.lattice_cells(self._lattice, lo, self._lat_spacing, mesh.xg,
                                           mesh.ien, tets)
            self._lat_cells = torch.as_tensor(cells, device=self.device)
            self.grid = None
        else:
            self.grid = coupling.element_grid(mesh.xg, mesh.ien)
        if sharded:
            self.rows = coupling.rank_rows(*self._ownership(mesh), self.device)

    def _ownership(self, mesh: Mesh) -> tuple:
        """(owner rank of each element, this rank, local row of each node):
        z-slabs, the rank of the element's cell layer, rows own layers then
        the right neighbour's first; RCB, the owner of the element's first
        vertex, rows [own | ghosts]."""
        fluid, ien = self.fluid, np.asarray(mesh.ien, dtype=np.int64)
        local_of = np.full(mesh.num_node, -1, dtype=np.int64)
        if fluid.mode == "slab":
            from dedflow_tpu_torch.fem.lattice import slab_layers

            sctx, comm = fluid.sctx, fluid.comm
            bounds = np.asarray(slab_layers(mesh.lattice[2] + 1, comm.world))
            # every Kuhn tet holds its cell's corner 0 (fem.lattice._slab_mesh)
            owner = np.searchsorted(bounds, ien.min(axis=1) // sctx.width, side="right") - 1
            lo, n_local = sctx.node_lo, sctx.lctx.num_node
            local_of[lo : lo + n_local] = np.arange(n_local)
        else:
            lay = fluid.layout
            owner = lay.node_part[ien[:, 0]]
            local_of[lay.nodes] = np.arange(lay.nodes.size)
        return owner, fluid.comm.rank, local_of

    def _locate(self, x):
        if self._lattice is not None:
            return coupling.locate_lattice(self._lattice, self._lat_origin, self._lat_spacing,
                                           self.geom, x, cells=self._lat_cells)
        return coupling.locate(self.grid, self.geom, x)

    def drag(self, wg, pstate: ParticleState):
        """(particle drag (P, 3), nodal reaction) at fluid state wg: (N, 3),
        or on N ranks the rank's own rows (n_own, 3) (every rank calls it)."""
        elem, bary = self._locate(pstate.x)
        if self.rows is None:
            return coupling._exchange(self.geom, elem, bary, pstate, wg, self.ccfg.drag_mu)
        comm, u = self.fluid.comm, wg[:, :3].T.contiguous()
        if self.fluid.mode == "slab":
            band = comm.band_from_right(u, self.fluid.sctx.width)
            u_local = u if band is None else torch.cat([u, band], dim=1)
        else:
            u_local = comm.exchange(u)
        f_p, react = coupling.owned_exchange(self.geom, self.rows, elem, bary, pstate,
                                             u_local.T, self.ccfg.drag_mu, comm.allreduce_sum)
        react = react.T.contiguous()
        if self.fluid.mode == "slab":
            return f_p, comm.carry_to_right(react, self.fluid.sctx.width).T
        return f_p, comm.reverse_add(react).T

    def advance_particles(self, pstate: ParticleState, f_p) -> ParticleState:
        """The DEM substeps of one fluid step with the drag f_p held fixed
        (on N ranks: on cell slabs, or replicated with use_grid=False)."""
        if self.ccfg.use_grid:
            return dem_run_grid(self.ccfg.dem, pstate, self.ccfg.substeps, ext=f_p,
                                shard=self.dem_comm)
        return dem_run(self.ccfg.dem, pstate, self.ccfg.substeps, ext=f_p)

    def step(self, wg, dwgold, dwg, pstate: ParticleState, num_newton: int | None = None,
             timings: dict | None = None):
        """One coupled step; returns (wg, dwgold, dwg, pstate, stats). With
        `num_newton` the fluid advances by `step_fixed` (a fixed Newton
        count, stats None); otherwise by the adaptive `step`. With a
        `timings` dict the device is synchronised after each part and its
        wall seconds are stored under "drag_s", "fluid_s" and "dem_s". On N
        ranks the fluid states are the rank's own rows."""
        mark = _Marks(self.device, timings)
        f_p, f_nodes = self.drag(wg, pstate)
        f_nodes = f_nodes.to(wg.dtype)
        mark("drag_s")
        if num_newton is not None:
            wg, dwgold, dwg = self.fluid.step_fixed(
                wg, dwgold, dwg, num_newton=num_newton, nodal_force=f_nodes
            )
            stats = None
        else:
            wg, dwgold, dwg, stats = self.fluid.step(wg, dwgold, dwg, nodal_force=f_nodes)
        mark("fluid_s")
        pstate = self.advance_particles(pstate, f_p)
        mark("dem_s")
        return wg, dwgold, dwg, pstate, stats


class _Marks:
    """Wall seconds between marks, after a device synchronise; does
    nothing (and never synchronises) without an output dict."""

    def __init__(self, device: torch.device, out: dict | None):
        self.out = out
        self.sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        if out is not None:
            self.sync()
            self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.out is not None:
            self.sync()
            t = time.perf_counter()
            self.out[name] = t - self.t
            self.t = t
