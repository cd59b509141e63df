"""Coupled FEM-DEM stepping (counterpart of dedflow_tpu/app/coupled.py).

Per fluid step:
  1. locate the particles in the mesh, interpolate the fluid velocity,
     compute the Stokes drag on each particle and the equal-and-opposite
     nodal reaction (dem.coupling.drag_exchange_lattice on a box mesh,
     drag_exchange elsewhere),
  2. advance the fluid one generalized-alpha step with the reaction as a
     nodal momentum load (NSSolver.step / step_fixed, nodal_force=),
  3. advance the DEM `substeps` explicit substeps with the drag held fixed
     (dem.grid.dem_run_grid, whose contact sweep is kernel K11, or the
     candidate-list dem.integrate.dem_run).
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
    device as in NSSolver). `device_mesh` (the JAX package's sharded fluid
    and DEM) raises NotImplementedError naming ROADMAP queue A16 (c)."""

    def __init__(self, mesh: Mesh, cfg: SolverConfig, ccfg: CoupledConfig,
                 device="cuda", dtype=None, device_mesh=None):
        if device_mesh is not None:
            raise NotImplementedError(
                "dedflow_tpu_torch does not port the sharded coupled solver "
                "(device_mesh) yet (ROADMAP queue A16 (c))"
            )
        self.ccfg = ccfg
        self.fluid = NSSolver(mesh, cfg, device=device, dtype=dtype)
        self.device, self.dtype = self.fluid.device, self.fluid.dtype
        self.geom = coupling.coupling_geometry(mesh.xg, mesh.ien, self.device, self.dtype)
        self._lattice = mesh.lattice
        if self._lattice is not None:
            # closed-form cell lookup on box meshes (locate_lattice)
            lo = np.asarray(mesh.xg).min(axis=0)
            hi = np.asarray(mesh.xg).max(axis=0)
            self._lat_origin = lo
            self._lat_spacing = (hi - lo) / np.asarray(self._lattice, float)
            self.grid = None
        else:
            self.grid = coupling.element_grid(mesh.xg, mesh.ien)

    def drag(self, wg, pstate: ParticleState):
        """(particle drag (P, 3), nodal reaction (N, 3)) at fluid state wg."""
        if self._lattice is not None:
            return coupling.drag_exchange_lattice(
                self._lattice, self._lat_origin, self._lat_spacing, self.geom,
                pstate, wg, self.ccfg.drag_mu,
            )
        return coupling.drag_exchange(self.grid, self.geom, pstate, wg, self.ccfg.drag_mu)

    def advance_particles(self, pstate: ParticleState, f_p) -> ParticleState:
        """The DEM substeps of one fluid step with the drag f_p held fixed."""
        if self.ccfg.use_grid:
            return dem_run_grid(self.ccfg.dem, pstate, self.ccfg.substeps, ext=f_p)
        return dem_run(self.ccfg.dem, pstate, self.ccfg.substeps, ext=f_p)

    def step(self, wg, dwgold, dwg, pstate: ParticleState, num_newton: int | None = None,
             timings: dict | None = None):
        """One coupled step; returns (wg, dwgold, dwg, pstate, stats). With
        `num_newton` the fluid advances by `step_fixed` (a fixed Newton
        count, stats None); otherwise by the adaptive `step`. With a
        `timings` dict the device is synchronised after each part and its
        wall seconds are stored under "drag_s", "fluid_s" and "dem_s"."""
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
