"""The reference, lid-driven cavity, moving-laser melt-pool and coupled
FEM-DEM powder-settling scenarios (copies of dedflow_tpu/app/scenarios.py).

Initial condition MyFieldInit (main.c:286-321): u=(1,0,0), p=0, phi=x,
T=-x; BC layout of main.c:454-477 on a generated box mesh:

  reference bound 0 (strong u all comps) -> x- (inflow)
  reference bound 1 (no BCs: do-nothing) -> x+ (outflow)
  reference bound 2 (strong u_y)         -> y-/y+ (slip)
  reference bound 3 (strong u_z)         -> z-    (slip)
  reference bound 4 (weak/Nitsche)       -> z+
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dedflow_tpu_torch.config import BCSpec, Laser, Physics, SolverConfig, TimeScheme
from dedflow_tpu_torch.mesh.mesh import Mesh


def reference_initial_state(mesh: Mesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(wgold, dwgold, dwg) per MyFieldInit + main.c:504-519."""
    n = mesh.num_node
    wg = np.zeros((n, 6))
    wg[:, 0] = 1.0  # u = (1, 0, 0)
    wg[:, 4] = mesh.xg[:, 0]  # phi = x
    wg[:, 5] = -mesh.xg[:, 0]  # T = -x
    return wg, np.zeros((n, 6)), np.zeros((n, 6))


def box_channel_bcs() -> tuple[BCSpec, ...]:
    """Reference BC roles on box side order [x-, x+, y-, y+, z-, z+]; x+
    carries no condition (do-nothing outflow), which pins the pressure."""
    return (
        BCSpec(boundary=0, strong_components=(0, 1, 2)),  # inflow (ref bound 0)
        BCSpec(boundary=2, strong_components=(1,)),  # y- slip (ref bound 2)
        BCSpec(boundary=3, strong_components=(1,)),  # y+ slip
        BCSpec(boundary=4, strong_components=(2,)),  # z- slip (ref bound 3)
        BCSpec(boundary=5, strong_components=(), weak=True),  # z+ weak (ref 4)
    )


def reference_scenario_config(**overrides) -> SolverConfig:
    cfg = SolverConfig(bcs=box_channel_bcs())
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# ---------------------------------------------------------------------------
# Lid-driven cavity (BASELINE config #2; scenarios.py:77-114): transient
# stabilized NS in a closed box, the z+ lid moving with u = (1, 0, 0), every
# other wall no-slip.


def lid_driven_cavity_bcs() -> tuple[BCSpec, ...]:
    """Box side order [x-, x+, y-, y+, z-, z+]: every velocity component
    fixed on every side; the lid value comes from the initial state (the
    Dirichlet rows keep what they hold)."""
    return tuple(BCSpec(boundary=b, strong_components=(0, 1, 2)) for b in range(6))


def lid_driven_cavity_config(**overrides) -> SolverConfig:
    cfg = SolverConfig(
        physics=Physics(rho=1.0, mu=1.0e-2),  # Re = 100 cavity
        time=TimeScheme(dt=5e-2),
        bcs=lid_driven_cavity_bcs(),
        pin_pressure=True,  # enclosed flow: constant-pressure null mode
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def lid_driven_cavity_initial_state(mesh: Mesh):
    """u = (1, 0, 0) on the lid interior, zero elsewhere; the lid's rim
    nodes (shared with the side walls) stay at zero."""
    n = mesh.num_node
    wg = np.zeros((n, 6))
    lid = mesh.boundaries[5].nodes
    rim = np.unique(np.concatenate([mesh.boundaries[b].nodes for b in range(5)]))
    wg[np.setdiff1d(lid, rim), 0] = 1.0
    return wg, np.zeros((n, 6)), np.zeros((n, 6))


# ---------------------------------------------------------------------------
# Moving-laser melt pool (BASELINE config #3; scenarios.py:124-157): the
# phi/T equations active with their consistent tangents
# (SolverConfig.implicit_scalars) and a moving volumetric heat source.


def laser_source(laser: Laser, xg: np.ndarray, t: float) -> np.ndarray:
    """(N,) nodal volumetric heat source q(x, t); integrates to power."""
    c = np.asarray(laser.start) + np.asarray(laser.velocity) * t
    r2 = ((np.asarray(xg) - c) ** 2).sum(axis=1)
    q0 = laser.power * (2.0 / np.pi) ** 1.5 / laser.radius**3
    return q0 * np.exp(-2.0 * r2 / laser.radius**2)


def melt_pool_scenario_config(**overrides) -> SolverConfig:
    """Single-track DED: the laser scans +x across the top (z+) face of the
    box, the thermal-fluid system fully active, slow time stepping."""
    laser = Laser(power=50.0, radius=0.15, velocity=(0.5, 0.0, 0.0), start=(0.1, 0.5, 1.0))
    cfg = SolverConfig(
        physics=Physics(laser=laser),
        time=TimeScheme(dt=2e-2),
        bcs=box_channel_bcs(),
        freeze_phi_temperature=False,
        implicit_scalars=True,
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def melt_pool_initial_state(mesh: Mesh):
    """u = 0, p = 0, phi = z - 0.5 (the melt interface), T = 0."""
    n = mesh.num_node
    wg = np.zeros((n, 6))
    wg[:, 4] = mesh.xg[:, 2] - 0.5
    return wg, np.zeros((n, 6)), np.zeros((n, 6))


# ---------------------------------------------------------------------------
# Coupled FEM-DEM powder settling: particles released in the upper half of
# the fluid box, two-way Stokes-drag coupled.


def coupled_scenario_setup(
    mesh: Mesh,
    num_particles: int = 1000,
    radius: float | None = None,
    substeps: int = 10,
    use_grid: bool = True,
    drag_mu: float = 1.0e-3,
    seed: int = 0,
    device="cuda",
    dtype=None,
):
    """(CoupledConfig, ParticleState) for a powder-settling cloud in the
    top half of the mesh bounding box; the particles lie on `device` (the
    card unless the caller asks for the CPU)."""
    from dedflow_tpu_torch.app.coupled import CoupledConfig
    from dedflow_tpu_torch.dem.cells import make_grid
    from dedflow_tpu_torch.dem.integrate import DEMConfig
    from dedflow_tpu_torch.dem.particles import particle_state

    lo = np.asarray(mesh.xg).min(axis=0)
    hi = np.asarray(mesh.xg).max(axis=0)
    ext = hi - lo
    if radius is None:
        # ~5% solids fraction in the release volume
        vol = float(np.prod(ext)) * 0.5
        radius = (0.05 * vol / max(num_particles, 1) * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    rng = np.random.RandomState(seed)
    margin = 2.0 * radius
    x_lo = lo + margin
    x_hi = hi - margin
    x_lo[2] = lo[2] + 0.5 * ext[2]  # top half
    x = rng.uniform(x_lo, x_hi, size=(num_particles, 3))
    pstate = particle_state(x, radius=radius, mass=1.0, device=device, dtype=dtype)
    grid = make_grid(lo, hi, cell_size=2.5 * radius, capacity=8)
    dem = DEMConfig(
        grid=grid,
        dt=1.0e-4,
        walls_lo=tuple(lo),
        walls_hi=tuple(hi),
        linear_drag=6.0 * np.pi * drag_mu * radius,
    )
    ccfg = CoupledConfig(dem=dem, drag_mu=drag_mu, substeps=substeps, use_grid=use_grid)
    return ccfg, pstate
