"""The reference scenario and the coupled FEM-DEM powder-settling set-up
(copies of those parts of dedflow_tpu/app/scenarios.py).

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

from dedflow_tpu_torch.config import BCSpec, SolverConfig
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
