"""Explicit DEM time stepping, candidate-list path (counterpart of
dedflow_tpu/dem/integrate.py).

Semi-implicit (symplectic) Euler, the standard soft-sphere DEM integrator.
The JAX package runs the substeps as one `lax.scan`; here they are a
Python loop of eager torch ops with the cell lists rebuilt every substep.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from dedflow_tpu_torch.dem.cells import CellGrid, build_buckets, candidate_lists
from dedflow_tpu_torch.dem.contact import ContactParams, pair_forces, wall_forces
from dedflow_tpu_torch.dem.particles import ParticleState


@dataclass(frozen=True)
class DEMConfig:
    grid: CellGrid
    contact: ContactParams = field(default_factory=ContactParams)
    gravity: tuple[float, float, float] = (0.0, 0.0, -9.81)
    dt: float = 1.0e-4
    # box for wall contacts; None = no walls
    walls_lo: tuple[float, float, float] | None = None
    walls_hi: tuple[float, float, float] | None = None
    # ambient linear (viscous) drag coefficient: F -= linear_drag * v
    linear_drag: float = 0.0


def forces(cfg: DEMConfig, state: ParticleState, ext: torch.Tensor | None = None):
    """Total force (P, 3): contacts + walls + gravity + external."""
    buckets = build_buckets(cfg.grid, state.x)
    cand = candidate_lists(cfg.grid, state.x, buckets)
    f = pair_forces(state.x, state.v, state.radius, cand, cfg.contact)
    if cfg.walls_lo is not None:
        f = f + wall_forces(
            state.x, state.v, state.radius, cfg.walls_lo, cfg.walls_hi, cfg.contact
        )
    g = torch.tensor(cfg.gravity, dtype=state.x.dtype, device=state.x.device)
    f = f + state.mass[:, None] * g[None]
    if cfg.linear_drag:
        f = f - cfg.linear_drag * state.v
    if ext is not None:
        f = f + ext
    return f


def dem_step(cfg: DEMConfig, state: ParticleState, ext: torch.Tensor | None = None) -> ParticleState:
    """One semi-implicit Euler substep."""
    f = forces(cfg, state, ext)
    a = f / state.mass[:, None]
    v = state.v + cfg.dt * a
    x = state.x + cfg.dt * v
    return ParticleState(x=x, v=v, a=a, mass=state.mass, radius=state.radius)


def dem_run(cfg: DEMConfig, state: ParticleState, num_steps: int,
            ext: torch.Tensor | None = None) -> ParticleState:
    """num_steps substeps; `ext` (P, 3) is an external per-particle force
    held fixed over the substeps (the fluid drag of dem.coupling)."""
    for _ in range(num_steps):
        state = dem_step(cfg, state, ext)
    return state


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    return 0.5 * torch.sum(state.mass * torch.sum(state.v * state.v, dim=-1))
