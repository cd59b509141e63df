"""Particle state container (counterpart of dedflow_tpu/dem/particles.py).

The reference hard-codes mass=1.0 and radius=0.1 (Particle.c:22-25); here
they are per-particle tensors with those defaults. The HDF5 reader and
writer of the JAX module (`save_particles`, `load_particles`) need h5py and
come with the port's HDF5 I/O (ROADMAP queue A17).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device


@dataclass
class ParticleState:
    """SoA particle state; all tensors (P, 3) or (P,)."""

    x: torch.Tensor  # positions
    v: torch.Tensor  # velocities
    a: torch.Tensor  # accelerations (stored for I/O parity; recomputed)
    mass: torch.Tensor | None  # (P,)
    radius: torch.Tensor  # (P,)

    @property
    def num_particle(self) -> int:
        return int(self.x.shape[0])


def particle_state(
    x: np.ndarray,
    v: np.ndarray | None = None,
    mass: float | np.ndarray = 1.0,
    radius: float | np.ndarray = 0.1,
    device="cuda",
    dtype=None,
) -> ParticleState:
    """Create a state on `device` (the card unless the caller asks for the
    CPU); the dtype follows the device (float32 on CUDA, float64 on the
    CPU) unless given. Defaults mirror Particle.c:22-25."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    x = np.asarray(x, dtype=float)
    p = x.shape[0]
    if v is None:
        v = np.zeros_like(x)
    mass = np.broadcast_to(np.asarray(mass, dtype=float), (p,))
    radius = np.broadcast_to(np.asarray(radius, dtype=float), (p,))
    conv = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return ParticleState(
        x=conv(x), v=conv(v), a=conv(np.zeros_like(x)), mass=conv(mass), radius=conv(radius)
    )
