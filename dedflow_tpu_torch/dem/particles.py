"""Particle state container (counterpart of dedflow_tpu/dem/particles.py).

The reference hard-codes mass=1.0 and radius=0.1 (Particle.c:22-25); here
they are per-particle tensors with those defaults. Particle files use the
reference's group layout (Particle.c:87-118): `save_particles` /
`load_particles` write and read them with h5py, imported only inside them;
`particle_datasets` / `particles_from_datasets` are the same layout as
NumPy arrays in a dict, for a machine without h5py.
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


def particle_datasets(state: ParticleState) -> dict:
    """{dataset name: NumPy array} of a particle group: coord / vel / acc
    flat (3P,), mass (unless the state has none) and radius (P,), in the
    state's dtype."""
    host = lambda t: t.detach().cpu().numpy()
    d = {name: host(t).reshape(-1) for name, t in (("coord", state.x), ("vel", state.v),
                                                   ("acc", state.a))}
    if state.mass is not None:
        d["mass"] = host(state.mass)
    d["radius"] = host(state.radius)
    return d


def particles_from_datasets(d, device="cuda", dtype=None) -> ParticleState:
    """The state of a particle group's datasets `d` (a dict of
    particle_datasets or an open h5py group) on `device`; mass and radius
    are optional and default to 1.0 and 0.1 (the reference stores neither,
    Particle.c:22-25)."""
    x = np.asarray(d["coord"]).reshape(-1, 3)
    v = np.asarray(d["vel"]).reshape(-1, 3)
    a = np.asarray(d["acc"]).reshape(-1, 3)
    p = x.shape[0]
    mass = np.asarray(d["mass"]) if "mass" in d else np.ones(p)
    radius = np.asarray(d["radius"]) if "radius" in d else np.full(p, 0.1)
    st = particle_state(x, v, mass=mass, radius=radius, device=device, dtype=dtype)
    st.a = torch.tensor(a, dtype=st.x.dtype, device=st.x.device)
    return st


def save_particles(path: str, group: str, state: ParticleState) -> None:
    """Write particle_datasets(state) into `group` of the file at `path`
    (appending to the file, replacing the group's datasets), as
    dedflow_tpu/dem/particles.py:59 does."""
    import h5py

    with h5py.File(path, "a") as f:
        g = f.require_group(group)
        for name, arr in particle_datasets(state).items():
            if name in g:
                del g[name]
            g.create_dataset(name, data=arr)


def load_particles(path: str, group: str, device="cuda", dtype=None) -> ParticleState:
    """particles_from_datasets of `group` in the file at `path`."""
    import h5py

    with h5py.File(path, "r") as f:
        return particles_from_datasets(f[group], device=device, dtype=dtype)
