"""Dense grid-resident DEM (counterpart of dedflow_tpu/dem/grid.py).

Particle state lives on the cell grid as (K, NC) arrays (slot-major, flat
cells last, z fastest; K = cell capacity). Neighbour (dx, dy, dz) of cell c
is cell c + (dx*NY + dy)*NZ + dz, so the contact forces are a dense sweep
over 27 neighbour offsets x K slots; re-bucketing happens every
`rebuild_every` substeps.

K11 `grid_pair_forces_cuda` is the contact sweep: on a CUDA tensor it
launches csrc/dem_contact.cu, which replaces the TPU kernel
dem/grid.py::_pair_kernel of the JAX package; on a CPU tensor it runs
`grid_pair_forces`, the plain twin (a copy of the JAX `_pair_sweep` /
`grid_pair_forces`). Nothing falls back: a CUDA tensor the kernel cannot
take raises. The rest of a substep (walls, gravity, drag, the update,
to_grid/from_grid) is plain torch, as it is XLA code in JAX.

Not ported here: `grid_run_shardmap` and `shard_halo_fits` (multi-device,
ROADMAP queue A16 (c)); `dem_run_grid(shard=...)` raises naming A16 (c).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dedflow_tpu_torch.dem.cells import CellGrid, cell_coords, sorted_ranks
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.integrate import DEMConfig
from dedflow_tpu_torch.dem.particles import ParticleState
from dedflow_tpu_torch.utils import nvcc


@dataclass
class GridState:
    """Grid-resident particle state; all tensors (K, NC) (NC = flat cells,
    z fastest). Empty slots: mask 0, pid = P (out of range)."""

    pos: tuple  # 3 x (K, NC)
    vel: tuple  # 3 x (K, NC)
    radius: torch.Tensor  # (K, NC)
    mask: torch.Tensor  # (K, NC) 0/1
    pid: torch.Tensor  # (K, NC) int32 particle id


def to_grid(grid: CellGrid, state: ParticleState, num_particle: int) -> GridState:
    """Bucket particles onto the grid (stable sort + rank + one scatter)."""
    p = num_particle
    k = grid.capacity
    nc = grid.num_cell
    coords = cell_coords(grid, state.x)
    nx, ny, nz = grid.dims
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    order, cid_s, rank = sorted_ranks(cid, nc)
    keep = rank < k  # overflow (rank >= K) is dropped
    slot = (rank * nc + cid_s)[keep]  # (K, NC) flattened: slot-major
    src = order[keep]

    def put(vals, fill):
        flat = torch.full((k * nc,), fill, dtype=vals.dtype, device=vals.device)
        flat[slot] = vals[src]
        return flat.reshape(k, nc)

    dev, dtype = state.x.device, state.x.dtype
    return GridState(
        pos=tuple(put(state.x[:, c], 0.0) for c in range(3)),
        vel=tuple(put(state.v[:, c], 0.0) for c in range(3)),
        radius=put(state.radius, 0.0),
        mask=put(torch.ones((p,), dtype=dtype, device=dev), 0.0),
        pid=put(torch.arange(p, dtype=torch.int32, device=dev), p),
    )


def from_grid(grid: CellGrid, gs: GridState, num_particle: int,
              prev: ParticleState | None = None) -> ParticleState:
    """Grid slots -> (P,) particle arrays via one scatter by pid. `prev`
    seeds the outputs, so a particle that overflowed its cell in to_grid
    carries its previous state through unchanged."""
    p = num_particle
    pid = gs.pid.reshape(-1)
    real = pid < p  # empty slots (pid = P) are dropped
    tgt = pid[real].long()

    def take(comp, seed):
        out = seed.clone() if seed is not None else torch.zeros(
            (p,), dtype=comp.dtype, device=comp.device
        )
        out[tgt] = comp.reshape(-1)[real]
        return out

    px = (None,) * 3 if prev is None else tuple(prev.x[:, c] for c in range(3))
    pv = (None,) * 3 if prev is None else tuple(prev.v[:, c] for c in range(3))
    x = torch.stack([take(gs.pos[c], px[c]) for c in range(3)], dim=-1)
    v = torch.stack([take(gs.vel[c], pv[c]) for c in range(3)], dim=-1)
    r = take(gs.radius, None if prev is None else prev.radius)
    return ParticleState(x=x, v=v, a=torch.zeros_like(x), mass=None, radius=r)


def _offsets(grid: CellGrid):
    nx, ny, nz = grid.dims
    offs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                offs.append((dx * ny + dy) * nz + dz)
    return offs


def grid_pair_forces(grid: CellGrid, gs: GridState, prm: ContactParams):
    """Plain twin of K11: 3 x (K, NC) contact forces by the dense
    27-offset x K-slot sweep, in the JAX package's op order. The fields are
    zero-padded along the cell axis (pid with -1), so every neighbour
    shift is a slice and a neighbour outside [0, NC) has mask 0; a shift
    that wraps across a grid row reads a far cell, never in contact."""
    k = grid.capacity
    nc = gs.mask.shape[1]
    offs = _offsets(grid)
    omax = max(abs(o) for o in offs)
    padf = lambda a, v=0.0: torch.nn.functional.pad(a, (omax, omax), value=v)
    pos, vel, radius, mask, pid = gs.pos, gs.vel, gs.radius, gs.mask, gs.pid
    m_p, r_p, pid_p = padf(mask), padf(radius), padf(pid, -1)
    pos_p = [padf(a) for a in pos]
    vel_p = [padf(a) for a in vel]
    f = [torch.zeros_like(mask) for _ in range(3)]
    tangential = prm.mu > 0.0 and prm.gamma_t > 0.0
    # centre fields as (K, 1, NC) against neighbour slots (1, K, NC): each
    # pair term is computed elementwise as in the JAX sweep, then summed in
    # its order (offsets, then slots kp; normal before tangential)
    ctr = lambda a: a[:, None, :]
    for o in offs:
        nbr = lambda a: a[None, :, omax + o : omax + o + nc]
        d = [ctr(pos[c]) - nbr(pos_p[c]) for c in range(3)]
        dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        dist = torch.sqrt(torch.clamp(dist2, min=prm.eps))
        delta = ctr(radius) + nbr(r_p) - dist
        # not self, both real, touching
        notself = ctr(pid) != nbr(pid_p)
        act = ctr(mask) * nbr(m_p) * notself.to(dist.dtype) * (delta > 0.0)
        vrel = [ctr(vel[c]) - nbr(vel_p[c]) for c in range(3)]
        n = [d[c] / dist for c in range(3)]
        vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2]
        w = act * (prm.k_n * delta - prm.gamma_n * vn)
        wn = [w * n[c] for c in range(3)]
        if tangential:
            vt = [vrel[c] - vn * n[c] for c in range(3)]
            vt_norm = torch.sqrt(
                torch.clamp(vt[0] ** 2 + vt[1] ** 2 + vt[2] ** 2, min=prm.eps)
            )
            ft = act * torch.minimum(
                prm.mu * torch.abs(prm.k_n * delta - prm.gamma_n * vn),
                prm.gamma_t * vt_norm,
            )
            st = [ft / vt_norm * vt[c] for c in range(3)]
        for kp in range(k):
            for c in range(3):
                f[c] = f[c] + wn[c][:, kp]
            if tangential:
                for c in range(3):
                    f[c] = f[c] - st[c][:, kp]
    return f


def _kernel(grid: CellGrid, gs: GridState, prm: ContactParams):
    k, nc = gs.mask.shape
    fields = {
        "pos_x": gs.pos[0], "pos_y": gs.pos[1], "pos_z": gs.pos[2],
        "vel_x": gs.vel[0], "vel_y": gs.vel[1], "vel_z": gs.vel[2],
        "radius": gs.radius, "mask": gs.mask,
    }
    for name, t in fields.items():
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"dem_contact kernel: {name} must be a contiguous float32 CUDA tensor "
                f"(got {t.dtype}, {t.device}, contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != (k, nc):
            raise ValueError(f"dem_contact kernel: {name} has shape {tuple(t.shape)}, expected {(k, nc)}")
    if gs.pid.dtype != torch.int32 or not gs.pid.is_cuda or tuple(gs.pid.shape) != (k, nc) \
            or not gs.pid.is_contiguous():
        raise ValueError("dem_contact kernel: pid must be a contiguous (K, NC) int32 CUDA tensor")
    if k != grid.capacity or nc != grid.num_cell:
        raise ValueError(f"dem_contact kernel: fields are {(k, nc)}, the grid "
                         f"{(grid.capacity, grid.num_cell)}")
    if k * nc >= 2**31:
        raise ValueError("dem_contact kernel: K * NC must stay below 2**31")
    fn = nvcc.function(
        "dem_contact", "dedflow_dem_contact",
        [nvcc.P] * 12 + [nvcc.I] * 4 + [nvcc.D] * 5 + [nvcc.I, nvcc.P],
    )
    out = torch.empty((3, k, nc), dtype=torch.float32, device=gs.mask.device)
    _, ny, nz = grid.dims
    nvcc.check(
        fn(*(t.data_ptr() for t in fields.values()), gs.pid.data_ptr(),
           out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
           k, nc, ny, nz, prm.k_n, prm.gamma_n, prm.mu, prm.gamma_t, prm.eps,
           int(prm.mu > 0.0 and prm.gamma_t > 0.0),
           torch.cuda.current_stream(gs.mask.device).cuda_stream),
        "dem_contact",
    )
    grid_pair_forces_cuda.launches += 1
    return list(out.unbind(0))


def grid_pair_forces_cuda(grid: CellGrid, gs: GridState, prm: ContactParams):
    """K11: 3 x (K, NC) contact forces. The CUDA kernel on a CUDA tensor,
    the plain twin on a CPU tensor."""
    if gs.mask.is_cuda:
        return _kernel(grid, gs, prm)
    return grid_pair_forces(grid, gs, prm)


grid_pair_forces_cuda.launches = 0


def _local_forces(cfg: DEMConfig, pos, vel, radius, mask, mass, ext, f):
    """Add the purely local terms (walls + gravity + drag + ext) to the
    contact forces `f` (updated in place and returned)."""
    prm = cfg.contact
    if cfg.walls_lo is not None:
        for axis in range(3):
            lo, hi = float(cfg.walls_lo[axis]), float(cfg.walls_hi[axis])
            d_lo = radius - (pos[axis] - lo)
            act = mask * (d_lo > 0)
            f[axis] = f[axis] + act * (prm.k_n * d_lo - prm.gamma_n * vel[axis])
            d_hi = radius - (hi - pos[axis])
            act = mask * (d_hi > 0)
            f[axis] = f[axis] - act * (prm.k_n * d_hi + prm.gamma_n * vel[axis])
    g = cfg.gravity
    for c in range(3):
        f[c] = f[c] + mask * (mass * g[c])
        if cfg.linear_drag:
            f[c] = f[c] - cfg.linear_drag * mask * vel[c]
        if ext is not None:
            f[c] = f[c] + mask * ext[c]
    return f


def grid_forces(cfg: DEMConfig, gs: GridState, mass: float, ext: tuple | None = None):
    """Total force on the grid: contacts (K11) + walls + gravity + drag
    (+ ext). The JAX `use_pallas` switch has no counterpart: on CUDA the
    kernel always runs."""
    f = grid_pair_forces_cuda(cfg.grid, gs, cfg.contact)
    return _local_forces(cfg, gs.pos, gs.vel, gs.radius, gs.mask, mass, ext, f)


def grid_run(cfg: DEMConfig, gs: GridState, mass: float, num_steps: int,
             ext: tuple | None = None) -> GridState:
    """num_steps semi-implicit Euler substeps on the grid (no re-bucket:
    the caller re-buckets before particles drift across the skin)."""
    for _ in range(num_steps):
        f = grid_forces(cfg, gs, mass, ext)
        vel = tuple(gs.vel[c] + (cfg.dt / mass) * f[c] * gs.mask for c in range(3))
        pos = tuple(gs.pos[c] + cfg.dt * vel[c] * gs.mask for c in range(3))
        gs = GridState(pos=pos, vel=vel, radius=gs.radius, mask=gs.mask, pid=gs.pid)
    return gs


def dem_run_grid(cfg: DEMConfig, state: ParticleState, num_steps: int,
                 rebuild_every: int = 20, ext: torch.Tensor | None = None,
                 shard: tuple | None = None) -> ParticleState:
    """Grid-resident DEM driver: rebuild buckets every `rebuild_every`
    substeps, integrate densely in between. Uniform mass assumed (read to
    the host once per call). `ext` (P, 3) is an external per-particle force
    (the fluid drag), mapped onto the grid at each rebuild."""
    if shard is not None:
        raise NotImplementedError(
            "dedflow_tpu_torch does not port the sharded grid DEM (shard=) yet "
            "(ROADMAP queue A16 (c))"
        )
    p = state.num_particle
    mass = float(state.mass[0])
    done = 0
    cur = state
    while done < num_steps:
        n = min(rebuild_every, num_steps - done)
        gs = to_grid(cfg.grid, cur, p)
        ext_g = None
        if ext is not None:
            safe = torch.clamp(gs.pid, max=p - 1).long()
            real = (gs.pid < p).to(gs.mask.dtype)
            ext_g = tuple(ext[:, c][safe] * real for c in range(3))
        gs = grid_run(cfg, gs, mass, n, ext_g)
        new = from_grid(cfg.grid, gs, p, prev=cur)
        cur = ParticleState(x=new.x, v=new.v, a=new.a, mass=state.mass, radius=state.radius)
        done += n
    return cur
