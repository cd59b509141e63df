"""Dense grid-resident DEM (counterpart of dedflow_tpu/dem/grid.py).

Particle state lives on the cell grid as (K, NC) arrays (slot-major, flat
cells last, z fastest; K = cell capacity). Neighbour (dx, dy, dz) of cell c
is cell c + (dx*NY + dy)*NZ + dz, so the contact forces are a dense sweep
over 27 neighbour offsets x K slots; re-bucketing happens every
`rebuild_every` substeps.

K11 `grid_pair_forces_cuda` is the contact sweep: on a CUDA tensor it
launches csrc/dem_contact.cu, which replaces the TPU kernel
dem/grid.py::_pair_kernel of the JAX package; on a CPU tensor it runs
`grid_pair_forces`, the plain twin (a copy of the JAX `grid_pair_forces`:
the fields zero-padded, then `_pair_sweep`). Nothing falls back: a CUDA
tensor the kernel cannot take raises. The rest of a substep (walls,
gravity, drag, the update, to_grid/from_grid) is plain torch, as it is XLA
code in JAX.

On N ranks (`dem_run_grid(shard=comm)`, a parallel.spmd.SlabComm; the
counterpart of the JAX `grid_run_shardmap` and `shard_halo_fits`) rank r
holds the cells [r nloc, (r + 1) nloc) of the flat cell axis, padded to a
multiple of N with empty cells, and trades omax-wide bands with its two
neighbours: mask, radius and pid once a rebuild window, pos and vel every
substep. K11's halo entry `halo_pair_forces_cuda` (the same kernel and C
entry, given the window's column of the first centre and its row stride)
sweeps the rank's own cells on the window [left band | own | right band];
its plain twin is `_pair_sweep` on that window, the JAX function of the
same name. Every centre reads the same candidates in the same order as on
the whole grid, so the run equals one process's bit for bit. Re-bucketing
stays global, as in JAX: every rank holds every particle between windows,
runs the same to_grid and keeps its slab; after a window the ranks' slots
come back through one all-reduce of disjoint (P, 7) rows. A grid whose
omax does not fit a slab runs replicated on every rank, as JAX's does;
`dem_run_grid.windows` counts the windows each way ran.
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


def halo_width(grid: CellGrid) -> int:
    """omax = (ny + 1) nz + 1: the farthest neighbour column of the sweep,
    the width of a cell slab's bands."""
    return max(abs(o) for o in _offsets(grid))


def _pair_sweep(center, padded, offs, omax, nc, k, prm):
    """Dense 27-offset x K-slot contact sweep (the JAX `_pair_sweep`, the
    plain twin of K11 and of its halo entry): 3 x (K, nc) forces.
    `center` = (pos, vel, radius, mask, pid), the (K, nc) centre fields;
    `padded` = (m_p, pos_p, vel_p, r_p, pid_p), the same fields widened to
    (K, nc + 2 omax) along the cell axis, the centres at columns
    [omax, omax + nc). Pad columns must have mask 0 (zero fill, or a
    neighbour rank's band); a shift that wraps across a grid row reads a
    far cell, never in contact. Each pair term is computed elementwise as
    in the JAX sweep, then summed in its order (offsets, then slots kp;
    normal before tangential)."""
    pos, vel, radius, mask, pid = center
    m_p, pos_p, vel_p, r_p, pid_p = padded
    f = [torch.zeros_like(mask) for _ in range(3)]
    tangential = prm.mu > 0.0 and prm.gamma_t > 0.0
    # centre fields as (K, 1, nc) against neighbour slots (1, K, nc)
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


def grid_pair_forces(grid: CellGrid, gs: GridState, prm: ContactParams):
    """Plain twin of K11: 3 x (K, NC) contact forces by the dense
    27-offset x K-slot sweep, in the JAX package's op order. The fields are
    zero-padded along the cell axis (pid with -1), so every neighbour
    shift is a slice and a neighbour outside [0, NC) has mask 0."""
    nc = gs.mask.shape[1]
    omax = halo_width(grid)
    padf = lambda a, v=0.0: torch.nn.functional.pad(a, (omax, omax), value=v)
    return _pair_sweep(
        (gs.pos, gs.vel, gs.radius, gs.mask, gs.pid),
        (padf(gs.mask), [padf(a) for a in gs.pos], [padf(a) for a in gs.vel],
         padf(gs.radius), padf(gs.pid, -1)),
        _offsets(grid), omax, nc, grid.capacity, prm,
    )


def halo_pair_forces(grid: CellGrid, win: GridState, nloc: int, prm: ContactParams):
    """Plain twin of K11's halo entry: 3 x (K, nloc) forces on the centre
    columns [omax, omax + nloc) of the window `win` (fields (K, nloc + 2
    omax): left band, own cells, right band), by `_pair_sweep`."""
    omax = halo_width(grid)
    cut = lambda a: a[:, omax : omax + nloc]
    return _pair_sweep(
        (tuple(cut(a) for a in win.pos), tuple(cut(a) for a in win.vel), cut(win.radius),
         cut(win.mask), cut(win.pid)),
        (win.mask, list(win.pos), list(win.vel), win.radius, win.pid),
        _offsets(grid), omax, nloc, grid.capacity, prm,
    )


def _kernel(grid: CellGrid, gs: GridState, prm: ContactParams, nloc: int | None = None):
    """K11 on a CUDA grid state: the whole grid (`nloc` None), or the
    halo entry on the window `gs` (fields (K, nloc + 2 omax), the centres
    its columns [omax, omax + nloc))."""
    k, ncw = gs.mask.shape
    c0, nc = (0, ncw) if nloc is None else (halo_width(grid), nloc)
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
        if tuple(t.shape) != (k, ncw):
            raise ValueError(f"dem_contact kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {(k, ncw)}")
    if gs.pid.dtype != torch.int32 or not gs.pid.is_cuda or tuple(gs.pid.shape) != (k, ncw) \
            or not gs.pid.is_contiguous():
        raise ValueError(f"dem_contact kernel: pid must be a contiguous {(k, ncw)} int32 CUDA "
                         f"tensor")
    want = grid.num_cell if nloc is None else nloc + 2 * c0
    if k != grid.capacity or ncw != want or nc < 1:
        raise ValueError(f"dem_contact kernel: fields are {(k, ncw)}, the grid "
                         f"{(grid.capacity, want)}")
    if k * ncw >= 2**31:
        raise ValueError("dem_contact kernel: K * NC must stay below 2**31")
    fn = nvcc.function(
        "dem_contact", "dedflow_dem_contact",
        [nvcc.P] * 12 + [nvcc.I] * 6 + [nvcc.D] * 5 + [nvcc.I, nvcc.P],
    )
    out = torch.empty((3, k, nc), dtype=torch.float32, device=gs.mask.device)
    _, ny, nz = grid.dims
    nvcc.check(
        fn(*(t.data_ptr() for t in fields.values()), gs.pid.data_ptr(),
           out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
           k, nc, c0, ncw, ny, nz, prm.k_n, prm.gamma_n, prm.mu, prm.gamma_t, prm.eps,
           int(prm.mu > 0.0 and prm.gamma_t > 0.0),
           torch.cuda.current_stream(gs.mask.device).cuda_stream),
        "dem_contact",
    )
    return list(out.unbind(0))


def grid_pair_forces_cuda(grid: CellGrid, gs: GridState, prm: ContactParams):
    """K11: 3 x (K, NC) contact forces. The CUDA kernel on a CUDA tensor,
    the plain twin on a CPU tensor."""
    if gs.mask.is_cuda:
        out = _kernel(grid, gs, prm)
        grid_pair_forces_cuda.launches += 1
        return out
    return grid_pair_forces(grid, gs, prm)


grid_pair_forces_cuda.launches = 0


def halo_pair_forces_cuda(grid: CellGrid, win: GridState, nloc: int, prm: ContactParams):
    """K11's halo entry: 3 x (K, nloc) contact forces on a rank's cell
    slab, the centre columns [omax, omax + nloc) of the window `win`
    (fields (K, nloc + 2 omax)). The CUDA kernel on a CUDA tensor (counted
    apart from the whole grid's), the plain twin `halo_pair_forces` on a
    CPU tensor."""
    if win.mask.is_cuda:
        out = _kernel(grid, win, prm, nloc)
        halo_pair_forces_cuda.launches += 1
        return out
    return halo_pair_forces(grid, win, nloc, prm)


halo_pair_forces_cuda.launches = 0


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


def _window(comm, x: torch.Tensor, omax: int) -> torch.Tensor:
    """[left neighbour's last omax columns | x | right neighbour's first
    omax columns] along the last axis, in one band exchange; zeros (mask 0)
    where there is no neighbour rank, as the JAX ppermute gives."""
    left, right = comm.bands(x, omax)
    zero = lambda: torch.zeros(x.shape[:-1] + (omax,), dtype=x.dtype, device=x.device)
    return torch.cat([zero() if left is None else left, x, zero() if right is None else right],
                     dim=-1)


def grid_run_shardmap(cfg: DEMConfig, gs: GridState, mass: float, num_steps: int,
                      ext: tuple | None, comm) -> GridState:
    """num_steps substeps of this rank's cell slab `gs` ((K, nloc) fields,
    its own cells) on a chain of ranks (`comm`, parallel.spmd.SlabComm):
    the counterpart of the JAX grid_run_shardmap. mask, radius and pid
    trade their omax-wide bands once; pos and vel (six rows, one exchange)
    every substep; then K11's halo entry on the window, the local forces
    and the update on the own cells. Requires omax <= nloc
    (`shard_halo_fits`)."""
    grid, omax = cfg.grid, halo_width(cfg.grid)
    nloc = gs.mask.shape[1]
    if omax > nloc:
        raise ValueError(f"grid_run_shardmap: a slab of {nloc} cells is narrower than the "
                         f"sweep's reach omax = {omax} (shard_halo_fits)")
    static = _window(comm, torch.stack([gs.radius, gs.mask]), omax)
    pid_w = _window(comm, gs.pid, omax)
    pos, vel = gs.pos, gs.vel
    for _ in range(num_steps):
        moving = _window(comm, torch.stack([*pos, *vel]), omax)
        win = GridState(pos=tuple(moving[:3]), vel=tuple(moving[3:]), radius=static[0],
                        mask=static[1], pid=pid_w)
        f = halo_pair_forces_cuda(grid, win, nloc, cfg.contact)
        f = _local_forces(cfg, pos, vel, gs.radius, gs.mask, mass, ext, f)
        vel = tuple(vel[c] + (cfg.dt / mass) * f[c] * gs.mask for c in range(3))
        pos = tuple(pos[c] + cfg.dt * vel[c] * gs.mask for c in range(3))
    return GridState(pos=pos, vel=vel, radius=gs.radius, mask=gs.mask, pid=gs.pid)


def shard_halo_fits(grid: CellGrid, num_cells_padded: int, nparts: int) -> bool:
    """True when the contact sweep's neighbour window fits inside one slab
    of the flat cell axis (the grid_run_shardmap precondition)."""
    return num_cells_padded % nparts == 0 and halo_width(grid) <= num_cells_padded // nparts


def _own_slab(gs: GridState, lo: int, hi: int, num_particle: int) -> GridState:
    """Columns [lo, hi) of the grid state, the cells past the grid's end
    empty (mask 0, pid = P), as the JAX padding of the cell axis."""
    nc = gs.mask.shape[1]
    pad = hi - max(min(hi, nc), lo)
    cut = lambda a, v=0.0: torch.nn.functional.pad(a[:, lo:hi], (0, pad), value=v).contiguous()
    return GridState(pos=tuple(cut(a) for a in gs.pos), vel=tuple(cut(a) for a in gs.vel),
                     radius=cut(gs.radius), mask=cut(gs.mask), pid=cut(gs.pid, num_particle))


def _ext_on_grid(ext: torch.Tensor, gs: GridState, p: int) -> tuple:
    """The per-particle force (P, 3) on the grid slots (zero where empty)."""
    safe = torch.clamp(gs.pid, max=p - 1).long()
    real = (gs.pid < p).to(gs.mask.dtype)
    return tuple(ext[:, c][safe] * real for c in range(3))


def _from_slabs(gs: GridState, prev: ParticleState, comm) -> ParticleState:
    """from_grid over every rank's slab: each rank scatters its live slots
    by pid into (P, 7) rows (x, v and a 1), every other entry -0.0, and one
    all-reduce sums the disjoint rows, so each value arrives exactly (x +
    -0.0 = x). A particle in no slot (a cell overflow) keeps `prev`."""
    p = prev.num_particle
    pid = gs.pid.reshape(-1)
    real = pid < p
    cols = [a.reshape(-1)[real] for a in (*gs.pos, *gs.vel)]
    buf = torch.full((p, 7), -0.0, dtype=prev.x.dtype, device=prev.x.device)
    buf[pid[real].long()] = torch.stack(cols + [torch.ones_like(cols[0])], dim=-1)
    buf = comm.allreduce_sum(buf)
    held = (buf[:, 6] > 0)[:, None]
    x = torch.where(held, buf[:, :3], prev.x)
    v = torch.where(held, buf[:, 3:6], prev.v)
    return ParticleState(x=x, v=v, a=torch.zeros_like(x), mass=None, radius=prev.radius)


def dem_run_grid(cfg: DEMConfig, state: ParticleState, num_steps: int,
                 rebuild_every: int = 20, ext: torch.Tensor | None = None,
                 shard=None) -> ParticleState:
    """Grid-resident DEM driver: rebuild buckets every `rebuild_every`
    substeps, integrate densely in between. Uniform mass assumed (read to
    the host once per call). `ext` (P, 3) is an external per-particle force
    (the fluid drag), mapped onto the grid at each rebuild.

    `shard`: this rank's parallel.spmd.SlabComm (every rank calls with the
    same particles): the flat cell axis, padded to a multiple of the ranks
    with empty cells, is cut into contiguous slabs and each window's
    substeps run on the rank's slab (grid_run_shardmap); the result is the
    same on every rank and equals one process's bit for bit. Where the
    sweep's reach does not fit a slab (`shard_halo_fits`), every rank runs
    the whole grid, as the JAX package does. `dem_run_grid.windows` counts
    the windows run on slabs and replicated."""
    p = state.num_particle
    mass = float(state.mass[0])
    slab = None
    if shard is not None:
        if not (hasattr(shard, "bands") and hasattr(shard, "allreduce_sum")):
            raise TypeError("dem_run_grid(shard=) takes this rank's parallel.spmd.SlabComm "
                            f"(the ranks' communicator), not {type(shard).__name__}")
        nc = cfg.grid.num_cell
        ncp = -(-nc // shard.world) * shard.world
        if shard_halo_fits(cfg.grid, ncp, shard.world):
            nloc = ncp // shard.world
            slab = (shard.rank * nloc, (shard.rank + 1) * nloc)
    done = 0
    cur = state
    while done < num_steps:
        n = min(rebuild_every, num_steps - done)
        gs = to_grid(cfg.grid, cur, p)
        if slab is not None:
            own = _own_slab(gs, *slab, p)
            ext_g = None if ext is None else _ext_on_grid(ext, own, p)
            own = grid_run_shardmap(cfg, own, mass, n, ext_g, shard)
            new = _from_slabs(own, cur, shard)
            dem_run_grid.windows["slabs"] += 1
        else:
            ext_g = None if ext is None else _ext_on_grid(ext, gs, p)
            gs = grid_run(cfg, gs, mass, n, ext_g)
            new = from_grid(cfg.grid, gs, p, prev=cur)
            if shard is not None:
                dem_run_grid.windows["replicated"] += 1
        cur = ParticleState(x=new.x, v=new.v, a=new.a, mass=state.mass, radius=state.radius)
        done += n
    return cur


dem_run_grid.windows = {"slabs": 0, "replicated": 0}
