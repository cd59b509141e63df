"""Static-shape cell lists for neighbour search (counterpart of
dedflow_tpu/dem/cells.py).

1. linear cell id per particle (grid dims are static Python ints),
2. stable sort of the particles by cell id,
3. fixed-capacity bucket table (ncell, K) of particle indices, built by a
   rank-within-cell scatter (overflow beyond K is dropped; `cell_stats`
   reports the true maximum),
4. per-particle candidate list = the buckets of the 27 surrounding cells,
   a (P, 27*K) gather.

The sort is stable, as `jnp.argsort` is, so the rank of a particle within
its cell (and with it which particle overflows) is the JAX package's. JAX
drops out-of-range scatter targets and fills out-of-range gathers; torch
raises on them, so both are masked here explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CellGrid:
    """Static grid config (hashable)."""

    origin: tuple[float, float, float]
    cell_size: float
    dims: tuple[int, int, int]
    capacity: int  # K: max particles per cell kept

    @property
    def num_cell(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz


def make_grid(lo, hi, cell_size: float, capacity: int = 8, pad_cells: int = 1) -> CellGrid:
    """Grid covering [lo, hi] with one ghost layer so boundary particles
    get full 27-cell stencils without clamping artifacts."""
    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    dims = tuple(
        int(np.ceil((hi[i] - lo[i]) / cell_size)) + 2 * pad_cells for i in range(3)
    )
    origin = tuple(lo - pad_cells * cell_size)
    return CellGrid(origin=origin, cell_size=cell_size, dims=dims, capacity=capacity)


def cell_coords(grid: CellGrid, x: torch.Tensor) -> torch.Tensor:
    """(P, 3) int32 cell coordinates, clamped into the grid."""
    rel = (x - torch.tensor(grid.origin, dtype=x.dtype, device=x.device)) / grid.cell_size
    c = torch.floor(rel).to(torch.int32)
    hi = torch.tensor(grid.dims, dtype=torch.int32, device=x.device) - 1
    return torch.minimum(torch.clamp(c, min=0), hi)


def linear_ids(grid: CellGrid, coords: torch.Tensor) -> torch.Tensor:
    nx, ny, nz = grid.dims
    return (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]


def sorted_ranks(cid: torch.Tensor, num_cell: int):
    """(order, cid_sorted, rank): the stable sort of the cell ids and each
    sorted particle's rank within its cell (int64)."""
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order].long()
    starts = torch.searchsorted(cid_s, torch.arange(num_cell, device=cid.device))
    rank = torch.arange(cid.shape[0], device=cid.device) - starts[cid_s]
    return order, cid_s, rank


def build_buckets(grid: CellGrid, x: torch.Tensor) -> torch.Tensor:
    """(ncell * K,) int32 bucket table of particle indices; empty slots = P."""
    p = x.shape[0]
    k = grid.capacity
    order, cid_s, rank = sorted_ranks(linear_ids(grid, cell_coords(grid, x)), grid.num_cell)
    keep = rank < k  # overflow (rank >= K) is dropped
    buckets = torch.full((grid.num_cell * k,), p, dtype=torch.int32, device=x.device)
    buckets[(cid_s * k + rank)[keep]] = order[keep].to(torch.int32)
    return buckets


_OFFSETS = np.array(
    [(i, j, l) for i in (-1, 0, 1) for j in (-1, 0, 1) for l in (-1, 0, 1)],
    dtype=np.int32,
)  # (27, 3)


def candidate_lists(grid: CellGrid, x: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """(P, 27*K) int32 candidate neighbour indices per particle (P = empty)."""
    p = x.shape[0]
    k = grid.capacity
    nx, ny, nz = grid.dims
    dev = x.device
    coords = cell_coords(grid, x)  # (P, 3)
    nbr = coords[:, None, :] + torch.as_tensor(_OFFSETS, device=dev)[None]  # (P, 27, 3)
    dims = torch.tensor(grid.dims, dtype=torch.int32, device=dev)
    inside = torch.all((nbr >= 0) & (nbr < dims), dim=-1)  # (P, 27)
    ncid = (nbr[..., 0] * ny + nbr[..., 1]) * nz + nbr[..., 2]
    ncid = torch.where(inside, ncid, grid.num_cell)  # OOB -> sentinel cell
    slots = (ncid[..., None].long() * k + torch.arange(k, device=dev)).reshape(p, 27 * k)
    # the sentinel cell's slots lie past the table: they read as empty (P)
    valid = slots < buckets.shape[0]
    cand = buckets[torch.where(valid, slots, 0)]
    return torch.where(valid, cand, torch.full_like(cand, p))


def cell_stats(grid: CellGrid, x: np.ndarray) -> dict:
    """Host-side diagnostics: occupancy histogram and overflow check."""
    coords = np.clip(
        np.floor((np.asarray(x) - np.asarray(grid.origin)) / grid.cell_size),
        0,
        np.asarray(grid.dims) - 1,
    ).astype(np.int64)
    nx, ny, nz = grid.dims
    cid = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    counts = np.bincount(cid, minlength=grid.num_cell)
    return {
        "max_per_cell": int(counts.max()),
        "overflow": int(np.maximum(counts - grid.capacity, 0).sum()),
        "occupied_cells": int((counts > 0).sum()),
    }
