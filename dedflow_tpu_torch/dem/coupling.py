"""FEM <-> DEM coupling: point location, interpolation, reaction scatter
(counterpart of dedflow_tpu/dem/coupling.py).

- particles are located in tets with the static-shape cell grid of the
  contact search (elements bucketed by centroid; each particle tests the
  27 surrounding cells' candidates with barycentric coordinates), or, on a
  box mesh, in closed form (`locate_lattice`: the containing cell is
  floor((p - origin)/h) and only its 6 Kuhn tets are tested),
- fluid velocity interpolates to particles with P1 weights,
- drag follows Stokes' law F = 6 pi mu r (u_f - v_p),
- the equal-and-opposite reaction goes back to the mesh nodes with the
  same barycentric weights (momentum-conserving by construction).

The JAX functions read xg, ien, inv_j and det_j from the general
FEMContext, which the port does not build; `CouplingGeometry` holds just
those four, computed by fem.element.tet_geometry (the JAX context's own
convention). `reaction_to_nodes` is deterministic on the card: a stable
sort of the (node, contribution) pairs and a segmented sum
(torch.segment_reduce) in place of an atomic scatter-add.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.dem.cells import CellGrid, build_buckets, candidate_lists, cell_stats, make_grid
from dedflow_tpu_torch.dem.particles import ParticleState
from dedflow_tpu_torch.fem.element import tet_geometry


@dataclass
class CouplingGeometry:
    """Device-resident mesh tables for the coupling."""

    xg: torch.Tensor  # (N, 3)
    ien: torch.Tensor  # (ne, 4) int64
    inv_j: torch.Tensor  # (ne, 3, 3) signed inverse element Jacobian
    det_j: torch.Tensor  # (ne,) |det J|


def coupling_geometry(xg: np.ndarray, ien: np.ndarray, device, dtype) -> CouplingGeometry:
    """xg and ien on the device, with the element geometry computed there
    in `dtype` (as the JAX build_context does)."""
    xg_t = torch.as_tensor(np.asarray(xg), dtype=dtype, device=device)
    ien_t = torch.as_tensor(np.asarray(ien, dtype=np.int64), device=device)
    geom = tet_geometry(xg_t[ien_t])
    return CouplingGeometry(xg=xg_t, ien=ien_t, inv_j=geom.inv_j, det_j=geom.det_j)


def element_grid(mesh_xg: np.ndarray, ien: np.ndarray, capacity: int | None = None) -> CellGrid:
    """Cell grid sized to the mesh: cell_size = max element diameter, so a
    point's containing element always has its centroid within one cell.
    Capacity defaults to the true maximum centroid count per cell."""
    xe = np.asarray(mesh_xg)[np.asarray(ien)]  # (ne, 4, 3)
    # exclude degenerate (zero-volume) elements from the capacity estimate
    j = xe[:, 1:, :] - xe[:, :1, :]
    real = np.abs(np.linalg.det(j)) > 0.0
    xe_r = xe[real] if real.any() else xe
    diam = np.linalg.norm(xe_r[:, :, None, :] - xe_r[:, None, :, :], axis=-1).max()
    lo = np.asarray(mesh_xg).min(axis=0)
    hi = np.asarray(mesh_xg).max(axis=0)
    grid = make_grid(lo, hi, float(diam) * 1.001, capacity=1)
    if capacity is None:
        capacity = cell_stats(grid, xe_r.mean(axis=1))["max_per_cell"]
    return make_grid(lo, hi, float(diam) * 1.001, capacity=int(capacity))


def _default_tol(x_p: torch.Tensor) -> float:
    """Barycentric slack accepting points on element faces; f32 roundoff
    in xi is ~1e-7, so f32 needs more slack than f64."""
    return 1.0e-10 if x_p.dtype == torch.float64 else 1.0e-5


def _first_inside(e, bary, inside):
    """(elem (P,) int32 with -1 = not found, bary (P, 4)) of the first
    candidate whose test passed (argmax over booleans picks the first)."""
    first = torch.argmax(inside.to(torch.uint8), dim=1)  # (P,)
    found = torch.gather(inside, 1, first[:, None])[:, 0]
    e_first = torch.gather(e, 1, first[:, None])[:, 0]
    elem = torch.where(found, e_first, torch.full_like(e_first, -1))
    w = torch.gather(bary, 1, first[:, None, None].expand(-1, 1, 4))[:, 0]
    w = torch.where(found[:, None], w, torch.zeros((), dtype=w.dtype, device=w.device))
    return elem.to(torch.int32), w


def _bary(geom: CouplingGeometry, e: torch.Tensor, x_p: torch.Tensor) -> torch.Tensor:
    """(P, M, 4) P1 weights of points x_p (P, 3) in elements e (P, M):
    xi = J^-1 (p - x_0), weights (1 - sum(xi), xi_1, xi_2, xi_3)."""
    x0 = geom.xg[geom.ien[e, 0]]  # (P, M, 3)
    xi = torch.einsum("pmij,pmj->pmi", geom.inv_j[e], x_p[:, None, :] - x0)
    lam0 = 1.0 - torch.sum(xi, dim=-1)
    return torch.cat([lam0[..., None], xi], dim=-1)


def locate(grid: CellGrid, geom: CouplingGeometry, x_p: torch.Tensor, tol: float | None = None):
    """Containing tet of each point: (elem (P,) int32, -1 = not found;
    bary (P, 4))."""
    if tol is None:
        tol = _default_tol(x_p)
    centroids = torch.mean(geom.xg[geom.ien], dim=1)  # (ne, 3)
    # degenerate (padding) elements go to the ghost corner cell, so they
    # cannot crowd real elements out of a bucket (filtered by det_j > 0)
    far = torch.tensor(grid.origin, dtype=centroids.dtype, device=x_p.device) - 10.0 * grid.cell_size
    centroids = torch.where((geom.det_j > 0.0)[:, None], centroids, far[None, :])
    buckets = build_buckets(grid, centroids)
    cand = candidate_lists(grid, x_p, buckets)  # (P, M) element ids; ne = empty
    ne = centroids.shape[0]
    valid = cand < ne
    e = torch.clamp(cand, max=ne - 1).long()  # (P, M)
    bary = _bary(geom, e, x_p)
    nondegen = geom.det_j[e] > 0.0
    inside = valid & nondegen & torch.all(bary >= -tol, dim=-1)  # (P, M)
    return _first_inside(e, bary, inside)


def interpolate(geom: CouplingGeometry, elem, bary, field: torch.Tensor) -> torch.Tensor:
    """P1-interpolate a nodal field (N, ...) to particles (P, ...).
    Particles outside the mesh (elem = -1) get zeros (bary is zeroed)."""
    e = torch.clamp(elem, min=0).long()
    nodal = field[geom.ien[e]]  # (P, 4, ...)
    return torch.einsum("pa,pa...->p...", bary, nodal)


def stokes_drag(u_fluid: torch.Tensor, state: ParticleState, mu: float) -> torch.Tensor:
    """(P, 3) drag force on particles: 6 pi mu r (u_f - v_p)."""
    coef = 6.0 * math.pi * mu * state.radius
    return coef[:, None] * (u_fluid - state.v)


def reaction_to_nodes(geom: CouplingGeometry, elem, bary, f_particle, num_node: int) -> torch.Tensor:
    """-f_particle summed onto the mesh nodes with barycentric weights,
    (N, 3). Deterministic: contributions sorted stably by node and summed
    per node in that order (one segmented sum, no atomics)."""
    e = torch.clamp(elem, min=0).long()
    nodes = geom.ien[e].reshape(-1)  # (4P,)
    vals = (-bary[..., None] * f_particle[:, None, :]).reshape(-1, 3)
    order = torch.argsort(nodes, stable=True)
    lengths = torch.bincount(nodes, minlength=num_node)
    return torch.segment_reduce(
        vals[order], "sum", lengths=lengths, axis=0, unsafe=True, initial=0.0
    )


def _exchange(geom, elem, bary, state, w, mu):
    u_p = interpolate(geom, elem, bary, w[:, :3])
    f_d = stokes_drag(u_p, state, mu)
    # no force where the particle is outside the fluid mesh
    f_d = torch.where((elem >= 0)[:, None], f_d, torch.zeros((), dtype=f_d.dtype, device=f_d.device))
    return f_d, reaction_to_nodes(geom, elem, bary, f_d, w.shape[0])


def drag_exchange(grid: CellGrid, geom: CouplingGeometry, state: ParticleState,
                  w: torch.Tensor, mu: float):
    """One coupling exchange: (particle drag force (P, 3), nodal reaction
    force (N, 3)); `w` (N, 6) is the fluid state."""
    elem, bary = locate(grid, geom, state.x)
    return _exchange(geom, elem, bary, state, w, mu)


def locate_lattice(lattice: tuple, origin: np.ndarray, spacing: np.ndarray,
                   geom: CouplingGeometry, x_p: torch.Tensor, tol: float | None = None):
    """Closed-form point location on a box mesh: the containing cell is
    floor((p - origin)/h), and only its 6 Kuhn tets are tested (the same
    (elem, bary) contract as `locate`). Element ids follow
    mesh.gen.box_mesh's cell-major order e = ((ix*ny + iy)*nz + iz)*6 + t."""
    if tol is None:
        tol = _default_tol(x_p)
    nx, ny, nz = lattice
    dev, dtype = x_p.device, x_p.dtype
    rel = (x_p - torch.as_tensor(np.asarray(origin), dtype=dtype, device=dev)[None, :]) / \
        torch.as_tensor(np.asarray(spacing), dtype=dtype, device=dev)[None, :]
    dims_i = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)
    coords = torch.minimum(torch.clamp(torch.floor(rel).to(torch.int32), min=0), dims_i - 1)
    dims_f = torch.tensor([nx, ny, nz], dtype=dtype, device=dev)
    inside_box = torch.all((rel >= -tol) & (rel <= dims_f + tol), dim=-1)
    cell = (coords[:, 0] * ny + coords[:, 1]) * nz + coords[:, 2]
    e = cell[:, None].long() * 6 + torch.arange(6, device=dev)[None, :]  # (P, 6)
    bary = _bary(geom, e, x_p)  # (P, 6, 4)
    inside = inside_box[:, None] & (geom.det_j[e] > 0.0) & torch.all(bary >= -tol, dim=-1)
    return _first_inside(e, bary, inside)


def drag_exchange_lattice(lattice: tuple, origin, spacing, geom: CouplingGeometry,
                          state: ParticleState, w: torch.Tensor, mu: float):
    """drag_exchange with the closed-form lattice locator."""
    elem, bary = locate_lattice(lattice, np.asarray(origin), np.asarray(spacing), geom, state.x)
    return _exchange(geom, elem, bary, state, w, mu)
