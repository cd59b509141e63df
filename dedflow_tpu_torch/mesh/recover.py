"""Structured-lattice recovery for converted (unstructured-format) meshes
(NumPy copy of dedflow_tpu/mesh/recover.py).

The reference's real workload is a gmsh-generated box mesh converted to the
flat HDF5 schema (tools/mesh_convert.py; loaded by Mesh3DCreateH5,
Mesh.c:78) - topologically a structured lattice, but stored as an
unstructured tet soup with arbitrary node numbering. The reference's
assembly does not care (AssembleSystemTet gathers through `ien`,
assemble.cu:1467-1762); the gather-free lattice tier (fem.lattice) needs
the structured numbering.

`recover_lattice` detects that structure and returns an equivalent mesh in
lattice order plus the node permutation:

1. node coordinates factor into an axis-aligned tensor grid
   (nx+1) x (ny+1) x (nz+1) - spacing may be non-uniform (graded);
2. every tet's vertices are corners of one grid cell, and every cell is
   subdivided into the SAME set of T <= 8 corner-pattern tets (e.g. the
   6-tet Kuhn split the generator uses, or any uniform transfinite split
   gmsh emits).

The permuted mesh carries `lattice=(nx, ny, nz)` and `lattice_tets`
((T, 4) cube-corner ids, corner = ix + 2*iy + 4*iz), which
fem.lattice.build_lattice_context consumes in place of the built-in Kuhn
table - so the lattice tier assembles the FILE's discretization, not a
substitute. Checkerboard (cell-parity-alternating) splits and meshes with
interior Steiner nodes do not satisfy (2); the solver's tier ladder then
tries the translation-class tier or the general ones.
"""

from __future__ import annotations

import numpy as np

from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


def _axis_levels(vals: np.ndarray, tol: float) -> np.ndarray | None:
    """Cluster a coordinate axis into grid levels (centers, ascending)."""
    u = np.unique(vals)
    if u.size < 2:
        return None
    gaps = np.diff(u)
    span = u[-1] - u[0]
    if span <= 0:
        return None
    brk = gaps > tol * span
    # cluster means
    gid = np.concatenate([[0], np.cumsum(brk)])
    levels = np.bincount(gid, weights=u) / np.bincount(gid)
    if levels.size < 2:
        return None
    # clusters must be well separated vs their own width
    width = np.max(
        np.bincount(gid, weights=np.abs(u - levels[gid]))
    )
    if width > 0.01 * np.min(np.diff(levels)):
        return None
    return levels


def recover_lattice(
    mesh: Mesh, tol: float = 1e-6
) -> tuple[Mesh, np.ndarray] | None:
    """Try to recover structured-box ordering. Returns (permuted_mesh,
    perm) with `perm[old_node_id] = new_node_id`, or None if the mesh is
    not a uniformly-subdivided axis-aligned box lattice."""
    xg = np.asarray(mesh.xg, dtype=np.float64)
    n = xg.shape[0]
    levels = [_axis_levels(xg[:, d], tol) for d in range(3)]
    if any(lv is None for lv in levels):
        return None
    dims = [lv.size for lv in levels]  # nx+1, ny+1, nz+1
    if dims[0] * dims[1] * dims[2] != n:
        return None
    nx, ny, nz = dims[0] - 1, dims[1] - 1, dims[2] - 1
    # integer coordinates per node (nearest level; verify within cluster)
    ijk = np.empty((n, 3), dtype=np.int64)
    for d in range(3):
        lv = levels[d]
        pos = np.clip(np.searchsorted(lv, xg[:, d]) , 0, lv.size - 1)
        pos = np.where(
            (pos > 0)
            & (
                np.abs(xg[:, d] - lv[np.maximum(pos - 1, 0)])
                < np.abs(xg[:, d] - lv[pos])
            ),
            pos - 1,
            pos,
        )
        ijk[:, d] = pos
    perm = ijk[:, 0] + dims[0] * (ijk[:, 1] + dims[1] * ijk[:, 2])
    # every grid point occupied exactly once
    if np.unique(perm).size != n:
        return None

    # --- per-tet corner signatures
    ien = np.asarray(mesh.ien, dtype=np.int64)
    if ien.size == 0 or mesh.extra_cells:
        return None
    vi = ijk[ien]  # (ne, 4, 3)
    base = vi.min(axis=1)  # (ne, 3)
    rel = vi - base[:, None, :]
    if rel.min() < 0 or rel.max() > 1:
        return None
    corner = rel[:, :, 0] + 2 * rel[:, :, 1] + 4 * rel[:, :, 2]  # (ne, 4)
    # 4 distinct corners per tet
    csort = np.sort(corner, axis=1)
    if np.any(np.diff(csort, axis=1) == 0):
        return None
    ncell = nx * ny * nz
    if base[:, 0].max() >= nx or base[:, 1].max() >= ny or base[:, 2].max() >= nz:
        return None
    cell = base[:, 0] + nx * (base[:, 1] + ny * base[:, 2])
    sig = ((csort[:, 0] * 8 + csort[:, 1]) * 8 + csort[:, 2]) * 8 + csort[:, 3]
    uniq, sig_id = np.unique(sig, return_inverse=True)
    t_count = uniq.size
    ne = ien.shape[0]
    if t_count > 8 or ne != t_count * ncell:
        return None
    # each cell carries each signature exactly once
    occ = np.zeros((t_count, ncell), dtype=np.int8)
    np.add.at(occ, (sig_id, cell), 1)
    if occ.min() != 1 or occ.max() != 1:
        return None

    # --- per-signature vertex order, taken VERBATIM from the file. The
    # VMS stabilization metric G = J^-T J^-1 is not invariant under
    # reference-tet vertex re-ordering (the remap is a non-orthogonal
    # affine), so tau and hence the residual depend on the file's vertex
    # order; the lattice tables must reproduce it exactly. Require the
    # order to be identical for every cell of a given signature (true of
    # transfinite/converted meshes, which stamp one template per cell).
    unit = np.array(
        [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
        dtype=np.float64,
    )
    first = np.full(t_count, ne, dtype=np.int64)
    np.minimum.at(first, sig_id, np.arange(ne, dtype=np.int64))
    tets = corner[first]  # (T, 4) file vertex order per signature
    if not np.array_equal(corner, tets[sig_id]):
        return None  # inconsistent per-cell vertex ordering
    vol = 0.0
    for cs in tets:
        p = unit[cs]
        det = np.linalg.det(p[1:] - p[0])
        if det <= 0.0:
            return None  # degenerate or negatively-oriented template
        vol += det / 6.0
    # the T tets must tile the cell exactly (no overlaps/holes)
    if abs(vol - 1.0) > 1e-12:
        return None

    # --- permuted mesh (element order preserved; vertex order per element
    # preserved, so f2e/forn stay valid)
    inv = np.argsort(perm)
    xg2 = xg[inv]
    ien2 = perm[ien].astype(INDEX_DTYPE)
    bnds = [
        Boundary(
            nodes=np.sort(perm[b.nodes]).astype(INDEX_DTYPE),
            ien=perm[np.asarray(b.ien, dtype=np.int64)].astype(INDEX_DTYPE),
            f2e=b.f2e.copy(),
            forn=b.forn.copy(),
        )
        for b in mesh.boundaries
    ]
    mesh2 = Mesh(
        xg=xg2,
        ien=ien2,
        boundaries=bnds,
        lattice=(nx, ny, nz),
        lattice_tets=np.asarray(tets, dtype=np.int64),
    )
    return mesh2, perm
