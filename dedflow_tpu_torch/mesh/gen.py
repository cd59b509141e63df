"""Built-in mesh generators (NumPy copy of dedflow_tpu/mesh/gen.py: box_mesh only).

The reference ships no mesh generator (it loads a pre-converted `box.h5`,
main.c:360); these generators produce meshes with the same table structure
so the framework is self-contained for tests and benchmarks.

Boundary group order for the box: [x-, x+, y-, y+, z-, z+] -> indices 0..5.
The reference scenario (main.c:454-477) uses boundary indices 0,2,3,4 for
strong BCs and 4 for the weak/Nitsche boundary; the app layer maps those
declaratively (dedflow_tpu.app.scenarios).
"""

from __future__ import annotations

import numpy as np

from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh, facet_tables_from_tris
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE

# Kuhn subdivision of the unit cube into 6 positively-oriented tets.
# Each row: 4 corner ids of the cube, corners numbered by bit pattern
# (ix + 2*iy + 4*iz).
_KUHN_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    dtype=np.int64,
)


def box_mesh(
    nx: int,
    ny: int,
    nz: int,
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0),
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Mesh:
    """Structured tet mesh of a box: nx*ny*nz cells, 6 tets per cell.

    Returns a mesh with 6 boundary groups in order [x-, x+, y-, y+, z-, z+],
    each carrying the full reference boundary tables (nodes, tri ien, f2e,
    forn; schema of mesh_convert.py:116-126).
    """
    lx, ly, lz = lengths
    ox, oy, oz = origin
    xs = np.linspace(ox, ox + lx, nx + 1)
    ys = np.linspace(oy, oy + ly, ny + 1)
    zs = np.linspace(oz, oz + lz, nz + 1)
    # Node id = ix + (nx+1)*(iy + (ny+1)*iz): x fastest.
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # order so that id formula holds: iterate iz outer, then iy, then ix
    xg = np.stack(
        [X.transpose(2, 1, 0), Y.transpose(2, 1, 0), Z.transpose(2, 1, 0)],
        axis=-1,
    ).reshape(-1, 3)

    def nid(ix, iy, iz):
        return ix + (nx + 1) * (iy + (ny + 1) * iz)

    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    corners = np.stack(
        [nid(ix + (c & 1), iy + ((c >> 1) & 1), iz + ((c >> 2) & 1)) for c in range(8)],
        axis=1,
    )  # (ncell, 8)
    ien = corners[:, _KUHN_TETS].reshape(-1, 4).astype(INDEX_DTYPE)

    # Boundary triangles: all tet faces that appear exactly once.
    opp = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    faces = ien[:, opp].reshape(-1, 3).astype(np.int64)  # (4*ne, 3)
    sfaces = np.sort(faces, axis=1)
    m = xg.shape[0]
    key = (sfaces[:, 0] * m + sfaces[:, 1]) * m + sfaces[:, 2]
    uniq, first, counts = np.unique(key, return_index=True, return_counts=True)
    btri = faces[first[counts == 1]]  # boundary triangles, original node order

    # Classify each boundary triangle by box side.
    cx = xg[btri].mean(axis=1)  # (nb, 3) centroids
    eps_ = np.array([lx / nx, ly / ny, lz / nz]) * 1e-6
    side_masks = [
        np.abs(cx[:, 0] - ox) < eps_[0],
        np.abs(cx[:, 0] - (ox + lx)) < eps_[0],
        np.abs(cx[:, 1] - oy) < eps_[1],
        np.abs(cx[:, 1] - (oy + ly)) < eps_[1],
        np.abs(cx[:, 2] - oz) < eps_[2],
        np.abs(cx[:, 2] - (oz + lz)) < eps_[2],
    ]
    boundaries = []
    for mask in side_masks:
        tris = btri[mask].astype(INDEX_DTYPE)
        f2e, forn = facet_tables_from_tris(ien, tris)
        nodes = np.unique(tris).astype(INDEX_DTYPE)
        boundaries.append(Boundary(nodes=nodes, ien=tris, f2e=f2e, forn=forn))
    mesh = Mesh(xg=xg, ien=ien, boundaries=boundaries, lattice=(nx, ny, nz))
    return mesh
