"""Built-in mesh generators (NumPy copy of dedflow_tpu/mesh/gen.py: box_mesh and
delaunay_mesh).

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


def _boundary_triangles(ien: np.ndarray, num_node: int) -> np.ndarray:
    """The tet faces that appear exactly once, in their element's node
    order."""
    opp = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]], dtype=np.int64)
    faces = ien[:, opp].reshape(-1, 3).astype(np.int64)  # (4*ne, 3)
    sfaces = np.sort(faces, axis=1)
    m = num_node
    key = (sfaces[:, 0] * m + sfaces[:, 1]) * m + sfaces[:, 2]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    return faces[first[counts == 1]]


def _boundary_groups(ien: np.ndarray, btri: np.ndarray, group: np.ndarray,
                     count: int) -> list[Boundary]:
    """Boundary tables of groups 0..count-1 of the triangles `btri`."""
    boundaries = []
    for g in range(count):
        tris = btri[group == g].astype(INDEX_DTYPE)
        f2e, forn = facet_tables_from_tris(ien, tris)
        boundaries.append(Boundary(nodes=np.unique(tris).astype(INDEX_DTYPE), ien=tris,
                                   f2e=f2e, forn=forn))
    return boundaries


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

    btri = _boundary_triangles(ien, xg.shape[0])

    # Classify each boundary triangle by box side.
    cx = xg[btri].mean(axis=1)  # (nb, 3) centroids
    eps_ = np.array([lx / nx, ly / ny, lz / nz]) * 1e-6
    side = np.full(btri.shape[0], 6)
    for g, (d, v) in enumerate([(0, ox), (0, ox + lx), (1, oy), (1, oy + ly), (2, oz),
                                (2, oz + lz)]):
        side[np.abs(cx[:, d] - v) < eps_[d]] = g
    boundaries = _boundary_groups(ien, btri, side, 6)
    mesh = Mesh(xg=xg, ien=ien, boundaries=boundaries, lattice=(nx, ny, nz))
    return mesh


def delaunay_mesh(num_points: int, seed: int = 0) -> Mesh:
    """Genuinely irregular tet mesh: Delaunay triangulation of uniform
    random points in the unit cube (~6.7 tets/point), no boundary tables
    (copy of dedflow_tpu/mesh/gen.py::delaunay_mesh, the same
    RandomState(seed) points). Near-degenerate slivers are dropped."""
    from scipy.spatial import Delaunay

    rng = np.random.RandomState(seed)
    pts = rng.rand(num_points, 3)
    ien = np.asarray(Delaunay(pts).simplices, dtype=np.int64)
    p = pts[ien]
    det = np.abs(np.linalg.det(p[:, 1:] - p[:, :1]))
    ien = ien[det > 1e-12]
    return Mesh(xg=pts, ien=ien.astype(INDEX_DTYPE), boundaries=[])


# ---------------------------------------------------------------------------
# Converted-mesh variants of a box: what a mesh file carries in place of the
# generator's metadata. The solver's tier ladder must find the structure
# from the tables alone (the JAX package's tests build the same meshes:
# tests/test_classes.py::_deformed, tests/test_recover.py::_shuffled).


def deformed_mesh(mesh: Mesh, amp: float = 0.08) -> Mesh:
    """`mesh`'s connectivity and boundaries on smoothly deformed coordinates,
    lattice metadata dropped: no tensor grid for mesh.recover, but still
    translation-regular (the classes tier)."""
    xg = mesh.xg + amp * np.sin(3.0 * mesh.xg[:, [1, 2, 0]])
    return Mesh(xg=xg, ien=mesh.ien.copy(), boundaries=mesh.boundaries)


def shuffled_mesh(mesh: Mesh, seed: int = 0, grade: bool = False, mirror: bool = False) -> Mesh:
    """`mesh` with its nodes renumbered at random, its elements shuffled and
    each element's vertices rotated (RandomState(seed)); `grade` spaces the
    coordinates unevenly, `mirror` reflects x, which turns the Kuhn split
    into another corner pattern (its vertex swap keeps every tet positively
    oriented). Boundary tables follow."""
    rng = np.random.RandomState(seed)
    rp = rng.permutation(mesh.num_node)  # old node id -> new
    xg = mesh.xg.copy()
    if grade:
        xg = np.sign(xg) * np.abs(xg) ** 1.5 + 0.05 * xg
    if mirror:
        xg[:, 0] = xg[:, 0].max() - xg[:, 0]
    pv = [2, 1, 0, 3] if mirror else [1, 2, 0, 3]
    forn_map = np.array([pv.index(k) for k in range(4)])
    ien = rp[mesh.ien][:, pv]
    eperm = rng.permutation(ien.shape[0])
    e_inv = np.argsort(eperm)
    bnds = [Boundary(nodes=np.sort(rp[b.nodes]), ien=rp[b.ien], f2e=e_inv[b.f2e],
                     forn=forn_map[b.forn]) for b in mesh.boundaries]
    return Mesh(xg=xg[np.argsort(rp)], ien=ien[eperm], boundaries=bnds)


def l_shaped_mesh(nx: int, ny: int, nz: int) -> Mesh:
    """box_mesh(nx, ny, nz) without the elements whose centroid lies in the
    (+x, +y) quadrant, every node kept: translation-regular, with whole
    regions of each class's lanes empty. Boundary groups: the box's six
    sides where they remain, in box_mesh's order [x-, x+, y-, y+, z-, z+]
    (so the reference scenario's BCs apply), 6 the walls the cut opened,
    and 7 the nodes no element touches, without facets: their rows are all
    zero, so a run constrains them (every component strong on group 7)."""
    box = box_mesh(nx, ny, nz)
    xg = box.xg
    cent = xg[box.ien].mean(axis=1)
    ien = box.ien[~((cent[:, 0] > 0.5) & (cent[:, 1] > 0.5))]
    btri = _boundary_triangles(ien, xg.shape[0])
    cx = xg[btri].mean(axis=1)
    group = np.full(btri.shape[0], 6)
    eps = 1e-6 / max(nx, ny, nz)
    for g, (axis, val) in enumerate([(0, 0.0), (0, 1.0), (1, 0.0), (1, 1.0), (2, 0.0), (2, 1.0)]):
        group[np.abs(cx[:, axis] - val) < eps] = g
    boundaries = _boundary_groups(ien, btri, group, 7)
    orphans = np.setdiff1d(np.arange(box.num_node), ien).astype(INDEX_DTYPE)
    empty = np.zeros(0, dtype=INDEX_DTYPE)
    boundaries.append(Boundary(nodes=orphans, ien=np.zeros((0, 3), dtype=INDEX_DTYPE),
                               f2e=empty, forn=empty))
    return Mesh(xg=xg.copy(), ien=ien, boundaries=boundaries)
