"""Unstructured tetrahedral mesh with named boundary tables (NumPy copy of
dedflow_tpu/mesh/mesh.py).

Mirrors the capability of the reference `Mesh3D` (Mesh.h:14-73, Mesh.c:12-59):
node coordinates, tet connectivity, and per-boundary tables (unique boundary
nodes, facet connectivity, facet->parent-element map `f2e`, facet orientation
`forn` = the local index 0..3 of the parent tet's node opposite the facet).

Differences from the reference, by TPU idiom:
- Topology lives on the host as NumPy (uploaded to device on demand);
  there is no host/device mirror struct pair (Mesh3DData, MeshData.c).
- No element coloring: the color/batch machinery (Mesh.c:165-206,
  color_impl.cu) exists only to serialize racy CUDA scatters; XLA
  scatter-add is deterministic, so it is dropped (SURVEY.md section 7.1).
- Prism/hex connectivity slots exist in the HDF5 schema but, like the
  reference (whose prism/hex assembly is empty, main.c:57-61), only tets
  are computed on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


@dataclass
class Boundary:
    """One named boundary: tables as in `mesh/bound/*` (mesh_convert.py:116-126)."""

    nodes: np.ndarray  # (num_bnode,) unique node ids on this boundary
    ien: np.ndarray  # (num_facet, 3) triangle connectivity
    f2e: np.ndarray  # (num_facet,) parent tet index
    forn: np.ndarray  # (num_facet,) local index (0..3) of the opposite node

    @property
    def num_node(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def num_facet(self) -> int:
        return int(self.ien.shape[0])


@dataclass
class Mesh:
    """Tet mesh. `xg` is (N, 3) float; `ien` is (num_tet, 4) int32.

    `lattice` is optional structured-mesh metadata `(nx, ny, nz)` set by
    the box generator (mesh.gen.box_mesh): node id = ix + (nx+1)*(iy +
    (ny+1)*iz) and cells carry the Kuhn 6-tet split. When present, solvers
    may use the gather-free lattice fast path (fem.lattice); the
    unstructured tables remain valid and authoritative either way."""

    xg: np.ndarray
    ien: np.ndarray
    boundaries: list[Boundary] = field(default_factory=list)
    lattice: tuple[int, int, int] | None = None
    # Per-cell tet split as (T, 4) cube-corner ids (corner = ix + 2*iy +
    # 4*iz), T <= 8. None means the generator's Kuhn 6-tet split. Set by
    # mesh.recover.recover_lattice for converted meshes whose cells use a
    # different uniform subdivision.
    lattice_tets: np.ndarray | None = None
    # Mixed-cell connectivity, mirroring the reference's MeshData slots
    # (MeshData.h:27-29). Like the reference (whose prism/hex assembly and
    # coloring are empty, csr.c:107-130 builds only their sparsity), these
    # cells contribute matrix STENCIL entries but are not assembled over.
    ien_prism: np.ndarray | None = None  # (num_prism, 6)
    ien_hex: np.ndarray | None = None  # (num_hex, 8)

    def __post_init__(self) -> None:
        self.xg = np.ascontiguousarray(self.xg, dtype=np.float64)
        self.ien = np.ascontiguousarray(self.ien, dtype=INDEX_DTYPE)
        for name in ("ien_prism", "ien_hex"):
            v = getattr(self, name)
            if v is not None:
                v = np.ascontiguousarray(v, dtype=INDEX_DTYPE)
                setattr(self, name, v if v.size else None)

    @property
    def num_node(self) -> int:
        return int(self.xg.shape[0])

    @property
    def num_tet(self) -> int:
        return int(self.ien.shape[0])

    @property
    def num_bound(self) -> int:
        return len(self.boundaries)

    @property
    def num_prism(self) -> int:
        return 0 if self.ien_prism is None else int(self.ien_prism.shape[0])

    @property
    def num_hex(self) -> int:
        return 0 if self.ien_hex is None else int(self.ien_hex.shape[0])

    @property
    def extra_cells(self) -> list[np.ndarray]:
        """Non-tet connectivity tables (sparsity stencils only)."""
        return [t for t in (self.ien_prism, self.ien_hex) if t is not None]

    @cached_property
    def tet_volumes(self) -> np.ndarray:
        """Signed volumes (host-side sanity check; detJ = 6*|vol|)."""
        x = self.xg[self.ien]  # (ne, 4, 3)
        j = x[:, 1:, :] - x[:, :1, :]  # (ne, 3, 3) rows = edge vectors
        return np.linalg.det(j) / 6.0

    def validate(self) -> None:
        assert self.ien.min() >= 0 and self.ien.max() < self.num_node
        for t in self.extra_cells:
            assert t.min() >= 0 and t.max() < self.num_node
        for b in self.boundaries:
            assert b.f2e.shape == b.forn.shape == (b.num_facet,)
            assert b.ien.shape == (b.num_facet, 3)
            if b.num_facet:
                assert b.f2e.max() < self.num_tet
                assert 0 <= b.forn.min() and b.forn.max() < 4
                # forn consistency: facet nodes == parent tet nodes minus the
                # opposite node (mesh_convert.py:59-66).
                tet_nodes = self.ien[b.f2e]  # (nf, 4)
                for k in range(4):
                    sel = b.forn == k
                    if not np.any(sel):
                        continue
                    rest = np.delete(tet_nodes[sel], k, axis=1)
                    assert (
                        np.sort(rest, axis=1) == np.sort(b.ien[sel], axis=1)
                    ).all(), f"facet/forn mismatch on local face {k}"


def facet_tables_from_tris(
    ien_tet: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Compute (f2e, forn) for boundary triangles.

    Vectorized replacement for the reference converter's per-facet Python
    loops (tools/mesh_convert.py:35-68). Each boundary triangle must be a
    face of exactly one tet; `forn` is the local index of the tet node not
    on the facet.
    """
    ien_tet = np.asarray(ien_tet, dtype=np.int64)
    tris = np.asarray(tris, dtype=np.int64)
    ne = ien_tet.shape[0]
    # Local faces opposite to node k, consistent with the reference's
    # convention (forn = index of the missing node, mesh_convert.py:59-66).
    opp = [
        [1, 2, 3],  # forn 0
        [0, 2, 3],  # forn 1
        [0, 1, 3],  # forn 2
        [0, 1, 2],  # forn 3
    ]
    faces = np.concatenate(
        [np.sort(ien_tet[:, o], axis=1) for o in opp], axis=0
    )  # (4*ne, 3), block k = faces with forn k
    face_elem = np.tile(np.arange(ne), 4)
    face_forn = np.repeat(np.arange(4), ne)

    # Hash-match sorted boundary tris against sorted tet faces.
    def keys(a: np.ndarray) -> np.ndarray:
        m = int(max(faces.max(initial=0), tris.max(initial=0))) + 1
        return (a[:, 0] * m + a[:, 1]) * m + a[:, 2]

    fk = keys(faces)
    tk = keys(np.sort(tris, axis=1))
    order = np.argsort(fk, kind="stable")
    pos = np.searchsorted(fk[order], tk)
    assert pos.max(initial=-1) < fk.shape[0], "boundary facet not found in mesh"
    idx = order[pos]
    assert (fk[idx] == tk).all(), "boundary facet not a face of any tet"
    return (
        face_elem[idx].astype(INDEX_DTYPE),
        face_forn[idx].astype(INDEX_DTYPE),
    )
