"""Bandwidth-reducing mesh reordering (NumPy/SciPy copy of
dedflow_tpu/mesh/reorder.py).

Reverse Cuthill-McKee brings the adjacency bandwidth of a random-order 3D
tet mesh from O(N) down to O(N^(2/3)). The windowed irregular tier
(fem.win_assembly) keeps the JAX package's input contract: nodes in RCM
order and elements sorted by their minimum node, so each element's nodes,
each matrix row's columns and each reduce target's contributions lie
close together in memory.

`NodeOrder` keeps both directions of the relabeling: `perm` reorders
nodal arrays, `rank` relabels connectivity.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


@dataclasses.dataclass(frozen=True)
class NodeOrder:
    """A node relabeling: internal id = rank[file id]; file id = perm[
    internal id]."""

    perm: np.ndarray  # (N,) internal -> file
    rank: np.ndarray  # (N,) file -> internal

    def to_internal(self, x: np.ndarray) -> np.ndarray:
        """Reorder a (N, ...) nodal array from file to internal order."""
        return np.asarray(x)[self.perm]


def rcm_order(ien: np.ndarray, num_node: int) -> NodeOrder:
    """Reverse Cuthill-McKee permutation of the node graph induced by the
    element connectivity (any (ne, k) simplex table)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ien = np.asarray(ien)
    k = ien.shape[1]
    i = np.repeat(ien, k, axis=1).ravel()
    j = np.tile(ien, (1, k)).ravel()
    adj = coo_matrix(
        (np.ones(i.size, dtype=np.int8), (i, j)), shape=(num_node, num_node)
    ).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)
    rank = np.empty(num_node, dtype=np.int64)
    rank[perm] = np.arange(num_node)
    return NodeOrder(perm=perm, rank=rank)


def reorder_mesh(mesh: Mesh, order: NodeOrder) -> Mesh:
    """A new Mesh with nodes relabeled to internal order and elements
    sorted by their minimum (internal) node. Boundary tables are
    relabeled; facet->element links follow the element sort."""
    ien = order.rank[np.asarray(mesh.ien)]
    eperm = np.argsort(ien.min(axis=1), kind="stable")
    erank = np.empty(len(eperm), dtype=np.int64)
    erank[eperm] = np.arange(len(eperm))
    ien = ien[eperm]
    bounds = [
        Boundary(
            nodes=order.rank[np.asarray(b.nodes)].astype(INDEX_DTYPE),
            ien=order.rank[np.asarray(b.ien)].astype(INDEX_DTYPE),
            f2e=erank[np.asarray(b.f2e)].astype(INDEX_DTYPE),
            forn=np.asarray(b.forn),
        )
        for b in mesh.boundaries
    ]
    relab = lambda t: (
        None if t is None else order.rank[np.asarray(t)].astype(INDEX_DTYPE)
    )
    return Mesh(
        xg=order.to_internal(mesh.xg),
        ien=ien.astype(INDEX_DTYPE),
        boundaries=bounds,
        ien_prism=relab(mesh.ien_prism),
        ien_hex=relab(mesh.ien_hex),
    )


def bandwidth(ien: np.ndarray) -> int:
    """Max per-element node-index spread."""
    ien = np.asarray(ien)
    return int((ien.max(axis=1) - ien.min(axis=1)).max()) if len(ien) else 0
