"""Geometric mesh partitioning by recursive coordinate bisection, with
padding (NumPy copy of dedflow_tpu/parallel/partition.py).

`partition_mesh` reorders a mesh so that each part's nodes and elements
are contiguous index ranges padded to one size per part: pad nodes touch
no real element and pad elements are degenerate (four copies of one node,
zero geometry), so their contributions are exact zeros. The z-slab path
of parallel.sharded does not use it (a box's own node order is already a
slab decomposition); its RCB mode does, through `part_layout`: rank r
owns the real nodes of part r in partitioned order (the padding slots, a
TPU layout, are dropped) and assembles on its local submesh, every
element with at least one own node, numbered [own nodes | ghost nodes]
(the ghosts sorted by their partitioned id, so each owner's ghosts are
one contiguous block). Every own row then sums all of its element and
facet contributions on its rank. The JAX package's C++ fast path of
`rcb_parts` (dedflow_tpu/native/topology.cpp, ROADMAP A14b) is not
ported: this NumPy body is that package's oracle, and it gives the same
parts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


def rcb_parts(xg: np.ndarray, num_parts: int) -> np.ndarray:
    """Recursive coordinate bisection: (N, 3) coords -> (N,) part ids
    (partition.py:34 of the JAX package, its NumPy body).

    Splits along the longest extent at the weighted median so part sizes
    are balanced to within one node for any `num_parts` (non-powers of two
    split proportionally)."""
    xg = np.asarray(xg)
    n = xg.shape[0]
    part = np.zeros(n, dtype=np.int64)

    def recurse(idx: np.ndarray, p0: int, p1: int) -> None:
        nparts = p1 - p0
        if nparts <= 1 or idx.size == 0:
            part[idx] = p0
            return
        left = nparts // 2
        # number of nodes for the left group, proportional to its part count
        nleft = (idx.size * left) // nparts
        coords = xg[idx]
        axis = int(np.argmax(coords.max(axis=0) - coords.min(axis=0)))
        order = np.argsort(coords[:, axis], kind="stable")
        recurse(idx[order[:nleft]], p0, p0 + left)
        recurse(idx[order[nleft:]], p0 + left, p1)

    recurse(np.arange(n, dtype=np.int64), 0, int(num_parts))
    return part


def _grouped_layout(owner: np.ndarray, num_parts: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack items into per-part contiguous slots padded to a common size
    (partition.py:72). Returns (item_map, slot_real, per_part): the new
    slot of each original item, the non-padding slots, the padded count a
    part."""
    counts = np.bincount(owner, minlength=num_parts)
    per_part = int(counts.max()) if counts.size else 0
    order = np.argsort(owner, kind="stable")
    within = np.empty(owner.size, dtype=np.int64)
    start = 0
    for p in range(num_parts):
        c = counts[p]
        within[order[start : start + c]] = np.arange(c)
        start += c
    item_map = owner * per_part + within
    slot_real = np.zeros(num_parts * per_part, dtype=bool)
    slot_real[item_map] = True
    return item_map, slot_real, per_part


@dataclass(frozen=True)
class PartitionInfo:
    """Mapping between the original mesh and the padded partitioned one."""

    num_parts: int
    node_map: np.ndarray  # (N_orig,) new node index of each original node
    elem_map: np.ndarray  # (ne_orig,) new element index of each original elem
    node_real: np.ndarray  # (N_new,) False on padding slots
    elem_real: np.ndarray  # (ne_new,) False on padding slots
    node_part: np.ndarray  # (N_new,) part id (non-decreasing)
    elem_part: np.ndarray  # (ne_new,) part id (non-decreasing)


def partition_mesh(mesh: Mesh, num_parts: int) -> tuple[Mesh, PartitionInfo]:
    """Reorder and pad `mesh` into `num_parts` equally sized contiguous
    blocks (partition.py:106): nodes by RCB of the coordinates, elements by
    the part owning the majority of their 4 nodes (ties to the lower part).
    Pad nodes copy their part's first real node's coordinates; pad
    elements are 4 x their part's first real node."""
    P = int(num_parts)
    xg = np.asarray(mesh.xg)
    ien = np.asarray(mesh.ien, dtype=np.int64)
    node_owner = rcb_parts(xg, P)
    # the median pair of the sorted owners: the majority where there is one,
    # else the lower part of a 2-2 split
    elem_owner = np.sort(node_owner[ien], axis=1)[:, 1]

    node_map, node_real, nodes_per_part = _grouped_layout(node_owner, P)
    elem_map, elem_real, elems_per_part = _grouped_layout(elem_owner, P)
    n_new = P * nodes_per_part
    ne_new = P * elems_per_part

    xg_new = np.zeros((n_new, xg.shape[1]), dtype=xg.dtype)
    xg_new[node_map] = xg
    for p in range(P):
        lo, hi = p * nodes_per_part, (p + 1) * nodes_per_part
        pad = ~node_real[lo:hi]
        if pad.any():
            src = np.flatnonzero(node_real[lo:hi])
            fill = xg_new[lo + src[0]] if src.size else np.zeros(xg.shape[1])
            xg_new[lo:hi][pad] = fill

    ien_new = np.zeros((ne_new, 4), dtype=np.int64)
    ien_new[elem_map] = node_map[ien]
    for p in range(P):
        lo, hi = p * elems_per_part, (p + 1) * elems_per_part
        pad = ~elem_real[lo:hi]
        if pad.any():
            anchors = np.flatnonzero(node_real[p * nodes_per_part : (p + 1) * nodes_per_part])
            anchor = p * nodes_per_part + (anchors[0] if anchors.size else 0)
            ien_new[lo:hi][pad] = anchor

    boundaries = []
    for b in mesh.boundaries:
        nodes = np.sort(node_map[np.asarray(b.nodes, dtype=np.int64)]).astype(INDEX_DTYPE)
        tri = node_map[np.asarray(b.ien, dtype=np.int64)].astype(INDEX_DTYPE)
        f2e = elem_map[np.asarray(b.f2e, dtype=np.int64)].astype(INDEX_DTYPE)
        boundaries.append(Boundary(nodes=nodes, ien=tri, f2e=f2e, forn=np.asarray(b.forn)))

    new_mesh = Mesh(xg=xg_new, ien=ien_new.astype(INDEX_DTYPE), boundaries=boundaries)
    info = PartitionInfo(
        num_parts=P,
        node_map=node_map,
        elem_map=elem_map,
        node_real=node_real,
        elem_real=elem_real,
        node_part=np.repeat(np.arange(P), nodes_per_part),
        elem_part=np.repeat(np.arange(P), elems_per_part),
    )
    return new_mesh, info


def permute_state(info: PartitionInfo, state: np.ndarray) -> np.ndarray:
    """(N_orig, ...) nodal state in the original order -> the padded
    partitioned order (padding rows are zero)."""
    out = np.zeros((info.node_real.size,) + state.shape[1:], dtype=state.dtype)
    out[info.node_map] = state
    return out


def unpermute_state(info: PartitionInfo, state: np.ndarray) -> np.ndarray:
    """Padded partitioned-order state -> (N_orig, ...) original order."""
    return np.asarray(state)[info.node_map]


@dataclass(frozen=True)
class PartLayout:
    """Rank `rank`'s piece of the RCB partition of a mesh into `num_parts`
    (`part_layout`). Local node i < n_own is the rank's own node of
    partitioned id (`node_key`) rank * L + i; the ghosts follow, sorted by
    partitioned id."""

    rank: int
    num_parts: int
    mesh: Mesh  # the local submesh: its tets and facets, local node ids
    n_own: int
    nodes: np.ndarray  # (n_local,) original node id of each local node
    node_part: np.ndarray  # (N,) owning part of each original node
    node_key: np.ndarray  # (N,) partitioned id of each original node (owners' blocks ascending)
    elems: np.ndarray  # (ne_local,) original element id of each local element

    def owned(self, part: int) -> np.ndarray:
        """Original ids of part `part`'s own nodes in its local order."""
        ids = np.flatnonzero(self.node_part == part)
        return ids[np.argsort(self.node_key[ids], kind="stable")]


def part_layout(mesh: Mesh, num_parts: int, rank: int) -> PartLayout:
    """Rank `rank`'s local submesh of the RCB partition (`partition_mesh`'s
    parts, its padding dropped): every tet with at least one own node, in
    partitioned element order, its nodes numbered [own | ghosts], and of
    each boundary the facets whose parent tet is local. Prism / hex tables
    are dropped, as partition_mesh drops them: they add stencil entries
    whose values are exact zeros, so F and J are unchanged."""
    _, info = partition_mesh(mesh, num_parts)
    P, r = int(num_parts), int(rank)
    node_key = info.node_map
    node_part = info.node_part[node_key]
    ien = np.asarray(mesh.ien, dtype=np.int64)
    own = np.flatnonzero(node_part == r)
    own = own[np.argsort(node_key[own], kind="stable")]
    local_elem = np.flatnonzero((node_part[ien] == r).any(axis=1))
    local_elem = local_elem[np.argsort(info.elem_map[local_elem], kind="stable")]
    touched = np.unique(ien[local_elem])
    ghosts = touched[node_part[touched] != r]
    ghosts = ghosts[np.argsort(node_key[ghosts], kind="stable")]
    nodes = np.concatenate([own, ghosts])
    local_of = np.full(mesh.num_node, -1, dtype=np.int64)
    local_of[nodes] = np.arange(nodes.size)
    elem_of = np.full(ien.shape[0], -1, dtype=np.int64)
    elem_of[local_elem] = np.arange(local_elem.size)
    boundaries = []
    for b in mesh.boundaries:
        f2e = elem_of[np.asarray(b.f2e, dtype=np.int64)]
        keep = f2e >= 0
        tri = local_of[np.asarray(b.ien, dtype=np.int64)[keep]]
        boundaries.append(Boundary(nodes=np.unique(tri).astype(INDEX_DTYPE),
                                   ien=tri.astype(INDEX_DTYPE), f2e=f2e[keep].astype(INDEX_DTYPE),
                                   forn=np.asarray(b.forn)[keep]))
    sub = Mesh(xg=np.asarray(mesh.xg)[nodes], ien=local_of[ien[local_elem]].astype(INDEX_DTYPE),
               boundaries=boundaries)
    return PartLayout(rank=r, num_parts=P, mesh=sub, n_own=int(own.size), nodes=nodes,
                      node_part=node_part, node_key=node_key, elems=local_elem)
