"""HDF5 mesh and solution I/O, format-compatible with the reference
(counterpart of dedflow_tpu/io/h5.py: either package reads the other's
files).

Mesh schema (written by tools/mesh_convert.py:116-126, read by
Mesh3DCreateH5 / ReadBoundFromH5Private, Mesh.c:12-94):

    mesh/xg                  flat (3*N) coordinates
    mesh/ien/{tet,prism,hex} flat connectivity (only tet is computed on)
    mesh/bound/node_offset   (num_bound+1,)
    mesh/bound/node          flat unique boundary nodes
    mesh/bound/elem_offset   (num_bound+1,)
    mesh/bound/ien           flat (3*num_facet) boundary triangles
    mesh/bound/f2e           (num_facet,) parent tet per facet
    mesh/bound/forn          (num_facet,) local opposite-node index

Solution schema (main.c:521-531, 571-591): datasets u (3N, node-interleaved),
p/phi/T (N), du (3N), dphi/dT (N), plus the JAX package's `meta` group
(step, time). The state is (N, 6) with columns [u0,u1,u2,p,phi,T]; the
pressure lives in the rate vector's slot 3 (main.c:584).

Prism and hex tables are read and kept; the solver refuses them (ROADMAP
A13). h5py is imported only inside the functions that read or write a
file, so the package imports where h5py is not installed. The solution
layout itself is split from the file calls: `solution_datasets` and
`state_from_datasets` build and read the datasets as NumPy arrays in a
dict, so a machine without h5py runs everything but the file access.
"""

from __future__ import annotations

import numpy as np

import os

from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


def _h5py():
    import h5py

    return h5py


def write_mesh_h5(path: str, mesh: Mesh) -> None:
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f.create_dataset("mesh/xg", data=mesh.xg.ravel())
        f.create_dataset("mesh/ien/tet", data=mesh.ien.ravel().astype(INDEX_DTYPE))
        if mesh.ien_prism is not None:
            f.create_dataset(
                "mesh/ien/prism", data=mesh.ien_prism.ravel().astype(INDEX_DTYPE)
            )
        if mesh.ien_hex is not None:
            f.create_dataset(
                "mesh/ien/hex", data=mesh.ien_hex.ravel().astype(INDEX_DTYPE)
            )
        node_offset = [0]
        elem_offset = [0]
        nodes, tris, f2e, forn = [], [], [], []
        for b in mesh.boundaries:
            nodes.append(b.nodes)
            tris.append(b.ien)
            f2e.append(b.f2e)
            forn.append(b.forn)
            node_offset.append(node_offset[-1] + b.num_node)
            elem_offset.append(elem_offset[-1] + b.num_facet)
        cat = lambda xs, w: (
            np.concatenate([np.asarray(x).reshape(-1, w) for x in xs], axis=0)
            if xs
            else np.zeros((0, w), dtype=INDEX_DTYPE)
        )
        f.create_dataset(
            "mesh/bound/node_offset", data=np.asarray(node_offset, dtype=INDEX_DTYPE)
        )
        f.create_dataset("mesh/bound/node", data=cat(nodes, 1).ravel())
        f.create_dataset(
            "mesh/bound/elem_offset", data=np.asarray(elem_offset, dtype=INDEX_DTYPE)
        )
        f.create_dataset("mesh/bound/ien", data=cat(tris, 3).ravel())
        f.create_dataset("mesh/bound/f2e", data=cat(f2e, 1).ravel())
        f.create_dataset("mesh/bound/forn", data=cat(forn, 1).ravel())


def read_mesh_h5(path: str, group: str = "mesh") -> Mesh:
    """Read a mesh written by this module or by tools/mesh_convert.py."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        g = f[group]
        xg = np.asarray(g["xg"]).reshape(-1, 3)
        ien = np.asarray(g["ien/tet"], dtype=INDEX_DTYPE).reshape(-1, 4)
        # mixed-cell tables (MeshData.h:27-29): preserved, stencil-only
        ien_prism = ien_hex = None
        if "ien/prism" in g:
            v = np.asarray(g["ien/prism"], dtype=INDEX_DTYPE).reshape(-1, 6)
            ien_prism = v if v.size else None
        if "ien/hex" in g:
            v = np.asarray(g["ien/hex"], dtype=INDEX_DTYPE).reshape(-1, 8)
            ien_hex = v if v.size else None
        boundaries: list[Boundary] = []
        if "bound" in g:
            b = g["bound"]
            node_offset = np.asarray(b["node_offset"], dtype=np.int64)
            elem_offset = np.asarray(b["elem_offset"], dtype=np.int64)
            node = np.asarray(b["node"], dtype=INDEX_DTYPE)
            tri = np.asarray(b["ien"], dtype=INDEX_DTYPE).reshape(-1, 3)
            f2e = np.asarray(b["f2e"], dtype=INDEX_DTYPE)
            forn = np.asarray(b["forn"], dtype=INDEX_DTYPE)
            for i in range(len(node_offset) - 1):
                n0, n1 = node_offset[i], node_offset[i + 1]
                e0, e1 = elem_offset[i], elem_offset[i + 1]
                boundaries.append(
                    Boundary(
                        nodes=node[n0:n1],
                        ien=tri[e0:e1],
                        f2e=f2e[e0:e1],
                        forn=forn[e0:e1],
                    )
                )
    return Mesh(
        xg=xg, ien=ien, boundaries=boundaries,
        ien_prism=ien_prism, ien_hex=ien_hex,
    )


def _host(a) -> np.ndarray:
    """NumPy copy of a tensor (any device) or array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def solution_datasets(wg, dwg, step: int | None = None, time: float | None = None) -> dict:
    """{dataset name: NumPy array} of a snapshot in the reference layout
    (dedflow_tpu/io/h5.py:142-180). `wg` and `dwg` are (N, 6) states,
    tensors or arrays; the datasets keep their dtype:
        u    = wg[:, :3] interleaved      du   = dwg[:, :3] interleaved
        phi  = wg[:, 4]                   p    = dwg[:, 3]
        T    = wg[:, 5]                   dphi = dwg[:, 4],  dT = dwg[:, 5]
    and meta/step (int64), meta/time (float64) where given."""
    wg, dwg = _host(wg), _host(dwg)
    d = {
        "u": wg[:, :3].ravel(),
        "p": dwg[:, 3].copy(),
        "phi": wg[:, 4].copy(),
        "T": wg[:, 5].copy(),
        "du": dwg[:, :3].ravel(),
        "dphi": dwg[:, 4].copy(),
        "dT": dwg[:, 5].copy(),
    }
    if step is not None:
        d["meta/step"] = np.int64(step)
    if time is not None:
        d["meta/time"] = np.float64(time)
    return d


def state_from_datasets(d) -> dict:
    """The reference's resume reconstruction (main.c:480-503,
    dedflow_tpu/io/h5.py:183-210) of a snapshot's datasets `d` (a dict of
    solution_datasets or an open h5py file): {"wg", "dwg"} as (N, 6)
    arrays, wg with u/phi/T and a zero pressure slot, dwg with du/p and
    dphi/dT where present (zero otherwise), and "step" / "time" where the
    snapshot has them."""
    u = np.asarray(d["u"]).reshape(-1, 3)
    n = u.shape[0]
    wg = np.zeros((n, 6), dtype=u.dtype)
    dwg = np.zeros((n, 6), dtype=u.dtype)
    wg[:, :3] = u
    wg[:, 4] = np.asarray(d["phi"])
    wg[:, 5] = np.asarray(d["T"])
    dwg[:, :3] = np.asarray(d["du"]).reshape(-1, 3)
    dwg[:, 3] = np.asarray(d["p"])
    if "dphi" in d:
        dwg[:, 4] = np.asarray(d["dphi"])
    if "dT" in d:
        dwg[:, 5] = np.asarray(d["dT"])
    out = {"wg": wg, "dwg": dwg}
    if "meta/step" in d:
        out["step"] = int(np.asarray(d["meta/step"]))
    if "meta/time" in d:
        out["time"] = float(np.asarray(d["meta/time"]))
    return out


def write_solution_h5(path: str, wg, dwg, step: int | None = None,
                      time: float | None = None) -> None:
    """Write solution_datasets(wg, dwg, step, time) to `path`, atomically:
    a `.tmp` file renamed over the path, so an interrupted run never leaves
    a truncated snapshot (as the JAX package does)."""
    h5py = _h5py()
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        for name, arr in solution_datasets(wg, dwg, step, time).items():
            f.create_dataset(name, data=arr)
    os.replace(tmp, path)


def read_solution_h5(path: str) -> dict:
    """state_from_datasets of the snapshot file at `path`."""
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return state_from_datasets(f)
