"""Mesh converter: Gmsh / meshio formats -> the solver's HDF5 schema
(counterpart of the JAX package's tools/mesh_convert.py, which imports the
JAX package; this one imports nothing of it).

    python -m dedflow_tpu_torch.tools.mesh_convert input.msh output.h5

The output schema (mesh/xg, mesh/ien/{tet,prism,hex},
mesh/bound/{node_offset,node,elem_offset,ien,f2e,forn}) is the reference
converter's and io.h5's. Cells map as the JAX tool maps them
(tools/mesh_convert.py:40-84): `tetra` -> the tets (required), `wedge` ->
mesh/ien/prism and `hexahedron` -> mesh/ien/hex (stencil-only cells: the
solver adds their node pairs to the matrix pattern and assembles the
tets), `triangle` cells -> one boundary per physical tag
(cell_data "gmsh:physical", ascending; all triangles one boundary without
tags), each facet mapped to its parent tet and the local index of the
opposite node by mesh.mesh.facet_tables_from_tris.

meshio reads the input and is imported only inside `from_meshio`: the
package and this module import without it. Writing needs h5py (io.h5).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from dedflow_tpu_torch.io.h5 import write_mesh_h5
from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh, facet_tables_from_tris
from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


def _cells(m, kind: str) -> np.ndarray | None:
    """The concatenated connectivity of meshio's cell blocks of `kind`, or
    None without one."""
    blocks = [c.data for c in m.cells if c.type == kind]
    return np.concatenate(blocks).astype(INDEX_DTYPE) if blocks else None


def from_meshio(path: str) -> Mesh:
    """The port's Mesh of a file meshio reads (`meshio.read(path)`)."""
    try:
        import meshio
    except ImportError as e:
        raise SystemExit(
            "meshio is required to read non-HDF5 meshes; install it or "
            "convert externally to the HDF5 schema"
        ) from e

    m = meshio.read(path)
    ien = _cells(m, "tetra")
    if ien is None:
        raise SystemExit("no tetrahedra in input mesh")
    boundaries = []
    tri = _cells(m, "triangle")
    if tri is not None:
        tags = [d for c, d in zip(m.cells, m.cell_data.get("gmsh:physical", ()))
                if c.type == "triangle"]
        tag = np.concatenate(tags) if tags else np.zeros(tri.shape[0], dtype=np.int64)
        for t in np.unique(tag):
            btri = tri[tag == t]
            f2e, forn = facet_tables_from_tris(ien, btri)
            boundaries.append(Boundary(nodes=np.unique(btri).astype(INDEX_DTYPE), ien=btri,
                                       f2e=f2e, forn=forn))
    return Mesh(xg=np.asarray(m.points, dtype=float), ien=ien, boundaries=boundaries,
                ien_prism=_cells(m, "wedge"), ien_hex=_cells(m, "hexahedron"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", help=".msh/.vtk/... (meshio) input")
    ap.add_argument("output", help="output .h5 in the solver schema")
    args = ap.parse_args(argv)
    mesh = from_meshio(args.input)
    write_mesh_h5(args.output, mesh)
    print(f"{args.output}: {mesh.num_node} nodes, {mesh.num_tet} tets, "
          f"{mesh.num_prism} prisms, {mesh.num_hex} hexes, {len(mesh.boundaries)} boundaries")
    return 0


if __name__ == "__main__":
    sys.exit(main())
