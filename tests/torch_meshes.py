"""Meshes that exist only to stress the port's kernels, not meshes a user
runs, and the lattice contexts of the converted meshes (test modules
import them as `import torch_meshes`)."""

import numpy as np
import torch

from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.mesh.gen import box_mesh, deformed_mesh, l_shaped_mesh, shuffled_mesh
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.mesh.recover import recover_lattice


def overlaid_mesh(nx: int, ny: int, nz: int, extra: int = 2) -> Mesh:
    """box_mesh(nx, ny, nz) with `extra` more tets in every cell, the first
    of the Kuhn split mirrored in x (positively oriented). They overlap the
    Kuhn tets, so the mesh is not conforming, but its tables are what the
    classes tier must take at its widest: 6 + extra classes (8 at most) and,
    with the mirrored split's diagonals, 21 DIA planes for extra = 2."""
    box = box_mesh(nx, ny, nz)
    kuhn = box_mesh(1, 1, 1).ien  # node id = corner id ix + 2*iy + 4*iz
    sy, sz = nx + 1, (nx + 1) * (ny + 1)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    base = (ix + sy * iy + sz * iz).ravel()
    corner = np.array([(c & 1) + sy * ((c >> 1) & 1) + sz * ((c >> 2) & 1) for c in range(8)])
    mirrored = (kuhn ^ 1)[:extra][:, [1, 0, 2, 3]]
    ien = np.concatenate([box.ien, (base[:, None, None] + corner[mirrored][None]).reshape(-1, 4)])
    return Mesh(xg=box.xg, ien=ien.astype(box.ien.dtype), boundaries=box.boundaries)


def table_context(name: str, box, implicit: bool = False, dtype=torch.float64):
    """The lattice context, on the CPU, of a variant of box_mesh(*box): the
    Kuhn box ("kuhn"), (a) deformed without metadata (the classes tier),
    (b) shuffled, mirrored and recovered (a lattice with another split),
    an L-shaped part of the box (classes, empty lanes), and overlaid_mesh
    (8 classes, 21 DIA planes)."""
    box_m = box_mesh(*box)
    mesh = {"kuhn": lambda: box_m, "a": lambda: deformed_mesh(box_m),
            "b": lambda: recover_lattice(shuffled_mesh(box_m, seed=1, mirror=True))[0],
            "L": lambda: l_shaped_mesh(*box), "overlaid": lambda: overlaid_mesh(*box)}[name]()
    if mesh.lattice is not None:
        return lat.build_lattice_context(mesh, "cpu", dtype, implicit)
    return lat.build_class_context(mesh, "cpu", dtype, scalar_implicit=implicit)
