"""Strong (Dirichlet) boundary conditions as boolean nodal masks (NumPy
copy of the mask builder in dedflow_tpu/fem/dirichlet.py).

Constrained residual rows are zeroed and constrained matrix rows get a
unit diagonal (dirichlet.c:47-61 of the reference)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from dedflow_tpu_torch.mesh.mesh import Mesh


@dataclass(frozen=True)
class StrongBC:
    """One strong BC: zero the listed solution components on a boundary."""

    boundary: int
    components: tuple[int, ...]


def build_mask(mesh: Mesh, bcs: Sequence[StrongBC], bs: int) -> np.ndarray:
    """(N, bs) boolean mask; True = constrained (node, component)."""
    mask = np.zeros((mesh.num_node, bs), dtype=bool)
    for bc in bcs:
        nodes = mesh.boundaries[bc.boundary].nodes
        for c in bc.components:
            mask[nodes, c] = True
    return mask
