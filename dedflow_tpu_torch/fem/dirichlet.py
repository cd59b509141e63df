"""Strong (Dirichlet) boundary conditions as boolean nodal masks
(counterpart of dedflow_tpu/fem/dirichlet.py).

Constrained residual rows are zeroed (`apply_vec`, dirichlet_impl.cu:16-21
of the reference) and constrained matrix rows get a unit diagonal
(`apply_mat`, dirichlet.c:47-61). The mask builder is NumPy; the two
applications take the mask as a tensor on the data's device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.sparse.bsr import BSRMatrix


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


def apply_vec(mask: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Zero the constrained residual entries (dirichlet_impl.cu:16-21)."""
    return torch.where(mask, torch.zeros((), dtype=f.dtype, device=f.device), f)


def apply_mat(mask: torch.Tensor, mat: BSRMatrix) -> BSRMatrix:
    """Zero the constrained rows, unit diagonal (dirichlet.c:47-61)."""
    return mat.zero_rows(mask, unit_diag=True)
