"""Batched linear-tet element geometry (PyTorch counterpart of
dedflow_tpu/fem/element.py; same conventions).

- J columns are edge vectors: J[:, c] = x_{c+1} - x_0.
- detJ is the absolute determinant.
- shape gradient of node a>0 is row a-1 of inv(J); node 0 is minus the sum.
- metric G = inv(J) @ inv(J)^T.
Degenerate (zero-volume) elements get zero inv_j/shgrad/metric and
det_j = 0, so all their weak-form contributions vanish.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dedflow_tpu_torch.fem import quadrature as quad


class TetGeometry(NamedTuple):
    inv_j: torch.Tensor  # (ne, 3, 3) inverse Jacobian (signed)
    det_j: torch.Tensor  # (ne,) |det J|
    shgrad: torch.Tensor  # (ne, 4, 3) physical shape gradients
    metric: torch.Tensor  # (ne, 3, 3) G = inv(J) @ inv(J)^T


def tet_jacobian(x_elem: torch.Tensor) -> torch.Tensor:
    """x_elem (..., 4, 3) -> J (..., 3, 3) with columns = edge vectors."""
    edges = x_elem[..., 1:, :] - x_elem[..., :1, :]
    return edges.transpose(-1, -2)


def _cofactor_rows(j: torch.Tensor):
    c0, c1, c2 = j[..., :, 0], j[..., :, 1], j[..., :, 2]
    r0 = torch.linalg.cross(c1, c2)
    r1 = torch.linalg.cross(c2, c0)
    r2 = torch.linalg.cross(c0, c1)
    det = (c0 * r0).sum(-1)
    return r0, r1, r2, det


def inv3x3(j: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form inverse and signed determinant of (..., 3, 3)."""
    r0, r1, r2, det = _cofactor_rows(j)
    inv = torch.stack([r0, r1, r2], dim=-2) / det[..., None, None]
    return inv, det


def tet_geometry(x_elem: torch.Tensor) -> TetGeometry:
    """Batched geometry for element coordinate gathers x_elem (ne, 4, 3)."""
    r0, r1, r2, det = _cofactor_rows(tet_jacobian(x_elem))
    valid = det != 0.0
    safe_det = torch.where(valid, det, torch.ones_like(det))
    inv_j = (
        torch.stack([r0, r1, r2], dim=-2)
        / safe_det[..., None, None]
        * valid[..., None, None].to(det.dtype)
    )
    det_j = det.abs()
    g0 = -inv_j.sum(dim=-2, keepdim=True)
    shgrad = torch.cat([g0, inv_j], dim=-2)  # (ne, 4, 3)
    metric = torch.einsum("...ik,...jk->...ij", inv_j, inv_j)
    return TetGeometry(inv_j=inv_j, det_j=det_j, shgrad=shgrad, metric=metric)


def face_normals(
    inv_j: torch.Tensor, det_j: torch.Tensor, forn: torch.Tensor
) -> torch.Tensor:
    """Nanson-formula facet normals (not unit length):
    nv = detJ * J^-T @ n_ref[forn]."""
    nref = torch.as_tensor(
        quad.REF_FACE_NORMALS, dtype=inv_j.dtype, device=inv_j.device
    )[forn]
    return det_j[:, None] * torch.einsum("fkn,fk->fn", inv_j, nref)
