"""Nodal sparsity pattern and element->nnz maps (NumPy copy of
dedflow_tpu/sparse/topology.py::Sparsity / build_sparsity, NumPy body
only; the JAX package's C++ fast path in native/ is not ported).

The flat key (row * N + col) of the unique node pairs, sorted ascending,
is the CSR ordering, so each element's 16 nnz indices are one
searchsorted. Every node keeps a diagonal entry even if no element
references it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dedflow_tpu_torch.utils.dtypes import INDEX_DTYPE


@dataclass(frozen=True)
class Sparsity:
    """CSR-structured nodal sparsity plus the element scatter map."""

    num_node: int
    row_ptr: np.ndarray  # (N+1,) int
    col_ind: np.ndarray  # (nnz,) int, sorted within each row
    elem_nnz: np.ndarray  # (ne, 4, 4) int: nnz of pair (ien[e,a], ien[e,b])
    diag_idx: np.ndarray  # (N,) int: nnz of each row's diagonal

    @property
    def nnz(self) -> int:
        return int(self.col_ind.shape[0])


def build_sparsity(ien: np.ndarray, num_node: int, extra_ien: list | None = None) -> Sparsity:
    """Nodal sparsity of the tet mesh and the element scatter map.
    `extra_ien` (prism/hex tables) adds stencil entries only: their pairs
    get no `elem_nnz` entries, as in the reference (csr.c:107-130)."""
    ien = np.asarray(ien, dtype=np.int64)
    ne = ien.shape[0]
    n = int(num_node)
    rows = np.repeat(ien, 4, axis=1)  # (ne, 16): a index slow
    cols = np.tile(ien, (1, 4))  # (ne, 16): b index fast
    keys = (rows * n + cols).ravel()
    diag_keys = np.arange(n, dtype=np.int64) * (n + 1)
    all_keys = [keys, diag_keys]
    for tbl in extra_ien or ():
        t = np.asarray(tbl, dtype=np.int64)
        k = t.shape[1]
        all_keys.append((np.repeat(t, k, axis=1) * n + np.tile(t, (1, k))).ravel())
    uniq = np.unique(np.concatenate(all_keys))
    col_ind = (uniq % n).astype(INDEX_DTYPE)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(uniq // n, minlength=n), out=row_ptr[1:])
    elem_nnz = np.searchsorted(uniq, keys).reshape(ne, 4, 4).astype(INDEX_DTYPE)
    diag_idx = np.searchsorted(uniq, diag_keys).astype(INDEX_DTYPE)
    assert (uniq[diag_idx] == diag_keys).all(), "missing diagonal entries"
    return Sparsity(
        num_node=n,
        row_ptr=row_ptr.astype(INDEX_DTYPE),
        col_ind=col_ind,
        elem_nnz=elem_nnz,
        diag_idx=diag_idx,
    )
