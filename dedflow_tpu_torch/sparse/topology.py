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

    @property
    def max_row(self) -> int:
        """Max nonzeros in any row (the ELL width)."""
        return int(np.diff(self.row_ptr).max())

    def ell_tables(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The JAX package's ELL-padded row layout (topology.py:46-70):
        (ell_col (N, PR), nnz_to_ell (nnz,), ell_valid (N, PR)). Slot
        (r, p) holds the p-th nonzero of row r; padding slots point at the
        row itself and are flagged invalid; `nnz_to_ell` relabels CSR
        position k to r*PR + p. The port stores matrices in CSR order
        (sparse.winell); these tables translate the JAX FSBSRMatrix's data
        (interop.fsbsr_from_numpy)."""
        n, pr = self.num_node, self.max_row
        lens = np.diff(self.row_ptr)
        ell_col = np.repeat(np.arange(n, dtype=np.int64), pr).reshape(n, pr)
        slots = np.arange(pr)[None, :]
        valid = slots < lens[:, None]
        pos = self.row_ptr[:-1, None] + slots
        ell_col[valid] = self.col_ind[pos[valid]]
        nnz_to_ell = np.repeat(np.arange(n, dtype=np.int64) * pr, lens) + (
            np.arange(self.nnz) - np.repeat(self.row_ptr[:-1], lens)
        )
        return ell_col.astype(INDEX_DTYPE), nnz_to_ell.astype(np.int64), valid


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


def scatter_permutation(elem_targets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-scatter plan (topology.py:155-164): the stable permutation
    making the flat element->target map non-decreasing. Returns (perm,
    sorted_targets), both int32; within a target the contributions keep
    their flat (element-major) order."""
    flat = np.asarray(elem_targets, dtype=np.int64).ravel()
    perm = np.argsort(flat, kind="stable").astype(INDEX_DTYPE)
    return perm, flat[perm].astype(INDEX_DTYPE)
