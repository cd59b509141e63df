"""Block-sparse-row (BSR) matrix with uniform (br, bc) blocks (counterpart
of dedflow_tpu/sparse/bsr.py).

The scalar heat / Poisson slice's operator (fem.heat: 1 x 1 blocks on the
nodal sparsity). The JAX package's SpMV is plain jnp, outside any Pallas
kernel, and so is this one: a gather of x by `col_ind`, the batched block
product, then a sorted segment sum over the rows (`row_ptr`, the offsets
of the non-decreasing `row_ids`) in a fixed order, as solver/amg.py's
`_segsum` does, so a product repeats bit for bit from run to run on the
card (an index_add there would not).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dedflow_tpu_torch.sparse.topology import Sparsity
from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device


@dataclass
class BSRMatrix:
    """BSR with uniform blocks: data (nnz, br, bc); block k couples row
    `row_ids[k]` (non-decreasing) to column `col_ind[k]`; `diag_idx` is
    each row's diagonal block; `row_ptr` (num_rows + 1) the rows' offsets,
    made from `row_ids` when not given."""

    data: torch.Tensor
    col_ind: torch.Tensor  # (nnz,)
    row_ids: torch.Tensor  # (nnz,) non-decreasing
    diag_idx: torch.Tensor  # (num_rows,)
    row_ptr: torch.Tensor | None = None  # (num_rows + 1,) int64

    def __post_init__(self):
        if self.row_ptr is None:
            counts = torch.bincount(self.row_ids.long(), minlength=self.diag_idx.shape[0])
            self.row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def block_shape(self) -> tuple[int, int]:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def num_rows(self) -> int:
        return int(self.diag_idx.shape[0])

    def _with(self, data: torch.Tensor) -> "BSRMatrix":
        return BSRMatrix(data, self.col_ind, self.row_ids, self.diag_idx, self.row_ptr)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[r] = sum_nz A[nz] @ x[col[nz]].  x: (num_rows, bc) -> (num_rows, br)."""
        prod = torch.einsum("nij,nj->ni", self.data, x[self.col_ind.long()])
        return torch.segment_reduce(prod, "sum", offsets=self.row_ptr, unsafe=True)

    def diag_blocks(self) -> torch.Tensor:
        """(num_rows, br, bc) diagonal blocks (reference MatrixGetDiagBlock,
        matrix_impl.cu:642-693)."""
        return self.data[self.diag_idx.long()]

    def zero(self) -> "BSRMatrix":
        return self._with(torch.zeros_like(self.data))

    def zero_rows(self, row_mask_bc: torch.Tensor, unit_diag: bool = True) -> "BSRMatrix":
        """Zero the scalar rows selected by the (num_rows, br) boolean
        `row_mask_bc` and put 1.0 on their diagonal (reference MatrixZeroRow
        with diag=1.0, dirichlet.c:47-61; matrix_impl.cu:6-23)."""
        mask = row_mask_bc.to(self.data.dtype)
        data = self.data * (1.0 - mask[self.row_ids.long()])[:, :, None]
        if unit_diag:
            br, bc = self.block_shape
            eye = torch.eye(br, bc, dtype=self.data.dtype, device=self.data.device)
            data = data.index_add(0, self.diag_idx.long(), mask[:, :, None] * eye[None])
        return self._with(data)


def bsr_zeros(sp: Sparsity, br: int, bc: int, dtype=None, device="cuda") -> BSRMatrix:
    """A zero BSR matrix on the sparsity's pattern, on the card unless
    `device` says otherwise (dtype: the device's default)."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)
    return BSRMatrix(
        data=torch.zeros((sp.nnz, br, bc), dtype=dtype, device=dev),
        col_ind=as_t(sp.col_ind),
        row_ids=as_t(np.repeat(np.arange(sp.num_node), np.diff(sp.row_ptr))),
        diag_idx=as_t(sp.diag_idx),
    )


def bsr_to_dense(mat: BSRMatrix) -> np.ndarray:
    """Test helper: the dense (N*br, N*bc) array."""
    n = mat.num_rows
    br, bc = mat.block_shape
    data = mat.data.detach().cpu().numpy()
    dense = np.zeros((n * br, n * bc), dtype=data.dtype)
    rows = mat.row_ids.cpu().numpy()
    cols = mat.col_ind.cpu().numpy()
    for k in range(rows.shape[0]):
        r, c = rows[k], cols[k]
        dense[r * br:(r + 1) * br, c * bc:(c + 1) * bc] += data[k]
    return dense
