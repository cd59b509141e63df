"""dedflow_tpu_torch DIA matrix, SpMV and field-split PC == the JAX package's.

One matrix, made with numpy from a seed on the box_mesh(6, 4, 4) lattice
stencil and stored with the TPU's lane padding (width 256 for 175 rows,
garbage in the pad columns), is handed to both packages: to the JAX
FSDIAMatrixT as it is, to the port through `interop.dia_from_numpy`, which
drops the padding. Relative error = max|port - jax| / max|jax|:

- float64 SpMV, diag rows, row zeroing and PC against the JAX XLA path:
  1e-13 (the same products summed in another order);
- float32 SpMV against the JAX Pallas kernel in interpret mode: 1e-6
  (float32 roundoff of 60 products a row).
The hand-written kernel K3 is held against the plain version on a card in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.fem.lattice import _lattice_tables
from dedflow_tpu.solver.pc import NSFieldSplitPCT as JPC
from dedflow_tpu.sparse import fsbsr as jfs
from dedflow_tpu.sparse.dia_kernels import dia_matvec_pallas
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT as TPC
from dedflow_tpu_torch.sparse import dia_kernels as tdk

BOX = (6, 4, 4)
N = 7 * 5 * 5
W = 256  # TPU lane-padded width


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def mat():
    offsets = _lattice_tables(*BOX)[3]
    nd, d0 = len(offsets), offsets.index(0)
    rng = np.random.default_rng(11)
    data = rng.standard_normal((nd, 16, W))
    scal = np.zeros((32, W))  # 2*D = 30 rows, sublane-padded to 32
    scal[: 2 * nd] = rng.standard_normal((2 * nd, W))
    # well-conditioned diagonal blocks for the PC
    for c in (0, 4, 8, 15):
        data[d0, c] += 8.0
    scal[2 * d0 : 2 * d0 + 2] += 8.0
    data[..., N:] = np.nan  # pad columns are garbage behind num_node
    scal[:, N:] = np.nan
    x = rng.standard_normal((6, N))
    mask_t = rng.random((6, N)) < 0.2
    return offsets, data, scal, x, mask_t


def _jax(data, scal, offsets, dtype=jnp.float64, backend="xla"):
    return jfs.FSDIAMatrixT(
        data=jnp.asarray(data, dtype), scal=jnp.asarray(scal, dtype),
        offsets=offsets, backend=backend, num_node=N,
    )


def test_dia_from_numpy_drops_padding(mat):
    offsets, data, scal, _, _ = mat
    m = interop.dia_from_numpy(data, scal, offsets, N)
    assert m.data.shape == (len(offsets), 16, N) and m.scal.shape == (2 * len(offsets), N)
    assert m.data.dtype == torch.float64 and torch.isfinite(m.data).all()
    assert rel(m.to_block_dense(), _jax(data, scal, offsets).to_block_dense()) < 1e-15


def test_matvec_f64_matches_jax_xla(mat):
    offsets, data, scal, x, _ = mat
    ref = _jax(data, scal, offsets).matvec_t(jnp.asarray(x))
    m = interop.dia_from_numpy(data, scal, offsets, N)
    got = tdk.dia_matvec_plain(m.data, m.scal, torch.as_tensor(x), offsets)
    assert rel(got.numpy(), ref) < 1e-13
    assert rel(m.matvec_t(torch.as_tensor(x)).numpy(), ref) < 1e-13


def test_matvec_f32_matches_pallas_interpret(mat):
    offsets, data, scal, x, _ = mat
    nd = len(offsets)
    ref = dia_matvec_pallas(
        jnp.asarray(np.nan_to_num(data), jnp.float32),
        jnp.asarray(np.nan_to_num(scal[: 2 * nd]), jnp.float32),
        jnp.asarray(x, jnp.float32), offsets, interpret=True,
    )
    m = interop.dia_from_numpy(data, scal, offsets, N, dtype=torch.float32)
    got = tdk.dia_matvec(m.data, m.scal, torch.as_tensor(x, dtype=torch.float32), offsets)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), ref) < 1e-6


def test_diag_rows_zero_rows_and_pc_match_jax(mat):
    offsets, data, scal, x, mask_t = mat
    jm = _jax(data, scal, offsets)
    tm = interop.dia_from_numpy(data, scal, offsets, N)
    assert rel(tm.diag_rows().numpy(), jm.diag_rows()) < 1e-15
    jz = jm.zero_rows_t(jnp.asarray(mask_t))
    tz = tm.zero_rows_t(torch.as_tensor(mask_t))
    assert rel(tz.to_block_dense(), jfs.FSDIAMatrixT(
        data=jz.data[..., :N], scal=jz.scal[:, :N], offsets=offsets
    ).to_block_dense()) < 1e-15
    jpc = JPC.from_diag_rows(jz.diag_rows())
    tpc = TPC.from_diag_rows(tz.diag_rows())
    assert rel(tpc(torch.as_tensor(x)).numpy(), jpc(jnp.asarray(x))) < 1e-13
