"""dedflow_tpu_torch WinELL matrix, reduces and element-row wrappers == the
JAX package's, on delaunay_mesh(600, seed=5) + RCM (tests/test_win_assembly.py).

Inputs are made with numpy from a seed and handed to both packages.
Relative error = max|port - jax| / max|jax|.

- The plan: the port numbers entries in CSR order; the JAX plan's
  `entry_of_nnz` maps each CSR nonzero to its TPU slot. Both must give
  every nonzero the same (row, column), and interop carries a JAX matrix
  over exactly (to_block_dense, diag_rows and zero_rows_t equal).
- The plain SpMV (K7's twin) against WinELLMatrix._matvec_xla on the same
  values: float64 to 1e-13 (the same products, another sum order), float32
  to 1e-5 (float32 roundoff of 16-term row sums).
- The plain reduces (K8's and K9's twin) against stream_reduce_xla /
  ring_reduce_xla on the same (tgt, src) lists: float64 to 1e-13, float32
  to 1e-5. These XLA lowerings are what the JAX tests hold the Pallas
  kernels to in interpret mode.
- The tier gate's window statistic equals the JAX stream plan's.
- The same on a synthetic pattern whose rows hold 1 (the diagonal alone)
  to 64 entries, the pattern of K7's card test.
- The K6 wrappers on the CPU against pallas_kernels.*_rows_call(xla), 2-D
  and slab-major, at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.config import Physics as JPhysics
from dedflow_tpu.config import TimeScheme as JScheme
from dedflow_tpu.fem import pallas_kernels as pk
from dedflow_tpu.mesh.gen import delaunay_mesh
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.sparse import win_ring as wr
from dedflow_tpu.sparse import win_stream as ws
from dedflow_tpu.sparse import winell as we
from dedflow_tpu.sparse.topology import build_sparsity
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem import element as tel
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import element_rows as er
from dedflow_tpu_torch.sparse import winell as twe
from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
from dedflow_tpu_torch.sparse.win_stream import (
    build_reduce_plan,
    stream_reduce,
    stream_reduce_plain,
    stream_window_counts,
)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def mesh():
    m = delaunay_mesh(600, seed=5)
    m = reorder_mesh(m, rcm_order(np.asarray(m.ien), m.num_node))
    sp = build_sparsity(np.asarray(m.ien), m.num_node, native=False)
    jplan = we.build_winell_plan(sp.row_ptr, sp.col_ind, m.num_node)
    tplan = twe.build_winell_plan(sp.row_ptr, sp.col_ind, m.num_node, device="cpu")
    return m, sp, jplan, tplan


def _matrices(mesh, dtype, seed=3):
    """A JAX WinELLMatrix with random values on the real entries (zero on
    the TPU pad slots) and the port's matrix carried over by interop."""
    m, sp, jplan, tplan = mesh
    real = np.zeros(jplan.S, bool)
    real[jplan.entry_of_nnz] = True
    vals = np.random.default_rng(seed).standard_normal((we.WIN_ROWS, jplan.S)) * real
    jmat = we.winell_matrix(jplan, jnp.asarray(vals.astype(NP[dtype])), backend="xla")
    tmat = interop.winell_from_numpy(np.asarray(jmat.vals), jplan.entry_of_nnz, tplan, dtype)
    return jmat, tmat


def test_plan_gives_every_nonzero_the_same_row_and_column(mesh):
    m, sp, jplan, tplan = mesh
    eon = jplan.entry_of_nnz
    assert tplan.S == sp.nnz and np.array_equal(tplan.entry_of_nnz, np.arange(sp.nnz))
    assert np.array_equal(jplan.grow[eon], tplan.grow)
    assert np.array_equal(jplan.ecol[eon], tplan.col)
    assert np.array_equal(eon[tplan.diag_entry], jplan.diag_entry)
    assert np.array_equal(twe.COMP2WIN, we.COMP2WIN)


def test_interop_carries_the_matrix_exactly(mesh):
    jmat, tmat = _matrices(mesh, torch.float64)
    assert np.array_equal(tmat.to_block_dense(), jmat.to_block_dense())
    assert np.array_equal(tmat.diag_rows().numpy(), np.asarray(jmat.diag_rows()))
    n = mesh[0].num_node
    mask = np.random.default_rng(4).random((6, n)) < 0.2
    jz = jmat.zero_rows_t(jnp.asarray(mask))
    tz = tmat.zero_rows_t(torch.as_tensor(mask))
    assert np.array_equal(tz.to_block_dense(), jz.to_block_dense())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_spmv_matches_jax_matvec_xla(mesh, dtype):
    jmat, tmat = _matrices(mesh, dtype)
    x = np.random.default_rng(5).standard_normal((6, mesh[0].num_node)).astype(NP[dtype])
    ref = np.asarray(jmat._matvec_xla(jnp.asarray(x)))
    got = winell_matvec_plain(tmat, torch.as_tensor(x))
    assert got.dtype == dtype
    assert rel(got.numpy(), ref) < TOL[dtype]
    before = winell_matvec.launches
    assert torch.equal(tmat.matvec_t(torch.as_tensor(x)), got)  # CPU: the plain version
    assert winell_matvec.launches == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_spmv_matches_jax_on_rows_of_1_to_64_entries(dtype):
    """Rows from the diagonal alone to 64 entries (longer than two turns of
    K7's 16 lanes), as in tests/test_torch_kernels_cuda.py's card test."""
    rng = np.random.default_rng(14)
    n = 160
    lengths = np.arange(n) % 64 + 1
    cols = [np.sort(np.concatenate([[r], rng.choice(np.delete(np.arange(n), r), k - 1,
                                                    replace=False)])) for r, k in enumerate(lengths)]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    col_ind = np.concatenate(cols)
    jplan = we.build_winell_plan(row_ptr, col_ind, n)
    tplan = twe.build_winell_plan(row_ptr, col_ind, n, device="cpu")
    jmat, tmat = _matrices((None, None, jplan, tplan), dtype, seed=16)
    x = rng.standard_normal((6, n)).astype(NP[dtype])
    ref = np.asarray(jmat._matvec_xla(jnp.asarray(x)))
    assert rel(winell_matvec(tmat, torch.as_tensor(x)).numpy(), ref) < TOL[dtype]


def _residual_lists(mesh):
    m = mesh[0]
    ien = np.asarray(m.ien, dtype=np.int64)
    ne = ien.shape[0]
    return ien.T.reshape(-1), np.arange(4 * ne), m.num_node, 4 * ne


def _jacobian_lists(mesh):
    m, sp, jplan, _ = mesh
    ne = m.num_tet
    tgt = jplan.entry_of_nnz[np.asarray(sp.elem_nnz, dtype=np.int64).reshape(ne, 16)].reshape(-1)
    return tgt, np.arange(16 * ne), jplan.S, 16 * ne


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("c", [6, 8])
def test_plain_stream_reduce_matches_jax(mesh, c, dtype):
    tgt, src, num_tgt, src_size = _residual_lists(mesh)
    x = np.random.default_rng(c).standard_normal((c, src_size)).astype(NP[dtype])
    ref = np.asarray(ws.stream_reduce_xla(ws.build_stream_plan(tgt, src, num_tgt, src_size), jnp.asarray(x)))
    plan = build_reduce_plan(tgt, src, num_tgt, device="cpu")
    got = stream_reduce_plain(plan, torch.as_tensor(x))
    assert got.shape == (c, num_tgt) and got.dtype == dtype
    assert rel(got.numpy(), ref) < TOL[dtype]
    assert torch.equal(stream_reduce(plan, torch.as_tensor(x)), got)  # CPU: plain


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("c", [16, 6])
def test_plain_ring_reduce_matches_jax(mesh, c, dtype):
    tgt, src, num_tgt, src_size = _jacobian_lists(mesh)
    x = np.random.default_rng(c).standard_normal((c, src_size)).astype(NP[dtype])
    ref = np.asarray(wr.ring_reduce_xla(wr.build_ring_plan(tgt, src, num_tgt, src_size), jnp.asarray(x)))
    plan = build_reduce_plan(tgt, src, num_tgt, device="cpu")
    got = ring_reduce_plain(plan, torch.as_tensor(x))
    assert got.shape == (c, num_tgt)
    assert rel(got.numpy(), ref) < TOL[dtype]
    assert torch.equal(ring_reduce(plan, torch.as_tensor(x)), got)  # CPU: plain


def test_reduce_reads_a_strided_source_in_place(mesh):
    """comps/cstride address the element rows where the element kernel
    left them: the same sums as the explicitly gathered (C, K) source."""
    tgt, _, num_tgt, _ = _jacobian_lists(mesh)
    ne = mesh[0].num_tet
    e, ab = np.arange(ne), np.arange(16)
    out288 = np.random.default_rng(8).standard_normal((288, ne))
    comps = tuple(int(c) for c in twe.WIN2COMP[:16])
    src = (e[:, None] + ab[None, :] * 18 * ne).reshape(-1)
    got = ring_reduce(build_reduce_plan(tgt, src, num_tgt, device="cpu"), torch.as_tensor(out288), comps, ne)
    x = out288.reshape(16, 18, ne)[:, list(comps)].transpose(1, 2, 0).reshape(16, 16 * ne)
    ref = ring_reduce_plain(
        build_reduce_plan(tgt, np.arange(16 * ne), num_tgt, device="cpu"), torch.as_tensor(x)
    )
    assert rel(got.numpy(), ref.numpy()) < 1e-14


@pytest.mark.parametrize("big_source", [False, True], ids=["resident", "streamed"])
def test_window_counts_match_jax_stream_plan(mesh, big_source):
    m = mesh[0]
    ien = np.asarray(m.ien, dtype=np.int64)
    ne = ien.shape[0]
    src_size = 1 << 20 if big_source else ne  # 1 << 20 columns: not VMEM-resident
    for a in range(4):
        tgt, src = ien[:, a], np.arange(ne)
        ref = ws.build_stream_plan(tgt, src, m.num_node, src_size).vwin & 1023
        assert np.array_equal(stream_window_counts(tgt, src, m.num_node, src_size), ref)


def _jax_phys():
    return JPhysics(), JScheme()


@pytest.mark.parametrize("shape", [(3,), ()], ids=["slab-major", "2d"])
def test_k6_wrappers_on_cpu_match_jax_rows_call(mesh, shape):
    """Geometry rows of the mesh's first elements (the first 5 columns
    zeroed: dead columns), random states."""
    rng = np.random.default_rng(11)
    m = mesh[0]
    g = tel.tet_geometry(torch.as_tensor(m.xg[np.asarray(m.ien[:40])]))
    geo = [er.res_geom_rows(g.shgrad, g.det_j, g.metric), er.lhs_geom_rows(g.shgrad, g.det_j, g.metric)]
    for r in geo:
        r[:, :5] = 0.0
    res_geo, lhs_geo = (np.broadcast_to(r.numpy(), (*shape, *r.shape)) for r in geo)
    inp67 = np.concatenate([res_geo, rng.standard_normal((*shape, 48, 40))], axis=-2)
    inp27 = np.concatenate(
        [lhs_geo[..., :12, :], rng.standard_normal((*shape, 12, 40)), lhs_geo[..., 12:, :]], axis=-2
    )
    jphys, jscheme = _jax_phys()
    before = (ek.res_rows_call.launches, ek.lhs_rows_call.launches)
    got_r = ek.res_rows_call(torch.as_tensor(inp67), Physics(), TimeScheme())
    got_j = ek.lhs_rows_call(torch.as_tensor(inp27), Physics(), TimeScheme())
    assert (ek.res_rows_call.launches, ek.lhs_rows_call.launches) == before
    ref_r = pk.res_rows_call(jnp.asarray(inp67), jphys, jscheme, backend="xla")
    ref_j = pk.lhs_rows_call(jnp.asarray(inp27), jphys, jscheme, backend="xla")
    assert got_r.shape == (*shape, 24, 40) and got_j.shape == (*shape, 288, 40)
    assert rel(got_r.numpy(), ref_r) < 1e-12
    assert rel(got_j.numpy(), ref_j) < 1e-12
    assert (got_r[..., :5] == 0).all() and (got_j[..., :5] == 0).all()
