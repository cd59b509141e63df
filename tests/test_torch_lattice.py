"""dedflow_tpu_torch lattice assembly == the JAX package's lattice assembly.

The same mesh, configuration and state (made with numpy from a seed) go
through both packages. Relative error = max|port - jax| / max|jax|.

- float64: the port's F and J (plain versions, facets and Dirichlet masking
  included) against JAX assemble_residual_t / assemble_jacobian_t on the
  XLA rows backend, to 1e-12: the same arithmetic in another framework.
- float32: the plain versions of K1 (volume residual) and K2 (finished DIA
  data with keep/add/facet band, and unmasked) against the JAX fused TPU
  kernels run through the Pallas interpreter (block=128, two blocks), to
  2e-5: the fused kernels reassociate the node sums across blocks, so the
  agreement is float32 roundoff, the JAX package's own fused-vs-unfused bar
  (fem/lattice.py:749-750).
The hand-written kernels themselves are held against these plain versions
on a card in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem import lattice as jlat
from dedflow_tpu.fem import ns
from dedflow_tpu.mesh.gen import box_mesh
from dedflow_tpu.solver.newton import NSSolver
from dedflow_tpu.sparse.fsbsr import diag_add_rows as j_diag_add_rows
from dedflow_tpu.sparse.fsbsr import keep_pc_rows as j_keep_pc_rows
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.fem import lattice as tlat
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh.gen import box_mesh as t_box_mesh
from dedflow_tpu_torch.solver.newton import NSSolver as TNSSolver
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BOX = (6, 4, 4)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def case():
    mesh = box_mesh(*BOX)
    cfg = reference_scenario_config()
    js = NSSolver(mesh, cfg)
    assert js.fastpath == "lattice"
    wg, dwgold, dwg = reference_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(0).standard_normal(dwg.shape)
    state = (wg, dwgold, dwg)
    tcfg = interop.config_from_dict(jcfg._to_dict(cfg))
    ts = TNSSolver(t_box_mesh(*BOX), tcfg, device="cpu")
    return mesh, cfg, js, ts, state


def _alphas_jax(cfg, state, dtype):
    return ns.alpha_states(*(jnp.asarray(a, dtype) for a in state), cfg.time)


def _alphas_port(ts, state, dtype):
    return alpha_states(*interop.state_from_numpy(*state, "cpu", dtype), ts.cfg.time)


def test_context_tables_and_geometry(case):
    mesh, cfg, js, ts, _ = case
    jl, tl = js.lctx, ts.lctx
    assert tl.deltas == jl.deltas and tl.offsets == jl.offsets
    assert tl.plane_tab == jl.plane_tab
    n, dmax = tl.num_node, jl.dmax
    np.testing.assert_array_equal(tl.mult.numpy(), np.asarray(jl.mult)[0, :n])
    # JAX geometry columns are cell j - dmax on the padded slab
    jr = np.asarray(jl.res_geom)[:, :19, dmax : dmax + n]
    jh = np.asarray(jl.lhs_geom)[:, :15, dmax : dmax + n]
    assert rel(tl.res_geom.numpy(), jr) < 1e-13
    assert rel(tl.lhs_geom.numpy(), jh) < 1e-13


def test_residual_f64_matches_jax(case):
    mesh, cfg, js, ts, state = case
    wa, dwa = _alphas_jax(cfg, state, jnp.float64)
    ref = jlat.assemble_residual_t(
        js.lctx, js.face_ctxs, js.mask, wa, dwa, cfg.physics, cfg.time, True
    )
    twa, tdwa = _alphas_port(ts, state, torch.float64)
    got = tlat.assemble_residual_t(
        ts.lctx, ts.face_ctxs, ts.mask_t, twa, tdwa, ts.cfg.physics, ts.cfg.time, True
    )
    assert got.shape == (6, mesh.num_node)
    assert rel(got.numpy(), ref) < 1e-12
    norms = tlat.field_norms_t(got).numpy()
    assert rel(norms, jlat.field_norms_t(ref)) < 1e-12


def test_jacobian_f64_matches_jax(case):
    mesh, cfg, js, ts, state = case
    wa, dwa = _alphas_jax(cfg, state, jnp.float64)
    ref = jlat.assemble_jacobian_t(
        js.lctx, js.face_ctxs, js.mask, wa, dwa, cfg.physics, cfg.time
    ).to_block_dense()
    twa, tdwa = _alphas_port(ts, state, torch.float64)
    jm = tlat.assemble_jacobian_t(
        ts.lctx, ts.face_ctxs, ts.mask_t, twa, tdwa, ts.cfg.physics, ts.cfg.time
    )
    assert jm.data.shape == (len(ts.lctx.offsets), 16, mesh.num_node)
    assert jm.scal.shape == (2 * len(ts.lctx.offsets), mesh.num_node)
    assert rel(jm.to_block_dense(), ref) < 1e-12


@pytest.fixture(scope="module")
def f32_case(case):
    """float32 alpha states and contexts of both packages."""
    mesh, cfg, js, ts, state = case
    wa, dwa = _alphas_jax(cfg, state, jnp.float32)
    jl32 = jlat.build_lattice_context(mesh, dtype=jnp.float32, rows_backend="xla")
    ts32 = TNSSolver(t_box_mesh(*BOX), ts.cfg, device="cpu", dtype=torch.float32)
    twa, tdwa = _alphas_port(ts32, state, torch.float32)
    return wa, dwa, jl32, ts32, twa, tdwa


def test_plain_k1_matches_fused_interpret(case, f32_case):
    mesh, cfg, *_ = case
    wa, dwa, jl32, ts32, twa, tdwa = f32_case
    ref = jlat.residual_fused(
        jl32, wa.T, dwa.T, None, cfg.physics, cfg.time, interpret=True, block=128
    )
    got = tlat.residual_volume(
        ts32.lctx, twa.T.contiguous(), tdwa.T.contiguous(), ts32.cfg.physics, ts32.cfg.time
    )
    assert got.dtype == torch.float32
    assert rel(got.numpy(), np.asarray(ref)[:, : mesh.num_node]) < 2e-5


def test_plain_k2_matches_fused_interpret(case, f32_case):
    mesh, cfg, js, *_ = case
    wa, dwa, jl32, ts32, twa, tdwa = f32_case
    n, nd = mesh.num_node, len(jl32.offsets)
    f32 = jnp.float32
    # the JAX masked-kernel inputs, as assemble_jacobian_t builds them
    mask_t = js.mask.T
    keep_pc, add18 = j_keep_pc_rows(mask_t, f32), j_diag_add_rows(mask_t, f32)
    bands = []
    for fctx in js.face_ctxs:
        blk = jlat._face_band(fctx, wa, dwa, cfg.physics, cfg.time, nd, f32)
        lo, span = fctx.dia_row_lo, fctx.dia_row_span
        blk = blk * keep_pc[:, lo : lo + span][None]
        bands.append((blk[:, :16].reshape(nd * 16, span), lo))
    ref = jlat.jacobian_fused(
        jl32, wa.T, cfg.physics, cfg.time, interpret=True, block=128,
        keep16=keep_pc[:16], add16=add18[:16], bands=tuple(bands),
    )
    tk = keep_pc_rows(ts32.mask_t, torch.float32)
    ta = diag_add_rows(ts32.mask_t, torch.float32)
    band, lo = tlat._masked_face_band(
        ts32.face_ctxs, twa, tdwa, ts32.cfg.physics, ts32.cfg.time, nd, tk
    )
    got = tlat.jacobian_volume(
        ts32.lctx, twa.T.contiguous(), ts32.cfg.physics, ts32.cfg.time,
        tk[:16].contiguous(), ta[:16].contiguous(), band, lo,
    )
    assert rel(got.numpy(), np.asarray(ref)[..., :n]) < 2e-5
    # unmasked (K2' mode): the element scale, not the unit diagonal, sets
    # the relative error. Held against the JAX unfused float32 planes, which
    # the JAX package's own tests hold against the fused raw kernel
    # (tests/test_pallas.py::test_fused_carry_kernels_multiblock_interpret).
    from dedflow_tpu.fem import pallas_kernels as pk

    raw = jnp.stack(jlat._reduce_lhs_planes(jl32, pk.lhs_rows_call(
        jlat._lhs_inputs(jl32, wa.T), cfg.physics, cfg.time, backend="xla"
    )))[:, :16]
    one, zero = torch.ones_like(tk[:16]), torch.zeros_like(ta[:16])
    got_raw = tlat.jacobian_volume(
        ts32.lctx, twa.T.contiguous(), ts32.cfg.physics, ts32.cfg.time, one, zero
    )
    assert rel(got_raw.numpy(), np.asarray(raw)) < 2e-5


def test_dead_cells_contribute_exact_zeros(case):
    """Cells on the far faces have zero geometry: their element rows are
    exactly 0, never NaN, in both plain bodies."""
    mesh, cfg, js, ts, state = case
    twa, tdwa = _alphas_port(ts, state, torch.float64)
    lctx = ts.lctx
    nx, ny, nz = mesh.lattice
    c = np.arange(lctx.num_node)
    dead = torch.as_tensor(
        (c % (nx + 1) == nx) | ((c // (nx + 1)) % (ny + 1) == ny) | (c // ((nx + 1) * (ny + 1)) == nz)
    )
    res = tlat.res_rows(tlat._residual_inputs(lctx, twa.T, tdwa.T), **tlat._res_args(cfg.physics, cfg.time))
    lhs = tlat.lhs_rows(tlat._lhs_inputs(lctx, twa.T), ncomp=16, **tlat._lhs_args(cfg.physics, cfg.time))
    for out in (res, lhs):
        assert torch.isfinite(out).all()
        assert (out[..., dead] == 0).all()
        assert (out[..., ~dead] != 0).any()
