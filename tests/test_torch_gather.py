"""dedflow_tpu_torch general gather tier (fem.assembly, fem.weakform,
fem.ns, K4/K5 and K10's plain twins, NSSolver fastpath "gather") == the
JAX package.

Meshes: box_mesh(4, 3, 3) with the reference scenario (strong BCs, the
weak Nitsche wall, its mask), delaunay_mesh(300, seed=5) in its generated
(unordered) node order, and the same Delaunay mesh RCM-ordered for K10.
Inputs are made with numpy from a seed. Relative error = max|port - jax|
/ max|jax|.

- Plans: the port's sparsity ELL tables, sorted-scatter permutations and
  reduce plans are the JAX build_context's, as integers.
- float64 against the JAX weak form and assembly (the same arithmetic in
  other sum orders): 1e-12; the field-split preconditioner 1e-13.
- float32 plain twins of K4/K5 against the JAX Pallas entry points in
  interpret mode: 2e-5 (float32 roundoff of the element bodies).
- Steps: 1e-9 with equal Newton and Krylov counts against the JAX gather
  solver (both run GMRES with the same block-Jacobi field split).
- K10's plain twin equals the JAX Pallas kernel (interpret mode) and its
  XLA lowering exactly: a gather is exact.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_initial_state, reference_scenario_config
from dedflow_tpu.fem import ns as jns
from dedflow_tpu.fem import pallas_kernels as jpk
from dedflow_tpu.fem import weakform as jwf
from dedflow_tpu.fem import win_assembly as jwin
from dedflow_tpu.fem.assembly import build_context as jbuild_context
from dedflow_tpu.mesh.gen import box_mesh, delaunay_mesh
from dedflow_tpu.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.solver.pc import NSFieldSplitPC
from dedflow_tpu.sparse import topology as jtop
from dedflow_tpu.sparse import win_gather as jwg
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app import main as tmain
from dedflow_tpu_torch.fem import assembly as tasm
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import ns as tns
from dedflow_tpu_torch.fem import weakform as twf
from dedflow_tpu_torch.fem import win_assembly as twin
from dedflow_tpu_torch.mesh import gen as tgen
from dedflow_tpu_torch.mesh import reorder as treo
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT
from dedflow_tpu_torch.sparse import topology as ttop
from dedflow_tpu_torch.sparse import win_gather as twg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _tcfg(cfg):
    return interop.config_from_dict(jcfg._to_dict(cfg))


def _perturbed(mesh, seed):
    wg, dwgold, dwg = reference_initial_state(mesh)
    return wg, dwgold, dwg + 0.1 * np.random.default_rng(seed).standard_normal(dwg.shape)


@pytest.fixture(scope="module")
def box():
    """box_mesh(4, 3, 3), the reference scenario on the gather tier: the JAX
    and port solvers (float64) and a perturbed state."""
    cfg = reference_scenario_config(use_lattice="gather")
    jm, tm = box_mesh(4, 3, 3), tgen.box_mesh(4, 3, 3)
    js = jnt.NSSolver(jm, cfg)
    ts = tnt.NSSolver(tm, _tcfg(cfg), device="cpu")
    assert js.fastpath == ts.fastpath == "gather" and ts.face_ctxs
    return jm, tm, js, ts, _perturbed(jm, 3)


@pytest.fixture(scope="module")
def delaunay():
    jm = delaunay_mesh(300, seed=5)
    tm = tgen.delaunay_mesh(300, seed=5)
    assert np.array_equal(tm.ien, np.asarray(jm.ien))
    jsp = jtop.build_sparsity(np.asarray(jm.ien), jm.num_node, native=False)
    tsp = ttop.build_sparsity(tm.ien, tm.num_node)
    rng = np.random.default_rng(2)
    wa, dwa = rng.normal(size=(2, tm.num_node, 6))
    src = rng.normal(size=tm.num_node)
    return jm, tm, jsp, tsp, reference_scenario_config(), wa, dwa, src


def _flat_plan(plan, per: int, rows: int, m: int):
    """(targets, flat e*per + slot) of a reduce plan over (rows*per, m)
    element output rows, sorted by (target, flat index)."""
    tgt = np.repeat(np.arange(plan.num_tgt), np.diff(plan.ptr.numpy()))
    src = plan.src.numpy().astype(np.int64)
    flat = (src % m) * per + src // (rows * m)
    order = np.lexsort((flat, tgt))
    return tgt[order], flat[order]


def test_plans_and_tables_equal_jax(delaunay):
    jm, tm, jsp, tsp, *_ = delaunay
    jctx = jbuild_context(jm, jsp)
    ctx = tasm.build_context(tm, tsp, device="cpu")
    assert tsp.max_row == jsp.max_row
    for got, ref in zip(tsp.ell_tables(), jsp.ell_tables()):
        assert np.array_equal(got, ref)
    ell_col, nnz_to_ell, _ = tsp.ell_tables()
    assert np.array_equal(ell_col, np.asarray(jctx.ell_col))
    diag_slot = nnz_to_ell[tsp.diag_idx] % tsp.max_row
    assert np.array_equal(diag_slot, np.asarray(jctx.diag_slot))
    for got, ref in zip(ttop.scatter_permutation(tsp.elem_nnz), jtop.scatter_permutation(jsp.elem_nnz)):
        assert np.array_equal(got, ref)
    (rng,) = ctx.ranges
    ne = ctx.num_elem
    for plan, per, rows, perm, targets in (
        (rng.res_plan, 4, 6, jctx.node_perm, jctx.node_targets),
        (rng.jac_plan, 16, 18, jctx.mat_perm, jctx.mat_targets),
    ):
        tgt, flat = _flat_plan(plan, per, rows, ne)
        assert np.array_equal(tgt, np.asarray(targets)) and np.array_equal(flat, np.asarray(perm))
    assert np.array_equal(ctx.ien_t.numpy(), np.asarray(jctx.ien_t))
    assert np.array_equal(ctx.win_plan.col, np.asarray(jctx.col_ind))
    assert rel(ctx.res_geom.numpy(), jctx.res_geom) < 1e-13
    assert rel(ctx.lhs_geom.numpy(), jctx.lhs_geom) < 1e-13
    g = tasm.elem_geom(ctx)
    for name in ("shgrad", "det_j", "metric"):
        assert rel(getattr(g, name).numpy(), getattr(jctx, name)) < 1e-13, name


def test_chunked_layout_and_plans_equal_jax(delaunay):
    """chunk=500: the zero-padded element layout of the JAX context, and
    element-range plans that together hold every contribution of the JAX
    whole-mesh plans exactly once."""
    jm, tm, jsp, tsp, *_ = delaunay
    jctx = jbuild_context(jm, jsp, chunk=500)
    ref = jbuild_context(jm, jsp)
    ctx = tasm.build_context(tm, tsp, device="cpu", chunk=500)
    assert ctx.num_elem == jctx.num_elem and ctx.num_elem % 500 == 0
    assert np.array_equal(ctx.ien_t.numpy(), np.asarray(jctx.ien_t))
    assert rel(ctx.res_geom.numpy(), jctx.res_geom) < 1e-13
    assert [(r.lo, r.hi) for r in ctx.ranges] == [(lo, lo + 500) for lo in range(0, ctx.num_elem, 500)]
    for kind, per, rows, perm, targets in (
        ("res", 4, 6, ref.node_perm, ref.node_targets),
        ("jac", 16, 18, ref.mat_perm, ref.mat_targets),
    ):
        tgts, flats = [], []
        for r in ctx.ranges:
            t, f = _flat_plan(getattr(r, f"{kind}_plan"), per, rows, 500)
            tgts.append(getattr(r, f"{kind}_tgt").numpy()[t])
            flats.append(f + r.lo * per)
        tgt, flat = np.concatenate(tgts), np.concatenate(flats)
        order = np.lexsort((flat, tgt))
        assert np.array_equal(tgt[order], np.asarray(targets))
        assert np.array_equal(flat[order], np.asarray(perm))


def test_weakform_port_matches_jax_f64(delaunay):
    jm, tm, jsp, tsp, cfg, wa, dwa, src = delaunay
    tc = _tcfg(cfg)
    jctx = jbuild_context(jm, jsp)
    ctx = tasm.build_context(tm, tsp, device="cpu")
    jef = jwf.gather_fields(jctx.ien, jnp.asarray(wa), jnp.asarray(dwa))
    ef = twf.gather_fields(torch.as_tensor(tm.ien), torch.as_tensor(wa), torch.as_tensor(dwa))
    for name in jef._fields:
        assert np.array_equal(getattr(ef, name).numpy(), np.asarray(getattr(jef, name))), name
    g = tasm.elem_geom(ctx)
    u_q = np.einsum("qa,eai->eqi", np.asarray(jpk._SHL), wa[tm.ien, :3])
    for got, ref in zip(
        twf.stab_tau(g.metric, torch.as_tensor(u_q), tc.physics, tc.time.dt),
        jwf.stab_tau(jctx.metric, jnp.asarray(u_q), cfg.physics, cfg.time.dt),
    ):
        assert rel(got.numpy(), ref) < 1e-12
    src_e = src[tm.ien]
    got = twf.ns_residual_elements(g, ef, tc.physics, tc.time, torch.as_tensor(src_e))
    ref = jwf.ns_residual_elements(jctx, jef, cfg.physics, cfg.time, jnp.asarray(src_e))
    assert rel(got.numpy(), ref) < 1e-12
    got = twf.ns_lhs_packed(g, ef, tc.physics, tc.time)
    assert rel(got.numpy(), jwf.ns_lhs_packed(jctx, jef, cfg.physics, cfg.time)) < 1e-12
    got = twf.ns_lhs_elements(g, ef, tc.physics, tc.time)
    assert rel(got.numpy(), jwf.ns_lhs_elements(jctx, jef, cfg.physics, cfg.time)) < 1e-12
    # the implicit phi/T tangents (melt-pool runs) in components 16/17
    got = twf.ns_lhs_packed(g, ef, tc.physics, tc.time, scalar_implicit=True)
    assert rel(got.numpy(), jwf.ns_lhs_packed(jctx, jef, cfg.physics, cfg.time, True)) < 1e-12


def test_k4_k5_plain_twins_f64_match_jax_weakform(delaunay):
    jm, tm, jsp, tsp, cfg, wa, dwa, src = delaunay
    tc = _tcfg(cfg)
    jctx = jbuild_context(jm, jsp)
    ctx = tasm.build_context(tm, tsp, device="cpu")
    ne = ctx.num_elem
    jef = jwf.gather_fields(jctx.ien, jnp.asarray(wa), jnp.asarray(dwa))
    w_t, dw_t = torch.as_tensor(wa.T.copy()), torch.as_tensor(dwa.T.copy())
    got = ek.ns_residual_gather(ctx.res_geom, ctx.ien_t, w_t, dw_t, tc.physics, tc.time,
                                torch.as_tensor(src))
    ref = jwf.ns_residual_elements(jctx, jef, cfg.physics, cfg.time, jnp.asarray(src[tm.ien]))
    assert rel(got.numpy().reshape(4, 6, ne).transpose(2, 0, 1), ref) < 1e-12
    got = ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, tc.physics, tc.time)
    ref = jwf.ns_lhs_packed(jctx, jef, cfg.physics, cfg.time)
    assert rel(got.numpy().reshape(16, 18, ne).transpose(2, 0, 1).reshape(ne * 16, 18), ref) < 1e-12


def test_k4_k5_plain_twins_f32_match_jax_pallas_interpret(delaunay):
    """On the first 512 elements (one grid step of the interpreted TPU
    kernels), read through column slices of the whole-mesh context."""
    jm, tm, jsp, tsp, cfg, wa, dwa, src = delaunay
    tc = _tcfg(cfg)
    jctx = jbuild_context(jm, jsp, dtype=jnp.float32)
    ctx = tasm.build_context(tm, tsp, device="cpu", dtype=torch.float32)
    ne = 512
    wa32, dwa32, src32 = wa.astype(np.float32), dwa.astype(np.float32), src.astype(np.float32)
    ref = jpk.ns_residual_pallas(jctx.res_geom[:, :ne], jctx.ien_t[:, :ne], jnp.asarray(wa32),
                                 jnp.asarray(dwa32), cfg.physics, cfg.time, jnp.asarray(src32),
                                 interpret=True)
    w_t, dw_t = torch.as_tensor(wa32.T.copy()), torch.as_tensor(dwa32.T.copy())
    ien_t = ctx.ien_t[:, :ne]
    got = ek.ns_residual_gather(ctx.res_geom[:, :ne], ien_t, w_t, dw_t, tc.physics, tc.time,
                                torch.as_tensor(src32))
    assert got.dtype == torch.float32
    assert rel(got.numpy().reshape(4, 6, ne).transpose(2, 0, 1), ref) < 2e-5
    ref = jpk.ns_lhs_packed_pallas(jctx.lhs_geom[:, :ne], jctx.ien_t[:, :ne], jnp.asarray(wa32),
                                   cfg.physics, cfg.time, interpret=True)
    got = ek.ns_lhs_gather(ctx.lhs_geom[:, :ne], ien_t, w_t, tc.physics, tc.time)
    got = got.numpy().reshape(16, 18, ne).transpose(2, 0, 1).reshape(ne * 16, 18)
    ref = np.asarray(ref)
    for comps in (slice(0, 9), slice(9, 12), slice(12, 15), slice(15, 16), slice(16, 18)):
        assert rel(got[:, comps], ref[:, comps]) < 2e-5  # each vel/p block on its own scale


@pytest.fixture(scope="module")
def box_contexts(box):
    """The JAX and port contexts of the box, whole-mesh and chunked (the
    JAX ones from gather solvers, which own the facet contexts and mask)."""
    jm, tm, js, ts, _ = box
    cfg = reference_scenario_config(use_lattice="gather", assembly_chunk=64)
    jsc = jnt.NSSolver(jm, cfg)
    return {None: js, 64: jsc}


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunk64"])
@pytest.mark.parametrize("method", ["segment", "prefix", "grouped", "tiered"])
def test_assembly_matches_jax_f64(box, box_contexts, method, chunk):
    """F and the dense J with the reference scenario's facets and mask,
    every scatter_method name (the box's "grouped" J is the JAX DIA matrix)
    and an assembly chunk, both element bodies of the CPU."""
    jm, tm, _, ts, _ = box
    js = box_contexts[chunk]
    rng = np.random.default_rng(4)
    wa, dwa = rng.normal(size=(2, tm.num_node, 6))
    phys, scheme = js.cfg.physics, js.cfg.time
    kw = dict(chunk=chunk, scatter_method=method, elements_kernel="xla")
    f_ref = jns.assemble_residual(js.ctx, js.face_ctxs, js.mask, jnp.asarray(wa), jnp.asarray(dwa),
                                  phys, scheme, **kw)
    j_ref = jns.assemble_jacobian(js.ctx, js.face_ctxs, js.mask, jnp.asarray(wa), jnp.asarray(dwa),
                                  phys, scheme, **kw).to_block_dense()
    tc = ts.cfg
    for kernel in ("xla", "pallas"):
        ctx = tasm.build_context(tm, None, device="cpu", chunk=chunk, scatter_method=method,
                                 elements_kernel=kernel)
        args = (ctx, ts.face_ctxs, ts.mask_t, torch.as_tensor(wa), torch.as_tensor(dwa),
                tc.physics, tc.time)
        assert rel(tns.assemble_residual(*args).numpy(), np.asarray(f_ref).T) < 1e-12, kernel
        assert rel(tns.assemble_jacobian(*args).to_block_dense(), j_ref) < 1e-12, kernel


def test_unknown_scatter_method_raises(delaunay):
    jm, tm, jsp, tsp, cfg, wa, dwa, _ = delaunay
    with pytest.raises(ValueError, match="scatter_method"):
        tasm.build_context(tm, tsp, device="cpu", scatter_method="atomic")
    # the implicit Jacobian (melt-pool runs) is ported: it equals JAX's
    mask = np.zeros((jm.num_node, 6), bool)
    ref = jns.assemble_jacobian(jbuild_context(jm, jsp), (), jnp.asarray(mask), jnp.asarray(wa),
                                jnp.asarray(dwa), cfg.physics, cfg.time, scalar_implicit=True)
    tc = _tcfg(cfg)
    got = tns.assemble_jacobian(tasm.build_context(tm, tsp, device="cpu"), (),
                                torch.as_tensor(mask.T.copy()), torch.as_tensor(wa),
                                torch.as_tensor(dwa), tc.physics, tc.time, scalar_implicit=True)
    assert rel(got.to_block_dense(), ref.to_block_dense()) < 1e-12


def test_fsbsr_converter_and_fieldsplit_pc_match_jax(delaunay):
    """The JAX FSBSRMatrix (ELL rows) carried onto the CSR entries equals the
    port's Jacobian, and NSFieldSplitPCT on its diag_rows() equals the JAX
    NSFieldSplitPC."""
    jm, tm, jsp, tsp, cfg, wa, dwa, _ = delaunay
    tc = _tcfg(cfg)
    jctx = jbuild_context(jm, jsp)
    mask = np.zeros((jm.num_node, 6), bool)
    mask[0, 3] = True
    jmat = jns.assemble_jacobian(jctx, (), jnp.asarray(mask), jnp.asarray(wa), jnp.asarray(dwa),
                                 cfg.physics, cfg.time)
    ctx = tasm.build_context(tm, tsp, device="cpu")
    tmat = tns.assemble_jacobian(ctx, (), torch.as_tensor(mask.T.copy()), torch.as_tensor(wa),
                                 torch.as_tensor(dwa), tc.physics, tc.time)
    conv = interop.fsbsr_from_numpy(np.asarray(jmat.data), tsp, ctx.win_plan)
    assert rel(conv.vals.numpy(), tmat.vals.numpy()) < 1e-12
    assert np.array_equal(conv.to_block_dense(), jmat.to_block_dense())
    x = np.random.default_rng(6).normal(size=(jm.num_node, 6))
    ref = NSFieldSplitPC.from_matrix(jmat)(jnp.asarray(x))
    got = NSFieldSplitPCT.from_diag_rows(tmat.diag_rows())(torch.as_tensor(x.T.copy()))
    assert rel(got.numpy(), np.asarray(ref).T) < 1e-13


def _states(state, device="cpu"):
    return interop.state_from_numpy(*state, device=device)


def test_step_fixed_matches_jax(box):
    _, _, js, ts, state = box
    ref = js.step_fixed(*(jnp.asarray(a) for a in state), num_newton=2)
    got = ts.step_fixed(*_states(state), num_newton=2)
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name


def _assert_same_step(js, ts, state):
    *ref, rstats = js.step(*(jnp.asarray(a) for a in state))
    *got, tstats = ts.step(*_states(state))
    for name, g, r in zip(("wgold", "dwgold", "dwg"), got, ref):
        assert rel(g.numpy(), r) < 1e-9, name
    assert len(tstats.rnorms) == len(rstats.rnorms)
    assert tstats.krylov_iters == rstats.krylov_iters and sum(tstats.krylov_iters) > 0
    assert tstats.converged == rstats.converged


def test_step_matches_jax(box):
    _, _, js, ts, state = box
    _assert_same_step(js, ts, state)


def test_auto_falls_back_to_gather_on_an_unordered_mesh(delaunay):
    """A generated Delaunay mesh in its own node order fails the WinELL
    gate (span ratio ~0.6) in both packages: "auto" lands on the gather
    tier."""
    jm, tm = delaunay[:2]
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    js = jnt.NSSolver(jm, cfg)
    ts = tnt.NSSolver(tm, _tcfg(cfg), device="cpu")
    assert js.fastpath == ts.fastpath == "gather"
    _assert_same_step(js, ts, _perturbed(jm, 8))


def test_assembly_chunk_step_matches_jax(box, box_contexts):
    jm, tm, _, _, state = box
    js = box_contexts[64]
    ts = tnt.NSSolver(tm, _tcfg(js.cfg), device="cpu")
    assert js.fastpath == ts.fastpath == "gather"
    assert [r.hi - r.lo for r in ts.gctx.ranges] == [64] * (ts.gctx.num_elem // 64)
    _assert_same_step(js, ts, state)


@pytest.fixture(scope="module")
def rcm_delaunay(delaunay):
    jm, tm, *_ = delaunay
    jm = reorder_mesh(jm, rcm_order(np.asarray(jm.ien), jm.num_node))
    tm = treo.reorder_mesh(tm, treo.rcm_order(tm.ien, tm.num_node))
    assert np.array_equal(tm.ien, np.asarray(jm.ien))
    return jm, tm


@pytest.mark.parametrize("kind", ["residual", "jacobian"])
def test_k10_plain_twin_equals_jax_exactly(rcm_delaunay, kind):
    """On the first 512 elements (one grid step of the interpreted TPU
    kernel), the JAX row maps."""
    jm, tm = rcm_delaunay
    assert twg.RES_ROWMAP == jwin._RES_ROWMAP and twg.JAC_ROWMAP == jwin._JAC_ROWMAP
    rowmap, rows, c = (twg.RES_ROWMAP, 48, 14) if kind == "residual" else (twg.JAC_ROWMAP, 12, 3)
    x = np.random.default_rng(9).normal(size=(c, tm.num_node)).astype(np.float32)
    ien_t = np.ascontiguousarray(tm.ien[:512].T).astype(np.int32)
    plan = jwg.build_gather_plan(ien_t, tm.num_node)
    ref = np.asarray(jwg.win_gather(plan, jnp.asarray(ien_t), jnp.asarray(x), rowmap, rows,
                                    interpret=True))
    xla = np.asarray(jwg.win_gather_xla(jnp.asarray(ien_t), jnp.asarray(x), rowmap, rows))
    got = twg.win_gather(torch.as_tensor(ien_t), torch.as_tensor(x), rowmap, rows).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got, ref) and np.array_equal(got, xla)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_win_assembly_through_k10_equals_the_index_gather(rcm_delaunay, dtype):
    """The WinELL tier's element input rows come through K10 with the JAX
    row maps; they equal the index gather of the K4/K5 twins exactly, and
    CPU tensors launch nothing."""
    _, tm = rcm_delaunay
    tsp = ttop.build_sparsity(tm.ien, tm.num_node)
    rng = np.random.default_rng(10)
    wa, dwa = (torch.as_tensor(a, dtype=dtype) for a in rng.normal(size=(2, tm.num_node, 6)))
    ctx = twin.build_win_context(tm, tsp, device="cpu", dtype=dtype)
    before = twg.win_gather.launches
    assert torch.equal(twin.residual_inputs(ctx, wa, dwa),
                       ek.res_gather_inputs(ctx.res_geom, ctx.ien_t, wa.T, dwa.T))
    assert torch.equal(twin.jacobian_inputs(ctx, wa),
                       ek.lhs_gather_inputs(ctx.lhs_geom, ctx.ien_t, wa.T))
    assert twg.win_gather.launches == before  # CPU tensors: the plain version


def test_cli_chunk_runs_the_gather_tier(capsys):
    rc = tmain.main(["--box", "3", "3", "3", "--steps", "1", "--device", "cpu", "--chunk", "40"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["fastpath"] == "gather" and all(np.isfinite(rec["field_norms"]))
    assert sum(rec["krylov_iters"]) > 0 and max(rec["field_norms"]) > 0
