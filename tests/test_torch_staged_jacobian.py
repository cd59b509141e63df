"""The staged element Jacobian (K5 / K6 writing K9's staging rows) and K9's
segment sum alone, on the CPU.

The staged kernels (csrc/element_rows.cu, csrc/gather_elements.cu) store
each element's 16 vel/p contributions straight into K9's (K, 16) staging
buffer at their plan positions (`ReducePlan.elem_pos`), and the implicit
phi/T tangents into a (K, 8) one; `ring_reduce_staged` then sums each
target's rows in plan order. They run only on the card. What the CPU
checks is their plain twins and the tables they read:

- the element positions: `plan.src[elem_pos.view(16, m)[ab, e]] ==
  ab*18*m + e` for every contribution the plan has, -1 exactly for the
  pad elements an assembly chunk leaves out, and `elem_pos` is the plan's
  own `stage_pos` when every contribution is present;
- the staged twin followed by the segment sum's twin equals
  `ring_reduce_plain` over the column rows bit for bit (the same values
  added in the same order), float64 and float32, frozen and implicit, on
  the WinELL context and every range of the gather tier (whole, in chunks
  with a padded last range, and the weak form's rows under
  elements_kernel="xla");
- the reduced entries against the JAX package: its element Jacobian rows
  (`pallas_kernels.lhs_rows_call`, backend "xla") reduced by its
  `ring_reduce_xla` over the same contribution lists, float64 to 1e-12;
- plans without element positions, or with them for another element
  count, raise; so do sources that are not element rows.

Meshes: delaunay_mesh(500, seed=7) + RCM (WinELL) and the same
triangulation in its generated order (gather tier).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.fem import pallas_kernels as jpk
from dedflow_tpu.sparse import win_ring as jwr
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import ns, weakform
from dedflow_tpu_torch.fem import win_assembly as wa_
from dedflow_tpu_torch.fem.assembly import build_context, elem_geom
from dedflow_tpu_torch.fem.element_rows import alpha_states
from dedflow_tpu_torch.mesh.gen import delaunay_mesh
from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.sparse.win_ring import (
    ring_reduce_plain,
    ring_reduce_staged,
    ring_reduce_staged_plain,
)
from dedflow_tpu_torch.sparse.win_stream import build_reduce_plan, with_element_positions


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JCFG = jsc.reference_scenario_config(bcs=(), pin_pressure=True)
CFG = interop.config_from_dict(jcfg._to_dict(JCFG))
PHYS, SCHEME = CFG.physics, CFG.time
CHUNK = 300  # the gather tier's assembly chunk: several ranges, the last one padded
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _state(num_node, dtype):
    """Seeded alpha states (N, 6) of the velocity the Jacobian reads."""
    rng = np.random.default_rng(11)
    wg, dwgold, dwg = (torch.as_tensor(rng.standard_normal((num_node, 6)), dtype=dtype)
                       for _ in range(3))
    return alpha_states(wg, dwgold, dwg, SCHEME)[0]


@pytest.fixture(scope="module")
def meshes():
    raw = delaunay_mesh(500, seed=7)
    rcm = reorder_mesh(raw, rcm_order(raw.ien, raw.num_node))
    return raw, rcm


@pytest.fixture(scope="module")
def contexts(meshes):
    """Per dtype: the WinELL context of the RCM mesh, and the gather
    tier's contexts of the generated order, whole, in chunks (the weak
    form's element body, "xla") and in chunks with the K5 twin ("pallas")."""
    raw, rcm = meshes
    sp = build_sparsity(rcm.ien, rcm.num_node)
    out = {}
    for name, dt in DTYPES.items():
        out[name] = {
            "winell": wa_.build_win_context(rcm, sp, device="cpu", dtype=dt),
            "gather": build_context(raw, device="cpu", dtype=dt, elements_kernel="pallas"),
            "gather_chunk": build_context(raw, device="cpu", dtype=dt, chunk=CHUNK,
                                          elements_kernel="pallas"),
            "gather_chunk_xla": build_context(raw, device="cpu", dtype=dt, chunk=CHUNK),
        }
    return out


def _plans(ctxs, tier):
    """[(jac_plan, m, elements of the range that exist)] of a tier."""
    ctx = ctxs[tier]
    if tier == "winell":
        return [(ctx.jac_plan, ctx.num_elem, ctx.num_elem)]
    real = ctxs["winell"].num_elem  # the same triangulation
    return [(r.jac_plan, r.hi - r.lo, min(r.hi, real) - r.lo) for r in ctx.ranges]


@pytest.mark.parametrize("tier", ["winell", "gather", "gather_chunk"])
def test_element_positions_locate_each_contribution(contexts, tier):
    ctxs = contexts["f64"]
    plans = _plans(ctxs, tier)
    if tier == "gather_chunk":  # several ranges, the last one padded
        assert len(plans) > 1 and plans[-1][2] < plans[-1][1]
    else:
        assert len(plans) == 1
    for plan, m, real in plans:
        pos = ek.element_positions(plan, m).long().view(16, m)
        ab, e = torch.meshgrid(torch.arange(16), torch.arange(m), indexing="ij")
        have = pos >= 0
        assert torch.equal(have, (e < real).expand(16, m))  # -1: exactly the pad elements
        assert torch.equal(plan.src[pos[have]].long(), (ab * 18 * m + e)[have])
        k = plan.src.numel()
        assert torch.equal(torch.sort(pos[have]).values, torch.arange(k))  # each row once
        if real == m:  # every contribution: the staging order is the element order
            assert plan.elem_pos is plan.stage_pos


def _column_entries(plan, rows, m, implicit):
    """The parent's reduce: K9's plain version over the (288, m) rows."""
    ent = ring_reduce_plain(plan, rows, wa_.JAC_COMPS, m)
    if implicit:
        ent = torch.cat([ent, ring_reduce_plain(plan, rows, (16, 17), m)])
    return ent


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tier", ["winell", "gather", "gather_chunk"])
def test_staged_twins_then_segment_sum_equal_ring_reduce(contexts, tier, dtype, implicit):
    """The staged K6 / K5 (their plain twins on the CPU, counting no launch)
    then K9's segment sum (its twin) == ring_reduce_plain over the column
    kernel's rows, bit for bit; the staged rows == stage_rows of those."""
    ctxs = contexts[dtype]
    ctx = ctxs[tier]
    wa = _state(ctx.num_node, DTYPES[dtype])
    w_t = wa.T.contiguous()
    launches = (ek.lhs_rows_staged.launches, ek.ns_lhs_gather_staged.launches,
                ring_reduce_staged.launches)
    for i, (plan, m, _) in enumerate(_plans(ctxs, tier)):
        if tier == "winell":
            inp = wa_.jacobian_inputs(ctx, wa, implicit)
            rows = ek.lhs_rows_call(inp, PHYS, SCHEME, scalar_implicit=implicit)
            staged = ek.lhs_rows_staged(inp, PHYS, SCHEME, plan, implicit)
        else:
            lo = ctx.ranges[i].lo
            geom, ien_t = ctx.lhs_geom[:, lo : lo + m], ctx.ien_t[:, lo : lo + m]
            met = ctx.res_geom[13:19, lo : lo + m] if implicit else None
            rows = ek.ns_lhs_gather(geom, ien_t, w_t, PHYS, SCHEME, met)
            staged = ek.ns_lhs_gather_staged(geom, ien_t, w_t, PHYS, SCHEME, plan, met)
        placed = ek.stage_rows(plan, rows, implicit)
        assert staged[0].dtype == DTYPES[dtype] and staged[0].shape == (plan.src.numel(), 16)
        assert torch.equal(staged[0], placed[0])
        if implicit:
            assert staged[1].shape == (plan.src.numel(), 8)
            assert torch.equal(staged[1], placed[1])
            assert not bool(staged[1][:, 2:].any())  # the padding is zeros
        else:
            assert staged[1] is None
        got = wa_.reduce_entries(plan, *staged)
        assert torch.equal(got, _column_entries(plan, rows, m, implicit))
    assert (ek.lhs_rows_staged.launches, ek.ns_lhs_gather_staged.launches,
            ring_reduce_staged.launches) == launches


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
@pytest.mark.parametrize("tier", ["winell", "gather", "gather_chunk", "gather_chunk_xla"])
def test_main_path_entries_equal_the_column_path(contexts, tier, implicit):
    """The tiers' Jacobian entry functions (win_assembly.jacobian_win,
    ns.jacobian_entries: the staged path, or the weak form's rows placed
    by stage_rows) == the column rows reduced by ring_reduce_plain,
    range by range, bit for bit (float64)."""
    ctx = contexts["f64"][tier]
    wa = _state(ctx.num_node, torch.float64)
    if tier == "winell":
        got = wa_.jacobian_win(ctx, wa, PHYS, SCHEME, scalar_implicit=implicit).vals
        rows = ek.lhs_rows_call(wa_.jacobian_inputs(ctx, wa, implicit), PHYS, SCHEME,
                                scalar_implicit=implicit)
        ref = _column_entries(ctx.jac_plan, rows, ctx.num_elem, implicit)
        if not implicit:
            ref = torch.cat([ref, ctx.mult_win])
        assert torch.equal(got, ref)
        return
    got = ns.jacobian_entries(ctx, wa, PHYS, SCHEME, implicit)
    ref = None
    for rng in ctx.ranges:
        m = rng.hi - rng.lo
        ien_t = ctx.ien_t[:, rng.lo : rng.hi]
        if ctx.elements_kernel == "xla":  # the weak form's rows, as ns.py computes them
            ef = weakform.gather_fields(ien_t.T, wa, wa)
            upd = weakform.ns_lhs_packed(elem_geom(ctx, rng.lo, rng.hi), ef, PHYS, SCHEME,
                                         implicit)
            rows = upd.reshape(m, 288).T.contiguous()
        else:
            met = ctx.res_geom[13:19, rng.lo : rng.hi] if implicit else None
            rows = ek.ns_lhs_gather_plain(ctx.lhs_geom[:, rng.lo : rng.hi], ien_t,
                                          wa.T.contiguous(), PHYS, SCHEME, met)
        ref = ns._range_sum(ref, rng.jac_tgt, _column_entries(rng.jac_plan, rows, m, implicit),
                            ctx.win_plan.S)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("implicit", [False, True], ids=["frozen", "implicit"])
def test_staged_entries_match_jax_element_rows_and_ring_reduce(contexts, implicit):
    """WinELL, float64: the staged path's entries against the JAX element
    Jacobian rows (lhs_rows_call, backend "xla") on the same inputs,
    reduced by the JAX ring_reduce_xla over the same contribution lists
    (target: entry; source: the (16, 16*m) vel/p rows at ab*m + e)."""
    ctx = contexts["f64"]["winell"]
    plan, m = ctx.jac_plan, ctx.num_elem
    wa = _state(ctx.num_node, torch.float64)
    inp = wa_.jacobian_inputs(ctx, wa, implicit)
    got = wa_.reduce_entries(plan, *ek.lhs_rows_staged(inp, PHYS, SCHEME, plan, implicit))
    rows = np.asarray(jax.jit(lambda x: jpk.lhs_rows_call(
        x, JCFG.physics, JCFG.time, backend="xla", scalar_implicit=implicit))(
        jnp.asarray(inp.numpy()))).reshape(16, 18, m)
    comps = list(wa_.JAC_COMPS) + ([16, 17] if implicit else [])
    x = rows[:, comps].transpose(1, 0, 2).reshape(len(comps), 16 * m)  # [r, ab*m + e]
    tgt = torch.repeat_interleave(torch.diff(plan.ptr.long())).numpy()
    src = plan.src.long().numpy()
    src = (src // (18 * m)) * m + src % (18 * m)
    ref = jwr.ring_reduce_xla(jwr.build_ring_plan(tgt, src, plan.num_tgt, 16 * m), jnp.asarray(x))
    assert rel(got.numpy(), np.asarray(ref)) < 1e-12


def test_plans_without_element_positions_raise(contexts):
    ctx = contexts["f64"]["winell"]
    m = ctx.num_elem
    wa = _state(ctx.num_node, torch.float64)
    inp = wa_.jacobian_inputs(ctx, wa)
    bare = dataclasses.replace(ctx.jac_plan, elem_pos=None)  # as build_reduce_plan returns it
    with pytest.raises(ValueError, match="element positions"):
        ek.lhs_rows_staged(inp, PHYS, SCHEME, bare)
    with pytest.raises(ValueError, match="element positions"):  # built for m elements, given m - 1
        ek.lhs_rows_staged(inp[:, : m - 1].contiguous(), PHYS, SCHEME, ctx.jac_plan)
    gctx = contexts["f64"]["gather"]
    (rng,) = gctx.ranges
    with pytest.raises(ValueError, match="element positions"):
        ek.ns_lhs_gather_staged(gctx.lhs_geom, gctx.ien_t, wa.T.contiguous(), PHYS, SCHEME,
                                rng.res_plan)
    with pytest.raises(ValueError, match="element positions"):
        ek.stage_rows(bare, torch.zeros((288, m), dtype=torch.float64))


def test_sources_that_are_not_element_rows_raise(contexts):
    ctx = contexts["f64"]["winell"]
    m = ctx.num_elem
    with pytest.raises(ValueError, match="not distinct"):  # the residual rows a*6*m + e
        with_element_positions(ctx.res_plan, m, 16, 18)
    with pytest.raises(ValueError, match="not distinct"):  # a source twice
        with_element_positions(build_reduce_plan([0, 1], [5, 5], 2, device="cpu"), m, 16, 18)
    with pytest.raises(ValueError, match="not distinct"):  # a slot past the 16 pairs
        with_element_positions(build_reduce_plan([0], [16 * 18 * m], 1, device="cpu"), m, 16, 18)
    partial = with_element_positions(build_reduce_plan([1, 0], [18 * m + 2, 3], 2, device="cpu"),
                                     m, 16, 18)
    pos = partial.elem_pos.view(16, m)
    assert (int(pos[1, 2]), int(pos[0, 3])) == (1, 0) and int((pos >= 0).sum()) == 2


def test_segment_sum_twin_checks_its_buffer(contexts):
    """ring_reduce_staged: the (K, 16) or (K, 8) buffer of the plan's K
    rows, 1 to W output rows; its twin sums in plan order."""
    ctx = contexts["f64"]["winell"]
    plan = ctx.jac_plan
    k = plan.src.numel()
    stage = torch.as_tensor(np.random.default_rng(3).standard_normal((k, 16)))
    got = ring_reduce_staged(plan, stage, 16)
    assert torch.equal(got, ring_reduce_staged_plain(plan, stage, 16))
    assert torch.equal(ring_reduce_staged(plan, stage[:, :8].contiguous(), 2), got[:2])
    for bad in (stage[:-1], stage[:, :4], stage.reshape(-1)):
        with pytest.raises(ValueError, match="staging buffer"):
            ring_reduce_staged(plan, bad, 2)
    with pytest.raises(ValueError, match="output rows"):
        ring_reduce_staged(plan, stage[:, :8].contiguous(), 9)
