"""The staged two-pass form of the segmented reduces K8 and K9
(dedflow_tpu_torch/csrc/seg_reduce.cu) on the CPU.

The kernels run only on the card. What the CPU can check is what they read:
the plans' staging arrays (`stage_src`, the sources sorted ascending, and
`stage_pos`, the plan position of each), and that the two passes computed
from them in torch (stage: rows written at their plan positions, zero-padded
to the stage width; segment sum: each target's contiguous rows added in
plan order) give the reduce's function:

- against the plain version (`seg_reduce_plain`) in float64 to 1e-13 (the
  same sums; the plain version adds by index_add_);
- against the JAX package's XLA lowerings `stream_reduce_xla` /
  `ring_reduce_xla` on the same (tgt, src) lists, float64 to 1e-13, as
  tests/test_torch_winell.py holds the plain version;
- on edge cases: targets without contributions (zeros), a plan without
  contributions, and 1, 2, 6, 8 and 16 output rows.

Plans: build_reduce_plan and reduce_plan_from_sorted on seeded lists with
repeated sources, the WinELL context's res_plan / jac_plan on
delaunay_mesh(400, seed=5) + RCM, and the gather tier's ranges on the same
triangulation in its generated order, whole and with assembly chunks of 64
elements.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.sparse import win_ring as wr
from dedflow_tpu.sparse import win_stream as ws
from dedflow_tpu_torch.fem.assembly import build_context
from dedflow_tpu_torch.fem.win_assembly import JAC_COMPS, build_win_context
from dedflow_tpu_torch.mesh.gen import delaunay_mesh
from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.sparse.win_ring import ring_reduce
from dedflow_tpu_torch.sparse.win_stream import (
    build_reduce_plan,
    reduce_plan_from_sorted,
    seg_reduce_plain,
    stage_width,
    stream_reduce,
)


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


def two_pass(plan, x, comps, cstride):
    """The kernels' two passes in torch: stage every contribution, read in
    ascending source order, as a row of a (K, W) buffer at its plan
    position (zero-padded to W = stage_width(C)); then sum each target's
    contiguous rows in plan order (k ascending)."""
    flat = x.reshape(-1)
    k, c = plan.stage_src.numel(), len(comps)
    stage = torch.zeros((k, stage_width(c)), dtype=x.dtype)
    offs = torch.tensor([int(r) * cstride for r in comps], dtype=torch.long)
    stage[plan.stage_pos.long(), :c] = flat[plan.stage_src.long()[:, None] + offs]
    start, counts = plan.ptr[:-1].long(), torch.diff(plan.ptr.long())
    acc = torch.zeros((plan.num_tgt, stage.shape[1]), dtype=x.dtype)
    for j in range(int(counts.max()) if k else 0):
        live = counts > j
        acc[live] = acc[live] + stage[start[live] + j]
    return acc[:, :c].T


def assert_staging(plan):
    """stage_pos is a permutation of the plan positions, stage_src the
    plan's sources in ascending order (ties in plan order: a stable sort)."""
    k = plan.src.numel()
    assert plan.stage_src.dtype == plan.stage_pos.dtype == torch.int32
    assert plan.stage_src.shape == plan.stage_pos.shape == (k,)
    pos = plan.stage_pos.long()
    assert torch.equal(torch.sort(pos).values, torch.arange(k))
    assert bool((torch.diff(plan.stage_src) >= 0).all())
    assert torch.equal(plan.src[pos], plan.stage_src)
    ties = torch.diff(plan.stage_src) == 0
    assert bool((torch.diff(pos)[ties] > 0).all())


@pytest.fixture(scope="module")
def meshes():
    """delaunay_mesh(400, seed=5): RCM-ordered with its WinELL context, and
    in its generated order with the gather tier's context, whole and in
    chunks of 64 elements."""
    raw = delaunay_mesh(400, seed=5)
    rcm = reorder_mesh(raw, rcm_order(raw.ien, raw.num_node))
    wctx = build_win_context(rcm, build_sparsity(rcm.ien, rcm.num_node), device="cpu")
    gctx = build_context(raw, device="cpu")
    chunked = build_context(raw, device="cpu", chunk=64)
    assert len(chunked.ranges) > 1
    return wctx, gctx, chunked, rcm


def _lists(seed, num_tgt, k, num_src):
    """Seeded (tgt, src) lists with repeated sources and, where k is small
    against num_tgt, targets without contributions."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, num_tgt, k), rng.integers(0, num_src, k)


def test_staging_arrays_of_the_list_plans():
    tgt, src = _lists(0, 50, 700, 300)
    assert_staging(build_reduce_plan(tgt, src, 50, device="cpu"))
    order = np.argsort(tgt, kind="stable")  # grouped by target, sources unsorted
    plan = reduce_plan_from_sorted(tgt[order], src[order], 50, device="cpu")
    assert_staging(plan)
    assert torch.equal(plan.src, torch.as_tensor(src[order], dtype=torch.int32))
    assert_staging(build_reduce_plan([], [], 3, device="cpu"))


def test_staging_arrays_of_the_context_plans(meshes):
    wctx, gctx, chunked, _ = meshes
    for plan in (wctx.res_plan, wctx.jac_plan):
        assert_staging(plan)
    for ctx in (gctx, chunked):
        for rng in ctx.ranges:
            assert_staging(rng.res_plan)
            assert_staging(rng.jac_plan)


@pytest.mark.parametrize("tier", ["winell", "gather", "gather_chunk64"])
def test_two_passes_equal_plain_on_element_rows(meshes, tier):
    """The residual's node reduce (6 rows of the (24, m) element rows) and
    the Jacobian's entry reduce (16 rows of the (288, m) rows), with the
    implicit second 2-row pass, read in place through comps/cstride."""
    wctx, gctx, chunked, _ = meshes
    if tier == "winell":
        parts = [(wctx.res_plan, wctx.jac_plan, wctx.num_elem)]
    else:
        ctx = gctx if tier == "gather" else chunked
        parts = [(r.res_plan, r.jac_plan, r.hi - r.lo) for r in ctx.ranges]
    rng = np.random.default_rng(1)
    for res_plan, jac_plan, m in parts:
        x24 = torch.as_tensor(rng.standard_normal((24, m)))
        x288 = torch.as_tensor(rng.standard_normal((288, m)))
        for plan, x, comps in ((res_plan, x24, tuple(range(6))), (jac_plan, x288, JAC_COMPS),
                               (jac_plan, x288, (16, 17))):
            ref = seg_reduce_plain(plan, x, comps, m)
            assert rel(two_pass(plan, x, comps, m), ref) < 1e-13


@pytest.mark.parametrize("c", [1, 2, 6, 8, 16])
@pytest.mark.parametrize("lists", ["seeded", "mesh"])
def test_two_passes_match_the_jax_lowerings(meshes, lists, c):
    """Plain (C, M) sources, on seeded lists and on the RCM mesh's node
    reduce lists (target ien[e, a], source a*ne + e): K8's widths against
    stream_reduce_xla, every width against ring_reduce_xla."""
    if lists == "seeded":
        num_tgt, num_src = 300, 500
        tgt, src = _lists(c, num_tgt, 1500, num_src)
    else:
        rcm = meshes[3]
        num_tgt, num_src = rcm.num_node, 4 * rcm.num_tet
        tgt, src = np.asarray(rcm.ien, dtype=np.int64).T.reshape(-1), np.arange(num_src)
    x = np.random.default_rng(c + 1).standard_normal((c, num_src))
    plan = build_reduce_plan(tgt, src, num_tgt, device="cpu")
    got = two_pass(plan, torch.as_tensor(x), tuple(range(c)), num_src)
    assert rel(got, seg_reduce_plain(plan, torch.as_tensor(x), tuple(range(c)), num_src)) < 1e-13
    refs = [wr.ring_reduce_xla(wr.build_ring_plan(tgt, src, num_tgt, num_src), jnp.asarray(x))]
    if c <= 8:
        refs.append(ws.stream_reduce_xla(ws.build_stream_plan(tgt, src, num_tgt, num_src),
                                         jnp.asarray(x)))
    for ref in refs:
        assert rel(got, np.asarray(ref)) < 1e-13


@pytest.mark.parametrize("c", [1, 2, 6, 8, 16])
@pytest.mark.parametrize("case", ["empty_targets", "no_contributions"])
def test_two_passes_on_edge_cases(c, case):
    """Targets without contributions sum to zero; a plan without
    contributions gives zeros. The CPU wrappers run the plain version."""
    num_tgt, num_src = 40, 60
    k = 0 if case == "no_contributions" else 25
    tgt, src = _lists(7 * c, num_tgt, k, num_src)
    plan = build_reduce_plan(tgt, src, num_tgt, device="cpu")
    x = torch.as_tensor(np.random.default_rng(c).standard_normal((c + 2) * num_src))
    comps = tuple(range(2, c + 2))  # offset rows of a flat source
    got = two_pass(plan, x, comps, num_src)
    ref = seg_reduce_plain(plan, x, comps, num_src)
    assert got.shape == ref.shape == (c, num_tgt)
    empty = torch.diff(plan.ptr.long()) == 0
    assert bool(empty.any())
    assert torch.equal(got[:, empty], torch.zeros((c, int(empty.sum())), dtype=x.dtype))
    if k:
        assert rel(got, ref) < 1e-13
    else:
        assert torch.equal(ref, got)
    wrappers = [ring_reduce] + ([stream_reduce] if c <= 8 else [])
    for wrapper in wrappers:
        before = wrapper.launches
        assert torch.equal(wrapper(plan, x, comps, num_src), ref)
        assert wrapper.launches == before  # the CPU runs the plain version


def test_stage_width_rounds_rows_up_to_a_sector():
    assert [stage_width(c) for c in (1, 2, 6, 8, 9, 16)] == [8, 8, 8, 8, 16, 16]
