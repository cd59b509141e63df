"""dedflow_tpu_torch scalar heat / Poisson slice == the JAX package's M1
slice (fem/heat.py, sparse/bsr.py, solver/krylov.py::cg, fem/dirichlet.py,
solver/pc.py), float64 on the CPU.

- Element residuals and Jacobians, assemble_heat and assemble_poisson
  (dense through bsr_to_dense) against JAX at 1e-12 on box 4 x 3 x 3; the
  scatters (K8 / K9 one-row plans, plain twins here) against a naive dense
  sum, with up to 8 (K8) and 16 (K9) trailing components too.
- The scalar plans' sources are the flat (e, slot) indices, equal to the
  JAX context's node_perm / mat_perm, their targets node_targets /
  mat_targets; a one-component scatter reads the element array where it
  lies (no copy).
- The one-row kernel of csrc/seg_reduce.cu (`gather_sum_kernel`, which
  runs only on the card) emulated in float32 with its block and tile
  constants read from the source, and with a small block and tile: every
  target in one block, every contribution in one round, and the sums
  equal to a one-by-one plan-order sum bit for bit, on a Delaunay plan
  (a high-degree node, targets without contributions, a target count that
  is no multiple of the block) and on plans without contributions.
- apply_vec / apply_mat and the Jacobi / block-Jacobi preconditioners
  against JAX.
- cg's iterates against JAX's at 1e-10 with equal iteration counts (after
  a few iterations, a block boundary, and to convergence).
- Float32 GMRES(120) + Jacobi on the manufactured Poisson problem at box
  15 (chip_smoke.py phase 22's): the port stops where the JAX package does,
  with the same iteration count and neither reaching rtol 1e-6 in the true
  residual (the float32 attainable-accuracy floor: after the first cycle
  every restart cycle takes one iteration whose estimate passes the
  tolerance while the true residual stays near 1.5e-6).
- The port alone, as the JAX package's tests/test_heat.py: the unit-tet
  golden values, J as the exact derivative, the linear-exact Poisson solve
  with CG and GMRES, and the manufactured solution's O(h^2) convergence
  on boxes 4 and 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu.fem import assembly as jasm
from dedflow_tpu.fem import dirichlet as jdbc
from dedflow_tpu.fem import heat as jheat
from dedflow_tpu.mesh.gen import box_mesh as jbox_mesh
from dedflow_tpu.solver import krylov as jkry
from dedflow_tpu.solver import pc as jpc
from dedflow_tpu.sparse.bsr import bsr_to_dense as jdense
from dedflow_tpu_torch.fem import assembly as tasm
from dedflow_tpu_torch.fem import heat as theat
from dedflow_tpu_torch.fem.dirichlet import StrongBC, apply_mat, apply_vec, build_mask
from dedflow_tpu_torch.mesh.gen import box_mesh, single_tet_mesh
from dedflow_tpu_torch.solver import krylov as tkry
from dedflow_tpu_torch.solver import pc as tpc
from dedflow_tpu_torch.sparse.bsr import bsr_to_dense, bsr_zeros
from dedflow_tpu_torch.sparse.topology import build_sparsity

# generalized-alpha constants of the reference (main.c:23-27)
RHOC = 0.5
ALPHA_M = (3.0 - RHOC) / (1.0 + RHOC)
ALPHA_F = 1.0 / (1.0 + RHOC)
GAMMA = 0.5 + ALPHA_M - ALPHA_F
DT = 5e-2
C1 = DT * ALPHA_F * GAMMA
BOX = (4, 3, 3)
ALL_FACES = [StrongBC(i, (0,)) for i in range(6)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ctx(mesh):
    return tasm.build_context(mesh, device="cpu", dtype=torch.float64, scalar_plans=True)


@pytest.fixture(scope="module")
def pair():
    """(port mesh, port context, JAX context) of BOX and seeded nodal fields."""
    mesh = box_mesh(*BOX)
    rng = np.random.default_rng(0)
    fields = rng.standard_normal((3, mesh.num_node))
    return mesh, _ctx(mesh), jasm.build_context(jbox_mesh(*BOX)), fields


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------------------------------
# assembly against JAX


def test_heat_element_residual_matches_jax(pair):
    mesh, ctx, jctx, (t, dt, _) = pair
    got = theat.heat_element_residual(ctx, _t(t), _t(dt), rho_cp=1.3, kappa=0.7)
    ref = jheat.heat_element_residual(jctx, jnp.asarray(t), jnp.asarray(dt), 1.3, 0.7)
    assert got.shape == (mesh.num_tet, 4)
    assert rel(got.numpy(), ref) < 1e-12


def test_heat_element_jacobian_matches_jax(pair):
    mesh, ctx, jctx, _ = pair
    got = theat.heat_element_jacobian(ctx, ALPHA_M, C1, rho_cp=1.3, kappa=0.7)
    ref = jheat.heat_element_jacobian(jctx, ALPHA_M, C1, 1.3, 0.7)
    assert got.shape == (mesh.num_tet, 4, 4)
    assert rel(got.numpy(), ref) < 1e-12


def test_assemble_heat_matches_jax(pair):
    _, ctx, jctx, (t, dt, _) = pair
    f, jmat = theat.assemble_heat(ctx, _t(t), _t(dt), ALPHA_M, C1)
    rf, rj = jheat.assemble_heat(jctx, jnp.asarray(t), jnp.asarray(dt), ALPHA_M, C1)
    assert rel(f.numpy(), rf) < 1e-12
    assert rel(bsr_to_dense(jmat), jdense(rj)) < 1e-12


def test_assemble_poisson_matches_jax(pair):
    _, ctx, jctx, (_, _, src) = pair
    k, b = theat.assemble_poisson(ctx, _t(src), kappa=2.0)
    rk, rb = jheat.assemble_poisson(jctx, jnp.asarray(src), 2.0)
    assert rel(bsr_to_dense(k), jdense(rk)) < 1e-12
    assert rel(b.numpy(), rb) < 1e-12


@pytest.mark.parametrize(
    "trail,bt",
    [((), (1, 1)), ((3,), (1, 1)), ((2, 2), (2, 2)), ((8,), (2, 4)), ((2, 4), (4, 4))],
    ids=["scalar", "3-vector", "2x2", "8", "16"])
def test_scatters_match_a_dense_sum(trail, bt):
    """K8 / K9's one-row plans (and C trailing components, one output row
    each: up to K8's 8 and K9's 16) against the naive sums; bsr_zeros has
    the same pattern."""
    mesh = box_mesh(2, 1, 2)
    ctx = _ctx(mesh)
    rng = np.random.default_rng(1)
    ef = rng.standard_normal((mesh.num_tet, 4) + trail)
    f = tasm.scatter_residual(ctx, _t(ef)).numpy()
    f_ref = np.zeros((mesh.num_node,) + trail)
    np.add.at(f_ref, mesh.ien, ef)
    assert np.abs(f - f_ref).max() < 1e-13
    ej = rng.standard_normal((mesh.num_tet, 4, 4) + bt)
    dense = bsr_to_dense(tasm.bsr_from_data(ctx, tasm.scatter_matrix(ctx, _t(ej))))
    n = mesh.num_node
    ref = np.zeros((n, bt[0], n, bt[1]))
    for e in range(mesh.num_tet):
        for a in range(4):
            for b in range(4):
                ref[mesh.ien[e, a], :, mesh.ien[e, b], :] += ej[e, a, b]
    assert np.abs(dense - ref.reshape(n * bt[0], n * bt[1])).max() < 1e-13
    zeros = bsr_zeros(build_sparsity(mesh.ien, n), *bt, device="cpu")
    np.testing.assert_array_equal(zeros.col_ind.numpy(), ctx.win_plan.col_t.numpy())
    np.testing.assert_array_equal(zeros.row_ids.numpy(), ctx.win_plan.grow_t.numpy())


def _targets(plan) -> np.ndarray:
    return np.repeat(np.arange(plan.num_tgt), np.diff(plan.ptr.numpy()))


def test_scalar_plans_are_the_jax_permutations(pair):
    """Sources = the flat (e, slot) indices in the JAX context's sorted
    order (node_perm / mat_perm), targets node_targets / mat_targets."""
    _, ctx, jctx, _ = pair
    for plan, perm, tgt in ((ctx.scalar_res_plan, jctx.node_perm, jctx.node_targets),
                            (ctx.scalar_jac_plan, jctx.mat_perm, jctx.mat_targets)):
        np.testing.assert_array_equal(plan.src.numpy(), np.asarray(perm))
        np.testing.assert_array_equal(_targets(plan), np.asarray(tgt))


def test_one_component_scatters_read_the_elements_where_they_lie(pair, monkeypatch):
    """scatter_residual / scatter_matrix hand K8 / K9 a (1, slots*ne) view
    of the element array itself: no transposing copy."""
    mesh, ctx, _, _ = pair
    seen = {}

    def spy(name, fn):
        def call(plan, x, *a, **k):
            seen[name] = x
            return fn(plan, x, *a, **k)
        return call

    monkeypatch.setattr(tasm, "stream_reduce", spy("res", tasm.stream_reduce))
    monkeypatch.setattr(tasm, "ring_reduce", spy("jac", tasm.ring_reduce))
    ef = torch.randn((mesh.num_tet, 4), dtype=torch.float64)
    ej = torch.randn((mesh.num_tet, 4, 4, 1, 1), dtype=torch.float64)
    tasm.scatter_residual(ctx, ef)
    tasm.scatter_matrix(ctx, ej)
    for name, elem in (("res", ef), ("jac", ej)):
        assert seen[name].shape == (1, elem.numel()) and seen[name].is_contiguous()
        assert seen[name].data_ptr() == elem.data_ptr()


def _kernel_constants() -> tuple[int, int]:
    """(targets a block, contributions a round) of csrc/seg_reduce.cu's
    one-row kernel, read from the source."""
    import re
    from pathlib import Path

    src = (Path(tasm.__file__).resolve().parents[1] / "csrc" / "seg_reduce.cu").read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    return get("kGatherThreads"), get("kGatherTile")


def _gather_sum_emulated(plan, x: np.ndarray, threads: int, tile: int) -> np.ndarray:
    """gather_sum_kernel in float32: block b owns targets [b*threads,
    (b+1)*threads); in rounds of at most `tile` contributions of its plan
    range it gathers x[src[k]] into the tile, then each target adds the
    part of its slice the round holds, k ascending, its sum carried over
    rounds. Checks that each target is in one block and each contribution
    in one round."""
    ptr, src = plan.ptr.numpy().astype(np.int64), plan.src.numpy()
    y = np.zeros(plan.num_tgt, np.float32)
    owner = np.zeros(plan.num_tgt, np.int64)
    visits = np.zeros(src.size, np.int64)
    for t0 in range(0, plan.num_tgt, threads):
        t1 = min(t0 + threads, plan.num_tgt)
        owner[t0:t1] += 1
        acc = [np.float32(0.0)] * (t1 - t0)
        for c0 in range(ptr[t0], ptr[t1], tile):
            n = min(tile, ptr[t1] - c0)
            shared = x[src[c0:c0 + n]]
            visits[c0:c0 + n] += 1
            for j, t in enumerate(range(t0, t1)):
                for k in range(max(ptr[t], c0), min(ptr[t + 1], c0 + n)):
                    acc[j] = np.float32(acc[j] + shared[k - c0])
        y[t0:t1] = acc
    assert (owner == 1).all() and (visits == 1).all()
    return y


def _one_by_one(plan, x: np.ndarray) -> np.ndarray:
    """Each target's contributions added one at a time in plan order,
    float32, from 0."""
    ptr, src = plan.ptr.numpy(), plan.src.numpy()
    y = np.zeros(plan.num_tgt, np.float32)
    for t in range(plan.num_tgt):
        acc = np.float32(0.0)
        for k in range(ptr[t], ptr[t + 1]):
            acc = np.float32(acc + x[src[k]])
        y[t] = acc
    return y


@pytest.mark.parametrize("tiling", ["kernel", "small"])
def test_one_row_kernel_sums_in_plan_order(tiling):
    """The one-row kernel's summation, emulated with its own block and tile
    (and with 16 targets a block, 32 contributions a round: slices and
    blocks longer than the tile), equals the one-by-one plan-order sum bit
    for bit on Delaunay plans."""
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh
    from dedflow_tpu_torch.sparse.win_stream import build_reduce_plan

    threads, tile = _kernel_constants() if tiling == "kernel" else (16, 32)
    mesh = delaunay_mesh(600, seed=1)
    ctx = _ctx(mesh)
    n = mesh.num_node
    assert n % threads
    flat = mesh.ien.reshape(-1).astype(np.int64)
    keep = np.nonzero(flat % 9 != 4)[0]  # every ninth node gets no contribution
    plans = [ctx.scalar_res_plan, ctx.scalar_jac_plan,
             build_reduce_plan(flat[keep], keep, n, device="cpu"),
             build_reduce_plan([], [], n, device="cpu")]
    counts = np.diff(plans[0].ptr.numpy())
    assert counts.max() >= 2 * counts.mean()  # a high-degree node
    assert (np.diff(plans[2].ptr.numpy()) == 0).sum() >= n // 9
    if tiling == "small":
        assert counts.max() > tile
    rng = np.random.default_rng(7)
    for plan in plans:
        x = rng.standard_normal(max(plan.src_max + 1, 1)).astype(np.float32)
        got = _gather_sum_emulated(plan, x, threads, tile)
        assert np.array_equal(got, _one_by_one(plan, x))


def test_scalar_scatters_need_the_scalar_plans():
    ctx = tasm.build_context(box_mesh(1, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="scalar_plans=True"):
        tasm.scatter_residual(ctx, torch.zeros((ctx.num_elem, 4), dtype=torch.float64))


def _poisson(mesh, ctx, src, bcs=ALL_FACES):
    """(K, b, mask) of -lap(u) = src with u = 0 on the faces of `bcs` (all
    six by default), the constrained rows applied."""
    k, b = theat.assemble_poisson(ctx, _t(src))
    mask = torch.as_tensor(build_mask(mesh, bcs, 1))
    return apply_mat(mask, k), apply_vec(mask[:, 0], b), mask


def test_dirichlet_and_jacobi_match_jax(pair):
    mesh, ctx, jctx, (_, _, src) = pair
    k, b, mask = _poisson(mesh, ctx, src)
    rk, rb = jheat.assemble_poisson(jctx, jnp.asarray(src))
    jmask = jnp.asarray(mask.numpy())
    rk, rb = jdbc.apply_mat(jmask, rk), jdbc.apply_vec(jmask[:, 0], rb)
    assert rel(bsr_to_dense(k), jdense(rk)) < 1e-12
    assert rel(b.numpy(), rb) < 1e-12
    got = tpc.JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])(b)
    ref = jpc.JacobiPC.from_diag(rk.diag_blocks()[:, 0, 0])(rb)
    assert rel(got.numpy(), ref) < 1e-12
    assert torch.equal(tpc.identity_pc(b), b)


@pytest.mark.parametrize("bs", [3, 2])
def test_block_jacobi_matches_jax(bs):
    rng = np.random.default_rng(bs)
    blocks = rng.standard_normal((7, bs, bs)) + 4 * np.eye(bs)
    x = rng.standard_normal((7, bs))
    got = tpc.BlockJacobiPC.from_blocks(_t(blocks))(_t(x))
    ref = jpc.BlockJacobiPC.from_blocks(jnp.asarray(blocks))(jnp.asarray(x))
    assert rel(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("maxit", [3, 8, 9, 400], ids=["3", "block", "block+1", "converged"])
def test_cg_iterates_match_jax(pair, maxit):
    """The same iterates (x) and iteration count as the JAX loop, whether
    maxit ends inside, at or past a block of host syncs (u = 0 on one face
    only: 64 unknowns, more iterations than a block)."""
    mesh, ctx, jctx, (_, _, src) = pair
    k, b, mask = _poisson(mesh, ctx, src, bcs=ALL_FACES[:1])
    rk, rb = jheat.assemble_poisson(jctx, jnp.asarray(src))
    jmask = jnp.asarray(mask.numpy())
    rk, rb = jdbc.apply_mat(jmask, rk), jdbc.apply_vec(jmask[:, 0], rb)
    tp = tpc.JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])
    jp = jpc.JacobiPC.from_diag(rk.diag_blocks()[:, 0, 0])
    got = tkry.cg(lambda v: k.matvec(v[:, None])[:, 0], b, maxit=maxit, atol=1e-14,
                  rtol=1e-10, pc=tp)
    ref = jkry.cg(lambda v: rk.matvec(v[:, None])[:, 0], rb, maxit=maxit, atol=1e-14,
                  rtol=1e-10, pc=jp)
    assert got.iters == int(ref.iters)
    assert got.converged == bool(ref.converged) == (maxit == 400)
    assert rel(got.x.numpy(), ref.x) < 1e-10
    # the recursive residual norm, on the scale of the initial one
    assert abs(float(got.resnorm) - float(ref.resnorm)) < 1e-10 * float(ref.resnorm0)


# ---------------------------------------------------------------------------
# the port alone (tests/test_heat.py's checks)


def test_single_tet_heat_golden():
    """The reference's unit tet (mesh.gen.single_tet_mesh)."""
    ctx = _ctx(single_tet_mesh())
    f = theat.heat_element_residual(ctx, _t([0.0, 1.0, 0.0, 0.0]), torch.ones(4,
                                    dtype=torch.float64))[0].numpy()
    expect = np.full(4, 1.0 / 24.0) + (1.0 / 6.0) * np.array([-1.0, 1.0, 0.0, 0.0])
    assert np.allclose(f, expect, atol=1e-14)
    ej = theat.heat_element_jacobian(ctx, ALPHA_M, C1)[0].numpy()
    mass = (1.0 / 6.0) / 20.0 * (np.ones((4, 4)) + np.eye(4))
    grads = np.array([[-1, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    assert np.allclose(ej, ALPHA_M * mass + C1 * (1.0 / 6.0) * grads @ grads.T, atol=1e-13)


def test_heat_jacobian_is_exact_derivative():
    mesh = box_mesh(2, 2, 2)
    ctx = _ctx(mesh)
    rng = np.random.default_rng(0)
    t0, dt0, delta = (_t(rng.standard_normal(mesh.num_node)) for _ in range(3))
    f0, jmat = theat.assemble_heat(ctx, t0, dt0, ALPHA_M, C1)
    f1, _ = theat.assemble_heat(ctx, t0 + C1 * delta, dt0 + ALPHA_M * delta, ALPHA_M, C1)
    jd = jmat.matvec(delta[:, None])[:, 0]
    assert torch.allclose(f1 - f0, jd, atol=1e-11)


@pytest.mark.parametrize("solver", ["cg", "gmres"])
def test_poisson_linear_exact(solver):
    """-lap(u) = 0 with u = 1 + 2x - y + 3z on all faces: P1 reproduces it."""
    mesh = box_mesh(3, 3, 3)
    ctx = _ctx(mesh)
    u_exact = _t(1.0 + 2.0 * mesh.xg[:, 0] - mesh.xg[:, 1] + 3.0 * mesh.xg[:, 2])
    k0, b = theat.assemble_poisson(ctx, torch.zeros(mesh.num_node, dtype=torch.float64))
    mask = torch.as_tensor(build_mask(mesh, ALL_FACES, 1))
    x_bc = torch.where(mask[:, 0], u_exact, 0.0)
    b2 = apply_vec(mask[:, 0], b - k0.matvec(x_bc[:, None])[:, 0])
    k = apply_mat(mask, k0)
    pc = tpc.JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])
    mv = lambda v: k.matvec(v[:, None])[:, 0]
    out = (tkry.cg(mv, b2, maxit=400, atol=1e-12, rtol=1e-12, pc=pc) if solver == "cg"
           else tkry.gmres(mv, b2, maxit=120, atol=1e-12, rtol=1e-12, pc=pc))
    assert out.converged
    assert torch.allclose(x_bc + out.x, u_exact, atol=1e-8)


def test_poisson_manufactured_convergence():
    """-lap(u) = 3 pi^2 sin(pi x) sin(pi y) sin(pi z): halving h must cut the
    L2 error by more than 2.5x (P1 is O(h^2))."""
    errs = []
    for nx in (4, 8):
        mesh = box_mesh(nx, nx, nx)
        x, y, z = mesh.xg.T
        u_exact = np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)
        k, b, _ = _poisson(mesh, _ctx(mesh), 3.0 * np.pi**2 * u_exact)
        pc = tpc.JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])
        out = tkry.cg(lambda v: k.matvec(v[:, None])[:, 0], b, maxit=500, atol=1e-13,
                      rtol=1e-11, pc=pc)
        assert out.converged
        errs.append(float(np.sqrt(np.mean((out.x.numpy() - u_exact) ** 2))))
    assert errs[1] < errs[0] / 2.5, errs


def test_float32_gmres_on_poisson_stops_where_jax_does():
    """GMRES(120) + Jacobi, float32, rtol 1e-6, maxit 4800, on -lap(u) =
    3 pi^2 sin(pi x) sin(pi y) sin(pi z) at box 15 (20,250 tets) in both
    packages: equal iteration counts, neither converged, both true relative
    residuals between 1e-6 and 2e-6 (ROADMAP's float32 GMRES item)."""
    n = 15
    mesh = box_mesh(n, n, n)
    x, y, z = mesh.xg.T
    src = 3.0 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)
    ctx = tasm.build_context(mesh, device="cpu", dtype=torch.float32, scalar_plans=True)
    k, b = theat.assemble_poisson(ctx, torch.as_tensor(src, dtype=torch.float32))
    mask = torch.as_tensor(build_mask(mesh, ALL_FACES, 1))
    k, b = apply_mat(mask, k), apply_vec(mask[:, 0], b)
    mv = lambda v: k.matvec(v[:, None])[:, 0]
    got = tkry.gmres(mv, b, maxit=4800, atol=0.0, rtol=1e-6, restart=120,
                     pc=tpc.JacobiPC.from_diag(k.diag_blocks()[:, 0, 0]))
    got_rel = float(torch.linalg.vector_norm(b - mv(got.x)) / torch.linalg.vector_norm(b))
    jctx = jasm.build_context(jbox_mesh(n, n, n), dtype=jnp.float32)
    jk, jb = jheat.assemble_poisson(jctx, jnp.asarray(src, jnp.float32))
    jmask = jnp.asarray(mask.numpy())
    jk, jb = jdbc.apply_mat(jmask, jk), jdbc.apply_vec(jmask[:, 0], jb)
    jmv = lambda v: jk.matvec(v[:, None])[:, 0]
    ref = jkry.gmres(jmv, jb, maxit=4800, atol=0.0, rtol=1e-6, restart=120,
                     pc=jpc.JacobiPC.from_diag(jk.diag_blocks()[:, 0, 0]))
    ref_rel = float(jnp.linalg.norm(jb - jmv(ref.x)) / jnp.linalg.norm(jb))
    assert got.iters == int(ref.iters)
    assert not got.converged and not bool(ref.converged)
    assert 1e-6 < got_rel < 2e-6 and 1e-6 < ref_rel < 2e-6
