"""dedflow_tpu_torch on meshes with prism / hex tables (ROADMAP A13) ==
the JAX package, float64 on the CPU.

The mixed cells add stencil entries only (their node pairs enter the
matrix pattern; the tets are assembled), as in the reference
(csr.c:107-130). Meshes: mesh.gen.mixed_box_mesh, a box with prisms on its
lowest cell layer ("prism"), a hex over every cube ("hex"), both
("both"), and a box whose prism table repeats nodes of its Kuhn tets, so
every pair lies inside the lattice stencil ("inside").

- The sparsity (row_ptr, col_ind, the row of each entry, diag_idx and the
  tets' elem_nnz) equal to the JAX package's build_sparsity array for
  array; the tets' elem_nnz still address their own node pairs.
- The tier (`fastpath`) equal to the JAX NSSolver's on each mesh and
  use_lattice mode ("inside" keeps the lattice; the others leave it for
  WinELL on "auto" and the gather tier on "off", and "on" raises in both).
- On box 4 x 3 x 3 with a hex table and prisms, against one JAX NSSolver
  on the gather tier (float64, its jitted Newton iteration): the port's
  WinELL ("auto") and gather solvers' residual and dense Jacobian with
  facets and mask at 1e-12, the extra entries exact zeros, and one Newton
  iteration's new state at 1e-9 with an equal Krylov count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app import scenarios as jsc
from dedflow_tpu.mesh.mesh import Boundary, Mesh
from dedflow_tpu.solver import newton as jnt
from dedflow_tpu.sparse.topology import build_sparsity as jbuild_sparsity
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.mesh.gen import mixed_box_mesh
from dedflow_tpu_torch.solver import newton as tnt
from dedflow_tpu_torch.sparse.topology import build_sparsity


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


def _jax_mesh(m) -> Mesh:
    """The JAX package's copy of a port mesh (the same arrays)."""
    return Mesh(xg=m.xg.copy(), ien=m.ien.copy(),
                boundaries=[Boundary(b.nodes.copy(), b.ien.copy(), b.f2e.copy(), b.forn.copy())
                            for b in m.boundaries],
                lattice=m.lattice, ien_prism=m.ien_prism, ien_hex=m.ien_hex)


def _inside(n):
    """Prisms whose nodes are those of every third Kuhn tet, two repeated:
    every pair lies inside the lattice's 15-point stencil."""
    m = mixed_box_mesh(n, n, n, hexes=False)
    return dataclasses.replace(m, ien_prism=m.ien[::3][:, [0, 1, 2, 3, 0, 1]])


MESHES = {
    "prism": lambda n: mixed_box_mesh(n, n, n, hexes=False, prism_layers=1),
    "hex": lambda n: mixed_box_mesh(n, n, n),
    "both": lambda n: mixed_box_mesh(n, n, n, prism_layers=1),
    "inside": _inside,
}


@pytest.mark.parametrize("name", list(MESHES))
def test_mixed_sparsity_matches_jax(name):
    m = MESHES[name](3)
    assert m.extra_cells
    ref = jbuild_sparsity(m.ien, m.num_node, native=False, extra_ien=m.extra_cells)
    got = build_sparsity(m.ien, m.num_node, extra_ien=m.extra_cells)
    for field in ("row_ptr", "col_ind", "diag_idx", "elem_nnz"):
        assert np.array_equal(getattr(got, field), getattr(ref, field)), field
    rows = np.repeat(np.arange(m.num_node), np.diff(got.row_ptr))
    assert np.array_equal(rows, ref.row_ids)
    # the tets' scatter map: entry (e, a, b) couples ien[e, a] to ien[e, b]
    assert got.elem_nnz.shape == (m.num_tet, 4, 4)
    assert np.array_equal(rows[got.elem_nnz], np.repeat(m.ien[:, :, None], 4, 2))
    assert np.array_equal(got.col_ind[got.elem_nnz], np.repeat(m.ien[:, None, :], 4, 1))
    tets = build_sparsity(m.ien, m.num_node)
    assert (got.nnz > tets.nnz) == (name != "inside")


TIER_CASES = [(name, mode) for name in MESHES for mode in ("auto", "off", "on")]


@pytest.mark.parametrize("name,mode", TIER_CASES, ids=[f"{n}-{m}" for n, m in TIER_CASES])
def test_fastpath_matches_jax(name, mode):
    m = MESHES[name](4)
    cfg = jsc.reference_scenario_config(use_lattice=mode)
    try:
        ref = jnt.NSSolver(_jax_mesh(m), cfg).fastpath
    except ValueError:
        with pytest.raises(ValueError, match="does not match"):
            tnt.NSSolver(m, _tcfg(cfg), device="cpu")
        assert mode == "on" and name != "inside"
        return
    got = tnt.NSSolver(m, _tcfg(cfg), device="cpu").fastpath
    assert got == ref
    if name == "inside" and mode != "off":
        assert got == "lattice"
    else:  # no classes tier for mixed meshes; "off" ignores the lattice metadata
        assert got == ("winell" if mode == "auto" else "gather")


# ---------------------------------------------------------------------------
# one Newton iteration on a mixed box

BOX = (4, 3, 3)


@pytest.fixture(scope="module")
def solvers():
    """The mixed box (hexes, a prism layer) with the reference scenario:
    one JAX NSSolver on the gather tier, the port's on "auto" (WinELL) and
    on "gather", all float64; a perturbed state."""
    mesh = mixed_box_mesh(*BOX, prism_layers=1)
    cfg = jsc.reference_scenario_config()
    js = jnt.NSSolver(_jax_mesh(mesh), dataclasses.replace(cfg, use_lattice="gather"))
    ts = {tier: tnt.NSSolver(mesh, _tcfg(dataclasses.replace(cfg, use_lattice=mode)),
                             device="cpu")
          for tier, mode in (("winell", "auto"), ("gather", "gather"))}
    assert js.fastpath == "gather" and {t: s.fastpath for t, s in ts.items()} == {
        "winell": "winell", "gather": "gather"}
    wg, dwgold, dwg = jsc.reference_initial_state(_jax_mesh(mesh))
    dwg = dwg + 0.1 * np.random.default_rng(3).standard_normal(dwg.shape)
    return mesh, js, ts, (wg, dwgold, dwg)


@pytest.mark.parametrize("tier", ["winell", "gather"])
def test_mixed_assembly_matches_jax(solvers, tier):
    """F and the dense J (facets, mask) at 1e-12; J's pattern holds the
    mixed cells' entries, and they are exact zeros."""
    mesh, js, ts, _ = solvers
    ts = ts[tier]
    states = [np.random.default_rng(4 + k).normal(size=(mesh.num_node, 6)) for k in range(3)]
    jst, tst = [jnp.asarray(s) for s in states], [torch.as_tensor(s) for s in states]
    jkw = dict(phys=js.cfg.physics, scheme=js.cfg.time)
    tkw = dict(phys=ts.cfg.physics, scheme=ts.cfg.time)
    f_ref = jnt.residual(js.solve_ctx, js.face_ctxs, js.mask, *jst, **jkw,
                         freeze=js.cfg.freeze_phi_temperature)
    f = tnt.residual(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tkw,
                     freeze=ts.cfg.freeze_phi_temperature)
    assert rel(f.numpy(), np.asarray(f_ref).T) < 1e-12
    j_ref, _ = jnt.assemble_system(js.solve_ctx, js.face_ctxs, js.mask, *jst, **jkw)
    jmat, _ = tnt.assemble_system(ts.solve_ctx, ts.face_ctxs, ts.mask_t, *tst, **tkw)
    dense = jmat.to_block_dense()
    assert rel(dense, j_ref.to_block_dense()) < 1e-12
    plan = jmat.plan
    assert plan.S == js.sparsity.nnz and int(np.diff(plan.row_ptr).max()) == 27
    tet_pairs = build_sparsity(mesh.ien, mesh.num_node)
    tet_keys = np.repeat(np.arange(mesh.num_node), np.diff(tet_pairs.row_ptr)) * mesh.num_node \
        + tet_pairs.col_ind
    extra = ~np.isin(plan.grow * mesh.num_node + plan.col, tet_keys)
    assert extra.any() and not bool(jmat.vals[:, torch.as_tensor(extra)].any())


@pytest.mark.parametrize("tier", ["winell", "gather"])
def test_mixed_newton_iteration_matches_jax(solvers, tier):
    """One Newton iteration from the predicted state (the JAX solver's
    jitted pieces): the new dwg at 1e-9, the residual at 1e-9 of its
    scale, equal Krylov counts."""
    _, js, ts, state = solvers
    ts = ts[tier]
    wg, dwo, dwg = (jnp.asarray(a) for a in state)
    c = (js.solve_ctx, js.face_ctxs, js.mask)
    d = js._predict(dwg)
    f = js._residual(*c, wg, dwo, d)
    d_ref, f_ref, _, kit_ref, _ = js._newton_iter(*c, wg, dwo, d, f)
    twg, tdwo, tdwg = interop.state_from_numpy(*state, device="cpu")
    cfg = ts.cfg
    tc = (ts.solve_ctx, ts.face_ctxs, ts.mask_t)
    td = tnt.predict(tdwg, cfg.time)
    tf = tnt.residual(*tc, twg, tdwo, td, cfg.physics, cfg.time, cfg.freeze_phi_temperature)
    d_got, f_got, _, kit, _ = tnt.newton_iter(*tc, twg, tdwo, td, tf, cfg.physics, cfg.time,
                                             cfg.krylov, cfg.freeze_phi_temperature)
    assert rel(d_got.numpy(), d_ref) < 1e-9
    assert rel(f_got.numpy(), np.asarray(f_ref).T) < 1e-9
    assert int(kit) == int(kit_ref)
