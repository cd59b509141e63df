"""The decompositions of the redesigned kernels K11 (csrc/dem_contact.cu)
and K2 (csrc/lattice_jacobian.cu) on the CPU.

The kernels run only on the card. What the CPU can check is the order and
the partition of the work they do, emulated in torch from the tables the
kernels use, against the plain versions:

- K11, the warp-cooperative sweep: each live centre slot's 27 x K
  candidates in groups of 32 lanes (candidate e = offset * K + kp), the
  touching pairs' terms added in lane order, normal then tangential,
  empty candidates skipped. In float32 it equals `grid_pair_forces` bit
  for bit: on seeded clouds with 2-3 particles in many cells, on a grid
  two cells deep in z (every row end's +-1 read wraps to the next row,
  at a distance that touches), with and without the tangential term, and
  with a gap in a cell's slots (slot 0 empty, slot 1 live).
- K2, the fused pass: (x, y) node tiles with a one-cell halo on the low
  side, sliding up z chunks a cell layer at a time, rounds of slabs
  (FUSED_ROUND_SLABS), each entry (t, a, b) taken from cell (x - cx, y - cy,
  z - cz) into plane accumulators of node layer z (cz = 0) or z + 1
  (cz = 1), stored when a layer is complete, then the epilogue. The
  components of the groups (FUSED_GROUPS) are emulated together; the
  groups' partition is checked on its own. In float64 the result equals
  `jacobian_volume_plain` to 1e-12, frozen and implicit, with the facet
  band, masked without it and unmasked, on boxes the tile does not divide
  (3 x 4 x 5 and 7 x 5 x 6), with the kernel's tile and z chunk and with a
  small one (3 x 2 nodes, 2 layers) that makes many tiles and chunks. The
  tables cover each of the 96 (t, a, b) entries exactly once per node.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config, reference_scenario_config
from dedflow_tpu_torch.dem import grid as dem_grid
from dedflow_tpu_torch.dem.cells import make_grid
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.particles import particle_state
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.fem.element_kernels import lhs_args
from dedflow_tpu_torch.fem.element_rows import alpha_states, lhs_rows
from dedflow_tpu_torch.interop import state_from_numpy
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS, box_mesh
from dedflow_tpu_torch.solver.newton import NSSolver
from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tier-1 run shares the CPU's cores among its
    workers, and torch's own thread pool would oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


# ---------------------------------------------------------------------------
# K11


def cooperative_sweep(grid, gs, prm):
    """K11's sweep in torch: for every live centre slot at once, the
    candidates e = 0 .. 27K - 1 in groups of 32 (lane e % 32), the pair
    terms computed with the plain version's float32 ops, and the terms of
    the touching pairs added in candidate order, normal then tangential."""
    k, nc = gs.mask.shape
    offs = torch.tensor(dem_grid._offsets(grid))
    flat = lambda a: a.reshape(-1)
    pos, vel = [flat(a) for a in gs.pos], [flat(a) for a in gs.vel]
    rad, msk, pid = flat(gs.radius), flat(gs.mask), flat(gs.pid)
    ci = torch.nonzero(msk != 0).reshape(-1)  # the live lanes, served in turn
    c = ci % nc
    tangential = prm.mu > 0.0 and prm.gamma_t > 0.0
    f = [torch.zeros(ci.numel(), dtype=msk.dtype) for _ in range(3)]
    for base in range(0, 27 * k, 32):
        for lane in range(32):
            e = base + lane
            if e >= 27 * k:
                break
            cn = c + offs[e // k]
            inside = (cn >= 0) & (cn < nc)
            j = torch.where(inside, (e % k) * nc + cn, 0)
            mn = torch.where(inside, msk[j], 0.0)
            d = [pos[i][ci] - pos[i][j] for i in range(3)]
            dist = torch.sqrt(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=prm.eps))
            delta = rad[ci] + rad[j] - dist
            act = (mn != 0) & (pid[j] != pid[ci]) & (delta > 0.0)
            w_act = msk[ci] * mn
            vrel = [vel[i][ci] - vel[i][j] for i in range(3)]
            n = [d[i] / dist for i in range(3)]
            vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2]
            w = w_act * (prm.k_n * delta - prm.gamma_n * vn)
            for i in range(3):
                f[i] = torch.where(act, f[i] + w * n[i], f[i])
            if tangential:
                vt = [vrel[i] - vn * n[i] for i in range(3)]
                vt_norm = torch.sqrt(torch.clamp(vt[0] ** 2 + vt[1] ** 2 + vt[2] ** 2,
                                                 min=prm.eps))
                ft = w_act * torch.minimum(prm.mu * torch.abs(prm.k_n * delta - prm.gamma_n * vn),
                                           prm.gamma_t * vt_norm)
                for i in range(3):
                    f[i] = torch.where(act, f[i] - ft / vt_norm * vt[i], f[i])
    out = [torch.zeros(k * nc, dtype=msk.dtype) for _ in range(3)]
    for i in range(3):
        out[i][ci] = f[i]
    return [o.reshape(k, nc) for o in out]


def _cloud(case):
    """(grid, GridState) float32 on the CPU for a seeded cloud."""
    rng = np.random.default_rng({"dense": 1, "row_ends": 2, "gap": 3}[case])
    if case == "row_ends":
        # two cells deep in z and no ghost layer: the +-1 reads of every row
        # end wrap to the neighbouring row's far cell, which touches
        grid = make_grid([0, 0, 0], [0.5, 0.5, 0.1], cell_size=0.05, capacity=3, pad_cells=0)
        x = rng.uniform([0.0, 0.0, 0.0], [0.5, 0.5, 0.1], size=(150, 3))
        radius = 0.03
    else:
        grid = make_grid([0, 0, 0], [0.3, 0.3, 0.3], cell_size=0.06, capacity=4)
        x = rng.uniform(0.0, 0.3, size=(300, 3))
        radius = 0.025
    v = rng.normal(scale=0.05, size=x.shape)
    st = particle_state(x, v, radius=radius, device="cpu", dtype=torch.float32)
    gs = dem_grid.to_grid(grid, st, x.shape[0])
    if case == "gap":
        # slot 0 of the cells holding two or more particles emptied
        full = gs.mask[1] != 0
        mask = gs.mask.clone()
        mask[0, full] = 0.0
        gs = dataclasses.replace(gs, mask=mask)
    return grid, gs


@pytest.mark.parametrize("case", ["dense", "row_ends", "gap"])
@pytest.mark.parametrize("tangential", [False, True])
def test_k11_cooperative_sweep_bit_equal_to_plain(case, tangential):
    grid, gs = _cloud(case)
    occ = gs.mask.sum(0)
    assert int((occ >= 2).sum()) >= 5  # many cells with 2-3 particles
    if case == "gap":
        assert bool(((gs.mask[0] == 0) & (gs.mask[1] != 0)).any())
    prm = ContactParams(k_n=2e3, gamma_n=3.0, mu=0.3 if tangential else 0.0,
                        gamma_t=2.0 if tangential else 0.0)
    got = cooperative_sweep(grid, gs, prm)
    ref = dem_grid.grid_pair_forces(grid, gs, prm)
    for c in range(3):
        assert float(ref[c].abs().max()) > 0
        assert torch.equal(got[c], ref[c])


def test_k11_row_end_cloud_has_wrapped_contacts():
    """The row_ends cloud exercises the wrapped reads: some touching pairs
    are read through an offset whose flat neighbour index wraps across a
    row (its cell is not the centre's cell shifted by that offset)."""
    grid, gs = _cloud("row_ends")
    nx, ny, nz = grid.dims
    k, nc = gs.mask.shape
    pos = np.stack([a.reshape(-1).numpy() for a in gs.pos], axis=1).astype(np.float64)
    rad, msk = gs.radius.reshape(-1).numpy(), gs.mask.reshape(-1).numpy()
    coords = lambda c: np.array([c // (ny * nz), c // nz % ny, c % nz])
    wrapped = 0
    for i in np.nonzero(msk)[0]:
        c = i % nc
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cn = c + (dx * ny + dy) * nz + dz
                    if not 0 <= cn < nc or np.array_equal(coords(cn), coords(c) + (dx, dy, dz)):
                        continue
                    for kp in range(k):
                        j = kp * nc + cn
                        if msk[j] and np.linalg.norm(pos[i] - pos[j]) < rad[i] + rad[j]:
                            wrapped += 1
    assert wrapped > 0


# ---------------------------------------------------------------------------
# K2


def fused_entries() -> list:
    """The kernel's 96 (t, a, b) entries in its order, each as (t, a, b,
    corner a's (cx, cy, cz), plane index in FUSED_PLANE_CODES): node
    (x, y, z) takes entry (t, a, b) from cell (x - cx, y - cy, z - cz)."""
    out = []
    for t in range(len(_KUHN_TETS)):
        for a in range(4):
            ca = lat._corner(int(_KUHN_TETS[t][a]))
            for b in range(4):
                cb = lat._corner(int(_KUHN_TETS[t][b]))
                code = sum((cb[i] - ca[i] + 1) * (9, 3, 1)[i] for i in range(3))
                out.append((t, a, b, ca, lat.FUSED_PLANE_CODES.index(code)))
    return out


def fused_emulation(lctx, elem, keep, add, band=None, band_lo=0, tile=lat.FUSED_TILE,
                    zchunk=None):
    """K2's fused pass in torch on the element outputs `elem` (6, 16*nc, N)
    (what the kernel's body computes for each (slab, cell); all components
    at once): data (D, 16, N), and (data, scal) in the implicit mode."""
    nc = elem.shape[1] // 16
    implicit = nc == 18
    zchunk = zchunk or lat.FUSED_ZCHUNK[implicit]
    round_slabs = lat.FUSED_ROUND_SLABS[implicit]
    sy, ny, nz, planes = lctx.fused
    sz, n, nd = sy * ny, lctx.num_node, len(lctx.offsets)
    entries = fused_entries()
    tx, ty = tile
    acc = torch.full((nd, nc, n), float("nan"), dtype=elem.dtype)  # each value stored once
    stored = torch.zeros(n, dtype=torch.long)
    hx = torch.arange(tx + 1)[None, :]
    hy = torch.arange(ty + 1)[:, None]
    lx = torch.arange(tx)[None, :]
    ly = torch.arange(ty)[:, None]
    for z0 in range(0, nz, zchunk):
        for y0 in range(0, ny, ty):
            for x0 in range(0, sy, tx):
                cx, cy = x0 - 1 + hx, y0 - 1 + hy  # (ty+1, tx+1) halo cells
                x, y = x0 + lx, y0 + ly
                own = (x < sy) & (y < ny)
                cur = torch.zeros((15, nc, ty, tx), dtype=elem.dtype)
                nxt = torch.zeros_like(cur)
                for layer in range(z0 - 1, min(z0 + zchunk, nz)):
                    c = cx + sy * cy + sz * layer
                    valid = (cx < sy) & (cy < ny) & (c >= 0) & (c < n)
                    stage = torch.where(valid, elem[:, :, c.clamp(0, n - 1)], 0.0)
                    stage = stage.reshape(6, 16, nc, ty + 1, tx + 1)
                    for h in range(6 // round_slabs):  # the rounds of slabs
                        for t, a, b, (kx, ky, kz), p in entries:
                            if t // round_slabs != h:
                                continue
                            v = stage[t, a * 4 + b, :, 1 - ky : 1 - ky + ty, 1 - kx : 1 - kx + tx]
                            (nxt if kz else cur)[p] += v
                    if layer >= z0:
                        r = (x + sy * y + sz * layer)[own]
                        for p in range(15):
                            acc[planes[p], :, r] = cur[p][:, own]
                        stored[r] += 1
                    cur, nxt = nxt, torch.zeros_like(cur)
    assert torch.equal(stored, torch.ones(n, dtype=torch.long))  # every node once
    planes_t = acc * keep[None]
    planes_t[lctx.offsets.index(0)] += add
    data = planes_t[:, :16]
    if band is not None:
        data[:, :, band_lo : band_lo + band.shape[2]] += band
    if nc == 16:
        return data
    return data.contiguous(), planes_t[:, 16:].reshape(-1, n)


def _lattice_case(box, implicit):
    mesh = box_mesh(*box)
    cfg = melt_pool_scenario_config() if implicit else reference_scenario_config()
    solver = NSSolver(mesh, cfg, device="cpu")
    assert solver.fastpath == "lattice" and solver.lctx.scalar_implicit == implicit
    rng = np.random.default_rng(sum(box) + 10 * implicit)
    n = mesh.num_node
    state = state_from_numpy(rng.standard_normal((n, 6)), rng.standard_normal((n, 6)),
                             rng.standard_normal((n, 6)), "cpu", torch.float64)
    wa, dwa = alpha_states(*state, cfg.time)
    return solver, wa, dwa


def _epilogue_args(solver, wa, dwa, mode):
    lctx, phys, scheme = solver.lctx, solver.cfg.physics, solver.cfg.time
    nc = 18 if lctx.scalar_implicit else 16
    keep = keep_pc_rows(solver.mask_t, torch.float64)
    add = diag_add_rows(solver.mask_t, torch.float64)
    if mode == "unmasked":
        return torch.ones_like(keep[:nc]), torch.zeros_like(add[:nc]), None, 0
    band, lo = (None, 0)
    if mode == "band":
        band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme,
                                         len(lctx.offsets), keep)
        assert band is not None
    return keep[:nc].contiguous(), add[:nc].contiguous(), band, lo


@pytest.mark.parametrize("tile", ["kernel", "small"])
@pytest.mark.parametrize("mode", ["band", "masked", "unmasked"])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("box", [(3, 4, 5), (7, 5, 6)])
def test_k2_fused_decomposition_matches_plain_f64(box, implicit, mode, tile):
    solver, wa, dwa = _lattice_case(box, implicit)
    lctx, phys, scheme = solver.lctx, solver.cfg.physics, solver.cfg.time
    keep, add, band, lo = _epilogue_args(solver, wa, dwa, mode)
    wa_t = wa.T.contiguous()
    nc = 18 if implicit else 16
    elem = lhs_rows(lat._lhs_inputs(lctx, wa_t), ncomp=nc, scalar_implicit=implicit,
                    **lhs_args(phys, scheme))
    kw = {} if tile == "kernel" else {"tile": (3, 2), "zchunk": 2}
    got = fused_emulation(lctx, elem, keep, add, band, lo, **kw)
    ref = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, lo)
    if implicit:
        assert rel(got[0], ref[0]) < 1e-12 and rel(got[1], ref[1]) < 1e-12
    else:
        assert rel(got, ref) < 1e-12


@pytest.mark.parametrize("box", [(3, 4, 5), (7, 5, 6)])
def test_k2_fused_tables_cover_every_entry_once(box):
    """The fused tables take entry (t, a, b) of node r from cell
    r - delta[t][a] into plane plane_tab[t][a][b], once each; counted
    through the emulation (every element output 1), each plane value is
    the number of (t, a, b, cell >= 0) entries the plain reduce adds; the
    component groups partition the components."""
    mesh = box_mesh(*box)
    lctx = lat.build_lattice_context(mesh, "cpu", torch.float64)
    sy, ny, nz, planes = lctx.fused
    assert lctx.fused == lat.fused_tables(lctx.deltas, lctx.offsets, lctx.num_node)
    entries = fused_entries()
    assert sorted((t, a, b) for t, a, b, _, _ in entries) == [
        (t, a, b) for t in range(6) for a in range(4) for b in range(4)]
    for t, a, b, (kx, ky, kz), p in entries:
        assert lctx.deltas[t][a] == kx + sy * ky + sy * ny * kz
        assert planes[p] == lctx.plane_tab[t][a][b]
    for implicit, groups in lat.FUSED_GROUPS.items():
        comps = sorted(k for g in groups for k in g)
        assert comps == list(range(18 if implicit else 16))
        assert all(list(g) == sorted(g) and len(g) == len(groups[0]) for g in groups)
    n = lctx.num_node
    ones = torch.ones((6, 256, n), dtype=torch.float64)
    keep, add = torch.ones((16, n), dtype=torch.float64), torch.zeros((16, n), dtype=torch.float64)
    ref = torch.stack(lat._reduce_lhs_planes(lctx, ones, 16))
    for kw in ({}, {"tile": (3, 2), "zchunk": 2}):
        counts = fused_emulation(lctx, ones, keep, add, **kw)
        assert torch.equal(counts, ref)
        assert int(counts[:, 0].sum()) == sum(
            n - lctx.deltas[t][a] for t in range(6) for a in range(4) for b in range(4))


def test_k2_fused_tables_refuse_a_non_kuhn_context():
    lctx = lat.build_lattice_context(box_mesh(3, 4, 5), "cpu", torch.float64)
    with pytest.raises(ValueError, match="Kuhn"):
        lat.fused_tables(lctx.deltas[::-1], lctx.offsets, lctx.num_node)
