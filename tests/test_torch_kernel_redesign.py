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
from torch_meshes import table_context


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


# ---------------------------------------------------------------------------
# K2c's one pass: K2's tiling over a run-time table placed on a node grid


def grid_emulation(lctx, elem, keep, add, band=None, band_lo=0, zchunk=None, computed=None):
    """K2c's one pass in torch on the element outputs `elem` (T, 16*nc, N)
    (the body's values for each (slab, column)), as the kernel runs it: a
    block a (component group, z chunk, 8 x 8 tile), its threads (slot,
    ly, lx); per cell layer the rounds of GRID_ROUND_SLABS slabs staged
    into a flat float stage (unwritten floats NaN), slab t's halo cell c
    at column c + shifts[t] (zero off the row / layer end or outside
    [0, N)); then the round's entries (t, a, b), in that order, each read
    at the thread's stage offset plus corner a's halo shift and added to
    its plane's sum of node layer L + (corner a's z bit), (2, D, threads)
    halves by layer parity; node layer L stored when complete, its half
    zeroed. `computed` (T, N) bool records the columns staged. Returns
    data (D, 16, N), and (data, scal) implicit."""
    nc = elem.shape[1] // 16
    implicit = nc == 18
    zchunk = zchunk or lat.FUSED_ZCHUNK[implicit]
    sy, ny, nz, corners, shifts = lctx.grid
    nt, n, nd, sz = len(corners), lctx.num_node, len(lctx.offsets), sy * ny
    (tx, ty), halo, hx = lat.FUSED_TILE, lat.FUSED_HALO, lat.FUSED_TILE[0] + 1
    groups_k = lat.FUSED_GROUPS[implicit]
    kg = len(groups_k[0])
    threads = tx * ty * kg
    rs = lat.GRID_ROUND_SLABS[implicit]
    tid = torch.arange(threads)
    slot, lx, ly = tid // (tx * ty), tid % tx, tid % (tx * ty) // tx
    base = slot * halo + ly * hx + lx
    hc = torch.arange(halo)
    acc = torch.full((nd, nc, n), float("nan"), dtype=elem.dtype)
    stored = torch.zeros((nc, n), dtype=torch.long)
    for comps in groups_k:
        k = torch.tensor(comps)[slot]
        for z0 in range(0, nz, zchunk):
            for y0 in range(0, ny, ty):
                for x0 in range(0, sy, tx):
                    sums = torch.zeros((2, nd, threads), dtype=elem.dtype)
                    cx, cy = x0 - 1 + hc % hx, y0 - 1 + hc // hx
                    for layer in range(z0 - 1, min(z0 + zchunk, nz)):
                        for h in range(-(-nt // rs)):
                            stage = torch.full((rs * 16 * kg * halo,), float("nan"),
                                               dtype=elem.dtype)
                            slabs = range(h * rs, min(nt, (h + 1) * rs))
                            for t in slabs:
                                ts = t - h * rs
                                c = cx + sy * cy + sz * layer + shifts[t]
                                ok = (cx < sy) & (cy < ny) & (c >= 0) & (c < n)
                                vals = torch.where(ok, elem[t][:, c.clamp(0, n - 1)], 0.0)
                                vals = vals.reshape(16, nc, halo)[:, list(comps)]
                                stage[ts * 16 * kg * halo : (ts + 1) * 16 * kg * halo] = (
                                    vals.reshape(-1))
                                if computed is not None:
                                    computed[t, c[ok]] = True
                            for t in slabs:
                                ts = t - h * rs
                                for a in range(4):
                                    ka, kb, kz = lat._corner(corners[t][a])
                                    shift = (1 - kb) * hx + (1 - ka)
                                    for b in range(4):
                                        off = (ts * 16 + a * 4 + b) * kg * halo + shift
                                        sums[(layer + kz) & 1, lctx.plane_tab[t][a][b]] += (
                                            stage[base + off])
                        if layer >= z0:
                            x, y = x0 + lx, y0 + ly
                            own = (x < sy) & (y < ny)
                            r = (x + sy * y + sz * layer)[own]
                            acc[:, k[own], r] = sums[layer & 1][:, own]
                            stored[k[own], r] += 1
                        sums[layer & 1] = 0.0
    assert torch.equal(stored, torch.ones_like(stored))  # every (component, node) once
    planes_t = acc * keep[None]
    planes_t[lctx.offsets.index(0)] += add
    data = planes_t[:, :16]
    if band is not None:
        data[:, :, band_lo : band_lo + band.shape[2]] += band
    if nc == 16:
        return data
    return data.contiguous(), planes_t[:, 16:].reshape(-1, n)


def _random_epilogue(lctx, implicit, seed):
    rng = np.random.default_rng(seed)
    n, nd, nc = lctx.num_node, len(lctx.offsets), 18 if implicit else 16
    keep = torch.as_tensor(rng.uniform(0.5, 1.5, (nc, n)))
    add = torch.as_tensor(rng.standard_normal((nc, n)))
    band = torch.as_tensor(rng.standard_normal((nd, 16, n // 3)))
    return keep, add, band, n // 5


SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024  # bytes, an H100's


def grid_smem_bytes(num_planes: int, implicit: bool) -> int:
    """K2c's dynamic shared memory a block (csrc/lattice_jacobian.cu's
    entry computes the same): a round's slabs x 16 pairs x the group's
    components x the halo cells, the plane sums of node layers L and L + 1
    for each (node, component) thread, and the slabs' offsets and shifts."""
    kg = len(lat.FUSED_GROUPS[implicit][0])
    threads = lat.FUSED_TILE[0] * lat.FUSED_TILE[1] * kg
    return (lat.GRID_ROUND_SLABS[implicit] * 16 * kg * lat.FUSED_HALO + 2 * num_planes * threads
            + lat.MAX_CLASSES * 5) * 4


GRID_CASES = {  # name: (table, implicit)
    "a": ("a", False), "b": ("b", False), "L": ("L", False), "melt-a": ("a", True),
    "overlaid": ("overlaid", False), "overlaid-implicit": ("overlaid", True),
    "kuhn": ("kuhn", False), "kuhn-implicit": ("kuhn", True),
}


@pytest.mark.parametrize("zchunk", [None, 2], ids=["kernel-chunk", "chunk-2"])
@pytest.mark.parametrize("case", list(GRID_CASES))
def test_k2c_one_pass_decomposition_matches_plain_f64(case, zchunk):
    """In float64 the emulated one pass equals jacobian_volume_plain to
    1e-12 (masked, with a band), every live (slab, column) element is
    staged; on the Kuhn table it also equals K2's fused emulation. Box 8 x
    8 x 3: 2 x 2 tiles, so halos cross tiles and wrap rows."""
    name, implicit = GRID_CASES[case]
    lctx = table_context(name, (8, 8, 3), implicit)
    assert lctx.grid is not None
    rng = np.random.default_rng(len(case))
    wa_t = torch.as_tensor(rng.standard_normal((6, lctx.num_node)))
    cfg = melt_pool_scenario_config() if implicit else reference_scenario_config()
    phys, scheme = cfg.physics, cfg.time
    nc = 18 if implicit else 16
    elem = lhs_rows(lat._lhs_inputs(lctx, wa_t), ncomp=nc, scalar_implicit=implicit,
                    **lhs_args(phys, scheme))
    keep, add, band, lo = _random_epilogue(lctx, implicit, len(case) + 1)
    computed = torch.zeros((len(lctx.deltas), lctx.num_node), dtype=torch.bool)
    got = grid_emulation(lctx, elem, keep, add, band, lo, zchunk, computed)
    ref = lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, lo)
    live = (lctx.lhs_geom != 0).any(dim=1)
    assert bool(live.any()) and bool(computed[live].all())
    for g, r in zip(got, ref) if implicit else ((got, ref),):
        assert rel(g, r) < 1e-12
    if lctx.fused is not None:
        fused = fused_emulation(lctx, elem, keep, add, band, lo)
        for g, f in zip(got, fused) if implicit else ((got, fused),):
            assert rel(g, f) < 1e-12


@pytest.mark.parametrize("case", ["a", "b", "L", "overlaid", "overlaid-implicit", "kuhn"])
def test_k2c_one_pass_adds_every_entry_once(case):
    """Counted through the emulation (every element output 1), each plane
    value is the number of (t, a, b) entries the plain reduce adds there:
    every entry once, none twice; the stage and the plane sums fit a
    block's shared memory (two blocks an SM frozen), for the widest table
    (27 planes) too."""
    name, implicit = GRID_CASES[case]
    lctx = table_context(name, (8, 8, 3), implicit)
    n, nt, nd = lctx.num_node, len(lctx.deltas), len(lctx.offsets)
    nc = 18 if implicit else 16
    ones = torch.ones((nt, 16 * nc, n), dtype=torch.float64)
    keep, add = torch.ones((nc, n), dtype=torch.float64), torch.zeros((nc, n), dtype=torch.float64)
    got = grid_emulation(lctx, ones, keep, add)
    counts = torch.cat([got[0], got[1].reshape(nd, 2, n)], dim=1) if implicit else got
    assert torch.equal(counts, torch.stack(lat._reduce_lhs_planes(lctx, ones, nc)))
    for planes in (nd, 27):
        assert grid_smem_bytes(planes, implicit) <= SMEM_PER_BLOCK
    if not implicit:
        assert 2 * (grid_smem_bytes(nd, implicit) + SMEM_RESERVED) <= SMEM_PER_SM


def test_grid_tables_of_the_kuhn_box_are_the_fused_tables():
    """On the Kuhn box the grid is K2's fused (sy, ny, nz) with the Kuhn
    corners in their order and no shifts, and the residual workspace is
    the one K1 keeps; the deformed box (a) holds the same table in
    np.unique order; the overlaid mesh's mirrored tet without corner 0
    takes its column at its smallest node (shift 1)."""
    for box in ((3, 4, 5), (7, 5, 6)):
        lctx = lat.build_lattice_context(box_mesh(*box), "cpu", torch.float64)
        sy, ny, nz, corners, shifts = lctx.grid
        assert (sy, ny, nz) == lctx.fused[:3]
        assert corners == tuple(tuple(int(c) for c in tet) for tet in _KUHN_TETS)
        assert shifts == (0,) * 6
        assert lctx.res_sync.numel() == 2 + 2 * lat.res_fused_items(sy, ny, nz)[2]
    a = table_context("a", (4, 3, 3))
    kuhn = {tuple(int(c) for c in tet) for tet in _KUHN_TETS}
    assert a.fused is None and set(a.grid[3]) == kuhn and a.grid[4] == (0,) * 6
    assert a.grid[:3] == (5, 4, 4)
    ov = table_context("overlaid", (4, 3, 3))
    assert len(ov.grid[3]) == 8 and sorted(ov.grid[4]) == [0] * 7 + [1]
    b = table_context("b", (4, 3, 3))
    assert b.grid[4] == (0,) * 6 and any(0 not in tet for tet in b.grid[3])


def test_grid_tables_refuse_a_table_that_does_not_place():
    """A table whose offsets are no cell's corners (a slab along one row)
    or whose elements wrap past a row end does not place: grid_tables
    returns None, and the context keeps no ticket workspace."""
    a = table_context("a", (4, 3, 3))
    row = dataclasses.replace(a, deltas=((0, 1, 2, 3),) + a.deltas[1:], grid=None, res_sync=None)
    assert lat.grid_tables(row) is None
    # an element whose cell lies on the last node column: its vertices wrap
    geom = a.res_geom.clone()
    sy = a.grid[0]
    geom[0, :, sy - 1] = 1.0
    assert lat.grid_tables(dataclasses.replace(a, res_geom=geom)) is None
    mesh = box_mesh(4, 3, 3)
    ien = mesh.ien.copy()
    ien[0] = [0, 1, 2, 9]  # a tet off the cell corners: its class does not place
    ctx = lat.build_class_context(dataclasses.replace(mesh, ien=ien, lattice=None), "cpu",
                                  torch.float64)
    assert ctx is not None and ctx.grid is None and ctx.res_sync is None


class _CudaLike(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: routing checks only."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("placed", [True, False], ids=["grid", "no-grid"])
def test_class_wrappers_route_by_the_grid(monkeypatch, placed):
    """On a CUDA tensor K1's and K2's wrappers send a context without the
    fused tables to K1c / K2c, which launch their one-pass kernels where
    the table placed and their two-pass entries where it did not; each
    route has its own counter (the launches stubbed here)."""
    a = table_context("a", (4, 3, 3), dtype=torch.float32)
    if not placed:
        a = dataclasses.replace(a, grid=None, res_sync=None)
    calls = []
    for name in ("residual_volume_two_pass", "jacobian_volume_two_pass"):
        monkeypatch.setattr(lat, name, lambda *args, name=name, **kw: calls.append(name))
    monkeypatch.setattr(lat.nvcc, "function",
                        lambda lib, sym, argtypes: calls.append(sym) or (lambda *x: 0))
    monkeypatch.setattr(lat, "_check_res_layout", lambda: None)
    monkeypatch.setattr(lat, "_check_fused_layout", lambda implicit: None)
    monkeypatch.setattr(lat, "_check_f32_cuda", lambda *a_, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: type("P", (), {"multi_processor_count": 132})())
    n = a.num_node
    z = torch.zeros((6, n)).as_subclass(_CudaLike)
    cfg = reference_scenario_config()
    before = lat.residual_volume_classes.launches, lat.jacobian_volume_classes.launches
    lat.residual_volume(a, z, z, cfg.physics, cfg.time)
    lat.jacobian_volume(a, z, cfg.physics, cfg.time, torch.ones((16, n)), torch.zeros((16, n)))
    after = lat.residual_volume_classes.launches, lat.jacobian_volume_classes.launches
    if placed:
        assert calls == ["dedflow_lattice_residual_grid", "dedflow_lattice_jacobian_grid"]
        assert after == (before[0] + 1, before[1] + 1)
    else:
        assert calls == ["residual_volume_two_pass", "jacobian_volume_two_pass"]
        assert after == before
