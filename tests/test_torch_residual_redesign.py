"""The redesigned residual kernels K1 (csrc/lattice_residual.cu, one fused
pass) and K4 (csrc/gather_elements.cu's staged entry, straight into K8's
staging rows) on the CPU.

The kernels run only on the card. What the CPU checks is the order and
the partition of the work they do, emulated in torch from the tables they
use, and their plain twins:

- K1, the fused pass: work items (L, T) in ticket order, each storing its
  8 x 8 node tile's cells of cell layer L into a ring of cell layers and
  summing its nodes' 24 contributions of node layer L - 1 in the plain
  order (t = 0..5, a = 0..3, from zero) from its own and its left, lower
  and lower-left neighbours' cells of layers L - 1 and L - 2, cells left of or
  below the lattice (where the plain version's wrapped index lands on a
  dead cell) and below layer 0 as zeros. The emulation checks the kernel's
  wait sets: every value read was stored by an item waited for and not yet
  overwritten, every overwrite waits for the readers of the layer it
  replaces, and every wait is on an earlier ticket. In float64 it equals
  `residual_volume_plain` to 1e-12 and in float32 bit for bit, with and
  without the heat source, on boxes the tile does not divide (3 x 4 x 5,
  7 x 5 x 6, 9 x 8 x 4), with the kernel's tile and ring and with small
  ones (many tiles, slots reused every 4 layers). Every (t, a)
  contribution reaches each node once (counted with unit element outputs),
  and the dead cells' rows are exactly zero.
- K4 staged: the residual plan's element positions (`elem_pos`, 4 slots)
  locate each (element, vertex) contribution, -1 exactly for a chunk's pad
  elements; the staged twin followed by K8's segment sum twin
  (`stream_reduce_staged`) equals `stream_reduce_plain` over the column
  rows bit for bit (float64 and float32, with and without the source,
  every range of a whole and a chunked context), and `ns.residual_volume`
  equals the JAX package's volume residual on the same tier to 1e-12.

Meshes: box_mesh for K1; delaunay_mesh(300, seed=5) in its generated
order (the gather tier) for K4. Inputs are made with numpy from a seed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dedflow_tpu import config as jcfg
from dedflow_tpu.app.scenarios import reference_scenario_config as jref
from dedflow_tpu.fem import ns as jns
from dedflow_tpu.fem import weakform as jwf
from dedflow_tpu.fem.assembly import build_context as jbuild_context
from dedflow_tpu.fem.assembly import scatter_residual as jscatter_residual
from dedflow_tpu.mesh.gen import delaunay_mesh as jdelaunay_mesh
from dedflow_tpu.sparse import topology as jtop
from dedflow_tpu_torch import interop
from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config, reference_scenario_config
from dedflow_tpu_torch.fem import element_kernels as ek
from dedflow_tpu_torch.fem import lattice as lat
from dedflow_tpu_torch.fem import ns
from dedflow_tpu_torch.fem.assembly import build_context
from dedflow_tpu_torch.fem.element_kernels import res_args
from dedflow_tpu_torch.fem.element_rows import res_rows
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS, box_mesh, delaunay_mesh
from dedflow_tpu_torch.sparse.topology import build_sparsity
from dedflow_tpu_torch.sparse.win_stream import (
    stream_reduce_plain,
    stream_reduce_staged,
    stream_reduce_staged_plain,
)
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
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# K1


def _corners():
    return [lat._corner(int(_KUHN_TETS[t][a])) for t in range(6) for a in range(4)]


def k1_waits(item, tiles_x, tiles, ring):
    """The items K1's work item `item` = (L, T) waits for, as the kernel
    computes them: (produced, consumed). Produced: the items of layers
    L - 1 and L - 2 of its tile and its left, lower and lower-left
    neighbours (what its sum of node layer L - 1 reads). Consumed, before it
    overwrites its ring slot: the items L - R + 1 and L - R + 2 of its tile
    and its right, upper and upper-right neighbours (the sums that read the
    layer the slot held)."""
    L, T = divmod(item, tiles)
    tx, ty, tiles_y = T % tiles_x, T // tiles_x, tiles // tiles_x
    produced, consumed = set(), set()
    for j in range(8):
        lr, ux, uy = L - 1 - (j >> 2), tx - (j & 1), ty - ((j >> 1) & 1)
        if lr >= 0 and ux >= 0 and uy >= 0:
            produced.add(lr * tiles + uy * tiles_x + ux)
        lw, ux, uy = L - ring + 1 + (j >> 2), tx + (j & 1), ty + ((j >> 1) & 1)
        if lw >= 0 and ux < tiles_x and uy < tiles_y:
            consumed.add(lw * tiles + uy * tiles_x + ux)
    return produced, consumed


def fused_residual_emulation(lctx, elem, tile=lat.RES_FUSED_TILE, ring=None):
    """K1's fused pass, and K1c's one pass, in torch on the element
    residual rows `elem` (T, 24, N) (what the kernel's body computes for
    each (slab, column)), over the context's node grid (`grid`: on the
    Kuhn box K1's table; else K1c's run-time corners and shifts): work
    items (L, T) in ticket order, L = 0..nz, each storing its tile's cells
    of cell layer L (L < nz) into a ring of `ring` cell layers, slab t's
    cell c from column c + shifts[t] (zero off the row / layer end or past
    N), and summing its nodes' 4T contributions of node layer L - 1
    (L >= 1) from the ring in the plain order. It checks the kernel's
    synchronization on the way: every value a node reads is the layer it
    wants (no slot overwritten early) and was stored by an item its
    produced-wait set names, and an item that overwrites a slot waits
    (consumed set) for every item that read the layer the slot held.
    Returns the (6, N) residual; each node is stored once."""
    sy, ny, nz, cells_of, shifts = lctx.grid
    nt = len(cells_of)
    tiles_x = -(-sy // tile)
    tiles = tiles_x * -(-ny // tile)
    items = tiles * (nz + 1)
    ring = ring or lat.res_ring_layers(tiles, H100_SMS, nt)
    corners = [lat._corner(c) for cs in cells_of for c in cs]
    n, sz = lctx.num_node, sy * ny
    out = torch.full((6, n), float("nan"), dtype=elem.dtype)
    stored = torch.zeros(n, dtype=torch.long)
    slots, readers = {}, {}  # (ring slot, tile) -> (layer, (24, 6, tile**2)); (layer, tile) -> items
    lx = torch.arange(tile * tile) % tile
    ly = torch.arange(tile * tile) // tile
    for item in range(items):
        L, T = divmod(item, tiles)
        tx, ty = T % tiles_x, T // tiles_x
        waits_p, waits_c = k1_waits(item, tiles_x, tiles, ring)
        if L < nz:  # produce: the tile's cells of layer L, zeros past the row or layer end
            cx, cy = tx * tile + lx, ty * tile + ly
            vals = []
            for t in range(nt):
                c = cx + sy * cy + sz * L + shifts[t]
                valid = (cx < sy) & (cy < ny) & (c < n)
                vals.append(torch.where(valid, elem[t][:, torch.where(valid, c, 0)], 0.0))
            vals = torch.stack(vals).reshape(4 * nt, 6, tile * tile)
            old = slots.get((L % ring, T))
            if old is not None:
                assert readers.get((old[0], T), set()) <= waits_c
            slots[(L % ring, T)] = (L, vals)
        if L == 0:
            continue
        Lc = L - 1  # consume node layer Lc of the tile
        acc = torch.zeros((6, tile * tile), dtype=elem.dtype)
        for ta, (kx, ky, kz) in enumerate(corners):
            sx, sy_, lr = lx - kx, ly - ky, Lc - kz
            v = torch.zeros((6, tile * tile), dtype=elem.dtype)
            for dx in (0, 1):
                for dy in (0, 1):
                    sel = ((sx < 0) == bool(dx)) & ((sy_ < 0) == bool(dy))
                    if not bool(sel.any()) or tx < dx or ty < dy or lr < 0:
                        continue  # left of or below the lattice, below layer 0: zeros
                    src_t = T - dx - dy * tiles_x
                    layer, data = slots[(lr % ring, src_t)]
                    assert layer == lr  # not overwritten before it was read
                    assert lr * tiles + src_t in waits_p
                    readers.setdefault((lr, src_t), set()).add(item)
                    cell = (sx % tile) + tile * (sy_ % tile)
                    v[:, sel] = data[ta][:, cell[sel]]
            acc += v
        x, y = tx * tile + lx, ty * tile + ly
        own = (x < sy) & (y < ny)
        r = (x + sy * y + sz * Lc)[own]
        out[:, r] = acc[:, own]
        stored[r] += 1
    assert torch.equal(stored, torch.ones(n, dtype=torch.long))  # every node once
    return out


def _lattice_case(box, dtype, source):
    cfg = melt_pool_scenario_config() if source else reference_scenario_config()
    mesh = box_mesh(*box)
    lctx = lat.build_lattice_context(mesh, "cpu", dtype)
    rng = np.random.default_rng(sum(box) + 7 * source)
    n = mesh.num_node
    wa_t, dwa_t = (torch.as_tensor(rng.standard_normal((6, n)), dtype=dtype) for _ in range(2))
    src = torch.as_tensor(rng.standard_normal(n), dtype=dtype) if source else None
    return lctx, cfg, wa_t, dwa_t, src


H100_SMS = 132
# the kernel's tiling and the wrapper's ring on an H100; small tiles and the
# shortest ring (many tiles, slots reused every 4 layers)
TILINGS = {"kernel": {}, "small": {"tile": 2, "ring": 4}}


@pytest.mark.parametrize("tiling", list(TILINGS))
@pytest.mark.parametrize("source", [False, True], ids=["no-source", "source"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("box", [(3, 4, 5), (7, 5, 6), (9, 8, 4)])
def test_k1_fused_decomposition_matches_plain(box, dtype, source, tiling):
    """float64: 1e-12 of residual_volume_plain; float32: bit for bit (the
    same element rows added in the same order, zeros for skipped cells)."""
    dt = {"f64": torch.float64, "f32": torch.float32}[dtype]
    lctx, cfg, wa_t, dwa_t, src = _lattice_case(box, dt, source)
    phys, scheme = cfg.physics, cfg.time
    elem = res_rows(lat._residual_inputs(lctx, wa_t, dwa_t, src), **res_args(phys, scheme))
    got = fused_residual_emulation(lctx, elem, **TILINGS[tiling])
    ref = lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, src)
    if dt == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert rel(got, ref) < 1e-12
    # the CPU wrapper is the plain version and counts no launch
    before = lat.residual_volume.launches
    assert torch.equal(lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme, src), ref)
    assert lat.residual_volume.launches == before


@pytest.mark.parametrize("box", [(3, 4, 5), (7, 5, 6), (9, 8, 4)])
def test_k1_fused_tables_cover_every_contribution_once(box):
    """The corners are the context's vertex offsets; counted through the
    emulation (every live cell's element outputs 1, the dead cells' 0, as
    their zero geometry makes them) each node receives exactly the
    (t, a, live cell) contributions the plain reduce adds; the wait sets
    name only earlier tickets (no item waits on a later one)."""
    nx, ny_, nz_ = box
    lctx = lat.build_lattice_context(box_mesh(*box), "cpu", torch.float64)
    sy, ny, nz, _ = lctx.fused
    for ta, (kx, ky, kz) in enumerate(_corners()):
        t, a = divmod(ta, 4)
        assert lctx.deltas[t][a] == kx + sy * ky + sy * ny * kz
    n = lctx.num_node
    c = torch.arange(n)
    live = (c % sy < nx) & ((c // sy) % ny < ny_) & (c // (sy * ny) < nz_)
    ones = live.to(torch.float64).expand(6, 24, n)
    ref = lat._reduce_residual(lctx, ones)
    for kw in TILINGS.values():
        counts = fused_residual_emulation(lctx, ones, **kw)
        assert torch.equal(counts, ref)
        assert int(counts[0].sum()) == 24 * nx * ny_ * nz_  # each live element's 4 x 6 once
    tiles_x, tiles, items = lat.res_fused_items(sy, ny, nz)
    for ring in (4, lat.res_ring_layers(tiles, H100_SMS)):
        for item in range(items):
            p, c = k1_waits(item, tiles_x, tiles, ring)
            assert all(w < item for w in p | c)


# the tables K1c's one pass takes: (table_context name, with the heat source)
K1C_CASES = {"a": ("a", False), "b": ("b", False), "L": ("L", False), "melt-a": ("a", True),
             "overlaid": ("overlaid", False)}


@pytest.mark.parametrize("tiling", list(TILINGS))
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", list(K1C_CASES))
def test_k1c_one_pass_decomposition_matches_plain(case, dtype, tiling):
    """K1c's one pass over the run-time tables (6 or 8 slabs, shifted
    columns, corners without corner 0): float64 within 1e-12 of
    residual_volume_plain, float32 bit for bit (the columns a cell off the
    grid stands for hold no element, so their zeros are the plain
    version's +-0)."""
    name, source = K1C_CASES[case]
    dt = {"f64": torch.float64, "f32": torch.float32}[dtype]
    lctx = table_context(name, (7, 5, 4), dtype=dt)
    assert lctx.fused is None and lctx.grid is not None
    cfg = melt_pool_scenario_config() if source else reference_scenario_config()
    rng = np.random.default_rng(len(case) + 7 * source)
    n = lctx.num_node
    wa_t, dwa_t = (torch.as_tensor(rng.standard_normal((6, n)), dtype=dt) for _ in range(2))
    src = torch.as_tensor(rng.standard_normal(n), dtype=dt) if source else None
    phys, scheme = cfg.physics, cfg.time
    elem = res_rows(lat._residual_inputs(lctx, wa_t, dwa_t, src), **res_args(phys, scheme))
    got = fused_residual_emulation(lctx, elem, **TILINGS[tiling])
    ref = lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, src)
    if dt == torch.float32:
        assert torch.equal(got, ref)
    else:
        assert rel(got, ref) < 1e-12


@pytest.mark.parametrize("case", ["a", "b", "L", "overlaid"])
def test_k1c_one_pass_covers_every_contribution_once(case):
    """Counted through the emulation (each column that holds an element
    outputs 1, the others 0), every node receives exactly the (t, a,
    element) contributions the plain reduce adds, each element's 4 x 6
    once; the ring keeps the six-slab ring's bytes past six slabs."""
    lctx = table_context(K1C_CASES[case][0], (7, 5, 4))
    live = (lctx.res_geom != 0).any(dim=1).to(torch.float64)  # (T, N)
    ones = live[:, None, :].expand(-1, 24, -1)
    ref = lat._reduce_residual(lctx, ones)
    for kw in TILINGS.values():
        counts = fused_residual_emulation(lctx, ones, **kw)
        assert torch.equal(counts, ref)
        assert int(counts[0].sum()) == 4 * int(live.sum())
    tiles = lat.res_fused_items(56, 56, 56)[1]
    six = lat.res_ring_layers(tiles, H100_SMS)
    assert lat.res_ring_layers(tiles, H100_SMS, 8) * 8 <= six * 6
    assert lat.res_ring_layers(tiles, H100_SMS, 8) >= -(-3 * H100_SMS // tiles) + 2


def test_k1_workspace_sizes():
    """res_fused_items: box 55 has 7 x 7 tiles and 57 x 49 items (a row
    more than the cell layers: the last sums only), box 44 6 x 6 and
    46 x 36; the ring spans the layers of the card's 396 resident items and
    RES_FUSED_RING_MARGIN more; the context's workspace holds a 64-bit
    counter and two flags an item, zeros."""
    assert lat.res_fused_items(56, 56, 56) == (7, 49, 2793)
    assert lat.res_fused_items(45, 45, 45) == (6, 36, 1656)
    margin = lat.RES_FUSED_RING_MARGIN
    assert lat.res_ring_layers(49, H100_SMS) == 9 + margin
    assert lat.res_ring_layers(36, H100_SMS) == 11 + margin
    lctx = lat.build_lattice_context(box_mesh(7, 5, 6), "cpu", torch.float64)
    assert lctx.res_sync.dtype == torch.int32 and not bool(lctx.res_sync.any())
    assert lctx.res_sync.numel() == 2 + 2 * lat.res_fused_items(8, 6, 7)[2]


@pytest.mark.parametrize("box", [(3, 4, 5), (7, 5, 6)])
def test_k1_dead_cells_add_exact_zeros(box):
    """The dead cells (ix == nx, iy == ny or iz == nz: zero geometry), which
    the plain reduce adds and the wrapped indices land on, give rows of
    exact zeros in both precisions, with any states and source."""
    nx, ny, nz = box
    for dt in (torch.float64, torch.float32):
        lctx, cfg, wa_t, dwa_t, src = _lattice_case(box, dt, True)
        elem = res_rows(lat._residual_inputs(lctx, wa_t, dwa_t, src),
                        **res_args(cfg.physics, cfg.time))
        c = torch.arange(lctx.num_node)
        ix, iy, iz = c % (nx + 1), (c // (nx + 1)) % (ny + 1), c // ((nx + 1) * (ny + 1))
        dead = (ix == nx) | (iy == ny) | (iz == nz)
        assert bool(dead.any()) and bool(torch.isfinite(elem).all())
        assert not bool(elem[:, :, dead].any())


# ---------------------------------------------------------------------------
# K4 staged + K8's segment sum

CHUNK = 300  # several ranges, the last one padded
DTYPES = {"f64": torch.float64, "f32": torch.float32}
JCFG = jref(bcs=(), pin_pressure=True)
CFG = interop.config_from_dict(jcfg._to_dict(JCFG))
PHYS, SCHEME = CFG.physics, CFG.time


@pytest.fixture(scope="module")
def mesh():
    return delaunay_mesh(300, seed=5)


@pytest.fixture(scope="module")
def contexts(mesh):
    sp = build_sparsity(mesh.ien, mesh.num_node)
    return {(name, chunk): build_context(mesh, sp, device="cpu", dtype=dt, chunk=chunk,
                                         elements_kernel="pallas")
            for name, dt in DTYPES.items() for chunk in (None, CHUNK)}


def _states(num_node, dtype, seed=2):
    rng = np.random.default_rng(seed)
    wa, dwa = (torch.as_tensor(rng.standard_normal((num_node, 6)), dtype=dtype) for _ in range(2))
    src = torch.as_tensor(rng.standard_normal(num_node), dtype=dtype)
    return wa, dwa, src


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunk"])
def test_residual_element_positions_locate_each_contribution(contexts, mesh, chunk):
    ctx = contexts[("f64", chunk)]
    real = mesh.num_tet
    if chunk:
        assert len(ctx.ranges) > 1 and ctx.ranges[-1].hi > real  # the last range padded
    for rng_ in ctx.ranges:
        plan, m = rng_.res_plan, rng_.hi - rng_.lo
        pos = ek.element_positions(plan, m, 4).long().view(4, m)
        a, e = torch.meshgrid(torch.arange(4), torch.arange(m), indexing="ij")
        have = pos >= 0
        assert torch.equal(have, (e < real - rng_.lo).expand(4, m))  # -1: exactly the pads
        assert torch.equal(plan.src[pos[have]].long(), (a * 6 * m + e)[have])
        assert torch.equal(torch.sort(pos[have]).values, torch.arange(plan.src.numel()))
        if chunk is None:  # every contribution: the staging order is the element order
            assert plan.elem_pos is plan.stage_pos


@pytest.mark.parametrize("source", [False, True], ids=["no-source", "source"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunk"])
def test_staged_twin_then_segment_sum_equal_stream_reduce(contexts, chunk, dtype, source):
    """The staged K4 (its plain twin on the CPU, counting no launch) then
    K8's segment sum (its twin) == stream_reduce_plain over the column K4
    rows, bit for bit, range by range; the staged rows == the column rows
    placed at the plan positions, zeros in columns 6-7."""
    ctx = contexts[(dtype, chunk)]
    wa, dwa, src = _states(ctx.num_node, DTYPES[dtype])
    src = src if source else None
    launches = (ek.ns_residual_gather_staged.launches, stream_reduce_staged.launches)
    for rng_ in ctx.ranges:
        m, plan = rng_.hi - rng_.lo, rng_.res_plan
        geom, ien_t = ctx.res_geom[:, rng_.lo : rng_.hi], ctx.ien_t[:, rng_.lo : rng_.hi]
        rows = ek.ns_residual_gather(geom, ien_t, wa.T.contiguous(), dwa.T.contiguous(),
                                     PHYS, SCHEME, src)
        stage = ek.ns_residual_gather_staged(geom, ien_t, wa, dwa, PHYS, SCHEME, plan, src)
        assert stage.dtype == DTYPES[dtype] and stage.shape == (plan.src.numel(), 8)
        assert torch.equal(stage, ek.stage_residual_rows(plan, rows))
        assert not bool(stage[:, 6:].any())
        ref = stream_reduce_plain(plan, rows, range(6), m)
        assert torch.equal(stream_reduce_staged(plan, stage, 6), ref)
        assert torch.equal(stream_reduce_staged_plain(plan, stage, 6), ref)
    assert (ek.ns_residual_gather_staged.launches, stream_reduce_staged.launches) == launches


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("source", [False, True], ids=["no-source", "source"])
@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["whole", "chunk"])
def test_volume_residual_matches_jax_f64(mesh, chunk, source, kernel):
    """ns.residual_volume (the staged path's twins, or the weak form's rows
    placed in the staging rows) against the JAX volume residual on the same
    tier: its weak-form element residuals scattered by scatter_residual, or
    its streaming _chunked_residual; float64, 1e-12."""
    sp = build_sparsity(mesh.ien, mesh.num_node)
    ctx = build_context(mesh, sp, device="cpu", dtype=torch.float64, chunk=chunk,
                        elements_kernel=kernel)
    jm = jdelaunay_mesh(300, seed=5)
    jctx = jbuild_context(jm, jtop.build_sparsity(np.asarray(jm.ien), jm.num_node, native=False),
                          chunk=chunk)
    wa, dwa, src = _states(ctx.num_node, torch.float64, seed=3)
    src = src if source else None
    jwa, jdwa = jnp.asarray(wa.numpy()), jnp.asarray(dwa.numpy())
    jsrc = None if src is None else jnp.asarray(src.numpy())
    if chunk:
        ref = jns._chunked_residual(jctx, jwa, jdwa, JCFG.physics, JCFG.time, chunk, jsrc)
    else:
        ef = jwf.gather_fields(jctx.ien, jwa, jdwa)
        src_e = None if jsrc is None else jsrc[jctx.ien]
        ref = jscatter_residual(jctx, jwf.ns_residual_elements(jctx, ef, JCFG.physics,
                                                                JCFG.time, src_e))
    got = ns.residual_volume(ctx, wa, dwa, PHYS, SCHEME, src)
    assert got.shape == (6, ctx.num_node)
    assert rel(got.numpy(), np.asarray(ref).T) < 1e-12


def test_staged_residual_raises_without_positions(contexts):
    ctx = contexts[("f64", None)]
    (rng_,) = ctx.ranges
    m = rng_.hi - rng_.lo
    wa, dwa, _ = _states(ctx.num_node, torch.float64)
    bare = dataclasses.replace(rng_.res_plan, elem_pos=None)
    with pytest.raises(ValueError, match="element residual"):
        ek.ns_residual_gather_staged(ctx.res_geom, ctx.ien_t, wa, dwa, PHYS, SCHEME, bare)
    with pytest.raises(ValueError, match="element residual"):  # the Jacobian plan's 16 slots
        ek.ns_residual_gather_staged(ctx.res_geom, ctx.ien_t, wa, dwa, PHYS, SCHEME, rng_.jac_plan)
    with pytest.raises(ValueError, match="element residual"):
        ek.stage_residual_rows(bare, torch.zeros((24, m), dtype=torch.float64))
    stage = torch.zeros((rng_.res_plan.src.numel(), 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="staging buffer"):  # K8's rows are 8 wide
        stream_reduce_staged(rng_.res_plan, stage, 6)
    with pytest.raises(ValueError, match="output rows"):
        stream_reduce_staged(rng_.res_plan, stage[:, :8].contiguous(), 9)
