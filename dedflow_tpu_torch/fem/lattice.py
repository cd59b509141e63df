"""Gather-free structured-lattice path for box meshes (counterpart of
dedflow_tpu/fem/lattice.py, single device).

On the Kuhn-subdivided box lattice (mesh.gen.box_mesh) every element-node
access is a fixed index offset: cell id = the node id of its lowest corner,
`ix + Sy*iy + Sz*iz`; vertex a of Kuhn tet ("slab") t of cell c is node
c + delta[t][a]. Cells on the far faces (ix == nx, iy == ny or iz == nz) are
dead: their geometry is zero, so their contributions are exactly zero and no
masking is needed. Geometry is slab-major (6, rows, N) with column = cell,
vectors travel component-major (6, N), and the Jacobian lands directly in
component-major DIA storage (sparse.fsbsr.FSDIAMatrixT).

Two kernels carry the path, each behind a wrapper with a launch counter:

- K1 `residual_volume`: the volume residual (6, N), with an optional nodal
  heat source (melt-pool runs). On CUDA the kernel
  csrc/lattice_residual.cu, which replaces fem/lattice.py::_res_t8_kernel of
  the JAX package: one launch of ticketed work items (an 8 x 8 node tile of
  one cell layer), each element computed once into a ring of cell layers
  that stays in the L2, each node's 24 contributions added in the plain
  version's order once its neighbours' items are done (RES_FUSED_*,
  checked against the built kernel's `residual_kernel_layout`; the
  context's `res_sync` workspace), with no element buffer in memory; on
  the CPU `residual_volume_plain`, the unfused pipeline (shifted-slice
  inputs -> element_rows.res_rows -> 24 shifted adds).
- K2 `jacobian_volume`: the finished (D, 16, N) velocity/pressure DIA data,
  Dirichlet-masked, unit diagonal on the zero-offset plane, facet band
  added. On CUDA csrc/lattice_jacobian.cu, which replaces
  fem/lattice.py::_lhs_fused_body (masked mode): one fused pass over
  (x, y) node tiles sliding up z chunks, a component group a block
  (`fused_tables`, FUSED_GROUPS, checked against the built kernel's
  `fused_kernel_layout`), with no element buffer in device memory;
  on the CPU `jacobian_volume_plain` (inputs -> element_rows.lhs_rows(ncomp=16)
  -> 96 shifted adds -> the mask epilogue).

A CUDA tensor always goes to the kernel (or raises); only a CPU tensor takes
the plain version. In the frozen-scalar mode the phi-phi / T-T components
are state independent and come from the node multiplicity `mult`, outside
the kernels. With `scalar_implicit` (melt-pool runs, the context's flag as
in the JAX LatticeContext) they are the consistent phi/T transport tangents
(element_rows.lhs_rows with 33 input rows: the 6 metric entries come from
`res_geom`), and K2 returns them too, as the (2D, N) scal rows, masked like
the rest. The JAX package builds that matrix with the 33-row K6 kernel and
a 96-slice XLA reduce (lattice.py:676-730); here K2 computes it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dedflow_tpu_torch.config import Physics, TimeScheme
from dedflow_tpu_torch.fem.element import tet_geometry
from dedflow_tpu_torch.fem.element_kernels import lhs_args as _lhs_args
from dedflow_tpu_torch.fem.element_kernels import res_args as _res_args
from dedflow_tpu_torch.fem.element_rows import (  # noqa: F401 (field_norms_t re-exported)
    field_norms_t,
    lhs_geom_rows,
    lhs_rows,
    res_geom_rows,
    res_rows,
)
from dedflow_tpu_torch.fem.face import (
    face_dia_band,
    face_lhs_packed,
    face_residual_elements,
    face_residual_scatter,
)
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS
from dedflow_tpu_torch.mesh.mesh import Mesh
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT, diag_add_rows, keep_pc_rows
from dedflow_tpu_torch.utils import nvcc


@dataclass
class LatticeContext:
    """Per-slab geometry rows + static shift tables."""

    res_geom: torch.Tensor  # (6, 19, N) element_rows.res_geom_rows, column = cell
    lhs_geom: torch.Tensor  # (6, 15, N) element_rows.lhs_geom_rows, column = cell
    # (N,) live-element multiplicity per node: the phi-phi/T-T identity
    # components of the Jacobian summed over incident live tets
    mult: torch.Tensor
    num_node: int
    dmax: int  # largest vertex offset, 1 + Sy + Sz
    deltas: tuple  # (6, 4) node offsets
    offsets: tuple  # sorted DIA column offsets
    plane_tab: tuple  # (6, 4, 4) -> plane
    # K2's fused pass: (sy, ny, nz, planes), see fused_tables
    fused: tuple
    # K1's ticket counter and item flags (res_sync_workspace), kept by the
    # kernel from call to call: calls on one context run in order
    res_sync: torch.Tensor
    # implicit phi/T transport tangents in the Jacobian (melt-pool runs)
    scalar_implicit: bool = False
    # node-grid shape (gx, gy, gz) = (nx+1, ny+1, nz+1), read by the
    # geometric multigrid preconditioner (solver.mg)
    dims: tuple | None = None


def lattice_tables(nx: int, ny: int, nz: int):
    tets = _KUHN_TETS
    nt = len(tets)
    sy, sz = nx + 1, (nx + 1) * (ny + 1)
    corner = [(o & 1) + sy * ((o >> 1) & 1) + sz * ((o >> 2) & 1) for o in range(8)]
    deltas = tuple(tuple(int(corner[c]) for c in tets[t]) for t in range(nt))
    offs = sorted(
        {deltas[t][b] - deltas[t][a] for t in range(nt) for a in range(4) for b in range(4)}
    )
    plane_of = {o: d for d, o in enumerate(offs)}
    plane_tab = tuple(
        tuple(
            tuple(plane_of[deltas[t][b] - deltas[t][a]] for b in range(4))
            for a in range(4)
        )
        for t in range(nt)
    )
    return sy, sz, deltas, tuple(offs), plane_tab


def build_lattice_context(mesh: Mesh, device, dtype, scalar_implicit: bool = False) -> LatticeContext:
    """Build from a box mesh carrying `mesh.lattice = (nx, ny, nz)`."""
    if mesh.lattice is None:
        raise ValueError("mesh has no lattice metadata")
    nx, ny, nz = mesh.lattice
    sy, sz, deltas, offs, plane_tab = lattice_tables(nx, ny, nz)
    n = mesh.num_node
    if n != (nx + 1) * (ny + 1) * (nz + 1):
        raise ValueError("node count does not match the lattice")
    cells = np.arange(n, dtype=np.int64)
    ix, iy, iz = cells % sy, (cells // sy) % (ny + 1), cells // sz
    live = (ix < nx) & (iy < ny) & (iz < nz)
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    lr, rr = [], []
    for t in range(len(deltas)):
        idx = cells[:, None] + np.asarray(deltas[t], dtype=np.int64)[None, :]
        idx = np.where(live[:, None], idx, 0)  # dead cells: degenerate
        geom = tet_geometry(xg[torch.as_tensor(idx, device=device)])
        lr.append(lhs_geom_rows(geom.shgrad, geom.det_j, geom.metric))
        rr.append(res_geom_rows(geom.shgrad, geom.det_j, geom.metric))
    lc = cells[live]
    vidx = np.concatenate([lc + deltas[t][a] for t in range(len(deltas)) for a in range(4)])
    mult = np.bincount(vidx, minlength=n).astype(np.float64)
    fused = fused_tables(deltas, offs, n)
    return LatticeContext(
        res_geom=torch.stack(rr).contiguous(),
        lhs_geom=torch.stack(lr).contiguous(),
        mult=torch.as_tensor(mult, dtype=dtype, device=device),
        num_node=n,
        dmax=max(max(d) for d in deltas),
        deltas=deltas,
        offsets=offs,
        plane_tab=plane_tab,
        fused=fused,
        res_sync=res_sync_workspace(fused, device),
        scalar_implicit=scalar_implicit,
        dims=(nx + 1, ny + 1, nz + 1),
    )


def detect_delta_classes(ien: np.ndarray, max_classes: int = 8):
    """Group tets by their vertex-offset signature relative to the
    element's minimum node id, preserving file vertex order (host copy of
    dedflow_tpu/fem/lattice.py::detect_delta_classes). Returns (keys (T, 4),
    cls_id (ne,), base (ne,)), or None when the mesh has more than
    `max_classes` translation classes or a class stamps two elements on
    the same base node."""
    ien = np.asarray(ien, dtype=np.int64)
    base = ien.min(axis=1)
    rel = ien - base[:, None]
    keys, cls_id = np.unique(rel, axis=0, return_inverse=True)
    if keys.shape[0] > max_classes:
        return None
    for t in range(keys.shape[0]):
        bt = base[cls_id.reshape(-1) == t]
        if bt.size != np.unique(bt).size:
            return None
    return keys, cls_id.reshape(-1).astype(np.int64), base


def classes_tier_applies(mesh: Mesh, mesh_offsets: tuple, dmax_limit: int = 16384) -> bool:
    """Whether the JAX package would run `mesh` on its translation-class
    tier: build_class_context returns a context (lattice.py:337-348) and
    its stencil offsets equal the mesh's sparsity offsets (the solver's
    agreement check, newton.py:597). Used only to route the tier; the
    classes tier itself is not ported (ROADMAP A10)."""
    ien = np.asarray(mesh.ien, dtype=np.int64)
    if mesh.extra_cells or ien.size == 0:
        return False
    det = detect_delta_classes(ien)
    if det is None:
        return False
    keys = det[0]
    if not 0 < int(keys.max()) <= dmax_limit:
        return False
    offs = tuple(sorted({int(kb - ka) for k in keys for ka in k for kb in k}))
    return offs == tuple(mesh_offsets)


# ---------------------------------------------------------------------------
# plain versions: shifted-slice input build / output reduction


def _residual_inputs(lctx: LatticeContext, wa_t, dwa_t, source=None) -> torch.Tensor:
    """(6, 67, N) slab-major rows for element_rows.res_rows: column c reads
    node c + delta[t][a]; nodes past N read zero. `source` (N,) is the
    nodal heat source (zero rows without one)."""
    n = lctx.num_node
    wpad = F.pad(wa_t, (0, lctx.dmax))
    dwpad = F.pad(dwa_t, (0, lctx.dmax))
    spad = None if source is None else F.pad(source[None], (0, lctx.dmax))
    zeros = torch.zeros((4, n), dtype=wa_t.dtype, device=wa_t.device)
    parts = []
    for t, d in enumerate(lctx.deltas):
        sh = lambda row, a, p: p[row : row + 1, d[a] : d[a] + n]
        rows = [lctx.res_geom[t]]
        rows += [sh(i, a, wpad) for i in range(3) for a in range(4)]  # u
        rows += [sh(i, a, dwpad) for i in range(3) for a in range(4)]  # du
        rows += [sh(3, a, dwpad) for a in range(4)]  # p (rate slot)
        rows += [sh(4, a, wpad) for a in range(4)]  # phi
        rows += [sh(5, a, wpad) for a in range(4)]  # T
        rows += [sh(4, a, dwpad) for a in range(4)]  # dphi
        rows += [sh(5, a, dwpad) for a in range(4)]  # dT
        rows += [zeros] if spad is None else [sh(0, a, spad) for a in range(4)]  # source
        parts.append(torch.cat(rows, dim=0))
    return torch.stack(parts)


def _lhs_inputs(lctx: LatticeContext, wa_t) -> torch.Tensor:
    """(6, 27, N) slab-major rows for element_rows.lhs_rows; (6, 33, N)
    with the context's scalar_implicit, the metric rows of res_geom last."""
    n = lctx.num_node
    upad = F.pad(wa_t[:3], (0, lctx.dmax))
    parts = []
    for t, d in enumerate(lctx.deltas):
        geom = lctx.lhs_geom[t]
        rows = [geom[:12]]
        rows += [upad[i : i + 1, d[a] : d[a] + n] for i in range(3) for a in range(4)]
        rows.append(geom[12:15])
        if lctx.scalar_implicit:
            rows.append(lctx.res_geom[t, 13:19])
        parts.append(torch.cat(rows, dim=0))
    return torch.stack(parts)


def _reduce_residual(lctx: LatticeContext, out) -> torch.Tensor:
    """(6, 24, N) element residual rows -> (6, N): node n receives slab t,
    vertex a from cell n - delta[t][a] (24 shifted adds, (t, a) order)."""
    n = lctx.num_node
    acc = torch.zeros((6, n), dtype=out.dtype, device=out.device)
    for t, dt_ in enumerate(lctx.deltas):
        for a in range(4):
            d = dt_[a]
            acc[:, d:] += out[t, a * 6 : a * 6 + 6, : n - d]
    return acc


def _reduce_lhs_planes(lctx: LatticeContext, out, ncomp: int) -> list:
    """(6, 16*ncomp, N) element Jacobians -> D x (ncomp, N) DIA planes (96
    shifted adds, (t, a, b) order)."""
    n = lctx.num_node
    planes = [
        torch.zeros((ncomp, n), dtype=out.dtype, device=out.device)
        for _ in lctx.offsets
    ]
    for t, dt_ in enumerate(lctx.deltas):
        for a in range(4):
            d = dt_[a]
            for b in range(4):
                r = (a * 4 + b) * ncomp
                planes[lctx.plane_tab[t][a][b]][:, d:] += out[t, r : r + ncomp, : n - d]
    return planes


def residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, source=None) -> torch.Tensor:
    """K1's plain version: (6, N) volume residual; `source` (N,) or None."""
    out = res_rows(_residual_inputs(lctx, wa_t, dwa_t, source), **_res_args(phys, scheme))
    return _reduce_residual(lctx, out)


def jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band=None, band_lo=0):
    """K2's plain version: finished (D, 16, N) data = raw planes * keep,
    + add on the zero-offset plane, + the pre-masked facet band (D, 16,
    span) over rows [band_lo, band_lo + span). Frozen mode: keep/add are
    (16, N) and the data is returned. scalar_implicit: keep/add are (18, N)
    and (data, scal) is returned, scal (2D, N) the masked phi-phi / T-T
    rows of every plane (row 2p, 2p+1)."""
    nc = 18 if lctx.scalar_implicit else 16
    out = lhs_rows(_lhs_inputs(lctx, wa_t), ncomp=nc, scalar_implicit=lctx.scalar_implicit,
                   **_lhs_args(phys, scheme))
    planes = torch.stack(_reduce_lhs_planes(lctx, out, nc)) * keep[None]
    planes[lctx.offsets.index(0)] += add
    data = planes[:, :16]
    if band is not None:
        data[:, :, band_lo : band_lo + band.shape[2]] += band
    if not lctx.scalar_implicit:
        return data
    return data.contiguous(), planes[:, 16:].reshape(-1, planes.shape[-1])


# ---------------------------------------------------------------------------
# K2's fused decomposition (csrc/lattice_jacobian.cu holds the same tables;
# _check_fused_layout holds them equal)

# The 15 planes of the Kuhn lattice by corner difference (dx, dy, dz) =
# corner b - corner a, as codes (dx+1)*9 + (dy+1)*3 + (dz+1), ascending:
# the kernel's plane order.
FUSED_PLANE_CODES = (0, 1, 3, 4, 9, 10, 12, 13, 14, 16, 17, 22, 23, 25, 26)
# Component groups, one a block: the diagonal uu components (one shared
# q-sum) with pp, and with phi-phi / T-T in the implicit mode.
FUSED_GROUPS = {
    False: ((0, 4, 8, 15), (1, 2, 3, 5), (6, 7, 9, 10), (11, 12, 13, 14)),
    True: ((0, 4, 8, 15, 16, 17), (1, 2, 3, 5, 6, 7), (9, 10, 11, 12, 13, 14)),
}
FUSED_TILE = (8, 8)  # nodes of a block in x and y
# node layers of a block, and slabs a round of the stage, by mode
# (implicit or not): the fastest of 4-56 layers and of rounds of 3 or 6
# slabs at box 55 frozen and box 44 implicit on an H100
FUSED_ZCHUNK = {False: 16, True: 8}
FUSED_ROUND_SLABS = {False: 3, True: 6}


def _corner(o: int) -> tuple:
    return o & 1, (o >> 1) & 1, (o >> 2) & 1


def fused_tables(deltas, offsets, n: int) -> tuple:
    """(sy, ny, nz, planes) of K2's fused pass for a lattice of n nodes
    with slab vertex offsets `deltas` (6, 4) and DIA offsets `offsets`:
    the nodes a row, rows a layer and layers (x fastest), and the DIA
    plane of each of the 15 planes of FUSED_PLANE_CODES.
    build_lattice_context keeps them as LatticeContext.fused. Raises unless
    the offsets are the Kuhn lattice's the kernel's tables describe."""
    sy = next(d[a] for t, d in enumerate(deltas) for a in range(4)
              if int(_KUHN_TETS[t][a]) == 2)
    sz = next(d[a] for t, d in enumerate(deltas) for a in range(4)
              if int(_KUHN_TETS[t][a]) == 4)
    ok = sy > 1 and sz % sy == 0 and n % sz == 0 and all(
        d[a] == sum(c * s for c, s in zip(_corner(int(_KUHN_TETS[t][a])), (1, sy, sz)))
        for t, d in enumerate(deltas) for a in range(4)
    )
    if not ok:
        raise ValueError("lattice_jacobian kernel: the lattice is not the 6-tet Kuhn lattice")
    planes = []
    for code in FUSED_PLANE_CODES:
        dx, dy, dz = code // 9 - 1, code // 3 % 3 - 1, code % 3 - 1
        planes.append(offsets.index(dx + sy * dy + sz * dz))
    return sy, sz // sy, n // sz, tuple(planes)


def fused_kernel_layout(implicit: bool) -> dict:
    """The tiling that csrc/lattice_jacobian.cu was compiled with, read from
    the built kernel (card only): tile, slabs a round, component groups,
    plane codes and the dynamic shared memory a block stages, in bytes."""
    fn = nvcc.function("lattice_jacobian", "dedflow_lattice_jacobian_layout",
                       [nvcc.I, nvcc.P, nvcc.I])
    buf = (ctypes.c_int * 16)()
    nvcc.check(fn(int(implicit), ctypes.addressof(buf), len(buf)), "lattice_jacobian layout")
    tx, ty, rounds, count, size, smem, codes = buf[:7]
    return {
        "tile": (tx, ty),
        "round_slabs": rounds,
        "groups": tuple(tuple(k for k in range(18) if m >> k & 1) for m in buf[7 : 7 + count]),
        "group_size": size,
        "plane_codes": tuple(c for c in range(27) if codes >> c & 1),
        "stage_bytes": smem,
    }


def _check_fused_layout(implicit: bool) -> None:
    """Raise unless the built kernel's tiling is the one FUSED_* describe
    (the tables the CPU emulation of the fused pass reads); checked once a
    mode."""
    if implicit in _check_fused_layout.done:
        return
    got = fused_kernel_layout(implicit)
    want = {"tile": FUSED_TILE, "round_slabs": FUSED_ROUND_SLABS[implicit],
            "groups": FUSED_GROUPS[implicit], "plane_codes": FUSED_PLANE_CODES}
    if any(got[k] != v for k, v in want.items()):
        raise RuntimeError(f"lattice_jacobian kernel: compiled tiling {got} is not {want}")
    _check_fused_layout.done.add(implicit)


_check_fused_layout.done = set()


# ---------------------------------------------------------------------------
# K1's fused pass (csrc/lattice_residual.cu holds the same constants;
# _check_res_layout holds them equal)

RES_FUSED_TILE = 8  # nodes of a tile in x and in y
RES_FUSED_THREADS = 128
RES_FUSED_BLOCKS_PER_SM = 3  # the kernel's launch bounds: 12 warps an SM
RES_FUSED_RING_MARGIN = 8  # ring layers beyond those the resident items span


def res_ring_layers(tiles: int, num_sms: int) -> int:
    """Cell layers of K1's ring of element values: the layers the card's
    resident items span (RES_FUSED_BLOCKS_PER_SM blocks an SM, `tiles`
    items a layer) and RES_FUSED_RING_MARGIN more, so that an item seldom
    waits for the readers of the layer its slot held."""
    return -(-RES_FUSED_BLOCKS_PER_SM * num_sms // tiles) + RES_FUSED_RING_MARGIN


def res_fused_items(sy: int, ny: int, nz: int) -> tuple:
    """(tiles in x, tiles, work items) of K1's fused pass on a lattice of
    (sy, ny, nz) nodes: 8 x 8 node tiles in (x, y); item (L, T), in
    (layer, tile) order, tiles x fastest, computes tile T's cells of cell
    layer L < nz and sums its node layer L - 1 >= 0, so L runs to nz."""
    tiles_x = -(-sy // RES_FUSED_TILE)
    tiles = tiles_x * -(-ny // RES_FUSED_TILE)
    return tiles_x, tiles, tiles * (nz + 1)


def res_sync_workspace(fused: tuple, device) -> torch.Tensor:
    """K1's persistent workspace for a lattice with K2's `fused` tables: a
    64-bit ticket counter, then each item's produced and consumed flags,
    int32 zeros; the kernel keeps it from call to call (a call takes one
    ticket an item)."""
    return torch.zeros(2 + 2 * res_fused_items(*fused[:3])[2], dtype=torch.int32, device=device)


def residual_kernel_layout() -> dict:
    """The tiling that csrc/lattice_residual.cu was compiled with, read from
    the built kernel (card only): tile, threads a block, blocks an SM,
    floats of a tile's cell layer in the ring, and its Kuhn corner table
    (corner code a (t, a) pair, t-major)."""
    fn = nvcc.function("lattice_residual", "dedflow_lattice_residual_layout", [nvcc.P, nvcc.I])
    buf = (ctypes.c_int * 28)()
    nvcc.check(fn(ctypes.addressof(buf), len(buf)), "lattice_residual layout")
    return {
        "tile": buf[0],
        "threads": buf[1],
        "blocks_per_sm": buf[2],
        "slot_floats": buf[3],
        "corners": tuple(buf[4:28]),
    }


def _check_res_layout() -> None:
    """Raise unless the built K1's tiling is the one RES_FUSED_* and the
    Kuhn table describe (the tables the CPU emulation reads); checked
    once."""
    if _check_res_layout.done:
        return
    got = residual_kernel_layout()
    want = {"tile": RES_FUSED_TILE, "threads": RES_FUSED_THREADS,
            "blocks_per_sm": RES_FUSED_BLOCKS_PER_SM, "slot_floats": 24 * 6 * RES_FUSED_TILE**2,
            "corners": tuple(int(c) for tet in _KUHN_TETS for c in tet)}
    if any(got[k] != v for k, v in want.items()):
        raise RuntimeError(f"lattice_residual kernel: compiled tiling {got} is not {want}")
    _check_res_layout.done = True


_check_res_layout.done = False


# ---------------------------------------------------------------------------
# kernel wrappers


def _check_f32_cuda(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous float32 CUDA tensor "
                f"(got {t.dtype}, {t.device}, contiguous={t.is_contiguous()})"
            )


def _flat_deltas(lctx):
    return nvcc.int_array(v for d in lctx.deltas for v in d)


def residual_volume(lctx: LatticeContext, wa_t, dwa_t, phys, scheme, source=None) -> torch.Tensor:
    """K1: (6, N) volume residual from the alpha states (6, N) and the
    nodal heat source `source` (N,) or None."""
    if not wa_t.is_cuda:
        return residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, source)
    n = lctx.num_node
    _check_f32_cuda("lattice_residual", wa_t=wa_t, dwa_t=dwa_t, res_geom=lctx.res_geom,
                    **({} if source is None else {"source": source}))
    if wa_t.shape != (6, n) or dwa_t.shape != (6, n) or (source is not None and source.shape != (n,)):
        raise ValueError("lattice_residual kernel: states must be (6, N), a source (N,)")
    fn = nvcc.function(
        "lattice_residual", "dedflow_lattice_residual",
        [nvcc.P] * 6 + [nvcc.I, nvcc.P] + [nvcc.I] * 4 + [nvcc.P] + [nvcc.D] * 8 + [nvcc.P],
    )
    _check_res_layout()
    sy, ny, nz, _ = lctx.fused
    if lctx.res_sync.device != wa_t.device:
        raise ValueError("lattice_residual kernel: the context lives on another device")
    dev = wa_t.device
    tiles = res_fused_items(sy, ny, nz)[1]
    layers = res_ring_layers(tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    ring = torch.empty(layers * tiles * 24 * 6 * RES_FUSED_TILE**2, dtype=torch.float32,
                       device=dev)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    a = _res_args(phys, scheme)
    nvcc.check(
        fn(lctx.res_geom.data_ptr(), wa_t.data_ptr(), dwa_t.data_ptr(),
           None if source is None else source.data_ptr(), out.data_ptr(), ring.data_ptr(), layers,
           lctx.res_sync.data_ptr(), n, sy, ny, nz, _flat_deltas(lctx),
           a["rho"], a["mu"], a["cp"], a["kappa"], *a["fb"], a["dt"],
           torch.cuda.current_stream(dev).cuda_stream),
        "lattice_residual",
    )
    residual_volume.launches += 1
    return out


residual_volume.launches = 0


def jacobian_volume(lctx: LatticeContext, wa_t, phys, scheme, keep, add, band=None, band_lo=0):
    """K2: the finished (D, 16, N) velocity/pressure DIA data, and with the
    context's scalar_implicit also the (2D, N) scal rows (see
    jacobian_volume_plain for the contract)."""
    if not wa_t.is_cuda:
        return jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
    n, nd = lctx.num_node, len(lctx.offsets)
    implicit = lctx.scalar_implicit
    nc = 18 if implicit else 16
    _check_f32_cuda(
        "lattice_jacobian", wa_t=wa_t, keep=keep, add=add, lhs_geom=lctx.lhs_geom,
        res_geom=lctx.res_geom, **({} if band is None else {"band": band}),
    )
    if wa_t.shape != (6, n) or keep.shape != (nc, n) or add.shape != (nc, n):
        raise ValueError(f"lattice_jacobian kernel: states (6, N), keep and add ({nc}, N)")
    sy, ny, nz, planes = lctx.fused
    span = 0
    if band is not None:
        span = band.shape[2]
        if band.shape[:2] != (nd, 16) or band_lo < 0 or band_lo + span > n:
            raise ValueError("lattice_jacobian kernel: band outside the matrix")
    fn = nvcc.function(
        "lattice_jacobian", "dedflow_lattice_jacobian",
        [nvcc.P] * 6 + [nvcc.I, nvcc.I, nvcc.P, nvcc.P] + [nvcc.I] * 5 + [nvcc.P, nvcc.P]
        + [nvcc.D] * 7 + [nvcc.P],
    )
    _check_fused_layout(implicit)
    dev = wa_t.device
    out = torch.empty((nd, 16, n), dtype=torch.float32, device=dev)
    scal = torch.empty((2 * nd, n), dtype=torch.float32, device=dev) if implicit else None
    a = _lhs_args(phys, scheme)
    nvcc.check(
        fn(lctx.lhs_geom.data_ptr(), lctx.res_geom.data_ptr() if implicit else None,
           wa_t.data_ptr(), keep.data_ptr(), add.data_ptr(),
           None if band is None else band.data_ptr(), int(band_lo), span,
           out.data_ptr(), None if scal is None else scal.data_ptr(), n, sy, ny, nz,
           FUSED_ZCHUNK[implicit], _flat_deltas(lctx), nvcc.int_array(planes),
           a["rho"], a["mu"], a["f1"], a["f2"], a["dt"], a["cp"],
           a["kappa"], torch.cuda.current_stream(dev).cuda_stream),
        "lattice_jacobian",
    )
    jacobian_volume.launches += 1
    return (out, scal) if implicit else out


jacobian_volume.launches = 0


# ---------------------------------------------------------------------------
# assembly entry points


def assemble_residual_t(
    lctx: LatticeContext,
    face_ctxs: tuple,
    mask_t: torch.Tensor,  # (6, N) boolean
    w_alpha: torch.Tensor,  # (N, 6)
    dw_alpha: torch.Tensor,  # (N, 6)
    phys: Physics,
    scheme: TimeScheme,
    freeze_phi_temperature: bool = True,
    nodal_force: torch.Tensor | None = None,  # (N, 3)
    source: torch.Tensor | None = None,  # (N,)
) -> torch.Tensor:
    """Global residual F as (6, N) (AssembleSystem, main.c:31-75).
    `nodal_force` (N, 3), an already-integrated nodal momentum load (the
    DEM drag reaction), is subtracted from the momentum rows after the
    volume terms and before the facet terms, freeze and mask, where the
    JAX package places it (fem/lattice.py:543-544 there). `source` (N,) is
    the nodal volumetric heat source of the T equation (melt-pool runs)."""
    f = residual_volume(
        lctx, w_alpha.T.contiguous(), dw_alpha.T.contiguous(), phys, scheme,
        None if source is None else source.contiguous(),
    ).to(w_alpha.dtype)
    if nodal_force is not None:
        f[:3] -= nodal_force.T
    for fctx in face_ctxs:
        face_residual_scatter(fctx, f, face_residual_elements(fctx, w_alpha, dw_alpha, phys))
    if freeze_phi_temperature:
        f[4:] = 0.0  # main.c:64
    return f.masked_fill(mask_t, 0.0)


def _masked_face_band(
    face_ctxs: tuple, w_alpha, dw_alpha, phys, scheme, num_planes, keep_pc
):
    """The facet Jacobian of every weak boundary, pre-masked by the keep
    factors of its rows and merged into one (D, 16, span) band over
    [lo, lo + span); (None, 0) without weak boundaries. The phi/T rows
    (components 16/17) are identically zero there."""
    if not face_ctxs:
        return None, 0
    lo = min(f.dia_row_lo for f in face_ctxs)
    hi = max(f.dia_row_lo + f.dia_row_span for f in face_ctxs)
    band = torch.zeros(
        (num_planes, 16, hi - lo), dtype=w_alpha.dtype, device=w_alpha.device
    )
    for fctx in face_ctxs:
        blk = face_dia_band(
            fctx, face_lhs_packed(fctx, w_alpha, dw_alpha, phys, scheme), num_planes
        )
        r0, span = fctx.dia_row_lo, fctx.dia_row_span
        blk = blk[:, :16] * keep_pc[None, :16, r0 : r0 + span]
        band[:, :, r0 - lo : r0 - lo + span] += blk
    return band, lo


def assemble_jacobian_t(
    lctx: LatticeContext,
    face_ctxs: tuple,
    mask_t: torch.Tensor,  # (6, N) boolean
    w_alpha: torch.Tensor,  # (N, 6)
    dw_alpha: torch.Tensor,  # (N, 6)
    phys: Physics,
    scheme: TimeScheme,
) -> FSDIAMatrixT:
    """Global field-split Jacobian in component-major DIA storage,
    Dirichlet rows zeroed with a unit diagonal. The phi/T rows are the
    frozen-scalar identities, or with the context's scalar_implicit the
    consistent transport tangents, which K2 reduces into every plane."""
    dtype = w_alpha.dtype
    nd = len(lctx.offsets)
    d0 = lctx.offsets.index(0)
    keep_pc = keep_pc_rows(mask_t, dtype)
    add18 = diag_add_rows(mask_t, dtype)
    band, lo = _masked_face_band(
        face_ctxs, w_alpha, dw_alpha, phys, scheme, nd, keep_pc
    )
    if lctx.scalar_implicit:
        data, scal = jacobian_volume(
            lctx, w_alpha.T.contiguous(), phys, scheme, keep_pc, add18, band, lo
        )
        return FSDIAMatrixT(data=data.to(dtype), scal=scal.to(dtype), offsets=lctx.offsets)
    data = jacobian_volume(
        lctx, w_alpha.T.contiguous(), phys, scheme,
        keep_pc[:16].contiguous(), add18[:16].contiguous(), band, lo,
    )
    # phi-phi / T-T identity components: state-independent nodal
    # multiplicity on the zero-offset plane
    scal = torch.zeros((2 * nd, lctx.num_node), dtype=dtype, device=w_alpha.device)
    scal[2 * d0 : 2 * d0 + 2] = lctx.mult.to(dtype) * keep_pc[16:18] + add18[16:18]
    return FSDIAMatrixT(data=data.to(dtype), scal=scal, offsets=lctx.offsets)
