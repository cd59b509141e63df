"""Gather-free structured-lattice path (counterpart of
dedflow_tpu/fem/lattice.py).

On the Kuhn-subdivided box lattice (mesh.gen.box_mesh) every element-node
access is a fixed index offset: cell id = the node id of its lowest corner,
`ix + Sy*iy + Sz*iz`; vertex a of Kuhn tet ("slab") t of cell c is node
c + delta[t][a]. Cells on the far faces (ix == nx, iy == ny or iz == nz) are
dead: their geometry is zero, so their contributions are exactly zero and no
masking is needed. Geometry is slab-major (T, rows, N) with column = cell,
vectors travel component-major (6, N), and the Jacobian lands directly in
component-major DIA storage (sparse.fsbsr.FSDIAMatrixT). The same machinery
serves any table of T <= 8 slabs: a recovered lattice whose cells carry
another split (`mesh.lattice_tets`, mesh.recover) and the translation-class
tier of a mesh without generator metadata (build_class_context: one slab a
class of equal vertex-offset signature, column = the element's base node,
zero geometry on the lanes without an element of that class).

Two kernels carry the path, each behind a wrapper with a launch counter,
and each has a second entry for any cell table:

- K1 `residual_volume`: the volume residual (6, N), with an optional nodal
  heat source (melt-pool runs). On CUDA, for the Kuhn split of a box (the
  context's `fused` tables), the kernel csrc/lattice_residual.cu, which
  replaces fem/lattice.py::_res_t8_kernel of the JAX package: one launch of
  ticketed work items (an 8 x 8 node tile of one cell layer), each element
  computed once into a ring of cell layers that stays in the L2, each
  node's 24 contributions added in the plain version's order once its
  neighbours' items are done (RES_FUSED_*, checked against the built
  kernel's `residual_kernel_layout`; the context's `res_sync` workspace),
  with no element buffer in memory. Any other table goes to K1c
  `residual_volume_classes`: where grid_tables places the table on a node
  grid (`grid`), the same ticketed kernel over the run-time table
  (csrc/lattice_residual.cu); where it does not, `residual_volume_two_pass`
  (csrc/lattice_classes.cu: an element pass into a (T, 24, N) buffer, then
  the node sums in the plain order). On the CPU `residual_volume_plain`,
  the unfused pipeline (shifted-slice inputs -> element_rows.res_rows -> 4T
  shifted adds).
- K2 `jacobian_volume`: the finished (D, 16, N) velocity/pressure DIA data,
  Dirichlet-masked, unit diagonal on the zero-offset plane, facet band
  added. On CUDA, for the Kuhn split, csrc/lattice_jacobian.cu, which
  replaces fem/lattice.py::_lhs_fused_body (masked mode): one fused pass
  over (x, y) node tiles sliding up z chunks, a component group a block
  (`fused_tables`, FUSED_GROUPS, checked against the built kernel's
  `fused_kernel_layout`), with no element buffer in device memory; any
  other table goes to K2c `jacobian_volume_classes`: on a node grid the
  same fused pass over the run-time table, its plane sums in shared memory
  (csrc/lattice_jacobian.cu, GRID_ROUND_SLABS); off one
  `jacobian_volume_two_pass` (csrc/lattice_classes.cu: an element pass
  into a (T, 16 * ncomp, N) buffer, then a plane pass in the plain order,
  `plane_entries`, with the epilogue); on the CPU `jacobian_volume_plain`
  (inputs -> element_rows.lhs_rows(ncomp=16) -> 16T shifted adds -> the
  mask epilogue).

A rank of a z-slab decomposition (parallel.sharded; the JAX package's
`*_shmap` functions) builds the lattice context of its own sub-box
(build_slab_context) and runs the same K1 / K2 on it; assemble_residual_slab
and assemble_jacobian_slab add the halo layer's carries between neighbours.

A CUDA tensor always goes to a kernel (or raises); only a CPU tensor takes
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
    build_face_context,
    face_dia_band,
    face_lhs_packed,
    face_residual_elements,
    face_residual_scatter,
)
from dedflow_tpu_torch.mesh.gen import _KUHN_TETS
from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT, diag_add_rows, keep_pc_rows
from dedflow_tpu_torch.utils import nvcc


@dataclass
class LatticeContext:
    """Per-slab geometry rows + static shift tables."""

    res_geom: torch.Tensor  # (T, 19, N) element_rows.res_geom_rows, column = cell
    lhs_geom: torch.Tensor  # (T, 15, N) element_rows.lhs_geom_rows, column = cell
    # (N,) live-element multiplicity per node: the phi-phi/T-T identity
    # components of the Jacobian summed over incident live tets
    mult: torch.Tensor
    num_node: int
    dmax: int  # largest vertex offset (1 + Sy + Sz on a box)
    deltas: tuple  # (T, 4) node offsets, T <= 8 slabs
    offsets: tuple  # sorted DIA column offsets
    plane_tab: tuple  # (T, 4, 4) -> plane
    # K2's fused pass: (sy, ny, nz, planes), see fused_tables; None unless
    # the table is the Kuhn split of a box (then K1c / K2c run instead)
    fused: tuple | None
    # K1's and K1c's ticket counter and item flags (res_sync_workspace),
    # kept by the kernels from call to call: calls on one context run in
    # order; None without `grid`
    res_sync: torch.Tensor | None
    # implicit phi/T transport tangents in the Jacobian (melt-pool runs)
    scalar_implicit: bool = False
    # node-grid shape (gx, gy, gz) = (nx+1, ny+1, nz+1), read by the
    # geometric multigrid preconditioner (solver.mg)
    dims: tuple | None = None
    # the table placed on a node grid, (sy, ny, nz, corners, shifts) of
    # grid_tables: K1c / K2c's one-pass kernels; None where it does not
    # place (then their two-pass kernels run)
    grid: tuple | None = None


def _plane_tables(deltas: tuple) -> tuple:
    """(sorted DIA offsets, plane_tab (T, 4, 4)) of slab vertex offsets
    `deltas` (T, 4): plane_tab[t][a][b] is the plane of delta[t][b] -
    delta[t][a]."""
    nt = len(deltas)
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
    return tuple(offs), plane_tab


def lattice_tables(nx: int, ny: int, nz: int, tets=None):
    """(sy, sz, deltas, offsets, plane_tab) of the (nx, ny, nz) lattice whose
    cells carry the (T, 4) cube-corner tets `tets` (corner = ix + 2*iy +
    4*iz; None: the generator's Kuhn split), as the JAX package's
    _lattice_tables (lattice.py:119)."""
    if tets is None:
        tets = _KUHN_TETS
    nt = len(tets)
    sy, sz = nx + 1, (nx + 1) * (ny + 1)
    corner = [(o & 1) + sy * ((o >> 1) & 1) + sz * ((o >> 2) & 1) for o in range(8)]
    deltas = tuple(tuple(int(corner[c]) for c in tets[t]) for t in range(nt))
    offs, plane_tab = _plane_tables(deltas)
    return sy, sz, deltas, offs, plane_tab


def is_kuhn_split(tets) -> bool:
    """Whether a mesh's `lattice_tets` is the generator's Kuhn split, vertex
    order included (None stands for it): the fused K1 / K2 take only that
    table."""
    return tets is None or np.array_equal(np.asarray(tets), _KUHN_TETS)


def build_lattice_context(mesh: Mesh, device, dtype, scalar_implicit: bool = False) -> LatticeContext:
    """Build from a box mesh carrying `mesh.lattice = (nx, ny, nz)` and, for
    a recovered mesh, its cells' split `mesh.lattice_tets`. The fused K1 /
    K2 tables (`fused`) only for the Kuhn split; any other table goes to
    K1c / K2c, which take every split placed on the box's node grid
    (`grid`; `res_sync` serves K1 and K1c)."""
    if mesh.lattice is None:
        raise ValueError("mesh has no lattice metadata")
    nx, ny, nz = mesh.lattice
    sy, sz, deltas, offs, plane_tab = lattice_tables(nx, ny, nz, mesh.lattice_tets)
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
    mult = _live_multiplicity(cells[live], deltas, n)
    fused = fused_tables(deltas, offs, n) if is_kuhn_split(mesh.lattice_tets) else None
    return _with_grid(LatticeContext(
        res_geom=torch.stack(rr).contiguous(),
        lhs_geom=torch.stack(lr).contiguous(),
        mult=torch.as_tensor(mult, dtype=dtype, device=device),
        num_node=n,
        dmax=max(max(d) for d in deltas),
        deltas=deltas,
        offsets=offs,
        plane_tab=plane_tab,
        fused=fused,
        res_sync=None,
        scalar_implicit=scalar_implicit,
        dims=(nx + 1, ny + 1, nz + 1),
    ), device)


def _live_multiplicity(live_cells: np.ndarray, deltas: tuple, n: int) -> np.ndarray:
    """(n,) float64: the live elements incident to each node (the cells
    `live_cells` times the slabs' vertex offsets)."""
    vidx = np.concatenate([live_cells + d[a] for d in deltas for a in range(4)])
    return np.bincount(vidx, minlength=n).astype(np.float64)


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


def _mesh_classes(mesh: Mesh, max_classes: int = 8, dmax_limit: int = 16384):
    """(keys, cls_id, base) of detect_delta_classes when the JAX package's
    build_class_context would build a context for `mesh` (lattice.py:337-348:
    tets only, at most `max_classes` classes, 0 < dmax <= dmax_limit), else
    None."""
    ien = np.asarray(mesh.ien, dtype=np.int64)
    if mesh.extra_cells or ien.size == 0:
        return None
    det = detect_delta_classes(ien, max_classes)
    if det is None or not 0 < int(det[0].max()) <= dmax_limit:
        return None
    return det


def classes_tier_applies(mesh: Mesh, mesh_offsets: tuple) -> bool:
    """Whether the JAX package would run `mesh` on its translation-class
    tier: build_class_context returns a context and its stencil offsets
    equal the mesh's sparsity offsets (the solver's agreement check,
    newton.py:597)."""
    det = _mesh_classes(mesh)
    return det is not None and _plane_tables(
        tuple(tuple(int(d) for d in k) for k in det[0]))[0] == tuple(mesh_offsets)


def build_class_context(
    mesh: Mesh, device, dtype, max_classes: int = 8, dmax_limit: int = 16384,
    scalar_implicit: bool = False,
) -> LatticeContext | None:
    """The translation-class tier for meshes without generator metadata
    (counterpart of dedflow_tpu/fem/lattice.py::build_class_context, :314):
    classes of equal vertex-offset signature from `ien` alone
    (detect_delta_classes, the file's vertex order kept), one slab a class,
    geometry at column = the element's base node (its smallest node id) and
    zero geometry on the lanes without an element of that class (their
    contributions are exact zeros, as a box's dead cells'), `mult` the node
    multiplicity over all of `ien`, no node grid (`dims` None). None when the
    mesh is not translation-regular. Its tables are not the Kuhn box's, so
    K1c / K2c assemble it on the card: in one pass where grid_tables places
    the table on a node grid (`grid`, `res_sync`), else in two
    (csrc/lattice_classes.cu)."""
    det = _mesh_classes(mesh, max_classes, dmax_limit)
    if det is None:
        return None
    keys, cls_id, base = det
    ien = np.asarray(mesh.ien, dtype=np.int64)
    dmax = int(keys.max())
    deltas = tuple(tuple(int(d) for d in k) for k in keys)
    offs, plane_tab = _plane_tables(deltas)
    n = mesh.num_node
    xg = torch.as_tensor(mesh.xg, dtype=dtype, device=device)
    lr, rr = [], []
    for t in range(len(deltas)):
        sel = np.nonzero(cls_id == t)[0]
        geom = tet_geometry(xg[torch.as_tensor(ien[sel], device=device)])
        bt = torch.as_tensor(base[sel], device=device)
        for rows, out in ((lhs_geom_rows(geom.shgrad, geom.det_j, geom.metric), lr),
                          (res_geom_rows(geom.shgrad, geom.det_j, geom.metric), rr)):
            full = torch.zeros((rows.shape[0], n), dtype=dtype, device=device)
            full[:, bt] = rows
            out.append(full)
    mult = np.bincount(ien.ravel(), minlength=n).astype(np.float64)
    return _with_grid(LatticeContext(
        res_geom=torch.stack(rr).contiguous(),
        lhs_geom=torch.stack(lr).contiguous(),
        mult=torch.as_tensor(mult, dtype=dtype, device=device),
        num_node=n,
        dmax=dmax,
        deltas=deltas,
        offsets=offs,
        plane_tab=plane_tab,
        fused=None,
        res_sync=None,
        scalar_implicit=scalar_implicit,
        dims=None,
    ), device)


# ---------------------------------------------------------------------------
# plain versions: shifted-slice input build / output reduction


def _residual_inputs(lctx: LatticeContext, wa_t, dwa_t, source=None) -> torch.Tensor:
    """(T, 67, N) slab-major rows for element_rows.res_rows: column c reads
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
    """(T, 27, N) slab-major rows for element_rows.lhs_rows; (T, 33, N)
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
    """(T, 24, N) element residual rows -> (6, N): node n receives slab t,
    vertex a from cell n - delta[t][a] (4T shifted adds, (t, a) order)."""
    n = lctx.num_node
    acc = torch.zeros((6, n), dtype=out.dtype, device=out.device)
    for t, dt_ in enumerate(lctx.deltas):
        for a in range(4):
            d = dt_[a]
            acc[:, d:] += out[t, a * 6 : a * 6 + 6, : n - d]
    return acc


def _reduce_lhs_planes(lctx: LatticeContext, out, ncomp: int) -> list:
    """(T, 16*ncomp, N) element Jacobians -> D x (ncomp, N) DIA planes (16T
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


def res_ring_layers(tiles: int, num_sms: int, slabs: int = 6) -> int:
    """Cell layers of K1's ring of element values: the layers the card's
    resident items span (RES_FUSED_BLOCKS_PER_SM blocks an SM, `tiles`
    items a layer) and RES_FUSED_RING_MARGIN more, so that an item seldom
    waits for the readers of the layer its slot held. A slot holds `slabs`
    slabs' values; past six (K1c on wider tables) the ring keeps the bytes
    of the six-slab ring (31 MB at box 55, in the L2), at least two layers
    beyond the resident ones."""
    base = -(-RES_FUSED_BLOCKS_PER_SM * num_sms // tiles)
    layers = base + RES_FUSED_RING_MARGIN
    return layers if slabs <= 6 else max(base + 2, layers * 6 // slabs)


def res_fused_items(sy: int, ny: int, nz: int) -> tuple:
    """(tiles in x, tiles, work items) of K1's fused pass on a lattice of
    (sy, ny, nz) nodes: 8 x 8 node tiles in (x, y); item (L, T), in
    (layer, tile) order, tiles x fastest, computes tile T's cells of cell
    layer L < nz and sums its node layer L - 1 >= 0, so L runs to nz."""
    tiles_x = -(-sy // RES_FUSED_TILE)
    tiles = tiles_x * -(-ny // RES_FUSED_TILE)
    return tiles_x, tiles, tiles * (nz + 1)


def res_sync_workspace(tables: tuple, device) -> torch.Tensor:
    """K1's and K1c's persistent workspace for a lattice of (sy, ny, nz) =
    tables[:3] nodes (K2's `fused` tables or the context's `grid`): a
    64-bit ticket counter, then each item's produced and consumed flags,
    int32 zeros; the kernels keep it from call to call (a call takes one
    ticket an item, whichever of the two it launches)."""
    return torch.zeros(2 + 2 * res_fused_items(*tables[:3])[2], dtype=torch.int32, device=device)


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
# A cell table placed on a node grid: the one-pass K1c / K2c, which
# csrc/lattice_residual.cu and csrc/lattice_jacobian.cu build from the
# ticketed K1's and the fused K2's code over a run-time table


def _corner_offsets(sy: int, sz: int) -> list:
    """Node offset of each cell corner o = ix + 2*iy + 4*iz on a grid of
    strides (1, sy, sz)."""
    return [(o & 1) + sy * ((o >> 1) & 1) + sz * (o >> 2) for o in range(8)]


def _place_slabs(deltas, sy: int, sz: int):
    """(corners, shifts) that put every vertex a of slab t on the cell
    corner corners[t][a] with delta[t][a] + shifts[t] its offset on the
    grid of strides (1, sy, sz), each slab with the smallest shift that
    places it; None when a slab does not place."""
    offs = _corner_offsets(sy, sz)
    corner_at = {o: c for c, o in enumerate(offs)}
    corners, shifts = [], []
    for d in deltas:
        shift = next((s for s in sorted(offs) if all(v + s in corner_at for v in d)), None)
        if shift is None:
            return None
        corners.append(tuple(corner_at[v + shift] for v in d))
        shifts.append(shift)
    return tuple(corners), tuple(shifts)


def _cells_inside(lctx: LatticeContext, sy: int, ny: int, nz: int, shifts) -> bool:
    """Whether every column that holds an element of slab t (nonzero
    geometry) is a cell inside the grid (x < sy - 1, y < ny - 1, z < nz -
    1) plus shifts[t]: then the columns a cell left of, below or under the
    grid stands for (x = -1 and y = -1 wrap to the previous row's and
    layer's last cells) hold no element, and their contributions are exact
    zeros, as a box's dead cells'."""
    live = ((lctx.res_geom != 0).any(dim=1) | (lctx.lhs_geom != 0).any(dim=1)).cpu().numpy()
    for t, s in enumerate(shifts):
        cell = np.nonzero(live[t])[0] - s
        if cell.size and (cell.min() < 0 or (cell % sy).max() > sy - 2
                          or (cell // sy % ny).max() > ny - 2
                          or (cell // (sy * ny)).max() > nz - 2):
            return False
    return True


def grid_tables(lctx: LatticeContext):
    """(sy, ny, nz, corners, shifts): the context's table placed on a node
    grid of sy nodes a row, ny rows a layer and nz layers (x fastest), or
    None. Slab t's element at column c is the cell c - shifts[t], and its
    vertex a the cell's corner corners[t][a] (0..7, bits x, y, z):
    delta[t][a] + shifts[t] = cx + sy*cy + sz*cz. A lattice context
    (`dims`) takes its own grid (shifts 0, corners its split's). A class
    context derives (sy, sz) from its offsets: the first pair, sy then sz
    ascending, with sz a multiple of sy and a divisor of N, on which every
    slab places and every element lies inside the grid (_cells_inside)."""
    n = lctx.num_node
    if lctx.dims is not None:
        gx, gy, _ = lctx.dims
        cands = [(gx, gx * gy)]
    else:
        pos = [o for o in lctx.offsets if o > 0]
        cands = [(sy, sz) for sy in sorted({o + dx for o in pos for dx in (-1, 0, 1)})
                 for sz in sorted({o - dx - sy * dy for o in pos for dx in (-1, 0, 1)
                                   for dy in (-1, 0, 1)})]
    for sy, sz in cands:
        if sy < 2 or sz < 2 * sy or sz % sy or n % sz:
            continue
        placed = _place_slabs(lctx.deltas, sy, sz)
        if placed is None:
            continue
        if lctx.dims is None and not _cells_inside(lctx, sy, sz // sy, n // sz, placed[1]):
            continue
        return (sy, sz // sy, n // sz) + placed
    return None


def _with_grid(lctx: LatticeContext, device) -> LatticeContext:
    """The context with its `grid` (grid_tables) and, where it placed, the
    ticket workspace K1 / K1c keep (`res_sync`)."""
    lctx.grid = grid_tables(lctx)
    if lctx.grid is not None:
        lctx.res_sync = res_sync_workspace(lctx.grid, device)
    return lctx


# K2c's one-pass kernel stages the elements of a round of slabs (K2's
# tiling, FUSED_TILE and FUSED_GROUPS) and keeps its plane sums in shared
# memory beside the stage. Slabs a round, by mode: frozen three (two
# blocks an SM, as K2), implicit four (one block; six or eight slabs in two
# element passes a layer, as K2's one round of six). The kernel refuses
# any other value.
FUSED_HALO = (FUSED_TILE[0] + 1) * (FUSED_TILE[1] + 1)  # cells a block computes a layer
GRID_ROUND_SLABS = {False: 3, True: 4}

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
    nodal heat source `source` (N,) or None. A context without the fused
    tables (any cell table but a box's Kuhn split) goes to K1c."""
    if not wa_t.is_cuda:
        return residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, source)
    if lctx.fused is None:
        return residual_volume_classes(lctx, wa_t, dwa_t, phys, scheme, source)
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
    jacobian_volume_plain for the contract). A context without the fused
    tables goes to K2c."""
    if not wa_t.is_cuda:
        return jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
    if lctx.fused is None:
        return jacobian_volume_classes(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
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
# K1c / K2c: any table of T <= 8 slabs. One pass where the table placed on a
# node grid (`grid`: csrc/lattice_residual.cu and csrc/lattice_jacobian.cu,
# the templates of K1 and K2 over a run-time table); two passes through a
# (T, rows, N) element buffer where it did not (csrc/lattice_classes.cu)

MAX_CLASSES = 8  # the slabs the kernels take


def _check_class_tables(what: str, lctx: LatticeContext) -> None:
    nt = len(lctx.deltas)
    if not 1 <= nt <= MAX_CLASSES or any(len(d) != 4 for d in lctx.deltas):
        raise ValueError(f"{what} kernel: {nt} slabs; it takes 1 to {MAX_CLASSES} of 4 vertices")
    if lctx.res_geom.shape[0] != nt or lctx.lhs_geom.shape[0] != nt:
        raise ValueError(f"{what} kernel: geometry for {lctx.res_geom.shape[0]} slabs, tables "
                         f"for {nt}")


def _check_residual_args(what: str, lctx: LatticeContext, wa_t, dwa_t, source) -> None:
    n = lctx.num_node
    _check_class_tables(what, lctx)
    _check_f32_cuda(what, wa_t=wa_t, dwa_t=dwa_t, res_geom=lctx.res_geom,
                    **({} if source is None else {"source": source}))
    if wa_t.shape != (6, n) or dwa_t.shape != (6, n) or (source is not None and source.shape != (n,)):
        raise ValueError(f"{what} kernel: states must be (6, N), a source (N,)")


def residual_volume_classes(lctx: LatticeContext, wa_t, dwa_t, phys, scheme,
                            source=None) -> torch.Tensor:
    """K1c: the function of residual_volume_plain for any table of T <= 8
    slabs. On CUDA, where the context's table placed on a node grid
    (`grid`), one launch of the ticketed K1 over the run-time table
    (csrc/lattice_residual.cu, `dedflow_lattice_residual_grid`): work items
    of an 8 x 8 node tile and a cell layer, the tile's T x 64 elements
    computed once into a ring of cell layers in the L2, each node's 4T
    contributions added in the plain (t, a) order from +0.0f (so on a Kuhn
    context it equals the ticketed K1 bit for bit), with the context's
    `res_sync` workspace; where it did not place, residual_volume_two_pass;
    on the CPU the plain version."""
    if not wa_t.is_cuda:
        return residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, source)
    if lctx.grid is None:
        return residual_volume_two_pass(lctx, wa_t, dwa_t, phys, scheme, source)
    n, nt = lctx.num_node, len(lctx.deltas)
    _check_residual_args("lattice_residual_grid", lctx, wa_t, dwa_t, source)
    fn = nvcc.function(
        "lattice_residual", "dedflow_lattice_residual_grid",
        [nvcc.P] * 6 + [nvcc.I, nvcc.P] + [nvcc.I] * 5 + [nvcc.P] * 3 + [nvcc.D] * 8 + [nvcc.P],
    )
    _check_res_layout()
    sy, ny, nz, corners, shifts = lctx.grid
    if lctx.res_sync.device != wa_t.device:
        raise ValueError("lattice_residual_grid kernel: the context lives on another device")
    dev = wa_t.device
    tiles = res_fused_items(sy, ny, nz)[1]
    layers = res_ring_layers(tiles, torch.cuda.get_device_properties(dev).multi_processor_count,
                             nt)
    ring = torch.empty(layers * tiles * 24 * nt * RES_FUSED_TILE**2, dtype=torch.float32,
                       device=dev)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    a = _res_args(phys, scheme)
    nvcc.check(
        fn(lctx.res_geom.data_ptr(), wa_t.data_ptr(), dwa_t.data_ptr(),
           None if source is None else source.data_ptr(), out.data_ptr(), ring.data_ptr(), layers,
           lctx.res_sync.data_ptr(), n, sy, ny, nz, nt, _flat_deltas(lctx),
           nvcc.int_array(c for cs in corners for c in cs), nvcc.int_array(shifts),
           a["rho"], a["mu"], a["cp"], a["kappa"], *a["fb"], a["dt"],
           torch.cuda.current_stream(dev).cuda_stream),
        "lattice_residual_grid",
    )
    residual_volume_classes.launches += 1
    return out


residual_volume_classes.launches = 0  # the one-pass kernel's


def residual_volume_two_pass(lctx: LatticeContext, wa_t, dwa_t, phys, scheme,
                             source=None) -> torch.Tensor:
    """K1c's two passes, for a table that does not place on a node grid
    (and held against the plain version on the card): on CUDA
    csrc/lattice_classes.cu, an element pass, a thread a (slab, base
    node), into a (T, 24, N) buffer, then a node pass that adds each
    node's 4T contributions in the plain (t, a) order; on the CPU the
    plain version."""
    if not wa_t.is_cuda:
        return residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, source)
    n, nt = lctx.num_node, len(lctx.deltas)
    _check_residual_args("lattice_residual_classes", lctx, wa_t, dwa_t, source)
    fn = nvcc.function(
        "lattice_classes", "dedflow_lattice_residual_classes",
        [nvcc.P] * 6 + [nvcc.I, nvcc.I, nvcc.P] + [nvcc.D] * 8 + [nvcc.P],
    )
    dev = wa_t.device
    elem = torch.empty((nt, 24, n), dtype=torch.float32, device=dev)
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    a = _res_args(phys, scheme)
    nvcc.check(
        fn(lctx.res_geom.data_ptr(), wa_t.data_ptr(), dwa_t.data_ptr(),
           None if source is None else source.data_ptr(), elem.data_ptr(), out.data_ptr(),
           n, nt, _flat_deltas(lctx), a["rho"], a["mu"], a["cp"], a["kappa"], *a["fb"], a["dt"],
           torch.cuda.current_stream(dev).cuda_stream),
        "lattice_residual_classes",
    )
    residual_volume_two_pass.launches += 1
    return out


residual_volume_two_pass.launches = 0


def plane_entries(lctx: LatticeContext, ncomp: int) -> tuple:
    """The two-pass K2c's plane table: (starts (D + 1,), entries (E, 2)) as
    int lists. Plane p sums entries starts[p]..starts[p+1]-1, each
    (element-buffer row (t*16 + a*4+b) * ncomp, vertex shift delta[t][a]),
    in the (t, a, b) order of _reduce_lhs_planes."""
    by_plane = [[] for _ in lctx.offsets]
    for t, d in enumerate(lctx.deltas):
        for a in range(4):
            for b in range(4):
                by_plane[lctx.plane_tab[t][a][b]].append(((t * 16 + a * 4 + b) * ncomp, d[a]))
    starts = [0]
    for ents in by_plane:
        starts.append(starts[-1] + len(ents))
    return starts, [e for ents in by_plane for e in ents]


# plane tables on the card by (deltas, plane_tab, ncomp, device): built once
# a context's tables and mode, so a call queues no host-to-device copy
_PLANE_TABLES: dict = {}


def _plane_tables_on(lctx: LatticeContext, ncomp: int, device) -> tuple:
    key = (lctx.deltas, lctx.plane_tab, ncomp, device)
    got = _PLANE_TABLES.get(key)
    if got is None:
        starts, ents = plane_entries(lctx, ncomp)
        got = (torch.tensor(starts, dtype=torch.int32, device=device),
               torch.tensor(ents, dtype=torch.int32, device=device).reshape(-1, 2).contiguous())
        _PLANE_TABLES[key] = got
    return got


def _check_jacobian_args(what: str, lctx: LatticeContext, wa_t, keep, add, band, band_lo) -> int:
    """Check K2c's arguments; returns the band's span (0 without one)."""
    n, nd = lctx.num_node, len(lctx.offsets)
    nc = 18 if lctx.scalar_implicit else 16
    _check_class_tables(what, lctx)
    _check_f32_cuda(
        what, wa_t=wa_t, keep=keep, add=add, lhs_geom=lctx.lhs_geom, res_geom=lctx.res_geom,
        **({} if band is None else {"band": band}),
    )
    if wa_t.shape != (6, n) or keep.shape != (nc, n) or add.shape != (nc, n):
        raise ValueError(f"{what} kernel: states (6, N), keep and add ({nc}, N)")
    if band is None:
        return 0
    if band.shape[:2] != (nd, 16) or band_lo < 0 or band_lo + band.shape[2] > n:
        raise ValueError(f"{what} kernel: band outside the matrix")
    return band.shape[2]


def jacobian_volume_classes(lctx: LatticeContext, wa_t, phys, scheme, keep, add, band=None,
                            band_lo=0):
    """K2c: the function of jacobian_volume_plain (the same contract as
    jacobian_volume) for any table of T <= 8 slabs. On CUDA, where the
    context's table placed on a node grid (`grid`), one pass of the fused
    K2's tiling over the run-time table (csrc/lattice_jacobian.cu,
    `dedflow_lattice_jacobian_grid`): 8 x 8 node tiles sliding up z chunks,
    a component group a block, the halo cells' elements of a round of
    GRID_ROUND_SLABS slabs staged in shared memory, their (t, a, b) entries
    added in that order into the plane sums of node layers L and L + 1 kept
    in shared memory (the corners' halo shifts and the entries' planes
    passed by value), each plane stored once with the epilogue: no element
    buffer in device memory, no atomics. Where it did not place,
    jacobian_volume_two_pass; on the CPU the plain version."""
    if not wa_t.is_cuda:
        return jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
    if lctx.grid is None:
        return jacobian_volume_two_pass(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
    n, nd, nt = lctx.num_node, len(lctx.offsets), len(lctx.deltas)
    implicit = lctx.scalar_implicit
    span = _check_jacobian_args("lattice_jacobian_grid", lctx, wa_t, keep, add, band, band_lo)
    fn = nvcc.function(
        "lattice_jacobian", "dedflow_lattice_jacobian_grid",
        [nvcc.P] * 6 + [nvcc.I, nvcc.I, nvcc.P, nvcc.P] + [nvcc.I] * 6 + [nvcc.P] * 4
        + [nvcc.I] * 3 + [nvcc.D] * 7 + [nvcc.P],
    )
    _check_fused_layout(implicit)
    sy, ny, nz, corners, shifts = lctx.grid
    dev = wa_t.device
    out = torch.empty((nd, 16, n), dtype=torch.float32, device=dev)
    scal = torch.empty((2 * nd, n), dtype=torch.float32, device=dev) if implicit else None
    a = _lhs_args(phys, scheme)
    nvcc.check(
        fn(lctx.lhs_geom.data_ptr(), lctx.res_geom.data_ptr() if implicit else None,
           wa_t.data_ptr(), keep.data_ptr(), add.data_ptr(),
           None if band is None else band.data_ptr(), int(band_lo), span,
           out.data_ptr(), None if scal is None else scal.data_ptr(), n, sy, ny, nz,
           FUSED_ZCHUNK[implicit], nt, _flat_deltas(lctx),
           nvcc.int_array(c for cs in corners for c in cs), nvcc.int_array(shifts),
           nvcc.int_array(p for pt in lctx.plane_tab for pa in pt for p in pa), nd,
           lctx.offsets.index(0), GRID_ROUND_SLABS[implicit],
           a["rho"], a["mu"], a["f1"], a["f2"], a["dt"], a["cp"], a["kappa"],
           torch.cuda.current_stream(dev).cuda_stream),
        "lattice_jacobian_grid",
    )
    jacobian_volume_classes.launches += 1
    if implicit:
        jacobian_volume_classes.implicit_launches += 1
    return (out, scal) if implicit else out


jacobian_volume_classes.launches = 0  # the one-pass kernel's, both modes
jacobian_volume_classes.implicit_launches = 0  # its implicit mode's alone


def jacobian_volume_two_pass(lctx: LatticeContext, wa_t, phys, scheme, keep, add, band=None,
                             band_lo=0):
    """K2c's two passes, for a table that does not place on a node grid
    (and held against the plain version on the card): on CUDA
    csrc/lattice_classes.cu, an element pass, a thread a (slab, base
    node), into a (T, 16 * ncomp, N) buffer, then a plane pass, a thread a
    (plane, component, node), that sums the plane's entries in the plain
    order (plane_entries) and applies the keep / add / band epilogue; on
    the CPU the plain version."""
    if not wa_t.is_cuda:
        return jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, band_lo)
    n, nd, nt = lctx.num_node, len(lctx.offsets), len(lctx.deltas)
    implicit = lctx.scalar_implicit
    nc = 18 if implicit else 16
    span = _check_jacobian_args("lattice_jacobian_classes", lctx, wa_t, keep, add, band, band_lo)
    fn = nvcc.function(
        "lattice_classes", "dedflow_lattice_jacobian_classes",
        [nvcc.P] * 7 + [nvcc.I, nvcc.I, nvcc.P, nvcc.P] + [nvcc.I, nvcc.I, nvcc.P]
        + [nvcc.I, nvcc.P, nvcc.P, nvcc.I] + [nvcc.D] * 7 + [nvcc.P],
    )
    dev = wa_t.device
    starts, ents = _plane_tables_on(lctx, nc, dev)
    elem = torch.empty((nt, 16 * nc, n), dtype=torch.float32, device=dev)
    out = torch.empty((nd, 16, n), dtype=torch.float32, device=dev)
    scal = torch.empty((2 * nd, n), dtype=torch.float32, device=dev) if implicit else None
    a = _lhs_args(phys, scheme)
    nvcc.check(
        fn(lctx.lhs_geom.data_ptr(), lctx.res_geom.data_ptr() if implicit else None,
           wa_t.data_ptr(), elem.data_ptr(), keep.data_ptr(), add.data_ptr(),
           None if band is None else band.data_ptr(), int(band_lo), span,
           out.data_ptr(), None if scal is None else scal.data_ptr(), n, nt, _flat_deltas(lctx),
           nd, starts.data_ptr(), ents.data_ptr(), lctx.offsets.index(0),
           a["rho"], a["mu"], a["f1"], a["f2"], a["dt"], a["cp"], a["kappa"],
           torch.cuda.current_stream(dev).cuda_stream),
        "lattice_jacobian_classes",
    )
    jacobian_volume_two_pass.launches += 1
    if implicit:
        jacobian_volume_two_pass.implicit_launches += 1
    return (out, scal) if implicit else out


jacobian_volume_two_pass.launches = 0  # both modes
jacobian_volume_two_pass.implicit_launches = 0  # the implicit mode's alone


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


# ---------------------------------------------------------------------------
# The z-slab decomposition of a box over N ranks (parallel.sharded): the
# counterpart of the JAX package's residual_fused_shmap /
# jacobian_fused_shmap (lattice.py:1223, :1273), which run K1 and K2 once a
# shard under shard_map and move the halo with ppermute. Here every rank
# builds the lattice context of its own sub-box and runs K1 and K2 on it
# through their usual wrappers; the bands and carries go through the
# rank's communicator (parallel.spmd.SlabComm). The JAX package pads each
# shard to a multiple of 1024 lanes (TPU tiling); ranks here hold unequal
# row counts and nothing is padded.


def slab_layers(num_layers: int, world: int) -> tuple:
    """Bounds a_0 = 0 < a_1 < ... < a_world = num_layers of the z-slab cut:
    rank r owns node layers [a_r, a_{r+1}), as even as possible (the first
    ranks take one more), at least 2 a rank."""
    if num_layers < 2 * world:
        raise ValueError(
            f"a z-slab cut gives each of {world} ranks at least 2 of the box's node layers; "
            f"this box has {num_layers} (nz + 1): use fewer ranks or more cells along z"
        )
    base, extra = divmod(num_layers, world)
    bounds = [0]
    for r in range(world):
        bounds.append(bounds[-1] + base + (r < extra))
    return tuple(bounds)


@dataclass
class SlabContext:
    """One rank's part of a z-slab decomposed box: `lctx` is the lattice
    context of the sub-box of its own cells (cell layers [a_r, a_{r+1})),
    whose node layers are its own ones and, on every rank but the last,
    the right neighbour's first layer (the halo layer, last); its `mult` is
    the whole mesh's (a sub-box alone would undercount the seam layer).
    Vectors of the rank hold its own rows only (n_own); `comm` moves the
    bands and carries of `width` nodes (a node layer) and sums over the
    ranks."""

    lctx: LatticeContext
    comm: object  # parallel.spmd.SlabComm
    node_lo: int  # global id of the first own node
    n_own: int
    width: int  # nodes a layer
    num_layers: int  # node layers of the whole box (nz + 1)


def _slab_mesh(mesh: Mesh, lo: int, top: int, layers_of_cells: tuple) -> Mesh:
    """The sub-box of node layers lo..top (inclusive) of a box mesh, with
    the tets of cell layers [c0, c1) renumbered into it and the facets of
    every boundary whose parent tet is one of them."""
    nx, ny, _ = mesh.lattice
    sz = (nx + 1) * (ny + 1)
    ien = np.asarray(mesh.ien, dtype=np.int64)
    layer = ien.min(axis=1) // sz  # every Kuhn tet holds its cell's corner 0
    c0, c1 = layers_of_cells
    own = (layer >= c0) & (layer < c1)
    local = np.full(ien.shape[0], -1, dtype=np.int64)
    local[own] = np.arange(int(own.sum()))
    boundaries = []
    for b in mesh.boundaries:
        f2e = np.asarray(b.f2e, dtype=np.int64)
        keep = own[f2e]
        tri = np.asarray(b.ien, dtype=np.int64)[keep] - lo * sz
        boundaries.append(Boundary(nodes=np.unique(tri), ien=tri, f2e=local[f2e[keep]],
                                   forn=np.asarray(b.forn)[keep]))
    return Mesh(xg=mesh.xg[lo * sz : (top + 1) * sz], ien=ien[own] - lo * sz,
                boundaries=boundaries, lattice=(nx, ny, top - lo))


def build_slab_context(mesh: Mesh, comm, weak: tuple, device, dtype) -> tuple:
    """(SlabContext, facet contexts) of rank `comm.rank` of `comm.world` on
    a box mesh with the Kuhn split. The cut is slab_layers'. The facet
    contexts are those of the boundaries `weak` whose parent tets lie in
    the rank's cells, in its local node numbering (their rows in the halo
    layer go into the carry)."""
    nx, ny, nz = mesh.lattice
    sz = (nx + 1) * (ny + 1)
    bounds = slab_layers(nz + 1, comm.world)
    lo, hi = bounds[comm.rank], bounds[comm.rank + 1]
    last = comm.rank == comm.world - 1
    top = nz if last else hi  # the sub-box's last node layer: the halo, or the box's last
    sub = _slab_mesh(mesh, lo, top, (lo, nz if last else hi))
    lctx = build_lattice_context(sub, device, dtype)
    cells = np.arange(mesh.num_node, dtype=np.int64)
    live = (cells % (nx + 1) < nx) & ((cells // (nx + 1)) % (ny + 1) < ny) & (cells // sz < nz)
    mult = _live_multiplicity(cells[live], lctx.deltas, mesh.num_node)[lo * sz : (top + 1) * sz]
    lctx.mult = torch.as_tensor(mult, dtype=dtype, device=device)
    face_ctxs = tuple(
        build_face_context(sub, b, lctx.offsets, device, dtype)
        for b in weak if sub.boundaries[b].num_facet
    )
    sctx = SlabContext(lctx=lctx, comm=comm, node_lo=lo * sz, n_own=(hi - lo) * sz, width=sz,
                       num_layers=nz + 1)
    return sctx, face_ctxs


def slab_states(sctx: SlabContext, w_alpha, dw_alpha, source=None) -> tuple:
    """(wa_t, dwa_t, source) on the rank's sub-box: its own rows (N, 6) as
    (6, n) and, on every rank but the last, the right neighbour's first
    layer appended (one band exchange)."""
    rows = [w_alpha.T, dw_alpha.T] + ([] if source is None else [source[None]])
    x = torch.cat(rows)
    band = sctx.comm.band_from_right(x, sctx.width)
    if band is not None:
        x = torch.cat([x, band], dim=1)
    return x[:6].contiguous(), x[6:12].contiguous(), None if source is None else x[12].contiguous()


def assemble_residual_slab(sctx: SlabContext, face_ctxs: tuple, mask_t, w_alpha, dw_alpha, phys,
                           scheme, freeze_phi_temperature: bool = True, nodal_force=None,
                           source=None) -> torch.Tensor:
    """The rank's own rows (6, n_own) of assemble_residual_t's F: K1 on the
    sub-box (residual_volume, the kernel on CUDA), its facets, then the
    halo layer's rows go to the right neighbour as a carry and the left
    neighbour's are added into the first own layer; the nodal load, freeze
    and mask apply after the carry. `nodal_force` (n_own, 3) and `source`
    (n_own,) are the rank's own rows."""
    wa_t, dwa_t, src = slab_states(sctx, w_alpha, dw_alpha, source)
    f = residual_volume(sctx.lctx, wa_t, dwa_t, phys, scheme, src).to(w_alpha.dtype)
    for fctx in face_ctxs:
        face_residual_scatter(fctx, f, face_residual_elements(fctx, wa_t.T, dwa_t.T, phys))
    f = sctx.comm.carry_to_right(f, sctx.width)
    if nodal_force is not None:
        f[:3] -= nodal_force.T
    if freeze_phi_temperature:
        f[4:] = 0.0  # main.c:64
    return f.masked_fill(mask_t, 0.0)


def slab_jacobian_inputs(sctx: SlabContext, face_ctxs: tuple, mask_t, wa_t, dwa_t, phys,
                         scheme) -> tuple:
    """(keep_pc (18, n), add18 (18, n), facet band, its first row) of K2 on
    the rank's sub-box (n rows, the halo layer's last): the rank's mask on
    its own rows, keep 1 and add 0 on the halo layer, the facet band
    pre-masked by them."""
    lctx, dtype = sctx.lctx, wa_t.dtype
    halo = torch.zeros((6, lctx.num_node - sctx.n_own), dtype=torch.bool, device=mask_t.device)
    mask_e = torch.cat([mask_t, halo], dim=1)
    keep_pc = keep_pc_rows(mask_e, dtype)
    add18 = diag_add_rows(mask_e, dtype)
    band, lo = _masked_face_band(face_ctxs, wa_t.T, dwa_t.T, phys, scheme, len(lctx.offsets),
                                 keep_pc)
    return keep_pc, add18, band, lo


def assemble_jacobian_slab(sctx: SlabContext, face_ctxs: tuple, mask_t, w_alpha, dw_alpha, phys,
                           scheme):
    """The rank's own rows of assemble_jacobian_t's J as a
    sparse.fsbsr.SlabDIAMatrixT. K2 (jacobian_volume, the fused kernel on
    CUDA) runs on the sub-box with its Dirichlet epilogue; the halo layer
    is computed unmasked (keep 1, add 0, its facet rows unmasked) and goes
    to the right neighbour, which adds keep * carry into its first layer,
    so a constrained row stays an identity row."""
    from dedflow_tpu_torch.sparse.fsbsr import SlabDIAMatrixT

    lctx, dtype, n_own, width = sctx.lctx, w_alpha.dtype, sctx.n_own, sctx.width
    wa_t, dwa_t, _ = slab_states(sctx, w_alpha, dw_alpha)
    nd, d0 = len(lctx.offsets), lctx.offsets.index(0)
    keep_pc, add18, band, lo = slab_jacobian_inputs(sctx, face_ctxs, mask_t, wa_t, dwa_t, phys,
                                                    scheme)
    data = jacobian_volume(
        lctx, wa_t, phys, scheme, keep_pc[:16].contiguous(), add18[:16].contiguous(), band, lo,
    ).to(dtype)
    data = sctx.comm.carry_to_right(data, width, scale=keep_pc[:16, :width])
    scal = torch.zeros((2 * nd, n_own), dtype=dtype, device=w_alpha.device)
    scal[2 * d0 : 2 * d0 + 2] = (lctx.mult[:n_own].to(dtype) * keep_pc[16:18, :n_own]
                                 + add18[16:18, :n_own])
    return SlabDIAMatrixT(data=data, scal=scal, offsets=lctx.offsets, comm=sctx.comm, width=width,
                          row_lo=sctx.node_lo)
