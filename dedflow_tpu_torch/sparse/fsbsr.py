"""Component-major DIA field-split matrix (subset of dedflow_tpu/sparse/fsbsr.py).

The 6x6 nodal blocks of the coupled system carry 18 structurally nonzero
packed components (velocity 3x3, velocity-pressure, pressure-velocity,
pressure-pressure, and the phi-phi / T-T diagonals). On the lattice the
matrix is stored per DIA offset plane, node axis last:

    data (D, 16, N)  the 16 velocity/pressure components of plane k
    scal (2*D, N)    row 2k = phi-phi, row 2k+1 = T-T of plane k

Plane k couples row n to column n + offsets[k]. The TPU layout's 128-lane
width padding and 8-row scal padding are tiling artefacts and are not
carried over: the width is exactly N and scal has exactly 2*D rows.

The JAX package's other field-split matrix, FSBSRMatrix (fsbsr.py:64-189,
the general gather tier's), pads every row to the widest (N, PR, 18) ELL
layout so that its SpMV is one row gather plus dense sums: its own
docstring (fsbsr.py:11-22) says the layout exists to avoid TPU scatter and
gather, and on a Delaunay mesh it stores about 2.7x the nonzeros. Its
counterpart here is the CSR-entry matrix sparse.winell.WinELLMatrixT:
ELL slot (r, p) of a valid row is CSR entry row_ptr[r] + p
(topology.Sparsity.ell_tables), `data[r, p, c]` is `vals[COMP2WIN[c], k]`,
`matvec` is `matvec_t` on (6, N) vectors (kernel K7), `diag_vel_blocks` /
`diag_p` are rows of `diag_rows()`, `zero_rows` is `zero_rows_t` and
`to_block_dense` is the same dense expansion; `interop.fsbsr_from_numpy`
carries the JAX data over; its component-restricted products `matvec_up`
/ `matvec_pu` / `matvec_pp` and `diag_p` serve the SIMPLE preconditioner
(solver.pc.SIMPLEPC).

The lattice matrix's component-restricted products and the compact Schur
bands (`SchurBandsT`, fsbsr.py:461-635 of the JAX package) serve the SIMPLE
and multigrid preconditioners. The JAX package writes each band product as
a per-offset accumulator loop that XLA fuses into one pass; in eager torch
that loop would be D launches a product. Here every product takes a fixed
number of launches, whatever D: the padded vector's (2m + 1, N) window
view (`Tensor.unfold`, no copy), one `index_select` of the D offset rows,
one multiply and one sum (`shifted`). Zeros outside [0, N) stand for the
columns past the grid's ends, whose entries the lattice assembly makes
exactly 0 (fem.lattice's dead cells). On a rank of a z-slab decomposition
(SlabDIAMatrixT) the same products read x with a node layer of each
neighbour around the own rows (`shifted_slab`: one band exchange a
product, SlabSchurBandsT), and diag(S_hat) takes the neighbours' inverse
velocity blocks and A_up planes in one exchange at set-up.

Component order:
    0..8   uu[i*3+j]   d y_u[i] / d x_u[j]
    9..11  up[i]       d y_u[i] / d x_p
    12..14 pu[j]       d y_p    / d x_u[j]
    15     pp
    16     phiphi
    17     TT
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

NUM_COMP = 18
UU = lambda i, j: i * 3 + j
UP = lambda i: 9 + i
PU = lambda j: 12 + j
PP = 15
PHIPHI = 16
TT = 17

# (component, block-row, block-col) of each packed slot
COMP_SLOTS = (
    [(UU(i, j), i, j) for i in range(3) for j in range(3)]
    + [(UP(i), i, 3) for i in range(3)]
    + [(PU(j), 3, j) for j in range(3)]
    + [(PP, 3, 3), (PHIPHI, 4, 4), (TT, 5, 5)]
)
# solution component whose equation each packed component lives in
COMP_ROW = np.array([bi for _, bi, _ in COMP_SLOTS])
# the 6 packed components on the block diagonal, by solution component
DIAG_COMPS = np.array([UU(0, 0), UU(1, 1), UU(2, 2), PP, PHIPHI, TT])


def keep_pc_rows(mask_t: torch.Tensor, dtype) -> torch.Tensor:
    """(18, N) per-packed-component row-keep factors from a (6, N) mask."""
    keep = 1.0 - mask_t.to(dtype)
    return keep[torch.as_tensor(COMP_ROW, device=mask_t.device)]


def diag_add_rows(mask_t: torch.Tensor, dtype) -> torch.Tensor:
    """(18, N) unit-diagonal additions (nonzero only on the 6 diagonal
    packed components) from a (6, N) mask."""
    add = mask_t.to(dtype)
    out = torch.zeros((NUM_COMP, add.shape[1]), dtype=dtype, device=add.device)
    out[torch.as_tensor(DIAG_COMPS, device=add.device)] = add
    return out


# The D offset rows of `shifted_band` by (offsets, first row, device): built
# once, so a product queues no host-to-device copy (the rows never change).
_SHIFT_ROWS: dict = {}


def shifted_band(x: torch.Tensor, offsets: tuple, lo: int, n: int) -> torch.Tensor:
    """(..., m) -> (..., D, n): row k, column r is x[..., lo + r +
    offsets[k]], zero outside [0, m) (x holds n rows from column lo with
    bands around them, m >= lo + n). Two launches whatever D: the pad and
    one index_select of the padded vector's window view."""
    m = max(max(abs(o) for o in offsets), 1)
    key = (tuple(offsets), m + lo, x.device)
    rows = _SHIFT_ROWS.get(key)
    if rows is None:
        rows = torch.as_tensor([m + lo + o for o in offsets], dtype=torch.long, device=x.device)
        _SHIFT_ROWS[key] = rows
    return F.pad(x, (m, m)).unfold(-1, n, 1).index_select(-2, rows)


def shifted(x: torch.Tensor, offsets: tuple) -> torch.Tensor:
    """(..., N) -> (..., D, N): row k is x shifted by offsets[k] (x[n + o]),
    zero outside [0, N)."""
    return shifted_band(x, offsets, 0, x.shape[-1])


def shifted_slab(x: torch.Tensor, offsets: tuple, comm, width: int) -> torch.Tensor:
    """shifted() of a rank's own rows (..., n) of a z-slab decomposed
    vector: one band exchange of `width` nodes through `comm`
    (parallel.spmd.SlabComm.banded, zeros where there is no neighbour)."""
    return shifted_band(comm.banded(x, width), offsets, width, x.shape[-1])


def schur_diag_rows(app0, pu, up_ext, duinv_ext, offs: tuple, lo: int) -> torch.Tensor:
    """(n,) diagonal of S_hat = A_pp - A_pu inv(D_u) A_up (fsbsr.py:515-540
    of the JAX package): entry r = app0[r] - sum_k sum_ij pu[k, i, r]
    duinv[ij, r + o_k] up[k, j, r + o_k] over the offsets o_k whose negation
    is an offset, all at once; pu (K, 3, n) the A_pu planes of o_k, up_ext
    (K, 3, m) the A_up planes of -o_k and duinv_ext (9, m) the row-major
    inverse velocity blocks on x-like columns, row r at column lo + r (a
    rank's own rows with a band of each neighbour's around them)."""
    n, k = app0.shape[-1], len(offs)
    dev = app0.device
    h = shifted_band(duinv_ext, offs, lo, n)  # (9, K, n): duinv at r + o_k
    h = h.reshape(3, 3, k, n).permute(2, 0, 1, 3)  # (K, i, j, n)
    # up_j of plane -o_k at r + o_k: each plane row shifted by its own offset
    m = max(max(abs(o) for o in offs), 1)
    upn = F.pad(up_ext, (m, m))
    idx = (torch.as_tensor([m + lo + o for o in offs], device=dev)[:, None]
           + torch.arange(n, device=dev)[None, :])
    upn = torch.gather(upn, 2, idx[:, None, :].expand(k, 3, n))  # (K, j, n)
    term = (pu[:, :, None] * h * upn[:, None]).sum((0, 1, 2))
    return app0 - term


@dataclass
class SchurBandsT:
    """Compact pressure-Schur operator: the A_pp / A_pu / A_up component
    planes of an FSDIAMatrixT with its linear DIA offsets (counterpart of
    dedflow_tpu/sparse/fsbsr.py::SchurBandsT, :588). Each product is four
    launches (module docstring); `matvec_pp_up` shares one shifted copy of
    p between A_pp p and A_up p, the pair the Schur apply needs."""

    app: torch.Tensor  # (D, N) pressure-pressure plane rows
    apu: torch.Tensor  # (D, 3, N) pressure-row / velocity-col planes
    aup: torch.Tensor  # (D, 3, N) velocity-row / pressure-col planes
    offsets: tuple

    def _shift(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N) -> (..., D, N), x at the columns of each plane."""
        return shifted(x, self.offsets)

    def matvec_pp(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) -> (N,): the A_pp block only."""
        return (self.app * self._shift(p)).sum(0)

    def matvec_pu(self, u: torch.Tensor) -> torch.Tensor:
        """(3, N) velocity -> (N,) pressure row: the A_pu block only."""
        return (self.apu * self._shift(u).transpose(0, 1)).sum((0, 1))

    def matvec_up(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) pressure -> (3, N) velocity rows: the A_up block only."""
        return (self.aup * self._shift(p)[:, None]).sum(0)

    def matvec_pp_up(self, p: torch.Tensor) -> tuple:
        """(A_pp p, A_up p) from one shifted copy of p."""
        ps = self._shift(p)
        return (self.app * ps).sum(0), (self.aup * ps[:, None]).sum(0)


@dataclass
class SlabSchurBandsT(SchurBandsT):
    """SchurBandsT on one rank's own rows of a z-slab decomposed box
    (SlabDIAMatrixT.schur_bands): each product takes one band exchange of
    `width` nodes (a node layer) through `comm` (parallel.spmd.SlabComm),
    zeros where there is no neighbour (beyond the domain every entry is an
    exact zero: JAX mg.py:127-131), and `matvec_pp_up` one for both."""

    comm: object = None
    width: int = 0

    def _shift(self, x: torch.Tensor) -> torch.Tensor:
        return shifted_slab(x, self.offsets, self.comm, self.width)


@dataclass
class FSDIAMatrixT:
    """Component-major DIA field-split matrix (see module docstring)."""

    data: torch.Tensor  # (D, 16, N) velocity/pressure components
    scal: torch.Tensor  # (2*D, N) phi-phi / T-T rows per plane
    offsets: tuple

    @property
    def _d0(self) -> int:
        return self.offsets.index(0)

    @property
    def num_rows(self) -> int:
        return int(self.data.shape[2])

    def matvec_t(self, x_t: torch.Tensor) -> torch.Tensor:
        """(6, N) -> (6, N) SpMV (sparse.dia_kernels: the hand-written
        kernel on CUDA, its plain version on the CPU)."""
        from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

        return dia_matvec(self.data, self.scal, x_t, self.offsets)

    def diag_rows(self) -> torch.Tensor:
        """(18, N) packed diagonal-block rows (PC setup)."""
        d0 = self._d0
        return torch.cat([self.data[d0], self.scal[2 * d0 : 2 * d0 + 2]], dim=0)

    # -- component-restricted products (SIMPLE / Schur preconditioners)
    def _shift(self, x: torch.Tensor) -> torch.Tensor:
        """(..., N) -> (..., D, N), x at the columns of each plane."""
        return shifted(x, self.offsets)

    def matvec_up(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) pressure -> (3, N) velocity rows: the A_up block only."""
        return (self.data[:, UP(0) : UP(0) + 3] * self._shift(p)[:, None]).sum(0)

    def matvec_pu(self, u: torch.Tensor) -> torch.Tensor:
        """(3, N) velocity -> (N,) pressure row: the A_pu block only."""
        us = self._shift(u).transpose(0, 1)
        return (self.data[:, PU(0) : PU(0) + 3] * us).sum((0, 1))

    def matvec_pp(self, p: torch.Tensor) -> torch.Tensor:
        """(N,) -> (N,): the A_pp block only."""
        return (self.data[:, PP] * self._shift(p)).sum(0)

    def _band_fields(self) -> dict:
        """The SchurBandsT fields: the A_pp / A_pu / A_up planes copied
        once at preconditioner set-up (fsbsr.py:497-513 of the JAX
        package)."""
        d = self.data
        return dict(app=d[:, PP].contiguous(), apu=d[:, PU(0) : PU(0) + 3].contiguous(),
                    aup=d[:, UP(0) : UP(0) + 3].contiguous(), offsets=self.offsets)

    def schur_bands(self) -> SchurBandsT:
        """The compact A_pp / A_pu / A_up planes."""
        return SchurBandsT(**self._band_fields())

    def _schur_planes(self) -> tuple:
        """(offsets o_k whose negation is an offset, A_pu planes of o_k
        (K, 3, N), A_up planes of -o_k (K, 3, N))."""
        d = self.data
        pos = {o: k for k, o in enumerate(self.offsets)}
        ks = [k for k, o in enumerate(self.offsets) if -o in pos]
        kneg = [pos[-self.offsets[k]] for k in ks]
        dev = d.device
        return (tuple(self.offsets[k] for k in ks),
                d[torch.as_tensor(ks, device=dev), PU(0) : PU(0) + 3],
                d[torch.as_tensor(kneg, device=dev), UP(0) : UP(0) + 3])

    def schur_diag(self, duinv_rows: torch.Tensor) -> torch.Tensor:
        """(N,) diagonal of S_hat = A_pp - A_pu inv(D_u) A_up, with
        duinv_rows (9, N) the row-major inverse velocity diagonal blocks
        (schur_diag_rows)."""
        offs, pu, up = self._schur_planes()
        return schur_diag_rows(self.data[self._d0, PP], pu, up, duinv_rows, offs, 0)

    def diag_p(self) -> torch.Tensor:
        return self.data[self._d0, PP]

    def zero_rows_t(self, mask_t: torch.Tensor) -> "FSDIAMatrixT":
        """Zero constrained rows (mask_t (6, N) boolean, True = constrained)
        and put a unit diagonal on them (dirichlet.c:47-61)."""
        dtype = self.data.dtype
        keep = keep_pc_rows(mask_t, dtype)
        add = diag_add_rows(mask_t, dtype)
        d0 = self._d0
        data = self.data * keep[None, :16]
        data[d0] += add[:16]
        scal = self.scal * keep[16:18].repeat(self.data.shape[0], 1)
        scal[2 * d0 : 2 * d0 + 2] += add[16:18]
        return FSDIAMatrixT(data=data, scal=scal, offsets=self.offsets)

    def to_block_dense(self) -> np.ndarray:
        """Test helper: expand to dense (N*6, N*6) float64."""
        d = self.data.detach().cpu().double().numpy()
        s = self.scal.detach().cpu().double().numpy()
        nd, _, n = d.shape
        d18 = np.concatenate([d, s.reshape(nd, 2, n)], axis=1)
        dense = np.zeros((n * 6, n * 6))
        rows = np.arange(n)
        for k, o in enumerate(self.offsets):
            cols = rows + o
            ok = (cols >= 0) & (cols < n)
            for comp, bi, bj in COMP_SLOTS:
                np.add.at(
                    dense,
                    (rows[ok] * 6 + bi, cols[ok] * 6 + bj),
                    d18[k, comp, rows[ok]],
                )
        return dense


@dataclass
class SlabDIAMatrixT(FSDIAMatrixT):
    """One rank's own rows of an FSDIAMatrixT on a z-slab decomposed box
    (fem.lattice.assemble_jacobian_slab), from the whole matrix's row
    `row_lo`: the offsets reach at most one node layer (`width` nodes) into
    either neighbour's rows, so a product takes one band exchange through
    `comm` (parallel.spmd.SlabComm) and K3's banded entry (the JAX
    package's fsbsr.py:355-399 with dia_matvec_pallas_shmap). Entries whose
    column lies past the band are the exact zeros of the box's dead cells.
    The component products and the Schur bands (SlabSchurBandsT) take one
    band exchange each; `schur_diag` one at set-up."""

    comm: object = None
    width: int = 0
    row_lo: int = 0

    def matvec_t(self, x_t: torch.Tensor) -> torch.Tensor:
        from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec_banded

        left, right = self.comm.bands(x_t, self.width)
        x_ext = torch.cat([p for p in (left, x_t, right) if p is not None], dim=1)
        return dia_matvec_banded(self.data, self.scal, x_ext, self.offsets,
                                 0 if left is None else self.width)

    def _shift(self, x: torch.Tensor) -> torch.Tensor:
        return shifted_slab(x, self.offsets, self.comm, self.width)

    def schur_bands(self) -> SlabSchurBandsT:
        return SlabSchurBandsT(**self._band_fields(), comm=self.comm, width=self.width)

    def schur_diag(self, duinv_rows: torch.Tensor) -> torch.Tensor:
        """diag(S_hat) on the own rows: a first or last own layer's row
        reads the neighbour's inverse velocity blocks and A_up planes of the
        neighbouring layer, which come in one band exchange."""
        offs, pu, up = self._schur_planes()
        k, n = len(offs), self.num_rows
        ext = self.comm.banded(torch.cat([duinv_rows, up.reshape(3 * k, n)]), self.width)
        return schur_diag_rows(self.data[self._d0, PP], pu, ext[9:].reshape(k, 3, -1), ext[:9],
                               offs, self.width)
