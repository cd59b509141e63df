"""Carry configuration, state and matrices from the JAX package's plain
forms into the port's objects. Imports no jax: every input is a dict or a
NumPy array, which is what the JAX package exposes (`config._to_dict`,
`dataclasses.asdict` of its DEM configs, `reference_initial_state`,
`np.asarray` of an FSDIAMatrixT's, an FSBSRMatrix's or a ParticleState's
arrays). Tensors land on the card unless `device` says otherwise, as the
JAX package's land on its default backend."""

from __future__ import annotations

import numpy as np
import torch

from dedflow_tpu_torch import config
from dedflow_tpu_torch.app.coupled import CoupledConfig
from dedflow_tpu_torch.dem.cells import CellGrid
from dedflow_tpu_torch.dem.contact import ContactParams
from dedflow_tpu_torch.dem.grid import GridState
from dedflow_tpu_torch.dem.integrate import DEMConfig
from dedflow_tpu_torch.dem.particles import ParticleState, particle_state
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT
from dedflow_tpu_torch.sparse.topology import Sparsity
from dedflow_tpu_torch.sparse.winell import NUM_ROWS, WIN2COMP, WinELLMatrixT, WinPlan
from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device


def config_from_dict(d: dict) -> config.SolverConfig:
    """The port's SolverConfig from the JAX package's `config._to_dict(cfg)`
    form (the schema `load_config` reads)."""
    return config.from_dict(d)


def state_from_numpy(wg, dwgold, dwg, device="cuda", dtype=None):
    """(N, 6) states (reference_initial_state) -> three tensors."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    return tuple(
        torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in (wg, dwgold, dwg)
    )


def dia_from_numpy(data, scal, offsets, num_node, device="cuda", dtype=None) -> FSDIAMatrixT:
    """An FSDIAMatrixT from the JAX package's arrays: data (D, 16, W) and
    scal (>= 2D, W) with W >= num_node. The TPU's lane and row padding is
    dropped."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    data = np.asarray(data)
    nd = data.shape[0]
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    return FSDIAMatrixT(
        data=t(data[:, :, :num_node]),
        scal=t(np.asarray(scal)[: 2 * nd, :num_node]),
        offsets=tuple(int(o) for o in offsets),
    )


def winell_from_numpy(vals, entry_of_nnz, plan: WinPlan, dtype=None) -> WinELLMatrixT:
    """The port's WinELLMatrixT from the JAX package's WinELLMatrix:
    `vals` (>= 18, >= S) in WinELL component order (np.asarray of its
    `vals`; the TPU's index rows 18/19 and padding are dropped) and its
    plan's `entry_of_nnz`, which places CSR nonzero k at entry
    entry_of_nnz[k] of the TPU layout. `plan` is the port's plan of the
    same sparsity (CSR order), on the device the matrix should live on."""
    vals = np.asarray(vals)[:NUM_ROWS]
    eon = np.asarray(entry_of_nnz, dtype=np.int64)
    if eon.size != plan.S:
        raise ValueError(f"entry_of_nnz has {eon.size} nonzeros, the plan {plan.S}")
    dev = plan.row_ptr_t.device
    dtype = dtype or default_dtype(dev)
    ours = vals[:, eon[plan.entry_of_nnz]]
    return WinELLMatrixT(
        vals=torch.tensor(np.ascontiguousarray(ours), dtype=dtype, device=dev), plan=plan
    )


def fsbsr_from_numpy(data, sparsity: Sparsity, plan: WinPlan, dtype=None) -> WinELLMatrixT:
    """The port's CSR-entry matrix from the JAX package's FSBSRMatrix data
    (N, PR, 18) in ELL row layout (sparse/fsbsr.py:64-189): CSR nonzero k
    is ELL slot `nnz_to_ell[k]` of `sparsity.ell_tables()`, its 18
    components go to the WinELL rows COMP2WIN. `plan` is the port's plan of
    the same sparsity, on the device the matrix should live on."""
    data = np.asarray(data)
    n, pr = sparsity.num_node, sparsity.max_row
    if data.shape != (n, pr, 18):
        raise ValueError(f"FSBSR data must be ({n}, {pr}, 18), got {data.shape}")
    _, nnz_to_ell, _ = sparsity.ell_tables()
    packed = data.reshape(n * pr, 18)[nnz_to_ell].T  # (18, nnz) fsbsr comps
    dev = plan.row_ptr_t.device
    return WinELLMatrixT(
        vals=torch.tensor(np.ascontiguousarray(packed[WIN2COMP]),
                          dtype=dtype or default_dtype(dev), device=dev),
        plan=plan,
    )


def particles_from_numpy(x, v, mass, radius, device="cuda", dtype=None) -> ParticleState:
    """A ParticleState from the JAX package's (P, 3) / (P,) arrays."""
    return particle_state(x, v, mass=mass, radius=radius, device=device, dtype=dtype)


def _tuple(v):
    return None if v is None else tuple(v)


def dem_config_from_dict(d: dict) -> DEMConfig:
    """The port's DEMConfig from `dataclasses.asdict(jax_dem_cfg)` (its
    CellGrid and ContactParams included)."""
    g = d["grid"]
    grid = CellGrid(
        origin=tuple(float(o) for o in g["origin"]), cell_size=float(g["cell_size"]),
        dims=tuple(int(n) for n in g["dims"]), capacity=int(g["capacity"]),
    )
    return DEMConfig(
        grid=grid, contact=ContactParams(**d["contact"]), gravity=tuple(d["gravity"]),
        dt=d["dt"], walls_lo=_tuple(d["walls_lo"]), walls_hi=_tuple(d["walls_hi"]),
        linear_drag=d["linear_drag"],
    )


def coupled_config_from_dict(d: dict) -> CoupledConfig:
    """The port's CoupledConfig from `dataclasses.asdict(jax_coupled_cfg)`."""
    return CoupledConfig(
        dem=dem_config_from_dict(d["dem"]), drag_mu=d["drag_mu"], substeps=d["substeps"],
        use_grid=d["use_grid"],
    )


def grid_state_from_numpy(pos, vel, radius, mask, pid, device="cuda", dtype=None) -> GridState:
    """A GridState from the JAX package's (K, NC) arrays; pos and vel are
    three arrays each (or a (3, K, NC) array)."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    t = lambda a: torch.tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype, device=dev)
    return GridState(
        pos=tuple(t(a) for a in pos), vel=tuple(t(a) for a in vel), radius=t(radius),
        mask=t(mask),
        pid=torch.tensor(np.ascontiguousarray(np.asarray(pid)), dtype=torch.int32, device=dev),
    )
