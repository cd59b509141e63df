"""Carry configuration, state and matrices from the JAX package's plain
forms into the port's objects. Imports no jax: every input is a dict or a
NumPy array, which is what the JAX package exposes (`config._to_dict`,
`reference_initial_state`, `np.asarray` of an FSDIAMatrixT's arrays)."""

from __future__ import annotations

import numpy as np
import torch

from dedflow_tpu_torch import config
from dedflow_tpu_torch.sparse.fsbsr import FSDIAMatrixT
from dedflow_tpu_torch.utils.dtypes import default_dtype, resolve_device


def config_from_dict(d: dict) -> config.SolverConfig:
    """The port's SolverConfig from the JAX package's `config._to_dict(cfg)`
    form (the schema `load_config` reads)."""
    return config.from_dict(d)


def state_from_numpy(wg, dwgold, dwg, device="cpu", dtype=None):
    """(N, 6) states (reference_initial_state) -> three tensors."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype(dev)
    return tuple(
        torch.tensor(np.asarray(a), dtype=dtype, device=dev) for a in (wg, dwgold, dwg)
    )


def dia_from_numpy(data, scal, offsets, num_node, device="cpu", dtype=None) -> FSDIAMatrixT:
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
