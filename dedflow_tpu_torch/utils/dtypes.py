"""Dtype and device policy (counterpart of dedflow_tpu/utils/dtypes.py).

The port computes in float64 on the CPU (the validation regime the JAX
package's tests run in) and in float32 on CUDA, where the hand-written
kernels live. There is no global default device: every solver object is
given its device and dtype, and a CUDA request on a machine without a
card raises instead of falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Index dtype (reference: index_type = i32, common.h:21-59).
INDEX_DTYPE = np.int32


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; the port never falls back to the CPU"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA (the kernels' type), float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


def parse_dtype(name: str | None, device: torch.device) -> torch.dtype:
    """'f32' / 'f64', or the device's default for None."""
    if name is None:
        return default_dtype(device)
    table = {"f32": torch.float32, "f64": torch.float64}
    if name not in table:
        raise ValueError(f"unsupported dtype {name!r}")
    return table[name]


def disable_tf32() -> None:
    """Keep float32 matrix products in full float32: GMRES's Gram-Schmidt
    products go through torch.matmul and must not drop to TF32 (about
    three decimal digits). Both switches are set explicitly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_floats(obj, dtype: torch.dtype):
    """`obj` with every floating tensor in it cast to `dtype`: tensors,
    and the fields of dataclasses, tuples and lists, recursively (the JAX
    package's tree_map over a pytree's floating leaves, newton.py:196-238).
    Integer and bool tensors and everything else are kept as they are."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (tuple, list)):
        return type(obj)(cast_floats(v, dtype) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: cast_floats(getattr(obj, f.name), dtype)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj
