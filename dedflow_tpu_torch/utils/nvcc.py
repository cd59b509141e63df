"""Build the CUDA sources under dedflow_tpu_torch/csrc/ at first use.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so a build takes seconds. Libraries land in
`dedflow_tpu_torch/_build/` (ignored by git) under a name that carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. A build that fails raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    name: str
    path: Path
    lib: ctypes.CDLL
    build_seconds: float  # 0.0 when an up-to-date build was reused
    ptxas: list  # the compiler's register / shared-memory / spill lines


_lock = threading.Lock()
_loaded: dict[str, KernelLibrary] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the CUDA kernels of "
        "dedflow_tpu_torch cannot be built"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines() if "ptxas" in ln]


def load(names) -> dict:
    """Build (where needed, in parallel) and load csrc/<name>.cu for each
    name; returns {name: KernelLibrary}."""
    names = [names] if isinstance(names, str) else list(names)
    with _lock:
        todo = [n for n in names if n not in _loaded]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            for name in todo:
                so = BUILD_DIR / f"{name}-{_digest(name)}.so"
                if so.exists():
                    log_path = so.with_suffix(".log")
                    log = log_path.read_text() if log_path.exists() else ""
                    _loaded[name] = KernelLibrary(
                        name, so, ctypes.CDLL(str(so)), 0.0, _ptxas_lines(log)
                    )
                    continue
                tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
                procs[name] = (
                    subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                    so, tmp, time.perf_counter(),
                )
            errors = []
            for name, (proc, so, tmp, t0) in procs.items():
                log, _ = proc.communicate()
                secs = time.perf_counter() - t0
                if proc.returncode != 0:
                    errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
                    continue
                so.with_suffix(".log").write_text(log)
                os.replace(tmp, so)
                _loaded[name] = KernelLibrary(
                    name, so, ctypes.CDLL(str(so)), secs, _ptxas_lines(log)
                )
            if errors:
                raise RuntimeError("\n".join(errors))
        return {n: _loaded[n] for n in names}


def function(name: str, symbol: str, argtypes: list):
    """The C entry `symbol` of csrc/<name>.cu, typed (returns a CUDA
    error code as int)."""
    fn = getattr(load(name)[name].lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
D = ctypes.c_double


def int_array(values) -> ctypes.Array:
    vals = [int(v) for v in values]
    return (ctypes.c_int * len(vals))(*vals)
