"""Starting the ranks of a multi-device run (the port's counterpart of the
JAX package's device meshes: a jax.sharding.Mesh over real chips, or over
virtual CPU devices, __graft_entry__.py:59-82 there).

    results = spawn(fn, world, device, args)

starts `world` processes with the "spawn" start method (CUDA cannot be
forked), each of which joins one torch.distributed process group through a
TCP store on 127.0.0.1 at a free port, then calls fn(device, *args) and
sends its return value back. The backend and the device of each rank
(`backend_for`):

- device "cpu": gloo, one torch thread a rank;
- device "cuda" with at least `world` cards: NCCL, card r for rank r;
- device "cuda" with fewer: gloo, every rank on card 0 (the JAX package's
  virtual devices on one host). Gloo's transport is the CPU, so the ranks'
  exchanges are staged through pinned host memory (parallel.spmd).

Every rank calls torch.cuda.set_device on its card. A rank that raises
fails the run with its traceback, and the others are stopped; a run that
outlasts `timeout` seconds (a deadlock) is stopped and raises TimeoutError,
never hangs. The parent builds nothing itself: callers build the kernels
they need before spawning (utils.nvcc.load; its build lock makes the ranks'
own builds safe too).
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(world: int, device: str) -> str:
    """The process group backend of `world` ranks on `device`."""
    if device == "cpu":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(rank: int, backend: str, device: str) -> str:
    """The device a rank computes on: its own card under NCCL, card 0 for
    gloo ranks sharing it, or the CPU."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank if backend == 'nccl' else 0}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, fn, args, results, timeout):
    try:
        dev = rank_device(rank, backend, device)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(dev, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, device="cuda", args=(), timeout: float = 900.0) -> list:
    """Run fn(device, *args) on `world` ranks of one process group (module
    docstring); returns the ranks' return values in rank order. `fn` and
    `args` must pickle (a module-level function)."""
    if world < 1:
        raise ValueError("spawn needs at least one rank")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "the port never falls back to the CPU")
    backend = backend_for(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, fn, args, results, timeout),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = [None] * world
    try:
        for _ in range(world):
            while True:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                    break
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} of {world} ({backend}) died with "
                                           f"exit code {procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world} ranks on {device} ({backend}) did not "
                                           f"finish in {timeout:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} ({backend}) failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.01))
            if p.exitcode is None:
                raise TimeoutError(f"a rank of {world} did not exit in {timeout:.0f} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return out
