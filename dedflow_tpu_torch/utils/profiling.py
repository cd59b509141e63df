"""Stage timers and the profiler trace (counterpart of
dedflow_tpu/utils/profiling.py).

`StageTimers` accumulates per-stage wall time, synchronising the card
before it stops a stage's clock (the JAX package blocks on a result with
`jax.block_until_ready`; here `torch.cuda.synchronize` waits for all the
card's queued work). `trace` wraps `torch.profiler.profile` where the JAX
package wraps `jax.profiler.trace`: a Chrome / TensorBoard trace file in
the directory, with the host's operators and, on the card, its kernels.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class StageTimers:
    """Accumulating per-stage wall timers (device-synced)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str, sync=None):
        """Time the block; with `sync` (the block's result) the card's
        queued work is waited for before the clock stops."""
        t0 = time.perf_counter()
        yield
        if sync is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            k: {"total_s": round(v, 4), "calls": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }


@contextmanager
def trace(log_dir: str | None, cuda: bool | None = None):
    """torch.profiler trace into `log_dir` (a `*.pt.trace.json` file that
    Chrome's trace viewer and TensorBoard read); a no-op for None. `cuda`
    (default: whether a card is present) adds the card's activities, which
    torch.profiler records through CUPTI: a trace without the card's
    kernels means CUPTI failed, and the caller that needs them checks for
    them."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
