"""Leveled logger and JSONL metrics stream (counterpart of
dedflow_tpu/utils/log.py).

The reference's only observability is raw printf (main.c:340-354,
main.c:266-269, krylov.c:284-285); the JAX package replaces it with a
stdlib logger on stderr and an append-only JSONL metrics file, and so does
the port, with the same format and records.
"""

from __future__ import annotations

import json
import logging
import sys
import time


class _StderrHandler(logging.StreamHandler):
    """A stream handler that writes to whatever `sys.stderr` is when a
    record comes (the CLI runs in-process under callers that swap it)."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _):
        pass


def get_logger(name: str = "dedflow", level: str = "info") -> logging.Logger:
    """The named logger with one stderr handler (added once), the JAX
    package's format, at `level` ("debug", "info", ...)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = _StderrHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level.upper()))
    return logger


class MetricsWriter:
    """Append-only JSONL metrics: one JSON object a record, flushed at once;
    `wall_s` defaults to the seconds since the writer was opened. A None
    path writes nothing."""

    def __init__(self, path: str | None):
        self._f = open(path, "a") if path else None
        self._t0 = time.time()

    def write(self, **fields) -> None:
        if self._f is None:
            return
        fields.setdefault("wall_s", round(time.time() - self._t0, 3))
        self._f.write(json.dumps(fields) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
