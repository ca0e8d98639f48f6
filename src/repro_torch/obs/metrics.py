"""Periodic metric snapshots to a JSONL sink, with per-interval deltas.

A copy of ``repro.obs.metrics``.

Each :meth:`MetricsLogger.sample` call writes one JSON line::

    {"t": <clock>, "seq": <n>, <fields...>, "d": {<deltas of cumulative fields>}}

The ``d`` sub-object holds the change since the previous sample for every
numeric field (elementwise for lists of numbers), so cumulative counters
(blocks written, gc moves, preemptions) become per-interval rates without
post-processing, while gauges (free blocks, queue depth) are read directly
from the top-level fields.
"""

from __future__ import annotations

import json
import time

__all__ = ["MetricsLogger"]


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _num_list(v) -> bool:
    return isinstance(v, list) and all(_is_num(x) for x in v)


class MetricsLogger:
    """Writes metric rows as JSON lines to ``sink`` (a path or a file-like
    object with ``.write``).  The logger owns the file only when given a
    path."""

    def __init__(self, sink, clock=None):
        self.clock = clock if clock is not None else time.perf_counter
        self._owns = isinstance(sink, (str, bytes)) or hasattr(sink, "__fspath__")
        self._f = open(sink, "w") if self._owns else sink
        self._prev: dict | None = None
        self.samples = 0

    def sample(self, fields: dict) -> dict:
        """Record one snapshot; returns the row written (with deltas)."""
        row = {"t": self.clock(), "seq": self.samples}
        row.update(fields)
        deltas = {}
        if self._prev is not None:
            for k, v in fields.items():
                p = self._prev.get(k)
                if _is_num(v) and _is_num(p):
                    deltas[k] = v - p
                elif _num_list(v) and _num_list(p):
                    m = max(len(v), len(p))
                    deltas[k] = [
                        (v[i] if i < len(v) else 0) - (p[i] if i < len(p) else 0)
                        for i in range(m)]
        row["d"] = deltas
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()   # rows are periodic; readers tail the file live
        self._prev = dict(fields)
        self.samples += 1
        return row

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()
