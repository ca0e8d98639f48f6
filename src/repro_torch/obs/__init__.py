"""Observability for the log-structured store and serving engine: a copy
of the JAX package's ``obs``.

- :mod:`.trace` — bounded-ring structured event tracer with Chrome-trace /
  Perfetto JSON export.  The core emits segment-lifecycle events on lane 2,
  the engine request lifecycles on lane 1 and per-dispatch phase spans on
  lane 0.
- :mod:`.metrics` — periodic JSONL snapshots with per-interval deltas
  (Wamp, u_now, free blocks, per-stream writes/moves, queue depth).
- :mod:`.calibration` — est-death vs. actual-death recording at kill time:
  per-stream misroute rate and death-time histograms.

Everything is opt-in: with no tracer or calibration attached the hot paths
run a single ``is None`` check and nothing else.
"""

from .calibration import DeathCalibration
from .metrics import MetricsLogger
from .trace import Tracer

__all__ = ["DeathCalibration", "MetricsLogger", "Tracer"]
