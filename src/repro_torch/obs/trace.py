"""Low-overhead structured event tracer with Chrome-trace JSON export.

A copy of ``repro.obs.trace`` (framework-free, as the original); its
``_jsonable`` also takes a 0-d or small tensor.

Events go into a bounded ring buffer (oldest dropped first, capacity never
exceeded); :meth:`Tracer.export` writes the Chrome trace-event JSON format
(``{"traceEvents": [...]}``) that loads in Perfetto / ``chrome://tracing``.

The tracer is *opt-in*: code that may run without one guards with
``if tracer is not None`` so the disabled path costs a single attribute
check.  When enabled, recording one event is a clock read plus a deque
append of a small tuple — no string formatting, no allocation beyond the
args dict the caller already built.

Timestamps come from a pluggable monotonic clock (default
``time.perf_counter``) shared with the engine, so queue-wait, compute
splits and trace spans sit on one timebase.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["Tracer"]

# event tuple layout: (ph, ts, tid, name, cat, args[, id])
_PH_BEGIN = "B"
_PH_END = "E"
_PH_INSTANT = "i"
_PH_COUNTER = "C"
_PH_ASYNC_BEGIN = "b"
_PH_ASYNC_INSTANT = "n"
_PH_ASYNC_END = "e"


class Tracer:
    """Bounded-ring event recorder with span / instant / counter API.

    ``capacity`` bounds memory: the ring holds at most that many events and
    drops the oldest first (``dropped`` counts them).  ``pid``/``tid`` map
    to Chrome-trace process/thread lanes; the engine uses tid 0 for the
    dispatch loop, tid 1 for request lifecycles and tid 2 for the store.
    """

    def __init__(self, capacity: int = 65536, clock=None, pid: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock = clock if clock is not None else time.perf_counter
        self.pid = int(pid)
        self.dropped = 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._t0 = self.clock()

    # -- recording ------------------------------------------------------------
    def _push(self, ev: tuple) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(ev)

    def instant(self, name: str, tid: int = 0, cat: str = "",
                **args) -> None:
        """One point-in-time event (Chrome-trace ph "i")."""
        self._push((_PH_INSTANT, self.clock(), tid, name, cat, args or None))

    def begin(self, name: str, tid: int = 0, cat: str = "", **args) -> None:
        """Open a duration span (ph "B"); close with :meth:`end`.  Spans on
        one tid must nest (close in reverse open order)."""
        self._push((_PH_BEGIN, self.clock(), tid, name, cat, args or None))

    def end(self, name: str, tid: int = 0, **args) -> None:
        self._push((_PH_END, self.clock(), tid, name, "", args or None))

    @contextmanager
    def span(self, name: str, tid: int = 0, cat: str = "", **args):
        self.begin(name, tid=tid, cat=cat, **args)
        try:
            yield self
        finally:
            self.end(name, tid=tid)

    def counter(self, name: str, tid: int = 0, **values) -> None:
        """Time-series sample (ph "C"): Perfetto renders one track per key."""
        self._push((_PH_COUNTER, self.clock(), tid, name, "", values))

    # -- async spans (overlapping lifecycles, e.g. one per request) -----------
    def async_begin(self, name: str, id: int, tid: int = 0,
                    cat: str = "async", **args) -> None:
        """Open an async span (ph "b"): spans with one (cat, id) pair form a
        track of their own, so overlapping requests need no nesting."""
        self._push((_PH_ASYNC_BEGIN, self.clock(), tid, name, cat,
                    args or None, int(id)))

    def async_instant(self, name: str, id: int, tid: int = 0,
                      cat: str = "async", **args) -> None:
        self._push((_PH_ASYNC_INSTANT, self.clock(), tid, name, cat,
                    args or None, int(id)))

    def async_end(self, name: str, id: int, tid: int = 0,
                  cat: str = "async", **args) -> None:
        self._push((_PH_ASYNC_END, self.clock(), tid, name, cat,
                    args or None, int(id)))

    # -- inspection / export --------------------------------------------------
    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> list[dict]:
        """Ring contents (oldest first) as Chrome-trace event dicts.
        ``ts`` is microseconds relative to tracer construction."""
        out = []
        for rec in self._buf:
            ph, ts, tid, name, cat, args = rec[:6]
            ev = {"ph": ph, "ts": (ts - self._t0) * 1e6,
                  "pid": self.pid, "tid": int(tid), "name": name}
            if cat:
                ev["cat"] = cat
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            if len(rec) > 6:
                ev["id"] = rec[6]
            out.append(ev)
        return out

    def export(self, path=None) -> dict:
        """Build (and optionally write) the Chrome-trace JSON document."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def _jsonable(v):
    """Coerce numpy scalars/arrays and 0-d or small tensors (by their
    ``item`` / ``tolist``) so ``json.dump`` never chokes.  A CUDA tensor
    would be read from the card here, at export: the engine passes only
    host values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)
