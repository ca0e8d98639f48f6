"""Death-prediction calibration: est-death vs. actual death at kill time.

A copy of ``repro.obs.calibration`` (numpy only).

SepBIT (arXiv:2104.12425) validates placement by comparing inferred and
actual invalidation times; this module does the same for every frame the
store routes.  At each death the core reports the frame's placement stream,
the death estimate it was routed with, its write time, and the clock at
which it actually died.  The calibrator accumulates, per stream:

- a **misroute rate** — the fraction of deaths that, re-routed by their
  *actual* lifetime through the current quantile cuts, would have landed
  in a different stream than the one they were physically placed in.  The
  cuts drift forward with the clock, so the observed lifetime is
  re-projected from now (``u_now + (u_now - wtime)``) before routing —
  "if this item were written again right now and lived as long as it
  actually did, which stream should it get?" — which keeps the comparison
  stationary under clock drift;
- **death-time histograms** — log2-bucketed actual lifetimes (death clock
  minus write clock), i.e. the observed death distribution that the
  stream-auto-tuning roadmap item needs as input;
- estimate-error moments (mean signed / mean absolute error).

Frames that were never routed (direct appends with no estimate, NaN est)
are counted in ``unrouted`` and excluded from the statistics.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DeathCalibration"]


class DeathCalibration:
    """Vectorized per-stream accumulator; ``record`` is called from the
    core's kill path with one batch of deaths."""

    def __init__(self, n_streams: int = 1, hist_bins: int = 16):
        self.k = max(int(n_streams), 1)
        self.bins = int(hist_bins)
        k, b = self.k, self.bins
        self.deaths = np.zeros(k, dtype=np.int64)
        self.routable = np.zeros(k, dtype=np.int64)   # misroute defined
        self.misroutes = np.zeros(k, dtype=np.int64)
        self.err_sum = np.zeros(k, dtype=np.float64)  # est - actual
        self.abs_err_sum = np.zeros(k, dtype=np.float64)
        self.life_hist = np.zeros((k, b), dtype=np.int64)
        self.unrouted = 0

    def record(self, streams, est, actual, wtime=None, bounds=None) -> None:
        """Account one batch of deaths.

        ``streams``: placement stream per frame (negative = unknown).
        ``est``: death estimate per frame at placement (NaN = none).
        ``actual``: death clock — scalar (whole batch dies now) or per-frame.
        ``wtime``: write clock per frame (optional; enables the histogram
        and the drift-corrected misroute projection).
        ``bounds``: the router's current quantile cuts (optional; enables
        the misroute comparison — routed indices are clipped to the
        calibrator's stream count, so a store that clamped its own stream
        count still compares sanely).
        """
        streams = np.asarray(streams, dtype=np.int64)
        n = len(streams)
        if n == 0:
            return
        est = np.asarray(est, dtype=np.float64)
        actual = np.broadcast_to(
            np.asarray(actual, dtype=np.float64), (n,))
        ok = (streams >= 0) & (streams < self.k) & ~np.isnan(est)
        self.unrouted += int(n - ok.sum())
        if not ok.any():
            return
        st, e, a = streams[ok], est[ok], actual[ok]
        np.add.at(self.deaths, st, 1)
        np.add.at(self.err_sum, st, e - a)
        np.add.at(self.abs_err_sum, st, np.abs(e - a))
        w = (np.asarray(wtime, dtype=np.float64)[ok]
             if wtime is not None else None)
        if (bounds is not None and len(bounds) and self.k > 1
                and w is not None):
            # re-project the observed lifetime from now: the cuts moved
            # forward with the clock since placement, so routing the raw
            # death clock would collapse everything into stream 0
            routed = np.minimum(
                np.searchsorted(np.asarray(bounds, dtype=np.float64),
                                a + np.maximum(a - w, 0.0)),
                self.k - 1)
            np.add.at(self.routable, st, 1)
            mis = routed != st
            if mis.any():
                np.add.at(self.misroutes, st[mis], 1)
        if w is not None:
            life = np.maximum(a - w, 0.0)
            # bin 0: life < 1; bin i: 2**(i-1) <= life < 2**i; last bin open
            bi = np.where(life < 1.0, 0,
                          np.floor(np.log2(np.maximum(life, 1.0))).astype(
                              np.int64) + 1)
            bi = np.clip(bi, 0, self.bins - 1)
            np.add.at(self.life_hist, (st, bi), 1)

    # -- reporting ------------------------------------------------------------
    @property
    def hist_edges(self) -> list[float]:
        """Left edges of the lifetime bins (last bin is open-ended)."""
        return [0.0] + [float(2 ** i) for i in range(self.bins - 1)]

    def misroute_rate(self) -> float:
        """Overall fraction of (routable) deaths placed in the wrong stream."""
        r = int(self.routable.sum())
        return float(self.misroutes.sum()) / r if r else 0.0

    def report(self) -> dict:
        per = []
        for s in range(self.k):
            d = int(self.deaths[s])
            r = int(self.routable[s])
            per.append({
                "stream": s,
                "deaths": d,
                "misroutes": int(self.misroutes[s]),
                "misroute_rate": int(self.misroutes[s]) / r if r else 0.0,
                "mean_err": self.err_sum[s] / d if d else 0.0,
                "mean_abs_err": self.abs_err_sum[s] / d if d else 0.0,
                "lifetime_hist": self.life_hist[s].tolist(),
            })
        return {
            "n_streams": self.k,
            "deaths": int(self.deaths.sum()),
            "unrouted": self.unrouted,
            "misroute_rate": self.misroute_rate(),
            "hist_edges": self.hist_edges,
            "per_stream": per,
        }

    def format_report(self) -> str:
        """Human-readable summary (``launch.serve --calibration``)."""
        rep = self.report()
        lines = [f"death calibration: {rep['deaths']} deaths, "
                 f"{rep['unrouted']} unrouted, "
                 f"misroute rate {rep['misroute_rate']:.3f}"]
        for p in rep["per_stream"]:
            if not p["deaths"]:
                continue
            lines.append(
                f"  stream {p['stream']}: {p['deaths']:>8d} deaths  "
                f"misroute {p['misroute_rate']:.3f}  "
                f"err {p['mean_err']:+.1f} (|{p['mean_abs_err']:.1f}|)")
            hist = p["lifetime_hist"]
            top = max(hist) or 1
            bars = "".join(" ▁▂▃▄▅▆▇█"[min(8, round(8 * h / top))]
                           for h in hist)
            lines.append(f"    lifetime (log2 bins): |{bars}|")
        return "\n".join(lines)
