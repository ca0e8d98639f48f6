"""Trace-driven cleaning simulator (paper §6): a copy of
``repro.core.simulator``, numpy on the host as the original is, so that one
seed and config give its ``StoreStats`` and per-segment arrays exactly.

Faithful to the paper's setup: fixed-size pages, segments of ``S`` pages,
cleaning triggered when free segments fall below a threshold, ``clean_batch``
segments evacuated per cycle, user writes staged through a sort buffer and
clustered by u_p2 (MDC) before being packed into segments.  Only page ids are
"written" (the paper's simulator does the same — §6.1.1); the store size is
scaled down per paper footnote 2 ("actual size does not impact the write
amplification").

Policies: age | greedy | cost_benefit | mdc | mdc_opt | multilog | multilog_opt
(multi-log per Stoica & Ailamaki [26] as described in the paper §6.1.3/§7.2).

``SimConfig.streams = k`` (k > 1) switches any non-multilog policy to SepBIT
death-stream placement: the sort buffer is bypassed and every write is routed
directly into one of k open segments by predicted invalidation time
(est_death = u_now + the MDC mean-update-interval estimate), via the shared
:class:`~.logstructure.Placement` surface.  Cleaning survivors
demote one stream colder (SepBIT's inference: surviving a clean is evidence
of coldness).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import policies as P
from .segment import USED, Placement, SegmentStore, StoreStats
from .workloads import Workload, make_workload

_MAX_DUP_ROUNDS = 8


@dataclasses.dataclass
class SimConfig:
    nseg: int = 256
    pages_per_seg: int = 512           # paper: 2MB segment / 4KB page = 512
    fill_factor: float = 0.8
    policy: str = "mdc"
    clean_trigger: int = 32            # paper §6.1.1
    clean_batch: int = 64              # paper §6.1.1 (1 for multi-log, per §6.1.3)
    buf_segs: int = 16                 # sort-buffer capacity (paper fig. 4)
    sort_user: bool = True             # separate user writes by u_p2
    sort_gc: bool = True               # separate GC writes by u_p2
    ml_bands: int = 32                 # multi-log frequency bands
    streams: int = 0                   # >=1: SepBIT death-stream placement
                                       # (1 = direct-append baseline, no sort)
    seed: int = 0

    def __post_init__(self):
        if self.policy.startswith("multilog"):
            self.clean_batch = 1
            if self.streams:
                raise ValueError("streams mode is its own placement policy; "
                                 "combine it with a victim policy, not multilog")


class _Buffer:
    """A dedup'ing staging buffer of page ids (user writes or GC survivors)."""

    def __init__(self, capacity: int, tag: int):
        self.cap = capacity
        self.tag = tag  # value stored in page_seg while a page is staged here
        self.pages = np.full(capacity * 2, -1, dtype=np.int64)
        self.n = 0
        self.valid = 0

    def compact(self, page_bufpos: np.ndarray) -> None:
        keep = self.pages[: self.n]
        keep = keep[keep >= 0]
        self.pages[: len(keep)] = keep
        self.pages[len(keep):] = -1
        self.n = len(keep)
        self.valid = len(keep)
        page_bufpos[keep] = np.arange(len(keep))

    def insert(self, pages: np.ndarray, page_bufpos: np.ndarray) -> None:
        k = len(pages)
        if self.n + k > len(self.pages):
            self.compact(page_bufpos)
        if self.n + k > len(self.pages):  # grow (flush cadence still uses .cap)
            grown = np.full(2 * (self.n + k), -1, dtype=np.int64)
            grown[: self.n] = self.pages[: self.n]
            self.pages = grown
        self.pages[self.n:self.n + k] = pages
        page_bufpos[pages] = np.arange(self.n, self.n + k)
        self.n += k
        self.valid += k

    def drop(self, pages: np.ndarray, page_bufpos: np.ndarray) -> None:
        pos = page_bufpos[pages]
        assert (pos >= 0).all()
        self.pages[pos] = -1
        page_bufpos[pages] = -1
        self.valid -= len(pages)

    def take_all(self, page_bufpos: np.ndarray) -> np.ndarray:
        self.compact(page_bufpos)
        out = self.pages[: self.n].copy()
        self.pages[: self.n] = -1
        page_bufpos[out] = -1
        self.n = 0
        self.valid = 0
        return out


class Simulator:
    def __init__(self, cfg: SimConfig, workload: Workload | None = None,
                 workload_name: str = "uniform", tracer=None,
                 calibration=None, **wkw):
        self.cfg = cfg
        S, nseg = cfg.pages_per_seg, cfg.nseg
        self.opt = cfg.policy.endswith("_opt")
        self.multilog = cfg.policy.startswith("multilog")
        self.st_mode = cfg.streams >= 1 and not self.multilog
        self._staged_load = 0
        self._in_clean = False

        # -- scaled-store corrections (see DESIGN.md §4) --------------------
        # The paper's store has 51200 segments, so its 16-segment sort
        # buffer, its 32-free-segment cleaning trigger and the in-flight
        # cleaning batch are all negligible fractions of capacity.  A scaled
        # store must account for them explicitly or the *effective* disk fill
        # factor silently drifts away from F:
        #   * clamps  — trigger/batch stay small fractions of the slack;
        #   * reserve — ~(trigger + batch/2) segments are always free, so
        #     they are removed from usable capacity when sizing user data;
        #   * staging — sort-buffer + GC-residue pages live in RAM; their
        #     steady-state occupancy is added to the user page population and
        #     kept staged from the initial load onward.
        slack0 = nseg - int(cfg.fill_factor * nseg)
        assert slack0 >= 8, f"store too small: only {slack0} slack segments"
        self.clean_trigger = max(2, min(cfg.clean_trigger, slack0 // 16))
        self.clean_batch = max(1, min(cfg.clean_batch, slack0 // 8))
        self.ml_bands = (max(4, min(cfg.ml_bands, slack0 // 3))
                         if self.multilog else cfg.ml_bands)
        self.st_k = (max(1, min(cfg.streams, slack0 // 3))
                     if self.st_mode else 1)
        if self.multilog:
            self.clean_batch = 1

        if workload is None:
            # steady-state free segments ≈ trigger + E·batch/2 (a cleaning
            # cycle frees E·batch net; free oscillates across that band)
            from .analysis import fixpoint_E
            E_est = fixpoint_E(cfg.fill_factor)
            reserve = self.clean_trigger + E_est * self.clean_batch / 2
            if self.multilog:
                reserve += self.ml_bands / 2  # half-full open band segments
            elif self.st_mode:
                reserve += self.st_k / 2      # half-full open stream segments
            else:
                self._staged_load = (cfg.buf_segs * S) // 2 + S // 2
            n_user = int(cfg.fill_factor * (nseg - reserve)) * S \
                + self._staged_load
            if workload_name == "tpcc" and "growth_frac" not in wkw:
                # Paper §6.3: "ran the TPC-C benchmark until the fill factor
                # increased by 0.1" — size the insert volume so F ends at F+0.1.
                wkw["growth_frac"] = 0.1 / cfg.fill_factor
            workload = make_workload(workload_name, n_user, seed=cfg.seed, **wkw)
        self.w = workload
        self.store = SegmentStore(nseg, S, workload.max_pages(),
                                  n_streams=self.st_k)
        self.S = S
        # observability (obs): segment-lifecycle tracing and death
        # calibration hook straight into the shared core.  Attached before
        # the initial load so even the preload placements are recorded.
        self.store.tracer = tracer
        self.calibration = calibration
        if calibration is not None:
            self.store.enable_calibration(calibration)

        mp = workload.max_pages()
        self.page_bufpos = np.full(mp, -1, dtype=np.int64)
        self.page_last = np.zeros(mp, dtype=np.float64)   # last-update clock (multi-log est.)
        self.page_wprob = np.zeros(mp, dtype=np.float64)  # prob charged to seg_prob at write
        self.user_buf = _Buffer(cfg.buf_segs * S, tag=-2)
        self.gc_buf = _Buffer(max(self.clean_batch, 2) * S, tag=-3)

        if self.multilog:
            self.seg_band = np.full(nseg, -1, dtype=np.int64)
            self.band_open: dict[int, int] = {}        # band -> OPEN seg id
            self.band_fifo: dict[int, list[int]] = {}  # band -> sealed seg ids (seal order)
            self._ml_rate: dict[int, float] = {}       # band -> EWMA user-write rate

        self._load_initial()

    # ------------------------------------------------------------------ load
    def _load_initial(self) -> None:
        """Fill the store to F with the initial page population (paper §2.2).

        The last ``_staged_load`` pages stay in the sort buffer (RAM), so the
        disk-resident fill factor is exactly F (see __init__)."""
        pages = self.w.initial_pages()
        if self._staged_load:
            staged = pages[len(pages) - self._staged_load:]
            pages = pages[: len(pages) - self._staged_load]
            self.user_buf.insert(staged, self.page_bufpos)
            self.store.page_seg[staged] = -2
        S = self.S
        if self.multilog:
            # [26]: unknown history ⇒ everything starts in one log.  The
            # estimator maps "never updated" to the coldest band; the -opt
            # oracle knows exact frequencies from the start.
            if self.opt:
                init_bands = self._ml_band(pages, np.zeros(len(pages)), np.zeros(len(pages)))
            else:
                init_bands = np.full(len(pages), self.ml_bands - 1, dtype=np.int64)
        for i in range(0, len(pages) - len(pages) % S, S):
            chunk = pages[i:i + S]
            probs = self.w.probs[chunk]
            self.page_wprob[chunk] = probs
            s = self.store.write_segment(chunk, np.zeros(S), probs, seal_time=i / S - 1e9)
            if self.multilog:
                self._set_band(s, int(np.bincount(init_bands[i:i + S]).argmax()))
        tail = pages[len(pages) - len(pages) % S:]
        if len(tail):
            if self.multilog:  # multi-log starts everything in one log ([26])
                self._ml_append(0, tail, np.zeros(len(tail)))
            elif self.st_mode:
                # never-updated pages go to the coldest stream (cf. multi-log)
                self._st_place(tail, np.zeros(len(tail)),
                               stream=np.full(len(tail), self.st_k - 1))
            else:
                self.user_buf.insert(tail, self.page_bufpos)
                self.store.page_seg[tail] = -2

    def _set_band(self, s: int, band: int) -> None:
        self.seg_band[s] = band
        self.band_fifo.setdefault(band, []).append(s)

    # ---------------------------------------------------------------- ingest
    def run(self, n_updates: int, chunk: int = 4096) -> StoreStats:
        # arrival granularity must stay fine vs the sort buffer, or the
        # buffer degenerates to fill-whole/flush-whole and its steady-state
        # occupancy (compensated for in __init__) collapses
        if not (self.multilog or self.st_mode):
            chunk = min(chunk, max(self.S, self.user_buf.cap // 4))
        done = 0
        while done < n_updates:
            b = min(chunk, n_updates - done)
            ids = self.w.sample(b)
            self._ingest(ids)
            self.w.tick(b)
            done += b
        return self.store.stats

    def run_measured(self, n_updates: int, warmup_frac: float = 0.25,
                     chunk: int = 4096) -> StoreStats:
        warm = int(n_updates * warmup_frac)
        self.run(warm, chunk)
        snap = self.store.stats.snapshot()
        self.run(n_updates - warm, chunk)
        return self.store.stats.since(snap)

    def _ingest(self, ids: np.ndarray) -> None:
        st = self.store
        times = st.u_now + 1.0 + np.arange(len(ids), dtype=np.float64)
        st.u_now += len(ids)
        st.stats.user_writes += len(ids)

        rem = np.arange(len(ids))
        rounds = 0
        while len(rem):
            _, first = np.unique(ids[rem], return_index=True)
            rounds += 1
            if rounds >= _MAX_DUP_ROUNDS:
                # Hot-page fast path: collapse the remaining duplicates to
                # their final occurrence (u_p2 converges to ~u_now anyway).
                _, last = np.unique(ids[rem][::-1], return_index=True)
                take = rem[len(rem) - 1 - last]
                self._apply_updates(ids[take], times[take])
                break
            take = rem[first]
            self._apply_updates(ids[take], times[take])
            mask = np.ones(len(rem), dtype=bool)
            mask[first] = False
            rem = rem[mask]

    def _apply_updates(self, pages: np.ndarray, t: np.ndarray) -> None:
        """One vectorized round of updates over *distinct* pages."""
        st = self.store
        loc = st.page_seg[pages]

        on_disk = loc >= 0
        in_user = loc == -2
        in_gc = loc == -3
        fresh = loc == -1

        old_up2 = np.empty(len(pages), dtype=np.float64)
        # Paper §5.2.2: the old u_p2 "can be found from its containing segment".
        old_up2[on_disk] = st.seg_up2[loc[on_disk]]
        old_up2[in_user | in_gc] = st.page_up2[pages[in_user | in_gc]]
        if self.st_mode:
            # a still-OPEN stream segment has no sealed u_p2 mean yet — its
            # pages are the analog of classic's staged writes: use the exact
            # per-page value (paper's "from containing segment" is a sealed-
            # segment storage optimization)
            in_open = on_disk & (st.seg_state[np.maximum(loc, 0)] != USED)
            old_up2[in_open] = st.page_up2[pages[in_open]]

        if on_disk.any():
            st.kill_pages(pages[on_disk], self.page_wprob[pages[on_disk]])
        if in_user.any():
            self.user_buf.drop(pages[in_user], self.page_bufpos)
        if in_gc.any():
            self.gc_buf.drop(pages[in_gc], self.page_bufpos)

        known = ~fresh
        new_up2 = np.empty(len(pages), dtype=np.float64)
        # Paper §5.2.2 (non-first write): new u_p2 = old + 0.5*(u_now - old).
        new_up2[known] = old_up2[known] + 0.5 * (t[known] - old_up2[known])
        if fresh.any():
            # First write: "coldish" — the oldest u_p2 in the batch (§5.2.2).
            base = new_up2[known].min() if known.any() else float(st.seg_up2[st.seg_state == USED].min(initial=0.0))
            new_up2[fresh] = base
        st.page_up2[pages] = new_up2
        prev_last = self.page_last[pages].copy()
        self.page_last[pages] = t

        if self.multilog:
            self._ml_write(pages, new_up2, t, prev_last)
        elif self.st_mode:
            self._st_write(pages, new_up2, t)
        else:
            st.page_seg[pages] = -2
            self.user_buf.insert(pages, self.page_bufpos)
            if self.user_buf.valid >= self.user_buf.cap:
                self._flush_user()

    # ----------------------------------------------------------- placement
    def _sort_key(self, pages: np.ndarray) -> np.ndarray:
        if self.opt:
            return -self.w.probs[pages]  # exact frequency (hottest first)
        return -self.store.page_up2[pages]  # most-recent u_p2 (hottest) first

    def _flush_user(self) -> None:
        st = self.store
        pages = self.user_buf.take_all(self.page_bufpos)
        if self.cfg.sort_user:
            pages = pages[np.argsort(self._sort_key(pages), kind="stable")]
        n_full = (len(pages) // self.S) * self.S
        for i in range(0, n_full, self.S):
            chunk = pages[i:i + self.S]
            self._ensure_free()
            probs = self.w.probs[chunk]
            self.page_wprob[chunk] = probs
            st.write_segment(chunk, st.page_up2[chunk], probs)
        tail = pages[n_full:]
        if len(tail):
            self.user_buf.insert(tail, self.page_bufpos)
            st.page_seg[tail] = -2

    # ------------------------------------------------------------- cleaning
    def _ensure_free(self) -> None:
        guard = 0
        while self.store.free_count() <= self.clean_trigger:
            before = self.store.free_count()
            self._clean_cycle()
            guard += 1
            if guard > 10_000 or self.store.free_count() < before:
                raise RuntimeError("cleaning is not reclaiming space")

    def _clean_cycle(self) -> None:
        if self.st_mode:
            return self._st_clean()
        st = self.store
        eligible = st.seg_state == USED
        victims = P.select_victims(
            self.cfg.policy,
            self.clean_batch,
            live=st.seg_live, S=self.S, up2=st.seg_up2,
            seal_time=st.seg_seal_time, u_now=st.u_now,
            seg_prob=st.seg_prob, eligible=eligible,
        )
        assert len(victims), "no cleanable segment"
        pages, up2 = st.evacuate(victims)
        st.page_seg[pages] = -3
        st.page_up2[pages] = up2
        self.gc_buf.insert(pages, self.page_bufpos)
        self._flush_gc()

    def _flush_gc(self) -> None:
        st = self.store
        pages = self.gc_buf.take_all(self.page_bufpos)
        if self.cfg.sort_gc:
            order = np.argsort(-st.page_up2[pages] if not self.opt else -self.w.probs[pages],
                               kind="stable")
            pages = pages[order]
        n_full = (len(pages) // self.S) * self.S
        for i in range(0, n_full, self.S):
            chunk = pages[i:i + self.S]
            probs = self.w.probs[chunk]
            self.page_wprob[chunk] = probs
            st.write_segment(chunk, st.page_up2[chunk], probs)
        tail = pages[n_full:]
        if len(tail):  # residual survivors stay staged until the next cycle
            self.gc_buf.insert(tail, self.page_bufpos)
            st.page_seg[tail] = -3

    # --------------------------------------------------------- death streams
    def _st_place(self, pages: np.ndarray, up2: np.ndarray, *,
                  est_death: np.ndarray | None = None,
                  stream: np.ndarray | None = None,
                  kind: str | None = None) -> None:
        """Place directly into the k open stream segments (no sort buffer),
        chunked so cleaning can interleave with a large batch."""
        st = self.store
        for i in range(0, len(pages), self.S):
            sel = slice(i, i + self.S)
            chunk = pages[sel]
            if not self._in_clean:
                self._ensure_free()
            probs = self.w.probs[chunk]
            self.page_wprob[chunk] = probs
            st.place(chunk, Placement(
                est_death=None if est_death is None else est_death[sel],
                stream=None if stream is None else stream[sel],
                up2=up2[sel], probs=probs, kind=kind))

    def _st_write(self, pages: np.ndarray, up2: np.ndarray,
                  t: np.ndarray) -> None:
        if self.opt:  # oracle: exact mean interval from true frequencies
            est = t + 1.0 / np.maximum(self.w.probs[pages], 1e-18)
        else:
            # (t - u_p2) is the MDC mean-update-interval estimate (§5.2.2),
            # so one interval ahead of now is the predicted invalidation time
            est = 2.0 * t - up2
        self._st_place(pages, up2, est_death=est, kind=None)

    def _st_clean(self) -> None:
        """Evacuate victims; survivors re-enter one stream colder (SepBIT)."""
        st = self.store
        victims = P.select_victims(
            self.cfg.policy, self.clean_batch,
            live=st.seg_live, S=self.S, up2=st.seg_up2,
            seal_time=st.seg_seal_time, u_now=st.u_now,
            seg_prob=st.seg_prob, eligible=st.seg_state == USED,
        )
        assert len(victims), "no cleanable segment"
        res = st.evacuate_result(victims)
        if not len(res.items):
            return
        if self.opt:
            est = st.u_now + 1.0 / np.maximum(self.w.probs[res.items], 1e-18)
        else:
            est = 2.0 * st.u_now - res.up2_slot
        demoted = st.demote_streams(res.streams, est)
        self._in_clean = True
        try:
            self._st_place(res.items, res.up2_slot, stream=demoted, kind="gc")
        finally:
            self._in_clean = False

    # ------------------------------------------------------------ multi-log
    def _ml_band(self, pages: np.ndarray, t: np.ndarray, prev_last: np.ndarray) -> np.ndarray:
        if self.opt:
            interval = 1.0 / np.maximum(self.w.probs[pages], 1e-18)
        else:
            # Two-interval estimate (u_now - u_p2)/2, the same estimator MDC
            # uses — [26] estimates from update timestamps; giving both
            # algorithms the same-quality estimator isolates the *policy*
            # difference (see DESIGN.md §4).  page_up2 was just refreshed, so
            # (t - page_up2) == (t - old_up2)/2 == the mean update interval.
            interval = np.maximum(t - self.store.page_up2[pages], 1.0)
        band = np.floor(np.log2(np.maximum(interval, 1.0))).astype(np.int64)
        return np.clip(band, 0, self.ml_bands - 1)

    def _ml_write(self, pages: np.ndarray, up2: np.ndarray, t: np.ndarray,
                  prev_last: np.ndarray) -> None:
        bands = self._ml_band(pages, t, prev_last)
        decay = 1.0 - len(pages) / (4.0 * self.cfg.nseg * self.S)
        for b in self._ml_rate:
            self._ml_rate[b] *= decay
        for b in np.unique(bands):
            sel = bands == b
            self._ml_rate[int(b)] = self._ml_rate.get(int(b), 0.0) + int(sel.sum())
            self._ml_append(int(b), pages[sel], up2[sel])

    def _ml_append(self, band: int, pages: np.ndarray, up2: np.ndarray) -> None:
        st = self.store
        i = 0
        while i < len(pages):
            if band not in self.band_open:
                if not getattr(self, "_in_clean", False):
                    self._ensure_free_ml(band)
                # _ensure_free_ml may itself have opened this band (survivor
                # demotion) — only begin a segment if it is still missing.
                if band not in self.band_open:
                    self.band_open[band] = st.begin_segment()
            s = self.band_open[band]
            room = st.room(s)
            take = min(room, len(pages) - i)
            chunk = pages[i:i + take]
            probs = self.w.probs[chunk]
            self.page_wprob[chunk] = probs
            st.append(s, chunk, up2[i:i + take], probs)
            i += take
            if take == room:
                st.seal(s)
                self._set_band(s, band)
                del self.band_open[band]

    def _ensure_free_ml(self, band: int) -> None:
        guard = 0
        while self.store.free_count() <= self.clean_trigger:
            self._ml_clean(band)
            guard += 1
            if guard > 100_000:
                raise RuntimeError("multi-log cleaning stalled")

    def _ml_prune(self, b: int) -> list[int]:
        """Drop already-cleaned segments from a band's FIFO (lazy)."""
        fifo = self.band_fifo.get(b, [])
        st = self.store
        fifo[:] = [s for s in fifo if st.seg_state[s] == USED and self.seg_band[s] == b]
        return fifo

    def _ml_oldest_cleanable(self, b: int) -> int:
        """Oldest segment of log b with reclaimable space (E > 0), or -1."""
        for s in self._ml_prune(b):
            if self.store.seg_live[s] < self.S:
                return int(s)
        return -1

    def _ml_clean(self, band: int) -> None:
        """Clean 1 segment ([26] as described in the paper §7.2).

        [26] partitions slack among the per-frequency logs and cleans the
        local-optimal segment from the requesting log's neighborhood.  We
        realize that as: find the log most over its space quota
        (quota = its live data + slack shared ∝ its recent write rate), then
        evacuate the best (max-E) of the oldest-cleanable segments of that log
        and its two neighbors.  Survivors demote one log colder.
        """
        st = self.store
        bands = [b for b in self.band_fifo if self._ml_prune(b)]
        assert bands, "multi-log: no sealed segments at all"
        held = np.array([len(self.band_fifo[b]) for b in bands], dtype=np.float64)
        data = np.array([st.seg_live[self.band_fifo[b]].sum() / self.S for b in bands])
        rate = np.array([self._ml_rate.get(b, 0.0) for b in bands]) + 1e-9
        slack = held.sum() - data.sum()
        # Slack share per log ∝ sqrt(update_rate · data_size): the paper §3.2
        # optimum (g_i ∝ sqrt(U_i·Dist_i), R_i ≈ const) that [26] approximates.
        w = np.sqrt(rate / rate.sum() * np.maximum(data, 1e-9))
        quota = data + slack * w / w.sum()
        over = held - quota
        b_star = bands[int(np.argmax(over))]

        victim, best_E = -1, -1
        for b in (b_star - 1, b_star, b_star + 1):
            s = self._ml_oldest_cleanable(b)
            if s >= 0:
                E = (self.S - int(st.seg_live[s])) / self.S
                if E > best_E:
                    victim, best_E = s, E
        if victim < 0:  # neighborhood exhausted: fall back to global sweep
            for b in bands:
                s = self._ml_oldest_cleanable(b)
                if s >= 0:
                    E = (self.S - int(st.seg_live[s])) / self.S
                    if E > best_E:
                        victim, best_E = s, E
        assert victim >= 0, "no cleanable segment in any band"

        src_band = int(self.seg_band[victim])
        self.band_fifo[src_band].remove(victim)
        self.seg_band[victim] = -1
        pages, up2 = st.evacuate(np.array([victim]))
        if len(pages):
            st.page_seg[pages] = -3
            self._in_clean = True
            try:
                if self.opt:
                    # -opt places by exact frequency, survivors included.
                    bands = self._ml_band(pages, np.zeros(len(pages)), np.zeros(len(pages)))
                    for b in np.unique(bands):
                        sel = bands == b
                        self._ml_append(int(b), pages[sel], up2[sel])
                else:
                    # survivors demote one band colder ([26])
                    self._ml_append(min(src_band + 1, self.ml_bands - 1), pages, up2)
            finally:
                self._in_clean = False


def run_policy(policy: str, workload_name: str, *, nseg=256, S=512, F=0.8,
               multiplier=20, seed=0, warmup_frac=0.25, streams=0,
               **wkw) -> StoreStats:
    """Convenience: simulate `multiplier`× the store size of user writes."""
    cfg = SimConfig(nseg=nseg, pages_per_seg=S, fill_factor=F, policy=policy,
                    seed=seed, streams=streams)
    sim = Simulator(cfg, workload_name=workload_name, **wkw)
    n = int(multiplier * nseg * S)
    return sim.run_measured(n, warmup_frac=warmup_frac)
