"""The log-structure substrate behind the cleaning simulator, the serving
KV pool, the session journal and the snapshot store.

A copy of ``repro.core.logstructure``: segment lifecycle (FREE → OPEN →
USED → FREE), per-segment {A, C, u_p2} accounting (§5.1.1), the §5.2.2
u_p2 carry-forward rules, declining-cost victim selection, and death-stream
placement (SepBIT arXiv:2104.12425: ``k`` open segments, each append routed
by running quantiles of its predicted death).  Two accounting modes cover
the paper's two page models:

  FrameLog  — fixed-size pages ("frames": the simulator's pages, the KV
              pool's pages): a segment is ``S`` slots; A is derived as
              S - C free frames.  With ``max_items`` it keeps item → (seg,
              slot) back-pointers, for frontends whose pages have stable
              logical ids (the simulator's ``SegmentStore``).
  ByteLog   — variable-size pages (§4.4): segments are byte extents that
              grow monotonically; A = written − live bytes.  Segment ids are
              never reused (they name files on disk).  :class:`JournalLog`
              (the engine's durable record journal) and the snapshot store
              (``checkpoint.logstore``) are its frontends.

Both share one :class:`StoreStats` that counts frames *and* bytes, so
``wamp()`` means the same thing everywhere.  The simulator's ``-opt``
oracle policies read ``seg_prob``, each segment's sum of its live items'
true update probabilities (:class:`Placement` ``probs``).

Reference counts are kept per frame: a page shared by several sequences
and the prefix cache lives until its last reference drops
(:meth:`FrameLog.incref_slots`, :meth:`FrameLog.kill_slots`), and its death
estimate is the maximum over its holders (:meth:`FrameLog.raise_up2`).

Asynchronous cleaning fences its victims (:meth:`FrameLog.evacuate` with
``fence=True``): their accounting leaves with the survivors at plan time,
but the frames stay un-allocatable (``FENCED``) until the owner commits the
deferred device move (:meth:`LogStructureBase.commit_fenced`).

Observability hooks (``obs``): a tracer attached to a core receives the
segment lifecycle (``seg.open``, ``seg.seal``, ``seg.evacuate``,
``seg.clean``) on its store lane, and :meth:`FrameLog.enable_calibration`
records each frame's routed death estimate so its death can be compared
with it.  Both are ``None`` by default, and then cost one check.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np

from . import policies as P

FREE = 0  # on the free list
OPEN = 1  # currently being filled (multi-log open segments)
USED = 2  # sealed, eligible for cleaning
FENCED = 3  # evacuated under an uncommitted (async) plan: not allocatable,
#             not re-victimizable, until the owner commits the move

IN_FLIGHT = -2  # item_seg marker: evacuated, not yet re-written

# stream cuts before the log has 4 live death tags: everything in stream 0
_STREAM_HORIZON = 1e9


class Clock:
    """The paper's update clock: ticks once per death (the KV pool, the
    snapshot store); the owner decides what a death is."""

    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = now

    def tick(self, n: float = 1.0) -> float:
        self.now += n
        return self.now


@dataclasses.dataclass
class StoreStats:
    """Cumulative counters in items *and* bytes (paper eq. 2); the serving
    vocabulary (blocks, compactions) is read-only alias properties.  The
    fields and their order are the JAX package's, so a session snapshot
    either package wrote loads in the other.

    ``stream_writes`` / ``stream_moves`` break the item counters down by
    placement stream (index = stream, 0 hottest)."""

    user_writes: int = 0       # user items (blocks / chunks / records)
    user_bytes: int = 0
    gc_moves: int = 0          # items relocated by cleaning
    gc_bytes: int = 0
    deaths: int = 0            # items freed (refcount hit zero)
    cleaned_segments: int = 0
    cleanings: int = 0         # clean cycles (pool: compactions)
    sum_E_cleaned: float = 0.0  # Σ empty-fraction of cleaned segments
    frames_shared: int = 0     # extra references taken on live frames
    ref_drops: int = 0         # decrefs that did NOT free (sharing survived)
    # async cleaning's deferred-move debt: items whose move was *planned*
    # (fenced evacuation) and *committed* (remap applied, victims released);
    # planned - committed = moves in flight
    gc_planned: int = 0
    gc_committed: int = 0
    stream_writes: list = dataclasses.field(default_factory=list)
    stream_moves: list = dataclasses.field(default_factory=list)

    def wamp(self) -> float:
        """Write amplification: bytes moved / bytes written (the item ratio
        where no bytes were counted).  0.0 with no user writes."""
        if self.user_bytes:
            return self.gc_bytes / self.user_bytes
        return self.gc_moves / self.user_writes if self.user_writes else 0.0

    def per_stream_wamp(self) -> list:
        """Item-count Wamp per placement stream (moves / writes, 0.0 for a
        stream that never took a user write)."""
        k = max(len(self.stream_writes), len(self.stream_moves))
        out = []
        for i in range(k):
            w = self.stream_writes[i] if i < len(self.stream_writes) else 0
            m = self.stream_moves[i] if i < len(self.stream_moves) else 0
            out.append(m / w if w else 0.0)
        return out

    def mean_E(self) -> float:
        return self.sum_E_cleaned / max(self.cleaned_segments, 1)

    def note_stream(self, stream: int, n: int, kind: str | None) -> None:
        """Count ``n`` items placed into ``stream`` (kind "gc": a move)."""
        tgt = self.stream_moves if kind == "gc" else self.stream_writes
        if len(tgt) <= stream:
            tgt.extend([0] * (stream + 1 - len(tgt)))
        tgt[stream] += n

    def snapshot(self) -> "StoreStats":
        s = dataclasses.replace(self)
        s.stream_writes = list(self.stream_writes)
        s.stream_moves = list(self.stream_moves)
        return s

    def since(self, other: "StoreStats") -> "StoreStats":
        """The counters accrued after ``other`` (a :meth:`snapshot`): the
        simulator's measurement window."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if isinstance(a, list):
                m = max(len(a), len(b))
                out[f.name] = [
                    (a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)
                    for i in range(m)]
            else:
                out[f.name] = a - b
        return StoreStats(**out)

    # -- serving-pool vocabulary ---------------------------------------------
    @property
    def blocks_written(self) -> int:
        return self.user_writes

    @property
    def blocks_moved(self) -> int:
        return self.gc_moves

    @property
    def blocks_died(self) -> int:
        return self.deaths

    @property
    def compactions(self) -> int:
        return self.cleanings


@dataclasses.dataclass
class EvacResult:
    """Live content of an evacuated victim batch, in victim order.

    ``up2_inherit`` is the §5.2.2 GC-write rule (each item takes its
    containing segment's u_p2 mean); ``up2_slot`` is the per-frame value the
    item was appended with (the KV pool's per-block death estimate)."""

    items: np.ndarray        # slot payloads (page ids / block owners)
    up2_inherit: np.ndarray  # containing-segment u_p2 per item
    up2_slot: np.ndarray     # per-slot appended u_p2 per item
    segs: np.ndarray         # source segment per item
    slots: np.ndarray        # source slot per item
    refs: np.ndarray         # reference count per item (carried by the move)
    streams: np.ndarray      # source segment's stream per item (-1 unknown)

    def __len__(self) -> int:
        return len(self.items)


def _per_item(x, n: int) -> np.ndarray:
    """Broadcast a scalar-or-array hint to one float64 value per item."""
    a = np.asarray(x, dtype=np.float64)
    return np.broadcast_to(a, (n,)) if a.ndim == 0 else a


@dataclasses.dataclass
class Placement:
    """Placement hint for one append batch.

    est_death : predicted invalidation clock per item (scalar or array),
                routed by running quantiles into one of the k death-streams
                and stored as the slot's u_p2 tag.
    stream    : explicit stream override (scalar or per-item); cleaning
                survivors pass their demoted stream here and skip routing.
    kind      : "user" | "gc" — write accounting ("gc" moves are counted
                once, at evacuation).
    refs      : per-item reference counts carried through relocation.
    up2       : the §5.2.2 per-item tag; defaults to ``est_death`` (the KV
                pool tags slots with death estimates), else 0.
    probs     : the true update probability per item (the simulator's
                ``-opt`` oracles), summed into ``seg_prob``.
    """

    est_death: "np.ndarray | float | None" = None
    stream: "np.ndarray | int | None" = None
    kind: str | None = "user"
    refs: np.ndarray | None = None
    up2: "np.ndarray | float | None" = None
    probs: np.ndarray | None = None

    def up2_values(self, n: int) -> np.ndarray:
        src = self.up2 if self.up2 is not None else self.est_death
        return np.zeros(n) if src is None else _per_item(src, n)


class StreamSet:
    """The k open segments of one log, bucketed by predicted invalidation
    time (SepBIT's death streams).  Stream 0 is the soonest-dying bucket,
    stream k-1 the coldest.  Holds the routing state only; lifecycle stays
    with the owning log."""

    def __init__(self, k: int, window: int = 4096):
        self.k = max(1, int(k))
        self.open = np.full(self.k, -1, dtype=np.int64)  # stream -> OPEN seg
        self.bounds = np.empty(0, dtype=np.float64)      # k-1 quantile cuts
        # ring of recently appended est_death values: the quantile sample of
        # a log that cannot enumerate its live deaths (ByteLog)
        self._ring = np.zeros(window, dtype=np.float64)
        self._n = 0
        self._pos = 0

    def observe(self, deaths: np.ndarray) -> None:
        deaths = np.asarray(deaths, dtype=np.float64).ravel()[-len(self._ring):]
        end = self._pos + len(deaths)
        if end <= len(self._ring):
            self._ring[self._pos:end] = deaths
        else:
            cut = len(self._ring) - self._pos
            self._ring[self._pos:] = deaths[:cut]
            self._ring[:end - len(self._ring)] = deaths[cut:]
        self._pos = end % len(self._ring)
        self._n = min(self._n + len(deaths), len(self._ring))

    def sample(self) -> np.ndarray:
        return self._ring[:self._n]

    def clear_seg(self, s: int) -> None:
        self.open[self.open == s] = -1


class LogStructureBase:
    """Segment-lifecycle state machine + §5.1.1 accounting, SoA over nseg."""

    _oom_msg = "store out of free segments (cleaning failed to keep up)"

    def __init__(self, nseg: int, *, clock: Clock | None = None,
                 use_free_list: bool = True, n_streams: int = 1):
        self.nseg = int(nseg)
        self.seg_state = np.full(nseg, FREE, dtype=np.int8)
        self.seg_live = np.zeros(nseg, dtype=np.int64)       # C (live items)
        self.seg_up2 = np.zeros(nseg, dtype=np.float64)      # sealed u_p2 mean
        self.seg_up2sum = np.zeros(nseg, dtype=np.float64)   # Σ u_p2, live items
        self.seg_seal_time = np.zeros(nseg, dtype=np.float64)
        self.seg_prob = np.zeros(nseg, dtype=np.float64)     # oracle Σ p(item)
        # which stream wrote each segment (-1: unknown); read back by
        # cleaning to demote survivors one stream colder
        self.seg_stream = np.full(nseg, -1, dtype=np.int16)
        self.streams = StreamSet(n_streams)
        self._use_free_list = use_free_list
        self.free_list: list[int] = (
            list(range(nseg - 1, -1, -1)) if use_free_list else [])
        self.clock = clock if clock is not None else Clock()
        self.stats = StoreStats()
        # observability hooks (obs): None keeps the hot paths free
        self.tracer = None          # obs.trace.Tracer | None
        self.calibration = None     # obs.calibration.DeathCalibration | None

    @property
    def u_now(self) -> float:
        return self.clock.now

    @u_now.setter
    def u_now(self, v: float) -> None:
        self.clock.now = v

    def tick(self, n: float = 1.0) -> float:
        return self.clock.tick(n)

    def free_count(self) -> int:
        return len(self.free_list)

    # segment-lifecycle trace events land on their own thread lane
    _trace_tid = 2

    def _trace_seg(self, name: str, s: int, **args) -> None:
        self.tracer.instant(name, tid=self._trace_tid, cat="segment",
                            seg=int(s), **args)

    # -- lifecycle ------------------------------------------------------------
    def alloc(self) -> int:
        """FREE → OPEN: take a segment for appending."""
        if not self.free_list:
            raise RuntimeError(self._oom_msg)
        s = self.free_list.pop()
        self.seg_state[s] = OPEN
        if self.tracer is not None:
            self._trace_seg("seg.open", s)
        return s

    def seal(self, s: int, seal_time: float | None = None) -> None:
        """OPEN → USED.  Paper §5.2.2: segment u_p2 = mean of its live
        items' u_p2 (frozen until the segment is cleaned)."""
        assert self.seg_state[s] == OPEN
        live = int(self.seg_live[s])
        self.seg_up2[s] = self.seg_up2sum[s] / live if live else self.u_now
        self.seg_seal_time[s] = self.u_now if seal_time is None else seal_time
        self.seg_state[s] = USED
        self.streams.clear_seg(s)
        if self.tracer is not None:
            self._trace_seg("seg.seal", s, live=live,
                            up2=float(self.seg_up2[s]),
                            stream=int(self.seg_stream[s]))

    def release(self, victims: np.ndarray) -> None:
        """→ FREE wholesale (cleaning frees victims after evacuation)."""
        victims = np.asarray(victims, dtype=np.int64)
        self.seg_state[victims] = FREE
        self.seg_live[victims] = 0
        self.seg_up2sum[victims] = 0.0
        self.seg_prob[victims] = 0.0
        self.seg_stream[victims] = -1
        if self._use_free_list:
            self.free_list.extend(int(s) for s in victims)

    def fence(self, victims: np.ndarray) -> None:
        """→ FENCED: accounting has left the victims (their survivors were
        re-placed at plan time), but the frames must not be reallocated
        until the owner commits the deferred device move and remap: until
        then a reader still resolves to the source frames."""
        victims = np.asarray(victims, dtype=np.int64)
        self.seg_state[victims] = FENCED
        self.seg_live[victims] = 0
        self.seg_up2sum[victims] = 0.0
        self.seg_prob[victims] = 0.0
        self.seg_stream[victims] = -1

    def commit_fenced(self, victims: np.ndarray) -> None:
        """FENCED → FREE: the deferred move committed; the frames rejoin the
        free list."""
        victims = np.asarray(victims, dtype=np.int64)
        if len(victims) == 0:
            return
        assert (self.seg_state[victims] == FENCED).all(), \
            "commit_fenced on a non-fenced segment"
        self.release(victims)

    def fenced_count(self) -> int:
        return int((self.seg_state == FENCED).sum())

    # -- death-stream routing -------------------------------------------------
    def _stream_death_sample(self) -> np.ndarray:
        """Quantile sample for the stream cuts (default: recent appends)."""
        return self.streams.sample()

    def refresh_stream_bounds(self) -> None:
        """Recompute the k-1 death-quantile cuts between streams."""
        k = self.streams.k - 1
        if k <= 0:
            self.streams.bounds = np.empty(0, dtype=np.float64)
            return
        sample = self._stream_death_sample()
        if len(sample) >= 4:
            qs = np.quantile(sample, np.linspace(0, 1, k + 2)[1:-1])
            self.streams.bounds = np.sort(qs)
        else:
            self.streams.bounds = np.full(k, self.u_now + _STREAM_HORIZON)

    def route(self, p: Placement, n: int) -> np.ndarray:
        """Stream index per item.  An explicit ``p.stream`` hint wins (GC
        survivors arrive pre-demoted); otherwise ``est_death`` is bucketed by
        the running quantile cuts — soonest-dying items to stream 0."""
        k = self.streams.k
        if p.stream is not None:
            s = np.asarray(p.stream, dtype=np.int64)
            s = np.broadcast_to(s, (n,)) if s.ndim == 0 else s
            return np.clip(s, 0, k - 1)
        if k <= 1 or p.est_death is None:
            return np.zeros(n, dtype=np.int64)
        deaths = _per_item(p.est_death, n)
        self.refresh_stream_bounds()
        out = (np.searchsorted(self.streams.bounds, deaths)
               if len(self.streams.bounds) else np.zeros(n, dtype=np.int64))
        self.streams.observe(deaths)
        return out

    def demote_streams(self, src_streams: np.ndarray, est_death=None,
                       overdue=None) -> np.ndarray:
        """SepBIT's survivor inference: an item that survived a clean is
        colder than its stream predicted, so it steps one stream colder;
        unknown sources (-1) route by ``est_death`` first.

        ``overdue`` restricts the inference to items whose predicted death
        demonstrably passed (the KV pool's absolute death clocks): elsewhere
        ``est_death`` is a believed future clock and survival carries no
        information, so the item re-routes by quantile with no step.  The
        snapshot store, whose every survival means the estimate was too
        hot, omits it."""
        k = self.streams.k
        src = np.asarray(src_streams, dtype=np.int64)
        n = len(src)
        if k <= 1:
            return np.zeros(n, dtype=np.int64)
        need_route = ((src < 0) if overdue is None
                      else (src < 0) | ~np.asarray(overdue, dtype=bool))
        if est_death is not None and need_route.any():
            self.refresh_stream_bounds()
            deaths = _per_item(est_death, n)
            routed = (np.searchsorted(self.streams.bounds, deaths)
                      if len(self.streams.bounds)
                      else np.zeros(n, dtype=np.int64))
            src = np.where(need_route, routed, src)
        stepped = np.minimum(np.maximum(src, 0) + 1, k - 1)
        if overdue is None:
            return stepped
        return np.where(np.asarray(overdue, dtype=bool), stepped,
                        np.clip(src, 0, k - 1))

    def _count_write(self, kind: str | None, n_items: int,
                     n_bytes: int) -> None:
        if kind == "user":
            self.stats.user_writes += n_items
            self.stats.user_bytes += n_bytes
        # kind "gc" moves are counted once, at evacuation


class FrameLog(LogStructureBase):
    """Fixed-size-page mode: segments of ``S`` frame slots.

    Slot occupancy (``slot_item``: payload id or -1), the per-slot u_p2
    (``slot_up2``) and the per-slot reference count live here, so
    evacuation, death accounting and seal means are computed in one place.
    With ``max_items`` set, item → (seg, slot) back-pointers are kept too
    (the simulator's logical pages); without it, items are opaque payloads
    (the KV pool stores sequence owners).  With ``auto_release_empty`` (the
    KV pool) a sealed segment whose last item dies is released at once
    (reclaimed for free, E = 1).  ``stream_sample="live"`` (the KV pool)
    takes the death-quantile cuts from the live slots' tags, which are death
    estimates there; the default samples the recent appends."""

    _noroom_msg = "no open segment with room (all segments sealed+full)"

    def __init__(self, nseg: int, frames_per_seg: int, *,
                 max_items: int | None = None,
                 auto_release_empty: bool = False, n_streams: int = 1,
                 stream_sample: str = "recent"):
        super().__init__(nseg, n_streams=n_streams)
        self.S = int(frames_per_seg)
        self.auto_release_empty = auto_release_empty
        self._stream_sample = stream_sample  # "recent" (ring) | "live" (slots)
        self.seg_fill = np.zeros(nseg, dtype=np.int64)  # next free slot
        self.slot_item = np.full((nseg, self.S), -1, dtype=np.int64)
        self.slot_up2 = np.zeros((nseg, self.S), dtype=np.float64)
        # reference count per slot: 0 = dead/empty, >= 1 live
        self.slot_ref = np.zeros((nseg, self.S), dtype=np.int64)
        self.max_items = max_items
        if max_items is not None:
            self.item_seg = np.full(max_items, -1, dtype=np.int64)
            self.item_slot = np.full(max_items, -1, dtype=np.int64)
            self.item_up2 = np.zeros(max_items, dtype=np.float64)
        # death-calibration side arrays (allocated by enable_calibration)
        self.slot_est = None    # death estimate each slot was routed with
        self.slot_wtime = None  # clock at placement

    def enable_calibration(self, cal) -> None:
        """Attach a :class:`~repro_torch.obs.DeathCalibration`: placements
        start recording their routed estimate and write clock per slot, so
        each death can be compared with its prediction."""
        self.calibration = cal
        if self.slot_est is None:
            self.slot_est = np.full((self.nseg, self.S), np.nan)
            self.slot_wtime = np.zeros((self.nseg, self.S))

    def _stream_death_sample(self) -> np.ndarray:
        if self._stream_sample == "live":
            return self.slot_up2[self.slot_item >= 0]
        return super()._stream_death_sample()

    # -- capacity -------------------------------------------------------------
    def live_items(self) -> int:
        return int(self.seg_live.sum())

    def fill_factor(self) -> float:
        return self.live_items() / (self.nseg * self.S)

    def free_frames(self) -> int:
        """Slots still appendable: whole free segments + open-segment room."""
        open_room = int((self.S - self.seg_fill[self.seg_state == OPEN]).sum())
        return self.free_count() * self.S + open_room

    def room(self, s: int) -> int:
        return self.S - int(self.seg_fill[s])

    # -- writes ---------------------------------------------------------------
    def alloc(self) -> int:
        s = super().alloc()
        self.seg_fill[s] = 0
        return s

    def append(self, s: int, items: np.ndarray, up2: np.ndarray,
               probs: np.ndarray | None = None, kind: str | None = None,
               refs: np.ndarray | None = None) -> np.ndarray:
        """Append items to an explicit OPEN segment; returns slot indices.

        ``refs``: reference count per item (default 1 — a fresh user write
        has exactly its owner's reference).  GC re-appends pass the counts
        carried out of the victims so sharing survives relocation."""
        n = len(items)
        start = int(self.seg_fill[s])
        assert self.seg_state[s] == OPEN and start + n <= self.S
        sl = slice(start, start + n)
        self.slot_item[s, sl] = items
        self.slot_up2[s, sl] = up2
        self.slot_ref[s, sl] = 1 if refs is None else refs
        self.seg_fill[s] = start + n
        self.seg_live[s] += n
        self.seg_up2sum[s] += float(np.sum(up2))
        if probs is not None:
            self.seg_prob[s] += float(np.sum(probs))
        if self.max_items is not None:
            self.item_seg[items] = s
            self.item_slot[items] = np.arange(start, start + n)
            self.item_up2[items] = up2
        # a frame counts one byte unit (the JAX package's frame_bytes 1)
        self._count_write(kind, n, n)
        return np.arange(start, start + n)

    # -- routed multi-stream placement ---------------------------------------
    def stream_segment(self, stream: int) -> int:
        """OPEN segment for ``stream``, allocating or borrowing as needed.

        When no free segment exists for this lifetime class, the nearest
        open stream with room absorbs the append (better slightly-mixed than
        OOM — the borrowed segment keeps its own stream tag)."""
        s = int(self.streams.open[stream])
        if s >= 0:
            return s
        if self.free_count():
            s = self.alloc()
            self.streams.open[stream] = s
            self.seg_stream[s] = stream
            return s
        for b in np.argsort(np.abs(np.arange(self.streams.k) - stream)):
            s = int(self.streams.open[b])
            if s >= 0 and self.room(s):
                return s
        raise RuntimeError(self._noroom_msg)

    def place(self, items: np.ndarray, p: Placement) -> np.ndarray:
        """Route one batch into the k open stream segments; returns flat
        frame ids (``seg * S + slot``).

        One :meth:`append` per (stream, segment) run — O(segments touched),
        not O(items).  Segments that fill are sealed immediately.  Capacity
        must exist (callers clean/compact first)."""
        items = np.asarray(items, dtype=np.int64)
        n = len(items)
        out = np.empty(n, dtype=np.int64)
        if n == 0:
            return out
        streams = self.route(p, n)
        up2 = p.up2_values(n)
        for b in np.unique(streams):
            idx = np.flatnonzero(streams == b)
            pos = 0
            while pos < len(idx):
                s = self.stream_segment(int(b))
                take = min(self.room(s), len(idx) - pos)
                sel = idx[pos:pos + take]
                slots = self.append(
                    s, items[sel], up2[sel],
                    probs=None if p.probs is None else p.probs[sel],
                    kind=p.kind,
                    refs=None if p.refs is None else p.refs[sel])
                out[sel] = s * self.S + slots
                self.stats.note_stream(int(b), int(take), p.kind)
                pos += take
                if self.room(s) == 0:
                    self.seal(s)
        if self.calibration is not None and self.slot_est is not None:
            est = (_per_item(p.est_death, n) if p.est_death is not None
                   else np.full(n, np.nan))
            self.slot_est[out // self.S, out % self.S] = est
            self.slot_wtime[out // self.S, out % self.S] = self.u_now
        return out

    # -- sharing --------------------------------------------------------------
    def incref_slots(self, segs: np.ndarray, slots: np.ndarray,
                     up2: np.ndarray | None = None) -> None:
        """Take an extra reference on live frames (prefix sharing).

        A multi-referenced frame is live until *every* reference is dropped;
        ``up2`` (optional) raises each frame's death estimate to the max over
        its referencing sequences — a shared frame dies when the *last*
        referencer does.  (seg, slot) pairs must be unique within one call,
        like ``kill_slots``."""
        segs = np.asarray(segs, dtype=np.int64)
        slots = np.asarray(slots, dtype=np.int64)
        if len(segs) == 0:
            return
        flat = segs * self.S + slots
        assert len(np.unique(flat)) == len(flat), \
            "duplicate (seg, slot) in one incref call"
        assert (self.slot_ref[segs, slots] >= 1).all(), "incref of dead slot"
        self.slot_ref[segs, slots] += 1
        self.stats.frames_shared += len(segs)
        if up2 is not None:
            self.raise_up2(segs, slots, up2)

    def raise_up2(self, segs: np.ndarray, slots: np.ndarray,
                  up2: np.ndarray) -> None:
        """Raise death estimates to ``max(current, up2)`` and re-tag the
        containing segments (§5.2.2): sealed segments recompute their frozen
        u_p2 mean so victim selection sees the extended lifetime at once."""
        cur = self.slot_up2[segs, slots]
        new = np.maximum(cur, np.asarray(up2, dtype=np.float64))
        self.slot_up2[segs, slots] = new
        np.add.at(self.seg_up2sum, segs, new - cur)
        used = np.unique(segs[self.seg_state[segs] == USED])
        if len(used):
            self.seg_up2[used] = (self.seg_up2sum[used]
                                  / np.maximum(self.seg_live[used], 1))

    # -- deaths ---------------------------------------------------------------
    def kill_slots(self, segs: np.ndarray, slots: np.ndarray,
                   probs: np.ndarray | None = None,
                   tick: bool = False) -> np.ndarray:
        """Drop one reference per frame; frames whose count hits zero die.

        (seg, slot) pairs must be unique within one call.  Death accounting
        — C decrement, u_p2 sums, the paper's per-death clock tick — happens
        only for frames that actually die.

        ``probs`` (the dying items' true update probabilities) leave
        ``seg_prob``.  Returns the segments released (sealed segments that
        became fully empty), when ``auto_release_empty`` is on."""
        if len(segs) == 0:
            return np.empty(0, dtype=np.int64)
        flat = np.asarray(segs, dtype=np.int64) * self.S + slots
        assert len(np.unique(flat)) == len(flat), \
            "duplicate (seg, slot) in one kill_slots call"
        refs = self.slot_ref[segs, slots]
        assert (refs >= 1).all(), "decref of dead slot"
        self.slot_ref[segs, slots] = refs - 1
        survive = refs > 1
        if survive.any():
            self.stats.ref_drops += int(survive.sum())
            segs, slots = segs[~survive], slots[~survive]
            if probs is not None:
                probs = probs[~survive]
            if len(segs) == 0:
                return np.empty(0, dtype=np.int64)
        if self.calibration is not None and self.slot_est is not None:
            self.calibration.record(
                self.seg_stream[segs], self.slot_est[segs, slots],
                self.u_now, wtime=self.slot_wtime[segs, slots],
                bounds=self.streams.bounds)
        up2v = self.slot_up2[segs, slots]
        self.slot_item[segs, slots] = -1
        np.add.at(self.seg_live, segs, -1)
        np.subtract.at(self.seg_up2sum, segs, up2v)
        if probs is not None:
            np.subtract.at(self.seg_prob, segs, probs)
        self.stats.deaths += len(segs)
        if tick:
            self.tick(len(segs))
        if not self.auto_release_empty:
            return np.empty(0, dtype=np.int64)
        cand = np.unique(segs)
        dead = cand[self.seg_live[cand] == 0]
        rel = dead[self.seg_state[dead] == USED]
        if len(rel):
            self.release(rel)
        # a fully-dead OPEN segment keeps its state but rewinds its fill:
        # no live item references its slots, so they are appendable again
        rewind = dead[self.seg_state[dead] == OPEN]
        if len(rewind):
            self.seg_fill[rewind] = 0
            self.slot_up2[rewind] = 0.0
            self.seg_up2sum[rewind] = 0.0
            if self.slot_est is not None:
                self.slot_est[rewind] = np.nan
        return rel

    def kill_items(self, items: np.ndarray,
                   probs: np.ndarray | None = None,
                   tick: bool = False) -> np.ndarray:
        """Kill by logical item id (requires back-pointers).  Only call for
        items whose current version is on disk (item_seg >= 0)."""
        if len(items) == 0:
            return np.empty(0, dtype=np.int64)
        segs = self.item_seg[items]
        assert (segs >= 0).all(), "kill_items on items not on disk"
        return self.kill_slots(segs, self.item_slot[items], probs, tick)

    # -- cleaning -------------------------------------------------------------
    def select_victims(self, policy: str, k: int,
                       eligible: np.ndarray | None = None) -> np.ndarray:
        if eligible is None:
            eligible = self.seg_state == USED
        return P.select_victims(
            policy, k, live=self.seg_live, S=self.S, up2=self.seg_up2,
            seal_time=self.seg_seal_time, u_now=self.u_now,
            seg_prob=self.seg_prob, eligible=eligible)

    def evacuate(self, victims: np.ndarray, *,
                 fence: bool = False) -> EvacResult:
        """Gather victims' live frames, free the victims, account the cycle.

        GC moves are counted here (once); re-appending the survivors should
        use ``kind="gc"`` (uncounted).  With back-pointers, survivors are
        marked IN_FLIGHT until re-written.  ``fence=True`` (async cleaning): the
        victims go to FENCED instead of FREE — their accounting is cleared,
        but the frames stay un-allocatable until :meth:`commit_fenced`,
        because the deferred device move still reads them and stale external
        page ids still resolve to them."""
        victims = np.asarray(victims, dtype=np.int64)
        assert (self.seg_state[victims] == USED).all()
        rows = self.slot_item[victims]                    # (k, S)
        mask = rows >= 0
        r, c = np.nonzero(mask)                           # victim order, then slot
        segs = victims[r]
        items = rows[r, c]
        res = EvacResult(
            items=items,
            up2_inherit=self.seg_up2[segs],
            up2_slot=self.slot_up2[victims][r, c],
            segs=segs,
            slots=c.astype(np.int64),
            refs=self.slot_ref[victims][r, c],
            streams=self.seg_stream[segs].astype(np.int64),
        )
        counts = mask.sum(axis=1)
        self.stats.sum_E_cleaned += float((1.0 - counts / self.S).sum())
        self.stats.cleaned_segments += len(victims)
        self.stats.gc_moves += len(items)
        self.stats.gc_bytes += len(items)
        self.stats.cleanings += 1
        if self.tracer is not None:
            for i, v in enumerate(victims):
                self._trace_seg("seg.evacuate", int(v),
                                E=float(1.0 - counts[i] / self.S),
                                up2=float(self.seg_up2[v]),
                                stream=int(self.seg_stream[v]))
            self._trace_seg("seg.clean", int(victims[0]),
                            victims=len(victims), moves=len(items),
                            mean_E=float((1.0 - counts / self.S).mean()))
        if fence:
            self.stats.gc_planned += len(items)
            self.fence(victims)
        else:
            self.release(victims)
        if self.max_items is not None:
            self.item_seg[items] = IN_FLIGHT
            self.item_slot[items] = -1
        return res

    def release(self, victims: np.ndarray) -> None:
        victims = np.asarray(victims, dtype=np.int64)
        super().release(victims)
        self._clear_slots(victims)

    def fence(self, victims: np.ndarray) -> None:
        victims = np.asarray(victims, dtype=np.int64)
        super().fence(victims)
        # slot accounting leaves with the survivors (block_owner reads of a
        # fenced frame see -1, so an unresolved free trips "double free"
        # instead of corrupting the destination's refcount)
        self._clear_slots(victims)

    def _clear_slots(self, victims: np.ndarray) -> None:
        self.slot_item[victims] = -1
        self.slot_up2[victims] = 0.0
        self.slot_ref[victims] = 0
        self.seg_fill[victims] = 0
        if self.slot_est is not None:
            self.slot_est[victims] = np.nan

    # -- invariant checks -----------------------------------------------------
    def check_invariants(self) -> None:
        live_mask = self.slot_item >= 0
        assert (live_mask.sum(axis=1) == self.seg_live).all(), "C != live slots"
        # refcounts and occupancy agree: a frame is live iff someone holds a
        # reference, and never freed while its refcount is positive
        assert ((self.slot_ref > 0) == live_mask).all(), \
            "slot_ref / slot_item disagree on liveness"
        assert (self.seg_live[self.seg_state == FREE] == 0).all()
        assert self.free_count() == int((self.seg_state == FREE).sum())
        # fenced segments: accounting already left (live == 0, untagged),
        # but the frames are NOT free — never on the free list
        fenced = self.seg_state == FENCED
        assert (self.seg_live[fenced] == 0).all(), "fenced segment has live"
        assert (self.seg_stream[fenced] == -1).all(), \
            "FENCED segment still tagged with a stream"
        assert not (fenced[np.asarray(self.free_list, dtype=np.int64)].any()
                    if self.free_list else False), "fenced segment in free list"
        # stream bookkeeping: open-stream segments are OPEN and tagged; FREE
        # segments carry no stream (no frame is stranded in a ghost stream)
        open_ids = self.streams.open[self.streams.open >= 0]
        assert (self.seg_state[open_ids] == OPEN).all(), \
            "stream points at a non-OPEN segment"
        assert (self.seg_stream[open_ids] >= 0).all(), "untagged open stream"
        assert (self.seg_stream[self.seg_state == FREE] == -1).all(), \
            "FREE segment still tagged with a stream"
        assert (self.seg_stream < self.streams.k).all(), "stream out of range"
        # nothing live past the fill pointer
        past_fill = np.arange(self.S)[None, :] >= self.seg_fill[:, None]
        assert not (live_mask & past_fill).any(), "live frame past fill"
        if self.max_items is None:
            return
        rows, cols = np.nonzero(live_mask)
        items = self.slot_item[rows, cols]
        assert len(np.unique(items)) == len(items), "item live in two frames"
        assert (self.item_seg[items] == rows).all(), "item_seg back-pointer broken"
        assert (self.item_slot[items] == cols).all(), "item_slot back-pointer broken"


class ByteLog(LogStructureBase):
    """Variable-size-page mode (§4.4): byte-extent segments, ids never reused.

    The frontend owns payload placement (file offsets); this class owns every
    counter the lifecycle and the victim keys read: B (written), B−A (live
    bytes), C (live chunks), u_p2 sums and the state machine."""

    def __init__(self, *, clock: Clock | None = None, n_streams: int = 1):
        super().__init__(0, clock=clock, use_free_list=False,
                         n_streams=n_streams)
        self.seg_written = np.zeros(0, dtype=np.int64)     # B
        self.seg_live_bytes = np.zeros(0, dtype=np.int64)  # B - A
        self.next_sid = 0

    def _grow_to(self, n: int) -> None:
        if n <= self.nseg:
            return
        cap = max(16, 2 * self.nseg, n)
        grow = cap - self.nseg

        def pad(a, fill=0):
            return np.concatenate([a, np.full(grow, fill, dtype=a.dtype)])

        self.seg_state = pad(self.seg_state, FREE)
        self.seg_live = pad(self.seg_live)
        self.seg_up2 = pad(self.seg_up2)
        self.seg_up2sum = pad(self.seg_up2sum)
        self.seg_seal_time = pad(self.seg_seal_time)
        self.seg_prob = pad(self.seg_prob)
        self.seg_stream = pad(self.seg_stream, -1)
        self.seg_written = pad(self.seg_written)
        self.seg_live_bytes = pad(self.seg_live_bytes)
        self.nseg = cap

    # -- lifecycle ------------------------------------------------------------
    def alloc(self) -> int:
        s = self.next_sid
        self.next_sid += 1
        self._grow_to(self.next_sid)
        self.seg_state[s] = OPEN
        if self.tracer is not None:
            self._trace_seg("seg.open", s)
        return s

    def seal(self, s: int, seal_time: float | None = None) -> None:
        # the age policy orders by segment id: ids are monotone in seal order
        # (one open segment at a time), and survive state reloads
        super().seal(s, float(s) if seal_time is None else seal_time)

    # -- writes / deaths ------------------------------------------------------
    def open_stream(self, stream: int) -> tuple[int, bool]:
        """OPEN segment id for ``stream`` (allocating one if none is open);
        returns (sid, freshly_allocated).  The frontend owns the file."""
        s = int(self.streams.open[stream])
        if s >= 0:
            return s, False
        s = self.alloc()
        self.streams.open[stream] = s
        self.seg_stream[s] = stream
        return s, True

    def append_bytes(self, s: int, nbytes: int, up2,
                     kind: str | None = "user") -> None:
        """``up2`` is a :class:`Placement` (its ``kind`` wins) or a bare
        float u_p2 tag."""
        if isinstance(up2, Placement):
            kind = up2.kind
            up2 = float(up2.up2_values(1)[0])
        assert self.seg_state[s] == OPEN
        self.seg_written[s] += nbytes
        self.seg_live_bytes[s] += nbytes
        self.seg_live[s] += 1
        self.seg_up2sum[s] += up2
        self.stats.note_stream(max(int(self.seg_stream[s]), 0), 1, kind)
        self._count_write(kind, 1, nbytes)

    def kill_bytes(self, s: int, nbytes: int, up2: float,
                   tick: bool = True) -> None:
        """One chunk died (§5.2.2: the clock ticks once per death)."""
        self.seg_live_bytes[s] -= nbytes
        self.seg_live[s] -= 1
        self.seg_up2sum[s] -= up2
        self.stats.deaths += 1
        if tick:
            self.tick()

    # -- cleaning -------------------------------------------------------------
    def select_victims(self, policy: str, k: int,
                       eligible: np.ndarray | None = None) -> np.ndarray:
        n = self.next_sid
        if eligible is None:
            eligible = (self.seg_state[:n] == USED) & \
                       (self.seg_live_bytes[:n] < self.seg_written[:n])
        return P.select_victims_bytes(
            policy, k, live_bytes=self.seg_live_bytes[:n],
            written=self.seg_written[:n], n_chunks=self.seg_live[:n],
            up2=self.seg_up2[:n], seal_time=self.seg_seal_time[:n],
            u_now=self.u_now, eligible=eligible)

    def evacuate_accounting(self, victims: np.ndarray) -> None:
        """Account one clean cycle and free the victims.  The frontend reads
        the victims' payload bytes *before* calling this, and re-appends the
        survivors with ``kind="gc"`` (moves are counted here, once)."""
        victims = np.asarray(victims, dtype=np.int64)
        assert (self.seg_state[victims] == USED).all()
        written = self.seg_written[victims].astype(np.float64)
        live_b = self.seg_live_bytes[victims]
        self.stats.sum_E_cleaned += float(
            ((written - live_b) / np.maximum(written, 1.0)).sum())
        self.stats.cleaned_segments += len(victims)
        self.stats.gc_moves += int(self.seg_live[victims].sum())
        self.stats.gc_bytes += int(live_b.sum())
        self.stats.cleanings += 1
        if self.tracer is not None:
            E = (written - live_b) / np.maximum(written, 1.0)
            for i, v in enumerate(victims):
                self._trace_seg("seg.evacuate", int(v), E=float(E[i]),
                                up2=float(self.seg_up2[v]),
                                stream=int(self.seg_stream[v]))
            self._trace_seg("seg.clean", int(victims[0]),
                            victims=len(victims),
                            moves=int(self.seg_live[victims].sum()),
                            mean_E=float(E.mean()))
        self.release(victims)

    def release(self, victims: np.ndarray) -> None:
        victims = np.asarray(victims, dtype=np.int64)
        super().release(victims)
        self.seg_written[victims] = 0
        self.seg_live_bytes[victims] = 0

    # -- persistence ----------------------------------------------------------
    def restore_segment(self, sid: int, *, written: int, live_bytes: int,
                        live_chunks: int, up2: float, up2_sum: float,
                        sealed: bool, stream: int = -1) -> None:
        """Rebuild one segment's accounting from persisted frontend state."""
        self._grow_to(sid + 1)
        self.next_sid = max(self.next_sid, sid + 1)
        self.seg_state[sid] = USED if sealed else OPEN
        self.seg_written[sid] = written
        self.seg_live_bytes[sid] = live_bytes
        self.seg_live[sid] = live_chunks
        self.seg_up2[sid] = up2
        self.seg_up2sum[sid] = up2_sum
        self.seg_seal_time[sid] = float(sid)
        self.seg_stream[sid] = stream
        if not sealed and 0 <= stream < self.streams.k:
            self.streams.open[stream] = sid


class JournalLog:
    """Durable append-only record journal, accounted by a :class:`ByteLog`.

    The serving engine writes one small record per state transition
    (submission, admission, emitted tokens, page alloc / release, compaction
    moves, preemption, snapshot markers); recovery is snapshot + replay of
    the surviving records (``serving.recovery``).  On-disk framing per
    record, the JAX package's byte for byte::

        [u32 length][u32 crc32(payload)][u64 seq][payload bytes]

    * ``seq`` is globally monotone and survives reopen, so replay order and
      snapshot cut-points are well defined after segments are reclaimed.
    * On open, each segment file is scanned front to back; the first frame
      whose length overruns the file or whose checksum mismatches marks a
      torn tail, and the file is truncated there (a crash mid-append loses
      at most the record being written, never a committed one).
    * ``compact(before_seq)`` kills every record older than a snapshot
      marker; sealed segment files whose records are all dead are deleted.
      Journal truncation is ordinary log-structured reclamation with zero
      relocation: cleaned segments are fully empty (E = 1), so the journal
      adds nothing to write amplification.
    """

    _HDR = struct.Struct("<IIQ")

    def __init__(self, root: str | os.PathLike, *,
                 seg_bytes: int = 256 * 1024, fsync: bool = False):
        self.root = Path(root)
        # writes its segment files (false only for a :meth:`mirror`)
        self.persist = True
        self.root.mkdir(parents=True, exist_ok=True)
        self.seg_bytes = int(seg_bytes)
        self.fsync = bool(fsync)
        self.core = ByteLog()
        # live record index: seq -> (sid, byte offset, framed size)
        self._index: dict[int, tuple[int, int, int]] = {}
        self.next_seq = 0
        self.torn_bytes = 0          # bytes dropped by torn-tail truncation
        self._cur_sid: int | None = None
        self._fh = None
        self._open_scan()

    def _seg_path(self, sid: int) -> Path:
        return self.root / f"journal_{sid:08d}.log"

    def _scan_file(self, path: Path):
        """Parse one segment file; returns ([(seq, off, size)], valid_prefix)."""
        data = path.read_bytes()
        off, recs = 0, []
        while off + self._HDR.size <= len(data):
            ln, crc, seq = self._HDR.unpack_from(data, off)
            end = off + self._HDR.size + ln
            if end > len(data):
                break                      # torn: length overruns the file
            if zlib.crc32(data[off + self._HDR.size:end]) != crc:
                break                      # torn: checksum mismatch
            recs.append((seq, off, end - off))
            off = end
        return recs, off

    def _open_scan(self) -> None:
        sids = sorted(int(p.stem.split("_")[1])
                      for p in self.root.glob("journal_*.log"))
        last = sids[-1] if sids else None
        for sid in sids:
            path = self._seg_path(sid)
            recs, valid = self._scan_file(path)
            size = path.stat().st_size
            if valid < size:               # torn tail: truncate to last good
                with open(path, "r+b") as f:
                    f.truncate(valid)
                self.torn_bytes += size - valid
            for seq, off, rsize in recs:
                self._index[seq] = (sid, off, rsize)
                self.next_seq = max(self.next_seq, seq + 1)
            # every surviving record is live until the owner compacts behind
            # the last snapshot's cut-point
            self.core.restore_segment(
                sid, written=valid, live_bytes=sum(r[2] for r in recs),
                live_chunks=len(recs), up2=0.0, up2_sum=0.0,
                sealed=sid != last)
        if last is not None:
            self._cur_sid = last
            self._fh = open(self._seg_path(last), "ab")

    def _rotate(self) -> None:
        if self._cur_sid is not None:
            if self._fh is not None:
                self._fh.close()
            self.core.seal(self._cur_sid)
        self._cur_sid = self.core.alloc()
        if self.persist:
            self._fh = open(self._seg_path(self._cur_sid), "ab")

    def append(self, payload: bytes) -> int:
        """Durably append one record; returns its seq."""
        if self._cur_sid is None or \
                int(self.core.seg_written[self._cur_sid]) >= self.seg_bytes:
            self._rotate()
        seq = self.next_seq
        frame = self._HDR.pack(len(payload), zlib.crc32(payload), seq) + payload
        off = int(self.core.seg_written[self._cur_sid])
        if self.persist:
            self._fh.write(frame)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        self.core.append_bytes(self._cur_sid, len(frame), 0.0, kind="user")
        self._index[seq] = (self._cur_sid, off, len(frame))
        self.next_seq = seq + 1
        return seq

    def append_record(self, obj: dict) -> int:
        """JSON wrapper over :meth:`append` (the JAX engine's encoding)."""
        return self.append(
            json.dumps(obj, separators=(",", ":")).encode("utf-8"))

    def records(self, start_seq: int = 0):
        """(seq, payload bytes) of the live records, in seq order."""
        if not self.persist:
            raise RuntimeError("a journal mirror holds no records: read the "
                               "writer's journal")
        by_sid: dict[int, list[tuple[int, int, int]]] = {}
        for seq, (sid, off, size) in self._index.items():
            if seq >= start_seq:
                by_sid.setdefault(sid, []).append((seq, off, size))
        out = []
        if self._fh is not None:
            self._fh.flush()
        for sid, entries in by_sid.items():
            data = self._seg_path(sid).read_bytes()
            for seq, off, size in entries:
                out.append((seq, data[off + self._HDR.size:off + size]))
        out.sort()
        return out

    def iter_records(self, start_seq: int = 0):
        """Yield (seq, decoded JSON record) in seq order."""
        for seq, payload in self.records(start_seq):
            yield seq, json.loads(payload.decode("utf-8"))

    def compact(self, before_seq: int) -> int:
        """Kill records with seq < before_seq (superseded by a snapshot) and
        delete sealed segment files left fully dead.  Returns files deleted."""
        dead = [s for s in self._index if s < before_seq]
        for seq in dead:
            sid, _, size = self._index.pop(seq)
            self.core.kill_bytes(sid, size, 0.0, tick=False)
        n = self.core.next_sid
        empty = (self.core.seg_state[:n] == USED) & (self.core.seg_live[:n] == 0)
        victims = np.nonzero(empty)[0]
        if len(victims):
            self.core.evacuate_accounting(victims)   # E = 1, zero moves
            if self.persist:
                for sid in victims:
                    self._seg_path(int(sid)).unlink(missing_ok=True)
        return len(victims)

    def check_tail(self) -> None:
        """Audit hook: the open segment re-parses cleanly end to end and the
        last durable record's seq matches the in-memory cursor (a mirror
        has no file to check)."""
        if not self.persist:
            return
        if self._cur_sid is None:
            assert not self._index, "live records with no segment open"
            return
        self._fh.flush()
        path = self._seg_path(self._cur_sid)
        recs, valid = self._scan_file(path)
        assert valid == path.stat().st_size, "torn tail in open journal segment"
        if recs:
            assert recs[-1][0] == self.next_seq - 1, \
                f"journal tail seq {recs[-1][0]} != cursor {self.next_seq - 1}"

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None

    def mirror(self) -> "JournalLog":
        """A copy of this journal's accounting that writes and reads no file
        (``persist`` false): what a tensor-parallel serving rank other than
        the writer keeps.  It appends and compacts the same records as the
        writer, so its sequence numbers, byte counts and Wamp (and its
        engine's ``metrics()``) are the writer's; it is picklable, for the
        broadcast from the writer."""
        m = copy.copy(self)
        m.persist, m.fsync, m._fh = False, False, None
        m.core = copy.deepcopy(self.core)
        m._index = dict(self._index)
        return m
