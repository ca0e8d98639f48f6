"""The log-structure substrate behind the serving KV pool (fixed-size pages).

A copy of the ``FrameLog`` path of ``repro.core.logstructure``: segment
lifecycle (FREE → OPEN → USED → FREE), per-segment {A, C, u_p2} accounting
(§5.1.1), the §5.2.2 u_p2 carry-forward rules, declining-cost victim
selection, and death-stream placement (SepBIT arXiv:2104.12425: ``k`` open
segments, each append routed by running quantiles of its predicted death).

What the serving slice does not run is left out: the byte-accounted log and
its journal, fenced (asynchronous) cleaning, the simulator's item
back-pointers, the oracle update probabilities, prefix sharing's extra
references, and the observability hooks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import policies as P

FREE = 0  # on the free list
OPEN = 1  # currently being filled (multi-log open segments)
USED = 2  # sealed, eligible for cleaning

# stream cuts before the log has 4 live death tags: everything in stream 0
_STREAM_HORIZON = 1e9


class Clock:
    """The paper's update clock: ticks once per death (the KV pool)."""

    __slots__ = ("now",)

    def __init__(self, now: float = 0.0):
        self.now = now

    def tick(self, n: float = 1.0) -> float:
        self.now += n
        return self.now


@dataclasses.dataclass
class StoreStats:
    """Cumulative counters (paper eq. 2, with uniform frames); the serving
    vocabulary (blocks, compactions) is read-only alias properties.

    ``stream_writes`` / ``stream_moves`` break the item counters down by
    placement stream (index = stream, 0 hottest)."""

    user_writes: int = 0       # user items (blocks) written
    gc_moves: int = 0          # items relocated by cleaning
    deaths: int = 0            # items freed (refcount hit zero)
    cleaned_segments: int = 0
    cleanings: int = 0         # clean cycles (pool: compactions)
    sum_E_cleaned: float = 0.0  # Σ empty-fraction of cleaned segments
    ref_drops: int = 0         # decrefs that did NOT free (sharing survived)
    stream_writes: list = dataclasses.field(default_factory=list)
    stream_moves: list = dataclasses.field(default_factory=list)

    def wamp(self) -> float:
        """Write amplification: moved / written (frames are uniform, so this
        is the byte ratio too).  0.0 with no user writes."""
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

    # -- serving-pool vocabulary ---------------------------------------------
    @property
    def blocks_written(self) -> int:
        return self.user_writes

    @property
    def blocks_moved(self) -> int:
        return self.gc_moves

    @property
    def compactions(self) -> int:
        return self.cleanings


@dataclasses.dataclass
class EvacResult:
    """Live content of an evacuated victim batch, in victim order.

    ``up2_slot`` is the per-frame value the item was appended with (the KV
    pool's per-block death estimate)."""

    items: np.ndarray        # slot payloads (block owners) of live slots
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
    """

    est_death: "np.ndarray | float | None" = None
    stream: "np.ndarray | int | None" = None
    kind: str | None = "user"
    refs: np.ndarray | None = None

    def up2_values(self, n: int) -> np.ndarray:
        src = self.est_death
        return np.zeros(n) if src is None else _per_item(src, n)


class StreamSet:
    """The k open segments of one log, bucketed by predicted invalidation
    time (SepBIT's death streams).  Stream 0 is the soonest-dying bucket,
    stream k-1 the coldest.  Holds the routing state only; lifecycle stays
    with the owning log."""

    def __init__(self, k: int):
        self.k = max(1, int(k))
        self.open = np.full(self.k, -1, dtype=np.int64)  # stream -> OPEN seg
        self.bounds = np.empty(0, dtype=np.float64)      # k-1 quantile cuts

    def clear_seg(self, s: int) -> None:
        self.open[self.open == s] = -1


class LogStructureBase:
    """Segment-lifecycle state machine + §5.1.1 accounting, SoA over nseg."""

    _oom_msg = "store out of free segments (cleaning failed to keep up)"

    def __init__(self, nseg: int, *, n_streams: int = 1):
        self.nseg = int(nseg)
        self.seg_state = np.full(nseg, FREE, dtype=np.int8)
        self.seg_live = np.zeros(nseg, dtype=np.int64)       # C (live items)
        self.seg_up2 = np.zeros(nseg, dtype=np.float64)      # sealed u_p2 mean
        self.seg_up2sum = np.zeros(nseg, dtype=np.float64)   # Σ u_p2, live items
        self.seg_seal_time = np.zeros(nseg, dtype=np.float64)
        # which stream wrote each segment (-1: unknown); read back by
        # cleaning to demote survivors one stream colder
        self.seg_stream = np.full(nseg, -1, dtype=np.int16)
        self.streams = StreamSet(n_streams)
        self.free_list: list[int] = list(range(nseg - 1, -1, -1))
        self.clock = Clock()
        self.stats = StoreStats()

    @property
    def u_now(self) -> float:
        return self.clock.now

    def tick(self, n: float = 1.0) -> float:
        return self.clock.tick(n)

    def free_count(self) -> int:
        return len(self.free_list)

    # -- lifecycle ------------------------------------------------------------
    def alloc(self) -> int:
        """FREE → OPEN: take a segment for appending."""
        if not self.free_list:
            raise RuntimeError(self._oom_msg)
        s = self.free_list.pop()
        self.seg_state[s] = OPEN
        return s

    def seal(self, s: int) -> None:
        """OPEN → USED.  Paper §5.2.2: segment u_p2 = mean of its live
        items' u_p2 (frozen until the segment is cleaned)."""
        assert self.seg_state[s] == OPEN
        live = int(self.seg_live[s])
        self.seg_up2[s] = self.seg_up2sum[s] / live if live else self.u_now
        self.seg_seal_time[s] = self.u_now
        self.seg_state[s] = USED
        self.streams.clear_seg(s)

    def release(self, victims: np.ndarray) -> None:
        """→ FREE wholesale (cleaning frees victims after evacuation)."""
        victims = np.asarray(victims, dtype=np.int64)
        self.seg_state[victims] = FREE
        self.seg_live[victims] = 0
        self.seg_up2sum[victims] = 0.0
        self.seg_stream[victims] = -1
        self.free_list.extend(int(s) for s in victims)

    # -- death-stream routing -------------------------------------------------
    def _stream_death_sample(self) -> np.ndarray:
        raise NotImplementedError

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
        return (np.searchsorted(self.streams.bounds, deaths)
                if len(self.streams.bounds) else np.zeros(n, dtype=np.int64))

    def demote_streams(self, src_streams: np.ndarray, est_death,
                       overdue: np.ndarray) -> np.ndarray:
        """SepBIT's survivor inference, restricted to ``overdue`` items
        (predicted death demonstrably passed): those step one stream colder.
        Elsewhere ``est_death`` is a believed future clock and survival
        carries no information, so the item re-routes by quantile with no
        step; unknown sources (-1) route by ``est_death`` first."""
        k = self.streams.k
        src = np.asarray(src_streams, dtype=np.int64)
        n = len(src)
        if k <= 1:
            return np.zeros(n, dtype=np.int64)
        overdue = np.asarray(overdue, dtype=bool)
        need_route = (src < 0) | ~overdue
        if need_route.any():
            self.refresh_stream_bounds()
            deaths = _per_item(est_death, n)
            routed = (np.searchsorted(self.streams.bounds, deaths)
                      if len(self.streams.bounds)
                      else np.zeros(n, dtype=np.int64))
            src = np.where(need_route, routed, src)
        stepped = np.minimum(np.maximum(src, 0) + 1, k - 1)
        return np.where(overdue, stepped, np.clip(src, 0, k - 1))

    def _count_write(self, kind: str | None, n_items: int) -> None:
        if kind == "user":
            self.stats.user_writes += n_items
        # kind "gc" moves are counted once, at evacuation


class FrameLog(LogStructureBase):
    """Fixed-size-page mode: segments of ``S`` frame slots.

    Slot occupancy (``slot_item``: payload id or -1), the per-slot u_p2
    (``slot_up2``) and the per-slot reference count live here, so
    evacuation, death accounting and seal means are computed in one place.
    Items are opaque payloads (the KV pool stores sequence owners).  A
    sealed segment whose last item dies is released at once (reclaimed for
    free, E = 1)."""

    _noroom_msg = "no open segment with room (all segments sealed+full)"

    def __init__(self, nseg: int, frames_per_seg: int, *, n_streams: int = 1):
        super().__init__(nseg, n_streams=n_streams)
        self.S = int(frames_per_seg)
        self.seg_fill = np.zeros(nseg, dtype=np.int64)  # next free slot
        self.slot_item = np.full((nseg, self.S), -1, dtype=np.int64)
        self.slot_up2 = np.zeros((nseg, self.S), dtype=np.float64)
        # reference count per slot: 0 = dead/empty, >= 1 live
        self.slot_ref = np.zeros((nseg, self.S), dtype=np.int64)

    def _stream_death_sample(self) -> np.ndarray:
        """Quantile cuts over the live slots' death tags (the KV pool's
        slot_up2 *is* a death estimate)."""
        return self.slot_up2[self.slot_item >= 0]

    # -- capacity -------------------------------------------------------------
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
               kind: str | None = None,
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
        self._count_write(kind, n)
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
                    s, items[sel], up2[sel], kind=p.kind,
                    refs=None if p.refs is None else p.refs[sel])
                out[sel] = s * self.S + slots
                self.stats.note_stream(int(b), int(take), p.kind)
                pos += take
                if self.room(s) == 0:
                    self.seal(s)
        return out

    # -- deaths ---------------------------------------------------------------
    def kill_slots(self, segs: np.ndarray, slots: np.ndarray,
                   tick: bool = False) -> np.ndarray:
        """Drop one reference per frame; frames whose count hits zero die.

        (seg, slot) pairs must be unique within one call.  Death accounting
        — C decrement, u_p2 sums, the paper's per-death clock tick — happens
        only for frames that actually die.

        Returns the segments released (sealed segments that became fully
        empty)."""
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
            if len(segs) == 0:
                return np.empty(0, dtype=np.int64)
        up2v = self.slot_up2[segs, slots]
        self.slot_item[segs, slots] = -1
        np.add.at(self.seg_live, segs, -1)
        np.subtract.at(self.seg_up2sum, segs, up2v)
        self.stats.deaths += len(segs)
        if tick:
            self.tick(len(segs))
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
        return rel

    # -- cleaning -------------------------------------------------------------
    def select_victims(self, policy: str, k: int,
                       eligible: np.ndarray | None = None) -> np.ndarray:
        if eligible is None:
            eligible = self.seg_state == USED
        return P.select_victims(
            policy, k, live=self.seg_live, S=self.S, up2=self.seg_up2,
            seal_time=self.seg_seal_time, u_now=self.u_now,
            eligible=eligible)

    def evacuate(self, victims: np.ndarray) -> EvacResult:
        """Gather victims' live frames, free the victims, account the cycle.

        GC moves are counted here (once); re-appending the survivors should
        use ``kind="gc"`` (uncounted)."""
        victims = np.asarray(victims, dtype=np.int64)
        assert (self.seg_state[victims] == USED).all()
        rows = self.slot_item[victims]                    # (k, S)
        mask = rows >= 0
        r, c = np.nonzero(mask)                           # victim order, then slot
        segs = victims[r]
        items = rows[r, c]
        res = EvacResult(
            items=items,
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
        self.stats.cleanings += 1
        self.release(victims)
        return res

    def release(self, victims: np.ndarray) -> None:
        victims = np.asarray(victims, dtype=np.int64)
        super().release(victims)
        self.slot_item[victims] = -1
        self.slot_up2[victims] = 0.0
        self.slot_ref[victims] = 0
        self.seg_fill[victims] = 0

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
