"""Log-structured paged KV cache with MDC compaction (host-side block manager).

A copy of the synchronous path of ``repro.serving.kvcache``.  Mapping: KV
*block* = paper page; a *slab* of ``blocks_per_slab`` contiguous pool pages =
paper segment; a block *dies* when its sequence completes (the paper's
overwrite); the clock ``u_now`` ticks once per block death; *compaction*
evacuates the live blocks of victim slabs into fresh slabs and rewrites the
block tables (paper: cleaning).  Victim choice is the paper's §5.1.3 MDC key
over per-slab {A, C, u_p2}, with ``age``/``greedy``/``cost_benefit``
selectable for ablation.

Placement: blocks are appended to one of ``streams`` open slabs bucketed by
*expected death time*, so blocks that die together share a slab and slabs
die nearly whole.  Compaction survivors re-route by the same quantiles
(survivor demotion, ``demote_survivors=True``, applies only to *overdue*
survivors).

Pages are reference-counted: a prompt prefix shared through the prefix
cache holds one reference per sequence that splices it plus one for the
cache, and dies when the last one drops (:meth:`incref_pages`,
:meth:`free_pages`); compaction carries the counts to the destinations.

All slab bookkeeping lives in :class:`FrameLog`; this class owns the serving
policy: the batched alloc surface and the compaction plan (src page -> dst
page) that the engine executes with the ``segment_move`` kernel.

Asynchronous cleaning splits a cycle in two phases.  :meth:`plan_compaction`
places the survivors and *fences* the victims (all accounting, Wamp
included, lands at plan time), cut into budget-sized sub-plans queued on
``pending_plans``; the engine moves them across later dispatches and
:meth:`commit_plan` retires each once every external holder is remapped.
Between the two, holders still carry source ids, which :meth:`resolve`
translates to the destinations through the pending-move LUT.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.logstructure import FENCED, USED, FrameLog, Placement, StoreStats

# the paper's oracle policies need per-page true update probabilities, which
# a serving pool cannot know (a block's owner gives no death distribution)
_SUPPORTED_POLICIES = ("mdc", "greedy", "age", "cost_benefit")


@dataclasses.dataclass
class CompactionPlan:
    """src/dst physical page ids (parallel arrays) + owners for remapping."""
    src_pages: np.ndarray
    dst_pages: np.ndarray
    owners: np.ndarray
    # async cleaning: victim slabs whose *last* move this sub-plan carries,
    # released (FENCED → FREE) when it commits; None for synchronous plans,
    # whose victims were released at evacuation
    commit_segs: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.src_pages)

    def split(self, budget: int, segs: np.ndarray) -> list["CompactionPlan"]:
        """Cut one cleaning cycle into budget-sized sub-plans.

        ``segs`` is the source slab per move, in victim order (contiguous
        runs, as :meth:`FrameLog.evacuate` emits them).  Each victim slab's
        release rides with the sub-plan holding its last move, so a slab
        stays fenced until every move out of it has committed.  ``budget <=
        0`` means unmetered (one sub-plan)."""
        n = len(self)
        step = n if budget <= 0 else max(int(budget), 1)
        segs = np.asarray(segs, dtype=np.int64)
        last = {int(s): i for i, s in enumerate(segs)}
        plans = []
        for lo in range(0, n, step):
            hi = min(lo + step, n)
            commit = np.array(sorted(s for s, i in last.items()
                                     if lo <= i < hi), dtype=np.int64)
            plans.append(CompactionPlan(
                src_pages=self.src_pages[lo:hi],
                dst_pages=self.dst_pages[lo:hi],
                owners=self.owners[lo:hi], commit_segs=commit))
        return plans


class LogStructuredKVPool:
    """Block manager for a paged KV pool laid out as slabs of blocks.

    Physical pool page ids are ``slab * blocks_per_slab + slot``.  The tensor
    pool itself lives with the engine; this class owns allocation, death,
    victim selection and the compaction *plan*, which the engine executes
    (tensor move + block-table remap) through ``on_compaction`` before any
    page id the plan freed can be handed out again — or, with async
    cleaning, across later dispatches (``pending_plans``, ``on_drain``).
    """

    def __init__(self, n_slabs: int, blocks_per_slab: int, *,
                 policy: str = "mdc", streams: int | None = None,
                 demote_survivors: bool = False, compact_trigger: int = 2,
                 compact_batch: int = 4):
        if policy not in _SUPPORTED_POLICIES:
            raise ValueError(
                f"KV pool cannot run policy {policy!r}: oracle policies "
                f"(mdc_opt) need true per-page update probabilities, which a "
                f"serving pool does not have; supported: {_SUPPORTED_POLICIES}")
        self.n_slabs = n_slabs
        self.S = blocks_per_slab
        self.policy = policy
        self.n_open = 4 if streams is None else streams
        self.demote_survivors = demote_survivors
        self.compact_trigger = compact_trigger
        self.compact_batch = compact_batch

        self.core = FrameLog(n_slabs, blocks_per_slab, n_streams=self.n_open)
        self.core._oom_msg = "KV pool out of slabs (compaction failed)"
        self.core._noroom_msg = "KV pool: no open slab (all slabs sealed+full)"
        # flat per-page views of the core's slot arrays (page = slab*S + slot):
        # owner sequence (-1 dead/empty), estimated death clock, and the
        # reference count (one per referencing sequence, plus one if the
        # prefix cache holds the page)
        self.block_owner = self.core.slot_item.reshape(-1)
        self.block_death = self.core.slot_up2.reshape(-1)
        self.block_ref = self.core.slot_ref.reshape(-1)

        # plan executor registered by the engine (tensor move + remap); it
        # MUST run before any page id freed by the plan is re-allocated, so
        # the pool invokes it synchronously at plan creation
        self.on_compaction = None  # Callable[[CompactionPlan], None] | None
        # async cleaning queues its fenced sub-plans here for the engine's
        # pump to move and commit, in order
        self.pending_plans: list[CompactionPlan] = []
        # pressure hook: called with the page deficit when compaction alone
        # cannot satisfy an alloc — the prefix cache registers its LRU
        # eviction here, so unreferenced cached prefixes are given back
        # before the pool declares OOM
        self.on_pressure = None  # Callable[[int], None] | None
        # async-cleaning drain hook: called (no arguments) when the alloc path
        # needs capacity that only committing the planned / in-flight
        # pipeline can give; the engine commits it in order
        self.on_drain = None  # Callable[[], None] | None
        # called with the destinations of uncommitted moves that a free just
        # killed (their pages may be reallocated before the move commits)
        self.on_dead_destination = None  # Callable[[np.ndarray], None] | None
        # sub-plan grain of alloc-path fence-planning (0 = one sub-plan); the
        # engine sets its per-dispatch clean budget here
        self.plan_budget = 0
        # pending-move LUT: between plan and commit, external holders (block
        # tables, the prefix tree) still carry *source* ids while the
        # accounting lives at the destinations; resolve() translates
        self._remap = np.arange(n_slabs * blocks_per_slab + 1, dtype=np.int64)
        self._pending_moves = 0

    @property
    def stats(self) -> StoreStats:
        return self.core.stats

    @property
    def u_now(self) -> float:
        return self.core.u_now

    # -- observability (obs) -------------------------------------------------
    def attach_tracer(self, tracer) -> None:
        """Stream segment-lifecycle events (seg.open/seal/evacuate/clean)
        to ``tracer`` from the shared core; None detaches."""
        self.core.tracer = tracer

    def enable_calibration(self, cal) -> None:
        """Route block deaths to a :class:`~repro_torch.obs.DeathCalibration`:
        each block's est-death (the absolute clock it was placed with) is
        compared against ``u_now`` when it actually dies."""
        self.core.enable_calibration(cal)

    # ------------------------------------------------------------ allocation
    def free_blocks(self) -> int:
        return self.core.free_frames()

    def deferred_moves(self) -> int:
        """Blocks whose move is planned or in flight, not committed."""
        return self._pending_moves

    def projected_free_slabs(self) -> int:
        """Free slabs counting fenced victims as reclaimed already: what the
        free count becomes once the planned pipeline commits."""
        return self.core.free_count() + self.core.fenced_count()

    def resolve(self, pages: np.ndarray) -> np.ndarray:
        """Translate page ids through the pending-move LUT: the identity
        with no debt, else each source id of an uncommitted move maps to its
        (newest) destination.  Every accounting entry point resolves
        first."""
        pages = np.asarray(pages, dtype=np.int64)
        if self._pending_moves == 0:
            return pages
        return self._remap[pages]

    def admission_reserve(self) -> int:
        """Blocks admission control must leave free: ``compact_trigger``
        slabs, the cleaner's evacuation headroom."""
        return self.compact_trigger * self.S

    def alloc_blocks(self, seq_ids: np.ndarray, p: Placement) -> np.ndarray:
        """Allocate one pool page per entry; returns physical page ids.

        ``p.est_death`` is the clock at which each block is expected to die
        (now + expected remaining tokens of its sequence); it drives the
        death-stream placement.  Compaction fires *before* placement when
        free slabs run low, so page ids handed out by one call are never
        moved by that same call."""
        seq_ids = np.asarray(seq_ids, dtype=np.int64)
        if p.kind != "user":
            p = dataclasses.replace(p, kind="user")
        n = len(seq_ids)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        self._compact_until(n)
        if self.core.free_frames() < n and self.on_pressure is not None:
            # last resort before OOM: drop reclaimable references (prefix
            # cache LRU eviction), then clean again
            self.on_pressure(n - self.core.free_frames())
            self._compact_until(n)
        if self.core.free_frames() < n:
            raise RuntimeError("KV pool out of slabs (compaction failed)")
        return self.core.place(seq_ids, p)

    def _compact_until(self, n: int) -> None:
        """Run compaction cycles until ``n`` frames are appendable and the
        free-slab reserve is above the trigger, or no cycle makes progress.

        With async cleaning (``on_drain`` set) the reserve trigger is judged
        on *projected* free slabs (free + fenced), and a crossing that is
        reserve upkeep — frames for ``n`` exist — fence-plans instead of
        compacting: the victims are the ones a synchronous cycle would pick
        at this state, and the moves defer to the engine's pump.  Only a
        real frame shortage drains the pipeline (``on_drain``) before a
        synchronous cycle.  Without async cleaning nothing is fenced, so
        projected equals actual and this is the synchronous trigger."""
        while (self.projected_free_slabs() <= self.compact_trigger
               or self.core.free_frames() < n):
            if self.on_drain is not None and self.core.free_frames() >= n:
                # upkeep, not shortage: fence-plan, unless the cycle does not
                # raise the projection (placement can open fresh slabs)
                proj = self.projected_free_slabs()
                if (self.plan_compaction(self.plan_budget)
                        and self.projected_free_slabs() > proj):
                    continue
            before = self.core.free_frames()
            if self.on_drain is not None and self.deferred_moves():
                debt = self.deferred_moves()
                self.on_drain()
                if self.deferred_moves() < debt:
                    continue
            if self.compact() is None or self.core.free_frames() <= before:
                break

    # ------------------------------------------------------------- sharing
    def incref_pages(self, pages: np.ndarray,
                     est_deaths: np.ndarray | float | None = None) -> None:
        """Add one reference per page (a sequence or the prefix cache starts
        sharing them).  ``est_deaths`` raises each page's death estimate to
        the max over its referencing sequences."""
        pages = self.resolve(pages)
        if len(pages) == 0:
            return
        assert (self.block_owner[pages] >= 0).all(), "incref of dead page"
        up2 = None
        if est_deaths is not None:
            up2 = np.broadcast_to(np.asarray(est_deaths, np.float64),
                                  pages.shape)
        self.core.incref_slots(pages // self.S, pages % self.S, up2=up2)

    # --------------------------------------------------------------- death
    def free_pages(self, pages: np.ndarray) -> None:
        """Drop one reference per block; unshared blocks die (their sequence
        finished or was preempted), shared ones stay live for the remaining
        referencers — a page is freed exactly when its refcount hits zero."""
        pages = np.asarray(pages, dtype=np.int64)
        pages = self.resolve(pages[pages >= 0])
        if len(pages) == 0:
            return
        assert (self.block_owner[pages] >= 0).all(), "double free"
        # sealed slabs that become fully dead are reclaimed for free by the
        # core; open slabs stay open (append-only slots)
        self.core.kill_slots(pages // self.S, pages % self.S, tick=True)
        if self._pending_moves and self.on_dead_destination is not None:
            # a planned move's destination died inside the window: its page
            # can be handed out again while the move may still be writing it
            ident = np.arange(len(self._remap), dtype=np.int64)
            pending_dst = self._remap[self._remap != ident]
            dead = pages[(self.block_ref[pages] == 0)
                         & np.isin(pages, pending_dst)]
            if len(dead):
                self.on_dead_destination(dead)

    # ----------------------------------------------------------- compaction
    def select_victims(self) -> np.ndarray:
        eligible = (self.core.seg_state == USED) & (self.core.seg_live < self.S)
        return self.core.select_victims(self.policy, self.compact_batch,
                                        eligible=eligible)

    def compact(self) -> CompactionPlan | None:
        """Evacuate victims; returns CompactionPlan(src_pages, dst_pages)
        after handing it to ``on_compaction``.  Synchronous: the victims are
        released at evacuation.  It never interleaves with uncommitted async
        plans — the pipeline drains first, so the block tables are current
        when this plan's remap applies."""
        if self.deferred_moves() and self.on_drain is not None:
            self.on_drain()
        assert self.deferred_moves() == 0, \
            "synchronous compact with uncommitted async plans"
        victims = self.select_victims()
        if len(victims) == 0:
            return None
        res = self.core.evacuate(victims)
        src = res.segs * self.S + res.slots
        # §5.3: sort survivors by expected death so they re-cluster; the
        # victims were freed above, so capacity for the survivors exists.
        # Reference counts ride along: sharing is invariant under relocation.
        # Survivor demotion only for *overdue* blocks (alive past their
        # predicted death); the rest re-route by quantile.
        order = np.argsort(res.up2_slot, kind="stable")
        streams = (self.core.demote_streams(res.streams, res.up2_slot,
                                            overdue=res.up2_slot <= self.u_now)
                   if self.demote_survivors else None)
        dst = np.empty(len(src), dtype=np.int64)
        dst[order] = self.core.place(
            res.items[order],
            Placement(est_death=res.up2_slot[order],
                      stream=None if streams is None else streams[order],
                      kind="gc", refs=res.refs[order]))
        plan = CompactionPlan(src_pages=src, dst_pages=dst, owners=res.items)
        if self.on_compaction is not None:
            self.on_compaction(plan)
        return plan

    # --------------------------------------------- async two-phase cleaning
    def plan_compaction(self, budget: int = 0) -> list[CompactionPlan]:
        """Phase one of async cleaning: one cycle whose victims are *fenced*
        instead of freed, cut into ``budget``-sized sub-plans appended to
        ``pending_plans``.  Survivors are placed (and all Wamp accounting
        lands) now, as in :meth:`compact`; only the device move and the
        remap defer.  The victims stay FENCED — not allocatable, not
        re-victimizable — until :meth:`commit_plan` releases them.  Returns
        the new sub-plans ([] when no victim's survivors fit in the current
        free room: the caller then falls back to the synchronous path)."""
        victims = self.select_victims()
        if len(victims) == 0:
            return []
        # survivors take appendable room now, the victims return only at
        # commit: keep the best-ranked victims whose survivors fit
        fits = self.core.seg_live[victims].cumsum() <= self.core.free_frames()
        victims = victims[fits]
        if len(victims) == 0:
            return []
        res = self.core.evacuate(victims, fence=True)
        if len(res) == 0:  # nothing live to move: pure reclamation
            self.core.commit_fenced(victims)
            return []
        src = res.segs * self.S + res.slots
        order = np.argsort(res.up2_slot, kind="stable")
        streams = (self.core.demote_streams(res.streams, res.up2_slot,
                                            overdue=res.up2_slot <= self.u_now)
                   if self.demote_survivors else None)
        dst = np.empty(len(src), dtype=np.int64)
        dst[order] = self.core.place(
            res.items[order],
            Placement(est_death=res.up2_slot[order],
                      stream=None if streams is None else streams[order],
                      kind="gc", refs=res.refs[order]))
        # victims that contributed no move (fully dead) reclaim now
        empty = victims[~np.isin(victims, res.segs)]
        if len(empty):
            self.core.commit_fenced(empty)
        # compose into the pending LUT: a stale id whose earlier destination
        # moves again now resolves to the newest location
        m = np.arange(len(self._remap), dtype=np.int64)
        m[src] = dst
        self._remap = m[self._remap]
        self._pending_moves += len(src)
        plans = CompactionPlan(src, dst, res.items).split(budget, res.segs)
        self.pending_plans.extend(plans)
        return plans

    def commit_plan(self, plan: CompactionPlan) -> None:
        """Phase two: the owner remapped every external holder by this
        sub-plan, so its source ids are gone — retire its LUT entries and
        release the victims whose last move it carried.  Sub-plans commit in
        plan order (the LUT composes in that order)."""
        if len(plan):
            self._remap[plan.src_pages] = plan.src_pages
            self._pending_moves -= len(plan)
            self.stats.gc_committed += len(plan)
        if plan.commit_segs is not None and len(plan.commit_segs):
            self.core.commit_fenced(plan.commit_segs)

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        self.core.check_invariants()
        # pending-move LUT: every non-identity entry maps a page of a FENCED
        # slab (its destination may have died inside the window); with no
        # debt the LUT is the identity
        ident = np.arange(len(self._remap) - 1, dtype=np.int64)
        stale = np.flatnonzero(self._remap[:-1] != ident)
        assert self._pending_moves >= 0, "negative deferred-move debt"
        if self._pending_moves == 0:
            assert len(stale) == 0, "pending LUT left behind after commit"
        else:
            assert (self.core.seg_state[stale // self.S] == FENCED).all(), \
                "pending-move source outside a fenced slab"
