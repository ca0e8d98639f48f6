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

All slab bookkeeping lives in :class:`FrameLog`; this class owns the serving
policy: the batched alloc surface and the compaction plan (src page -> dst
page) that the engine executes with the ``segment_compact`` kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.logstructure import USED, FrameLog, Placement, StoreStats

# the paper's oracle policies need per-page true update probabilities, which
# a serving pool cannot know (a block's owner gives no death distribution)
_SUPPORTED_POLICIES = ("mdc", "greedy", "age", "cost_benefit")


@dataclasses.dataclass
class CompactionPlan:
    """src/dst physical page ids (parallel arrays) + owners for remapping."""
    src_pages: np.ndarray
    dst_pages: np.ndarray
    owners: np.ndarray

    def __len__(self) -> int:
        return len(self.src_pages)


class LogStructuredKVPool:
    """Block manager for a paged KV pool laid out as slabs of blocks.

    Physical pool page ids are ``slab * blocks_per_slab + slot``.  The tensor
    pool itself lives with the engine; this class owns allocation, death,
    victim selection and the compaction *plan*, which the engine executes
    (tensor move + block-table remap) through ``on_compaction`` before any
    page id the plan freed can be handed out again.
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
        # flat per-page views of the core's slot arrays (page = slab*S + slot)
        self.block_owner = self.core.slot_item.reshape(-1)
        self.block_death = self.core.slot_up2.reshape(-1)
        self.block_ref = self.core.slot_ref.reshape(-1)

        # plan executor registered by the engine (tensor move + remap); it
        # MUST run before any page id freed by the plan is re-allocated, so
        # the pool invokes it synchronously at plan creation
        self.on_compaction = None  # Callable[[CompactionPlan], None] | None

    @property
    def stats(self) -> StoreStats:
        return self.core.stats

    @property
    def u_now(self) -> float:
        return self.core.u_now

    # ------------------------------------------------------------ allocation
    def free_blocks(self) -> int:
        return self.core.free_frames()

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
        if self.core.free_frames() < n:
            raise RuntimeError("KV pool out of slabs (compaction failed)")
        return self.core.place(seq_ids, p)

    def _compact_until(self, n: int) -> None:
        """Run compaction cycles until ``n`` frames are appendable and the
        free-slab reserve is above the trigger, or no cycle makes progress."""
        while (self.core.free_count() <= self.compact_trigger
               or self.core.free_frames() < n):
            before = self.core.free_frames()
            if self.compact() is None or self.core.free_frames() <= before:
                break

    # --------------------------------------------------------------- death
    def free_pages(self, pages: np.ndarray) -> None:
        """Drop one reference per block; a page is freed exactly when its
        refcount hits zero (its sequence finished)."""
        pages = np.asarray(pages, dtype=np.int64)
        pages = pages[pages >= 0]
        if len(pages) == 0:
            return
        assert (self.block_owner[pages] >= 0).all(), "double free"
        # sealed slabs that become fully dead are reclaimed for free by the
        # core; open slabs stay open (append-only slots)
        self.core.kill_slots(pages // self.S, pages % self.S, tick=True)

    # ----------------------------------------------------------- compaction
    def select_victims(self) -> np.ndarray:
        eligible = (self.core.seg_state == USED) & (self.core.seg_live < self.S)
        return self.core.select_victims(self.policy, self.compact_batch,
                                        eligible=eligible)

    def compact(self) -> CompactionPlan | None:
        """Evacuate victims; returns CompactionPlan(src_pages, dst_pages)
        after handing it to ``on_compaction``."""
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

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        self.core.check_invariants()
