"""SegmentStore: the simulator's fixed-size-page view of the unified core.

A copy of ``repro.core.segment``.  All segment-lifecycle mechanics (open →
seal → clean, §5.1.1 {A, C, u_p2} accounting, §5.2.2 carry-forward, victim
eviction) live in :mod:`.logstructure`; this module is a thin adapter that exposes
them under the paper's *page* vocabulary and maintains nothing of its own
beyond name aliases.  A store is ``nseg`` segments of ``S`` page frames;
pages are logical ids with back-pointers (``page_seg``/``page_slot``), so an
update can kill its prior on-disk frame in place (paper §2).

``page_seg`` conventions (owned by the simulator): >=0 on disk in that
segment; -1 never written; -2 staged in the user sort buffer; -3 staged as a
GC survivor.
"""

from __future__ import annotations

import numpy as np

from .logstructure import (FREE, IN_FLIGHT, OPEN, USED,  # noqa: F401
                           Clock, EvacResult, FrameLog, Placement, StoreStats)

__all__ = ["FREE", "OPEN", "USED", "IN_FLIGHT", "Clock", "EvacResult",
           "Placement", "SegmentStore", "StoreStats"]


class SegmentStore(FrameLog):
    """Fixed-size-page log-structured store with paper §5 accounting."""

    def __init__(self, nseg: int, pages_per_seg: int, max_pages: int,
                 *, n_streams: int = 1):
        super().__init__(nseg, pages_per_seg, max_items=max_pages,
                         n_streams=n_streams)
        self.max_pages = int(max_pages)
        # paper vocabulary — same arrays, no separate bookkeeping
        self.page_seg = self.item_seg
        self.page_slot = self.item_slot
        self.page_up2 = self.item_up2
        self.slot_page = self.slot_item

    # -- paper-vocabulary aliases --------------------------------------------
    def live_pages(self) -> int:
        return self.live_items()

    def kill_pages(self, pages: np.ndarray,
                   probs: np.ndarray | None = None) -> None:
        """Mark the on-disk frames of ``pages`` empty (they were superseded).

        Only call for pages whose current version is on disk (page_seg >= 0).
        """
        self.kill_items(pages, probs)

    def begin_segment(self) -> int:
        """Allocate an OPEN segment for incremental filling (multi-log path)."""
        return self.alloc()

    def write_segment(
        self,
        pages: np.ndarray,
        up2: np.ndarray,
        probs: np.ndarray | None = None,
        seal_time: float | None = None,
    ) -> int:
        """Write one full (or partial) segment of pages and seal it."""
        assert 0 < len(pages) <= self.S
        s = self.alloc()
        self.append(s, pages, up2, probs)
        self.seal(s, seal_time)
        return s

    def evacuate(self, victims: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Read victims, return (live page ids, their u_p2), free the victims.

        The returned pages keep ``page_seg == -2`` (in flight) until re-written
        via :meth:`write_segment`.  Paper §5.2.2 (GC writes): each page's u_p2
        is taken from its containing segment.
        """
        res = super().evacuate(victims)
        return res.items, res.up2_inherit

    def evacuate_result(self, victims: np.ndarray) -> EvacResult:
        """Like :meth:`evacuate` but returns the full :class:`EvacResult`
        (per-page slot u_p2, refs and source streams — the death-stream
        cleaning path demotes survivors by their source stream)."""
        return super().evacuate(victims)
