"""Shared-prefix KV reuse: a refcounted radix tree over the pool's pages.

A copy of the JAX package's prefix cache.

Serving traffic at scale shares prompt prefixes — system prompts, few-shot
templates, conversation history.  Recomputing the shared prefix's KV for
every request wastes prefill FLOPs, and storing one copy per sequence
wastes pool pages (and therefore raises Wamp: more live pages to relocate
per cleaning cycle).  This module caches the *physical pages* of full-page
prompt prefixes so later requests splice them into their block tables and
prefill only the uncached tail.

Structure: a radix tree whose edges are keyed by the exact token tuple of
one full page (``page_T`` tokens); each node owns one physical pool page.  Matching walks the tree page-by-page, so the longest
cached full-page prefix is found in O(pages) dict lookups.  The tree itself
holds one pool reference per cached page (``LogStructuredKVPool``
refcounts), which is what keeps a cached prefix alive after its writing
sequence finishes; every sequence that splices a page takes its own
reference.  A page is reclaimable exactly when its count hits zero —
multi-referenced liveness, which is also why death estimates are the max
over referencing sequences (see ``incref_pages``).

Boundary rule (copy-on-write): only *full, immutable* pages enter the tree.
A partial trailing page still receives decode writes, so it stays private
to its sequence; a request whose prompt fully matches the tree still
recomputes its final page privately (the lookup is capped so at least one
token is prefilled — the engine needs the last position's logits).

Eviction: leaves whose only reference is the tree's own (no active
sequence) are evicted least-recently-used, either when the cache exceeds
``capacity_pages`` or when the pool is under pressure (the pool's
``on_pressure`` hook fires before it would declare OOM).  Interior nodes
are never evicted while they have children — a child page's KV is only
reachable through its whole prefix path.

Compaction stays invisible: plans are global physical page ids, and the
engine remaps the tree with the same LUT it applies to the block tables.
"""

from __future__ import annotations

import numpy as np


class _Node:
    """One cached full page: the edge key is the page's token tuple."""

    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key, page, parent):
        self.key = key                  # tuple of page_T tokens (root: None)
        self.page = page                # physical pool page id (root: -1)
        self.parent = parent
        self.children: dict[tuple, _Node] = {}
        self.last_use = 0

    def depth_first(self):
        for c in list(self.children.values()):
            yield from c.depth_first()
        yield self


class PrefixCache:
    """Token-keyed radix tree of full-page prompt prefixes over ``pool``.

    The cache owns one pool reference per cached page; ``lookup`` returns
    matching pages *without* taking references (the engine increfs per
    sequence), ``insert`` adopts new full pages (incref for the tree),
    ``evict`` drops tree references of LRU unreferenced leaves.
    """

    def __init__(self, pool, page_T: int, *, capacity_pages: int = 0):
        self.pool = pool
        self.page_T = page_T
        # 0 = bounded only by pool pressure; otherwise a soft page cap
        self.capacity_pages = capacity_pages
        self.root = _Node(None, -1, None)
        self.n_pages = 0
        self._clock = 0
        # counters for metrics / bench (a "hit" is a lookup that returned
        # >= 1 page *after* the CoW cap, i.e. pages the caller splices)
        self.lookups = 0
        self.hits = 0
        self.pages_reused = 0       # pages spliced into block tables
        self.tokens_reused = 0      # page_T * pages_reused
        self.evictions = 0
        # pool pressure gives back unreferenced cached pages before OOM
        pool.on_pressure = self._on_pressure

    # ------------------------------------------------------------- matching
    def _keys(self, tokens: np.ndarray):
        """Full-page token tuples of ``tokens`` (the radix edge keys)."""
        T = self.page_T
        toks = np.asarray(tokens)
        return [tuple(int(t) for t in toks[i:i + T])
                for i in range(0, (len(toks) // T) * T, T)]

    def _walk(self, tokens: np.ndarray) -> list[_Node]:
        """Nodes of the longest *usable* cached full-page prefix of
        ``tokens``: the match is capped at ``(len(tokens) - 1) // page_T``
        pages — the copy-on-write boundary rule, so at least one prompt
        token is always left for the caller to prefill (it needs the last
        position's logits; a fully-matched final page is recomputed
        privately)."""
        cap = (len(np.asarray(tokens)) - 1) // self.page_T
        node, path = self.root, []
        for key in self._keys(tokens)[:cap]:
            node = node.children.get(key)
            if node is None:
                break
            path.append(node)
        return path

    def match(self, tokens: np.ndarray) -> list[int]:
        """Pages the longest usable cached prefix would splice, WITHOUT
        touching hit counters or the LRU clock — the admission-control
        peek (``_admit`` computes a request's page need *net* of the
        cached prefix before deciding whether it fits)."""
        return [n.page for n in self._walk(tokens)]

    def lookup(self, tokens: np.ndarray) -> list[int]:
        """Pages of the longest usable cached full-page prefix (see
        :meth:`_walk` for the CoW cap).

        Touches the matched path's LRU clock and counts hit/reuse stats;
        the caller must incref every returned page (it splices all of
        them)."""
        self.lookups += 1
        self._clock += 1
        path = self._walk(tokens)
        for node in path:
            node.last_use = self._clock
        pages = [n.page for n in path]
        if pages:
            self.hits += 1
            self.pages_reused += len(pages)
            self.tokens_reused += len(pages) * self.page_T
        return pages

    # ------------------------------------------------------------ insertion
    def insert(self, tokens: np.ndarray, pages: np.ndarray,
               est_death: float) -> int:
        """Register a prompt's full pages; returns how many were adopted.

        ``pages[i]`` must hold the KV of tokens ``[i*T, (i+1)*T)``.  Keys
        already present keep their existing page (the caller's duplicate
        page stays private to its sequence and dies with it); new nodes take
        one tree reference with death estimate ``est_death``, so hot shared
        prefixes sort into long-lifetime slabs."""
        self._clock += 1
        node, adopted = self.root, []
        for key, page in zip(self._keys(tokens), np.asarray(pages)):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(page), node)
                node.children[key] = child
                adopted.append(int(page))
                self.n_pages += 1
            child.last_use = self._clock
            node = child
        if adopted:
            self.pool.incref_pages(np.asarray(adopted, np.int64), est_death)
        if self.capacity_pages and self.n_pages > self.capacity_pages:
            self.evict(self.n_pages - self.capacity_pages)
        return len(adopted)

    # ------------------------------------------------------------- eviction
    def _unreferenced_leaves(self) -> list[_Node]:
        """Leaves only the tree still references (pool refcount == 1)."""
        leaves = [n for n in self.root.depth_first()
                  if n is not self.root and not n.children]
        if not leaves:
            return []
        # tree ids may be pending-move sources: read refcounts through the
        # pool's LUT (a fenced source's own count is 0)
        ref = self.pool.block_ref[self.pool.resolve(
            np.asarray([n.page for n in leaves], np.int64))]
        return [n for n, r in zip(leaves, ref) if r == 1]

    def evictable(self) -> int:
        """Pages the cache could give back right now (pool pressure view).

        A page is reclaimable only if its *whole subtree* is unreferenced:
        evicting leaves exposes their parents, but a referenced descendant
        pins every ancestor (matches cascaded leaves-first eviction).
        ``depth_first`` is post-order, so children are classified first."""
        nodes = [n for n in self.root.depth_first() if n is not self.root]
        if not nodes:
            return 0
        unref = self.pool.block_ref[self.pool.resolve(
            np.asarray([n.page for n in nodes], np.int64))] == 1
        reclaim: dict[int, bool] = {}
        count = 0
        for n, u in zip(nodes, unref):
            ok = bool(u) and all(reclaim[id(c)] for c in n.children.values())
            reclaim[id(n)] = ok
            count += ok
        return count

    def evict(self, n: int) -> int:
        """Drop tree references of up to ``n`` LRU unreferenced leaves.

        Cascades: evicting a leaf may expose its parent.  Returns the number
        of pages given back (their refcount hits zero, so they die in the
        pool and compaction can reclaim their slabs)."""
        freed = 0
        while freed < n:
            leaves = self._unreferenced_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_use)
            batch = leaves[:n - freed]
            for nd in batch:          # detach the whole cascade round …
                del nd.parent.children[nd.key]
            # … then drop their references in one vectorized kill (this
            # runs on the allocation path right before OOM — peak load)
            self.pool.free_pages(np.asarray([nd.page for nd in batch],
                                            np.int64))
            self.n_pages -= len(batch)
            freed += len(batch)
            self.evictions += len(batch)
        return freed

    def _on_pressure(self, deficit: int) -> None:
        self.evict(deficit)

    # ----------------------------------------------------------- compaction
    def remap(self, lut: np.ndarray) -> None:
        """Rewrite cached page ids after a compaction plan (same LUT the
        engine applies to its block tables — the tree is just one more
        reference holder)."""
        for n in self.root.depth_first():
            if n is not self.root:
                n.page = int(lut[n.page])

    # ------------------------------------------------------------- holders
    def pages(self) -> list[int]:
        """Every physical page the tree currently references."""
        return [n.page for n in self.root.depth_first() if n is not self.root]

    # -------------------------------------------------------------- metrics
    def tree_state(self) -> list[dict]:
        """Serializable view of the radix tree, one entry per cached page
        with its full token path, in the JAX tree's order: it goes into the
        session snapshot.  Page *contents* live on the device and are not
        persisted, so a recovered engine starts with an empty tree and
        re-warms it as its sequences re-prefill; the view records which
        prefixes were warm (forensics)."""
        out: list[dict] = []

        def rec(node, prefix):
            for key, c in node.children.items():
                path = prefix + list(key)
                out.append({"tokens": [int(t) for t in path],
                            "page": int(c.page),
                            "last_use": int(c.last_use)})
                rec(c, path)

        rec(self.root, [])
        return out

    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    def check_invariants(self) -> None:
        pages = [n.page for n in self.root.depth_first() if n is not self.root]
        assert len(pages) == self.n_pages
        assert len(set(pages)) == len(pages), "page cached twice"
        if pages:
            # across a pending async-compaction window the tree still holds
            # source ids (its remap defers with the block tables')
            arr = self.pool.resolve(np.asarray(pages, np.int64))
            assert (self.pool.block_owner[arr] >= 0).all(), \
                "cached page is dead"
            assert (self.pool.block_ref[arr] >= 1).all()
