"""Update-trace generators for the cleaning simulator (paper §6.1.4): a
copy of ``repro.core.workloads``.  Each draws from numpy's
``default_rng(seed)``, so one seed gives the JAX package's update trace.

All generators yield batches of page ids to update, plus expose the *true*
per-page update probability (``probs``) used by the `*-opt` oracle policies.

- uniform:   every page equally likely (§2.2 analysis conditions)
- hot_cold:  m% of updates to (1-m)% of the data (§3 gedanken conditions)
- zipfian:   bounded Zipf over ranks, θ=0.99 (~80-20) / θ=1.35 (~90-10) (§6.2.2)
- tpcc_proxy: synthetic proxy for the paper's TPC-C B+-tree traces (§6.3):
    ~80-20 skew + data growth (inserts) + hot→cold drift.  Real traces are not
    available offline; see DESIGN.md §4.
"""

from __future__ import annotations

import numpy as np


class Workload:
    """Base: fixed page population with stationary probabilities."""

    def __init__(self, n_pages: int, probs: np.ndarray, seed: int = 0):
        assert len(probs) == n_pages
        p = np.asarray(probs, dtype=np.float64)
        self.n_pages = n_pages
        self.probs = p / p.sum()
        self._cdf = np.cumsum(self.probs)
        self._cdf[-1] = 1.0
        self.rng = np.random.default_rng(seed)
        self.grows = False

    def sample(self, n: int) -> np.ndarray:
        u = self.rng.random(n)
        return np.searchsorted(self._cdf, u, side="right").astype(np.int64)

    def initial_pages(self) -> np.ndarray:
        return np.arange(self.n_pages, dtype=np.int64)

    def max_pages(self) -> int:
        return self.n_pages

    def tick(self, n_updates: int) -> None:  # hook for non-stationary loads
        pass


class Uniform(Workload):
    def __init__(self, n_pages: int, seed: int = 0):
        super().__init__(n_pages, np.ones(n_pages), seed)

    def sample(self, n: int) -> np.ndarray:  # fast path
        return self.rng.integers(0, self.n_pages, size=n, dtype=np.int64)


class HotCold(Workload):
    """``update_frac`` of updates go to ``data_frac`` of the pages.

    Page identities are scattered by a fixed permutation so that the initial
    sequential load does *not* pre-separate hot from cold (the policy has to
    discover the skew, as in the paper's simulator).
    """

    def __init__(self, n_pages: int, update_frac: float, data_frac: float, seed: int = 0):
        n_hot = max(1, int(round(n_pages * data_frac)))
        probs = np.full(n_pages, (1.0 - update_frac) / (n_pages - n_hot))
        probs[:n_hot] = update_frac / n_hot
        perm = np.random.default_rng(seed + 1).permutation(n_pages)
        super().__init__(n_pages, probs[np.argsort(perm)], seed)
        # probs[np.argsort(perm)][perm] == original: page perm[i] is hot iff i < n_hot
        self.n_hot = n_hot


class Zipfian(Workload):
    """Bounded Zipf: P(rank i) ∝ 1/i^θ, ranks scattered over page ids."""

    def __init__(self, n_pages: int, theta: float, seed: int = 0):
        ranks = np.arange(1, n_pages + 1, dtype=np.float64)
        probs = ranks ** (-theta)
        perm = np.random.default_rng(seed + 1).permutation(n_pages)
        super().__init__(n_pages, probs[perm], seed)
        self.theta = theta


class TpccProxy(Workload):
    """Synthetic stand-in for the paper's TPC-C B+-tree I/O traces.

    Three trace properties the paper leans on (§6.3):
      * ~80-20 skew across the update-in-place tables (stock/customer),
      * storage growth over time (orderline/history inserts → new pages,
        fill factor climbs, as in the paper's 'run until F rose by 0.1'),
      * hot pages turning cold (hotspot drift across warehouses/districts).
    """

    def __init__(self, n_pages: int, seed: int = 0, growth_frac: float = 0.35,
                 insert_share: float = 0.25, drift_every: int = 200_000):
        self._static_pages = n_pages
        self._grow_total = int(n_pages * growth_frac)
        probs = np.arange(1, n_pages + 1, dtype=np.float64) ** (-0.99)
        perm = np.random.default_rng(seed + 1).permutation(n_pages)
        super().__init__(n_pages, probs[perm], seed)
        # Inserted pages (history/orderline appends) are write-once-cold:
        # true update probability 0.  Size ``probs`` for the grown store so
        # the *-opt oracles can index any page id ever written.
        full = np.zeros(self._static_pages + int(n_pages * growth_frac))
        full[:n_pages] = self.probs
        self.probs = full
        self.grows = True
        self.insert_share = insert_share
        self.drift_every = drift_every
        self._since_drift = 0
        self._next_new_page = n_pages
        self._theta_probs = probs  # by rank

    def max_pages(self) -> int:
        return self._static_pages + self._grow_total

    def sample(self, n: int) -> np.ndarray:
        n_ins = self.rng.binomial(n, self.insert_share)
        n_ins = min(n_ins, self._static_pages + self._grow_total - self._next_new_page)
        upd = np.searchsorted(self._cdf, self.rng.random(n - n_ins), side="right")
        ins = np.arange(self._next_new_page, self._next_new_page + n_ins, dtype=np.int64)
        self._next_new_page += n_ins
        out = np.concatenate([upd.astype(np.int64), ins])
        self.rng.shuffle(out)
        return out

    def tick(self, n_updates: int) -> None:
        self._since_drift += n_updates
        if self._since_drift >= self.drift_every:
            self._since_drift = 0
            # Hotspot drift: re-deal which pages carry which rank probability.
            perm = self.rng.permutation(self._static_pages)
            p = self._theta_probs[perm]
            p = p / p.sum()
            self.probs = np.zeros(self.max_pages())
            self.probs[: self._static_pages] = p
            self._cdf = np.cumsum(p)
            self._cdf[-1] = 1.0

    def initial_pages(self) -> np.ndarray:
        return np.arange(self._static_pages, dtype=np.int64)


def make_workload(name: str, n_pages: int, seed: int = 0, **kw) -> Workload:
    if name == "uniform":
        return Uniform(n_pages, seed)
    if name == "hot_cold":
        return HotCold(n_pages, kw.get("update_frac", 0.8), kw.get("data_frac", 0.2), seed)
    if name == "zipfian":
        return Zipfian(n_pages, kw.get("theta", 0.99), seed)
    if name == "tpcc":
        return TpccProxy(n_pages, seed, **{k: v for k, v in kw.items()
                                           if k in ("growth_frac", "insert_share", "drift_every")})
    raise ValueError(f"unknown workload {name!r}")
