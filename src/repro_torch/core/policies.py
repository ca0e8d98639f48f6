"""Cleaning priorities: the NumPy keys the KV pool's victim selection uses
(f64, on the host), and their device twins on tensors (f32; the MDC key
through the ``mdc_priority`` kernel on the card).

Every policy is a *priority key* over segments; cleaning selects the ``k``
segments with the **smallest** key.

Paper mapping
-------------
age           clean oldest seal time first                       (§2.2)
greedy        clean emptiest first                               (§4.5)
cost_benefit  LFS [23] benefit/cost = E*age/(2-E), largest first (§6.1.3)
mdc           smallest declining-cost rate first (§4, §5.1.3):
                  -dCost/du ∝ ((B-A)/A)^2 * 1/(C * (u_now - u_p2))

For fixed-size pages, with E = empty fraction = (S-C)/S:
  (B-A)/A == (1-E)/E == C/(S-C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops

_INF = np.float64(np.inf)
_EPS = 1e-12


def key_age(seal_time: np.ndarray, **_) -> np.ndarray:
    return seal_time.astype(np.float64)


def key_greedy(live: np.ndarray, S: int, **_) -> np.ndarray:
    # emptiest first == fewest live pages first
    return live.astype(np.float64)


def key_cost_benefit(live: np.ndarray, S: int, seal_time: np.ndarray,
                     u_now: float, **_) -> np.ndarray:
    E = (S - live) / S
    age = np.maximum(u_now - seal_time, 1.0)
    benefit = E * age / (2.0 - E)
    return -benefit  # largest benefit/cost first


def key_mdc(live: np.ndarray, S: int, up2: np.ndarray, u_now: float, **_) -> np.ndarray:
    """Declining-cost rate (paper §5.1.3), fixed-size pages; smallest first."""
    C = live.astype(np.float64)
    A = (S - C)  # free frames ∝ free bytes
    interval = np.maximum(u_now - up2, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        decline = np.where(A > 0, (C / np.maximum(A, _EPS)) ** 2 / (np.maximum(C, 1.0) * interval), _INF)
    # Fully-empty segments (C == 0) have decline 0: reclaimed first, for free.
    return np.where(C == 0, -1.0, decline)


_KEYS = {
    "age": key_age,
    "greedy": key_greedy,
    "cost_benefit": key_cost_benefit,
    "mdc": key_mdc,
}


def _take_smallest(key: np.ndarray, k: int) -> np.ndarray:
    """ids of the k smallest finite keys, ascending."""
    n_ok = int((key < _INF).sum())
    k = min(k, n_ok)
    if k == 0:
        return np.empty(0, dtype=np.int64)
    idx = np.argpartition(key, k - 1)[:k]
    return idx[np.argsort(key[idx])]


def select_victims(policy: str, k: int, *, live: np.ndarray, S: int,
                   up2: np.ndarray, seal_time: np.ndarray, u_now: float,
                   eligible: np.ndarray) -> np.ndarray:
    """Return up to ``k`` eligible segment ids with the smallest policy key."""
    key = _KEYS[policy](live=live, S=S, up2=up2, seal_time=seal_time,
                        u_now=u_now)
    key = np.where(eligible, key, _INF)
    # Never pick segments with zero reclaimable space (E == 0): cleaning them
    # frees nothing (and MDC's decline is infinite there anyway).
    key = np.where(live >= S, _INF, key)
    return _take_smallest(key, k)


# ---------------------------------------------------------------------------
# torch twins: the device route of victim selection (f32, no host sync)
# ---------------------------------------------------------------------------

def torch_key_mdc(live, S, up2, u_now):
    """:func:`key_mdc` in f32 on tensors; on the card, the ``mdc_priority``
    kernel."""
    return ops.mdc_priority(live, up2, u_now, S=S)


def torch_key_greedy(live, S):
    return live.float()


def torch_key_cost_benefit(live, S, seal_time, u_now):
    E = (S - live.float()) / S
    age = torch.clamp(u_now - seal_time.float(), min=1.0)
    return -(E * age / (2.0 - E))


def torch_select_victims(key, eligible, k: int, *, live, S):
    """The ``k`` smallest keys among eligible segments → (ids (k,), valid
    (k,) bool).  Mirrors :func:`select_victims`, including the exclusion of
    full segments (live >= S: nothing reclaimable)."""
    key = torch.where(eligible, key, torch.inf)
    key = torch.where(live >= S, torch.inf, key)
    neg, ids = torch.topk(-key, k)
    return ids, torch.isfinite(neg)
