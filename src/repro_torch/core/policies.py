"""Cleaning priorities: the NumPy keys the simulator's and the KV pool's
victim selection use (f64, on the host), their byte-accounted twins (the journal's and the
snapshot store's segments), and their device twins on tensors (f32; the MDC
key through the ``mdc_priority`` kernel on the card).

Every policy is a *priority key* over segments; cleaning selects the ``k``
segments with the **smallest** key.

Paper mapping
-------------
age           clean oldest seal time first                       (§2.2)
greedy        clean emptiest first                               (§4.5)
cost_benefit  LFS [23] benefit/cost = E*age/(2-E), largest first (§6.1.3)
mdc           smallest declining-cost rate first (§4, §5.1.3):
                  -dCost/du ∝ ((B-A)/A)^2 * 1/(C * (u_now - u_p2))
mdc_opt       same, with the exact per-segment live update probability
              replacing the (u_now - u_p2) estimate                (§6.1.3)

For fixed-size pages, with E = empty fraction = (S-C)/S:
  (B-A)/A == (1-E)/E == C/(S-C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops

_INF = np.float64(np.inf)
_EPS = 1e-12

POLICIES = ("age", "greedy", "cost_benefit", "mdc", "mdc_opt")


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


def key_mdc_bytes(live_bytes: np.ndarray, free_bytes: np.ndarray,
                  n_chunks: np.ndarray, up2: np.ndarray,
                  u_now: float) -> np.ndarray:
    """Variable-size-page MDC (paper §4.4 / §5.1.3), smallest first:
    -dCost/du ∝ ((B-A)/A)^2 · 1/(C·(u_now - u_p2)) with B-A = live bytes,
    A = free (dead + unused) bytes, C = live chunk count.  The key of the
    byte-accounted log (the journal's and the snapshot store's segments)."""
    BA = live_bytes.astype(np.float64)
    A = free_bytes.astype(np.float64)
    C = np.maximum(n_chunks.astype(np.float64), 1.0)
    interval = np.maximum(u_now - up2, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        decline = np.where(A > 0, (BA / np.maximum(A, _EPS)) ** 2 / (C * interval), _INF)
    return np.where(BA == 0, -1.0, decline)


def key_mdc_opt(live: np.ndarray, S: int, seg_prob: np.ndarray, **_) -> np.ndarray:
    """MDC with the oracle update rate: dE/du ∝ Σ_live p(page) (paper §6.1.3).

    decline ∝ (1-E)/E^2 * U_seg * Δ_E  with  U_seg = Σ_live prob,
    and (1-E) * Δ_E constant factors folded in:  key = U_seg / E^2 weighted by
    the same ((B-A)/A)^2 / C shape as `key_mdc` (the two differ only in the
    update-rate estimator).
    """
    C = live.astype(np.float64)
    A = (S - C)
    rate = np.maximum(seg_prob, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        decline = np.where(A > 0, (C / np.maximum(A, _EPS)) ** 2 * rate / np.maximum(C, 1.0), _INF)
    return np.where(C == 0, -1.0, decline)


_KEYS = {
    "age": key_age,
    "greedy": key_greedy,
    "cost_benefit": key_cost_benefit,
    "mdc": key_mdc,
    "mdc_opt": key_mdc_opt,
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
                   eligible: np.ndarray,
                   seg_prob: np.ndarray | None = None) -> np.ndarray:
    """Return up to ``k`` eligible segment ids with the smallest policy key.
    ``seg_prob`` (the oracle's live update probability per segment) is read
    by ``mdc_opt`` only."""
    key = _KEYS[policy](live=live, S=S, up2=up2, seal_time=seal_time,
                        u_now=u_now, seg_prob=seg_prob)
    key = np.where(eligible, key, _INF)
    # Never pick segments with zero reclaimable space (E == 0): cleaning them
    # frees nothing (and MDC's decline is infinite there anyway).
    key = np.where(live >= S, _INF, key)
    return _take_smallest(key, k)


def select_victims_bytes(policy: str, k: int, *, live_bytes: np.ndarray,
                         written: np.ndarray, n_chunks: np.ndarray,
                         up2: np.ndarray, seal_time: np.ndarray,
                         u_now: float, eligible: np.ndarray) -> np.ndarray:
    """Variable-size-page victim selection (§4.4): the byte-accounted twin
    of :func:`select_victims`, used by :class:`ByteLog`."""
    if policy == "mdc":
        key = key_mdc_bytes(live_bytes, written - live_bytes, n_chunks, up2,
                            u_now)
    elif policy == "greedy":
        key = live_bytes / np.maximum(written, 1.0)
    elif policy == "age":
        key = seal_time.astype(np.float64)
    else:
        raise ValueError(f"unsupported byte-mode policy: {policy!r}")
    key = np.where(eligible, key, _INF)
    # E == 0 segments reclaim nothing: the fixed-size path's exclusion
    key = np.where(live_bytes >= written, _INF, key)
    return _take_smallest(key, k)


def key_preempt(recompute: np.ndarray, freeable: np.ndarray,
                remaining: np.ndarray) -> np.ndarray:
    """Sequence-preemption priority of the serving scheduler; smallest key
    preempted first.

    The MDC declining-cost shape applied to *sequences* instead of
    segments: B−A ≡ ``recompute`` (tokens to re-prefill on resume — the
    cost of evicting the sequence), A ≡ ``freeable`` (pages whose last
    reference the preemption drops — the space reclaimed now), and
    C·interval ≡ ``freeable`` × ``remaining`` (the space-time the pages
    would otherwise stay occupied).  Sequences that are cheap to recompute,
    hold many exclusive pages and would hold them longest go first; one
    whose pages are all shared (``freeable`` == 0) frees nothing and is
    never picked (key = inf)."""
    cost = recompute.astype(np.float64)
    A = freeable.astype(np.float64)
    interval = np.maximum(remaining.astype(np.float64), 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        decline = np.where(
            A > 0,
            (cost / np.maximum(A, _EPS)) ** 2 / (np.maximum(A, 1.0) * interval),
            _INF)
    return decline


def select_preempt(k: int, *, recompute: np.ndarray, freeable: np.ndarray,
                   remaining: np.ndarray) -> np.ndarray:
    """Up to ``k`` preemption victims (indices into the candidate arrays)
    with the smallest :func:`key_preempt`, ascending."""
    return _take_smallest(key_preempt(recompute, freeable, remaining), k)


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
