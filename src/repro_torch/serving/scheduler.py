"""Scheduling helpers of the serving engine: the chunked-prefill budget,
the clean budget of async compaction, output-length prediction, preemption
victims and load shedding.

With stop-token decode a request's output length — and therefore every
page's lifetime — is data-dependent, so the ``est_death`` the engine hands
the pool becomes a *prediction*.  ``ewma`` (default) tracks an
exponentially-weighted moving average of recent completion lengths; ``max``
predicts the ``max_new_tokens`` bound.  Under pool pressure the engine
preempts the sequences :func:`choose_preempt_victims` picks, and with its
queue at depth it sheds new requests with :class:`AdmissionShed`.
"""

from __future__ import annotations

import numpy as np

from ..core import policies as P

# default fused-dispatch prefill budget (tokens) when chunking is enabled
# without an explicit size: one page at the engine's default page_T=8
DEFAULT_PREFILL_CHUNK = 8


def normalize_prefill_chunk(chunk: int, page_T: int) -> int:
    """Round the chunked-prefill budget up to a whole number of pages
    (``0`` keeps monolithic prefill).  Chunk boundaries must be page
    boundaries: each chunk's K/V scatters into whole pool pages, and a
    cached-prefix hit starts the first chunk at a full-page offset."""
    if chunk <= 0:
        return 0
    return -(-int(chunk) // page_T) * page_T


# default per-dispatch clean budget (blocks moved) of async compaction: one
# default-sized slab's worth, a typical sub-plan per dispatch at steady state
DEFAULT_CLEAN_BUDGET = 8


def clean_budget(base: int, *, free_slabs: int, trigger: int,
                 blocks_per_slab: int, queue_depth: int = 0) -> int:
    """Per-dispatch clean budget in blocks moved.

    At or above comfortable free-slab headroom the budget is ``base`` (a
    steady trickle); below it, it grows by the slab deficit converted to
    blocks — the deeper the pool digs into its reserve, the more moves each
    dispatch retires — plus a small queue-depth term (waiting admissions are
    reclamation demand too)."""
    base = max(int(base), 1)
    deficit = max(int(trigger) + 1 - int(free_slabs), 0)
    if deficit == 0:
        return base
    return (base + deficit * max(int(blocks_per_slab), 1)
            + 2 * min(int(queue_depth), 8))


class EwmaLengthPredictor:
    """EWMA over recent completions' output lengths (in tokens).

    Before the first observation, predicts the request's own
    ``max_new_tokens``; afterwards the EWMA clamped to
    ``[1, max_new_tokens]``."""

    name = "ewma"

    def __init__(self, alpha: float = 0.25):
        self.alpha = float(alpha)
        self.value: float | None = None
        self.n_obs = 0

    def observe(self, n_tokens: int) -> None:
        n = float(n_tokens)
        self.value = n if self.value is None else (
            (1.0 - self.alpha) * self.value + self.alpha * n)
        self.n_obs += 1

    def predict(self, max_new_tokens: int) -> int:
        if self.value is None:
            return int(max_new_tokens)
        return int(np.clip(round(self.value), 1, max_new_tokens))


class MaxLengthPredictor:
    """Predict the cap: every request is assumed to decode
    ``max_new_tokens``."""

    name = "max"

    def observe(self, n_tokens: int) -> None:
        pass

    def predict(self, max_new_tokens: int) -> int:
        return int(max_new_tokens)


_PREDICTORS = {"ewma": EwmaLengthPredictor, "max": MaxLengthPredictor}


def make_length_predictor(name: str):
    if name not in _PREDICTORS:
        raise ValueError(f"unknown length predictor {name!r}; "
                         f"supported: {tuple(_PREDICTORS)}")
    return _PREDICTORS[name]()


class AdmissionShed(RuntimeError):
    """Raised by ``submit`` when the engine sheds load: admission has been
    stalled past preemption and the queue is at its configured depth.
    Carries a ``retry_after_s`` hint derived from the waiting work and the
    measured per-token decode time (HTTP 503 + Retry-After)."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"admission shed; retry after {retry_after_s:.3f}s")
        self.retry_after_s = float(retry_after_s)


def retry_after_estimate(n_waiting_tokens: int, tpot_s: float) -> float:
    """Retry-after hint for a shed request: the time to decode the tokens
    already waiting ahead of it at the measured time per output token."""
    return max(float(n_waiting_tokens) * max(float(tpot_s), 1e-4), 1e-3)


def choose_preempt_victims(k: int, *, recompute: np.ndarray,
                           freeable: np.ndarray,
                           remaining: np.ndarray) -> np.ndarray:
    """Indices (into the candidate arrays) of up to ``k`` sequences to
    preempt, cheapest declining-cost first (:func:`policies.select_preempt`)."""
    return P.select_preempt(k, recompute=recompute, freeable=freeable,
                            remaining=remaining)
