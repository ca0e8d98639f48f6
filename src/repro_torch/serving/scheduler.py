"""Output-length prediction for stop-token decode.

With stop-token decode a request's output length — and therefore every
page's lifetime — is data-dependent, so the ``est_death`` the engine hands
the pool becomes a *prediction*.  ``ewma`` (default) tracks an
exponentially-weighted moving average of recent completion lengths; ``max``
predicts the ``max_new_tokens`` bound.
"""

from __future__ import annotations

import numpy as np


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
