"""Fault injection and bounded retry for the serving engine.

A copy of the serving half of ``repro.distributed.fault``.  The engine
names each call site by its operation ("dispatch", "prefill",
"compaction", "host_sync", "journal"), and a :class:`FailureInjector`
raises either a hard :class:`SimulatedFailure` (crash-grade: the engine
does not survive it, and recovery starts from the journal) or a retryable
:class:`TransientFault` (the engine unwinds or retries with bounded
backoff, :func:`backoff_delay`).  The injector's firing sequence is the JAX
one's: the same configuration fails the same calls.

The training half (the straggler detector and the restart loop) comes
with the training side of the port.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector to model a node loss mid-run."""

    def __init__(self, msg: str, *, step: int = -1, op: str | None = None):
        super().__init__(msg)
        self.step = step
        self.op = op


class TransientFault(SimulatedFailure):
    """A retryable fault (flaky transfer, slow host sync): the caller is
    expected to unwind any partial state and retry with backoff."""


@dataclasses.dataclass
class FailureInjector:
    """Deterministically fail at given steps/ops (tests) or with prob p (chaos).

    Training keys faults by *step* (``fail_at_steps`` + ``check(step)``,
    unchanged semantics).  Serving keys them by *operation*: ``check(step,
    op=...)`` counts calls per op, so ``fail_at=(("dispatch", 3),)`` fails
    the 4th dispatch deterministically, and ``transient_prob`` /
    ``fail_prob`` draw per-call from an rng seeded by (seed, op, call
    count) — a retried op re-rolls, so transient faults clear.  Both prob
    knobs accept a float (all ops, optionally filtered by ``ops``) or a
    per-op dict like ``{"compaction": 0.05}``.
    """

    fail_at_steps: tuple = ()
    fail_prob: float | dict = 0.0        # hard faults (SimulatedFailure)
    seed: int = 0
    ops: tuple = ()                      # op filter for float probs (empty = all)
    fail_at: tuple = ()                  # ((op, call_count), ...) hard one-shots
    transient_at: tuple = ()             # ((op, call_count), ...) transient
    transient_prob: float | dict = 0.0   # retryable faults (TransientFault)
    _fired: set = dataclasses.field(default_factory=set)
    op_counts: dict = dataclasses.field(default_factory=dict)

    def _prob(self, knob: float | dict, op: str) -> float:
        if isinstance(knob, dict):
            return float(knob.get(op, 0.0))
        if self.ops and op not in self.ops:
            return 0.0
        return float(knob)

    def check(self, step: int, op: str | None = None) -> None:
        if op is None:
            if step in self.fail_at_steps and step not in self._fired:
                self._fired.add(step)
                raise SimulatedFailure(
                    f"injected failure at step {step}", step=step)
            if self.fail_prob and not isinstance(self.fail_prob, dict):
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.seed, step]))
                if rng.random() < self.fail_prob:
                    raise SimulatedFailure(
                        f"random failure at step {step}", step=step)
            return
        k = self.op_counts.get(op, 0)
        self.op_counts[op] = k + 1
        if (op, k) in self.transient_at:
            raise TransientFault(
                f"injected transient fault: {op} call {k}", step=step, op=op)
        if (op, k) in self.fail_at:
            raise SimulatedFailure(
                f"injected failure: {op} call {k}", step=step, op=op)
        pt = self._prob(self.transient_prob, op)
        ph = self._prob(self.fail_prob, op)
        if pt <= 0.0 and ph <= 0.0:
            return
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, zlib.crc32(op.encode()), k]))
        r = rng.random()
        if r < pt:
            raise TransientFault(
                f"random transient fault: {op} call {k}", step=step, op=op)
        if r < pt + ph:
            raise SimulatedFailure(
                f"random failure: {op} call {k}", step=step, op=op)


def backoff_delay(attempt: int, *, base_s: float, factor: float = 2.0,
                  jitter: float = 0.25, rng=None) -> float:
    """Exponential backoff with multiplicative jitter: base·factor^attempt,
    stretched by up to ``jitter`` fraction.  base_s=0 (tests) → 0."""
    if base_s <= 0.0:
        return 0.0
    delay = base_s * factor ** attempt
    if jitter > 0.0 and rng is not None:
        delay *= 1.0 + jitter * float(rng.random())
    return delay
