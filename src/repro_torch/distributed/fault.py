"""Fault injection, bounded retry, straggler detection and the restart
driver: a copy of ``repro.distributed.fault``.

The serving half: the engine names each call site by its operation
("dispatch", "prefill", "compaction", "host_sync", "journal"), and a :class:`FailureInjector`
raises either a hard :class:`SimulatedFailure` (crash-grade: the engine
does not survive it, and recovery starts from the journal) or a retryable
:class:`TransientFault` (the engine unwinds or retries with bounded
backoff, :func:`backoff_delay`).  The injector's firing sequence is the JAX
one's: the same configuration fails the same calls.

The training half: :class:`StragglerDetector` flags steps slower than a
multiple of the EWMA of recent step times, and :func:`run_with_restarts`
rebuilds the trainer's state from its checkpoint after each injected node
loss.  The restart driver drops the failed attempt's state, the traceback
that holds its loop's locals included, before it builds the next one: at
full width those hold the params and the f32 moments (~20 GB for
qwen3-1.7b), which the card would otherwise hold beside the next
attempt's.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable

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


class StragglerDetector:
    """Flags steps slower than ``threshold`` × EWMA of recent step times.

    On a real pod the per-host step times arrive via the coordination
    service; here the driver feeds its local wall times.  ``on_straggler``
    is the mitigation hook (re-shard, evict host, rebalance data).
    """

    def __init__(self, threshold: float = 3.0, alpha: float = 0.2,
                 warmup: int = 3, on_straggler: Callable | None = None):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.seen = 0
        self.stragglers: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (self.seen > self.warmup
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.stragglers.append((step, dt, self.ewma))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.ewma)
        else:  # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    steps_replayed: int = 0
    last_failure_step: int = -1
    backoff_total_s: float = 0.0


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


def run_with_restarts(make_state, train_loop, *, max_restarts: int = 5,
                      backoff_s: float = 0.0, backoff_factor: float = 2.0,
                      jitter: float = 0.25, seed: int = 0,
                      restored_step: Callable | None = None):
    """Restart driver: (re)build state via ``make_state(restart_idx)`` and
    run ``train_loop(state)`` until it completes or restarts are exhausted.

    ``train_loop`` raises SimulatedFailure (or any RuntimeError subclass the
    cluster layer maps node loss to); ``make_state`` restores from the
    checkpoint manager — the loop owns nothing across attempts, exactly like
    a scheduler relaunching a died job.

    ``restored_step(state)`` (optional) reports which step an attempt resumed
    from, so ``stats.steps_replayed`` accounts the re-executed span between
    the restored step and the step the previous attempt failed at.  Restart
    delay is exponential backoff with jitter (``backoff_s`` base, 0 in tests
    ⇒ no sleep), accumulated in ``stats.backoff_total_s``.

    A failed attempt's state and its exception (whose traceback keeps the
    loop's frame, and so its params and moments, alive) are dropped before
    ``make_state`` builds the next attempt.
    """
    stats = RestartStats()
    rng = np.random.default_rng(seed)
    failed_at: int | None = None
    for attempt in range(max_restarts + 1):
        state = make_state(attempt)
        if failed_at is not None and failed_at >= 0 and restored_step is not None:
            rs = restored_step(state)
            if rs is not None:
                stats.steps_replayed += max(0, failed_at - int(rs))
        failed_at = None
        try:
            result = train_loop(state)
            return result, stats
        except SimulatedFailure as e:
            stats.restarts += 1
            stats.last_failure_step = getattr(e, "step", -1)
            failed_at = stats.last_failure_step
            if attempt == max_restarts:
                raise RuntimeError("restart budget exhausted") from e
        # ``e`` and its traceback are gone here; the state goes too
        state = None
        delay = backoff_delay(attempt, base_s=backoff_s,
                              factor=backoff_factor, jitter=jitter, rng=rng)
        stats.backoff_total_s += delay
        if delay > 0.0:
            time.sleep(delay)  # real driver: also a health check
    raise AssertionError("unreachable")
