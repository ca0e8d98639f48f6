"""Deterministic, host-sharded, resumable synthetic token pipeline.

Design constraints of a 1000-node run, honored at laptop scale:
  * determinism  — batch content is a pure function of (seed, step, host),
                   so a restarted/elastically-rescaled job replays the exact
                   stream from its checkpointed step (no data loss/dup);
  * host sharding — each host materializes only its slice of the global
                   batch (global_batch // n_hosts);
  * overlap      — a double-buffered background thread keeps batches ahead
                   of the training step (compute/IO overlap).  The prefetch
                   is best-effort: on any step mismatch (seek/restore) the
                   consumer falls back to synchronous recomputation, so
                   correctness never depends on thread timing.

The token model is a Zipf-mixture LM surrogate: document ids drawn Zipf(1.2),
tokens = per-document affine chain + 5% noise — cheap, but with enough
structure that cross-entropy visibly falls during the example runs.

A copy of ``repro.data.pipeline`` (numpy only): ``batch_at`` gives the JAX
stream's batches bit for bit, and the trainer moves them onto its device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLMStream:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 n_hosts: int = 1, host_id: int = 0, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2):
        assert global_batch % n_hosts == 0, (global_batch, n_hosts)
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.host_id = host_id
        self.seed = seed
        self.step = start_step
        self._lock = threading.Lock()
        self._prod_step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._alive = True
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # --------------------------------------------------------- deterministic
    def batch_at(self, step: int) -> dict:
        """The (host-local) batch for ``step`` — pure function, replayable."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, step]))
        B, S, V = self.local_batch, self.seq_len, self.vocab
        doc = rng.zipf(1.2, size=(B, 1)).astype(np.int64) % 997
        t0 = rng.integers(0, V, size=(B, 1))
        steps = (doc * 31 + 17) % (V - 1) + 1
        ar = np.arange(S, dtype=np.int64)[None, :]
        toks = (t0 + ar * steps) % V
        noise = rng.random((B, S)) < 0.05
        toks = np.where(noise, rng.integers(0, V, size=(B, S)), toks)
        return {"tokens": toks.astype(np.int32)}

    # ------------------------------------------------------------- iteration
    def _producer(self) -> None:
        while self._alive:
            with self._lock:
                s = self._prod_step
                self._prod_step += 1
            batch = self.batch_at(s)
            while self._alive:
                try:
                    self._q.put((s, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> dict:
        # take prefetched batches while they line up; otherwise recompute
        for _ in range(4):
            try:
                step, batch = self._q.get(timeout=2.0)
            except queue.Empty:
                break
            if step == self.step:
                self.step += 1
                return batch
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self

    # ------------------------------------------------------------ resumption
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed, "host_id": self.host_id}

    def seek(self, step: int) -> None:
        """Rewind/forward to ``step`` (checkpoint restore)."""
        with self._lock:
            self.step = step
            self._prod_step = step
        try:  # drop stale prefetch
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self) -> None:
        self._alive = False
