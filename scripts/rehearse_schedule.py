#!/usr/bin/env python3
"""Rehearse the host-side schedule of ``chip_smoke.py``'s engine streams on
the CPU, to size a pool before a run on the card.

    PYTHONPATH=src python3 scripts/rehearse_schedule.py preemption 10 12 16 64
    PYTHONPATH=src python3 scripts/rehearse_schedule.py prefix 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py chunked 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py engine 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py async 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py async-f32 8
    PYTHONPATH=src python3 scripts/rehearse_schedule.py recovery 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py tp 12
    PYTHONPATH=src python3 scripts/rehearse_schedule.py moe 12

Without a stop token the pool's decisions (admission, placement, cleaning,
preemption, prefix hits) depend on the prompts' lengths and shared pages,
not on the model's values, so the smoke model on the CPU, at the same pool
geometry (``chip_smoke.POOL``), replays the full-width schedule.  For each
pool size (in slabs) it prints one JSON line: preemptions, resumes,
recomputed tokens, compactions, Wamp, dispatches and, for the prefix
stream, the hit rate and the prefill tokens saved; for the chunked stream
(the engine phase's 32 requests with ``chip_smoke.PREFILL_CHUNK``) the
chunks dispatched.  ``engine`` is the engine phase's stream as it is (32
requests, synchronous compaction), with its direct and staged plans;
``async`` the same stream with ``async_compaction=True`` at the default
clean budget, with the pipeline's counters: moves planned and committed,
sub-plans, hazard commits, drains, the waits for a dead destination, and
the step boundaries crossed with a move in flight; ``async-f32`` the async
phase's f32 leg (``chip_smoke.long_requests`` with ``ASYNC_F32_NEW`` new
tokens) with async compaction.  ``recovery`` rehearses the recovery phase:
the engine phase's stream journaled with a snapshot every
``chip_smoke.RECOVERY_SNAPSHOT_EVERY`` dispatches (its record count, its
snapshots and the seqs of the three cuts ``chip_smoke.recovery_cuts``
picks), a recovery from each cut (records replayed, sequences resumed,
requests requeued, tokens replayed), the kill inside the async window (its
dispatch) and the f32 leg's middle cut: the ``RECOVERY_REHEARSED`` that
``chip_smoke.py`` asserts.  ``tp`` is the tp phase's stream, the engine
phase's first ``chip_smoke.TP_REQUESTS`` requests (its pool compacts at
``chip_smoke.TP_SLABS``; the sharded engine plans as the unsharded one).
``moe`` is the same stream through the MoE smoke model (the moe phase's
``MOE_REHEARSED``): the plan does not depend on the family either.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import PagedServingEngine  # noqa: E402


def _journaled(model, reqs, root, pick=None, **kw):
    """One journaled run to completion; with ``pick``, the cuts it names
    are cloned (``chip_smoke.capture``).  Returns (engine, cuts)."""
    eng = PagedServingEngine(model, journal_dir=root, **kw)
    cuts = chip_smoke.capture(eng, Path(f"{root}_cuts"),
                              pick or (lambda e, s, r: None))
    for p, n in reqs:
        eng.submit(p, n)
    eng.run_to_completion()
    eng.journal.close()
    return eng, cuts


def _counters(model, d, **kw) -> dict:
    _, summ = chip_smoke.recover_drain(model, d, **kw)
    return {k: summ[k] for k in chip_smoke.RECOVERY_COUNTERS}


def rehearse_recovery(model, vocab: int, n_slabs: int) -> dict:
    """The recovery phase's host counters at ``n_slabs`` slabs."""
    kw = dict(chip_smoke.POOL, n_slabs=n_slabs, pool_dtype=torch.float32,
              device="cpu")
    prompts, news = chip_smoke.engine_requests(vocab)
    reqs = [(p % model.cfg.vocab_size, int(n)) for p, n in zip(prompts, news)]
    S = chip_smoke.RECOVERY_SNAPSHOT_EVERY
    root = Path(tempfile.mkdtemp(prefix="rehearse_recovery_"))
    try:
        # a first run counts the records, for the rule's half-way point
        eng, _ = _journaled(model, reqs, root / "count", snapshot_every=S, **kw)
        records = eng.journal.next_seq
        eng, cuts = _journaled(model, reqs, root / "journal",
                               chip_smoke.recovery_cuts(records // 2),
                               snapshot_every=S, **kw)
        kinds = cuts.pop("kinds")
        out = {"records": records, "snapshots": eng._snap_id,
               "cuts": {n: cuts[n][0] for n in sorted(cuts)},
               "per_cut": {n: _counters(model, cuts[n][2], **kw)
                           for n in sorted(cuts)}}
        akw = dict(kw, async_compaction=True, audit_every=1)
        eng = PagedServingEngine(model, journal_dir=root / "async", **akw)
        for p, n in reqs:
            eng.submit(p, n)
        while eng.has_work() and not (
                eng.dispatches >= chip_smoke.RECOVERY_ASYNC_FROM
                and eng._inflight_plans):
            eng.step()
        out["async"] = {"dispatch": eng.dispatches,
                        **_counters(model, root / "async", **akw)}
        small = [(p % model.cfg.vocab_size, n) for p, n in
                 chip_smoke.long_requests(vocab, chip_smoke.ASYNC_F32_NEW)]
        fkw = dict(kw, n_slabs=chip_smoke.ASYNC_F32_SLABS)
        eng, _ = _journaled(model, small, root / "f32count", **fkw)
        half = eng.journal.next_seq // 2
        _, cuts = _journaled(model, small, root / "f32",
                             lambda e, s, r: "middle" if s == half else None,
                             **fkw)
        out["f32_records"] = eng.journal.next_seq
        out["f32"] = {"records": eng.journal.next_seq,
                      **_counters(model, cuts["middle"][2], **fkw)}
        out["record_kinds"] = kinds
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    stream, slabs = sys.argv[1], [int(a) for a in sys.argv[2:]]
    torch.set_num_threads(1)
    full = get_config("qwen3-1.7b")
    model = Model(full.smoke(), device="cpu", seed=0)
    if stream == "recovery":
        for n_slabs in slabs:
            print(json.dumps({"stream": stream, "n_slabs": n_slabs,
                              **rehearse_recovery(model, full.vocab_size,
                                                  n_slabs)}), flush=True)
        return
    if stream == "preemption":
        prompts, news = chip_smoke.engine_requests(full.vocab_size)
        reqs = [(p, int(n)) for p, n in zip(prompts[:16], news[:16])]
        kw = dict(preemption=True)
    elif stream == "prefix":
        reqs = chip_smoke.prefix_requests(full.vocab_size)
        kw = dict(prefix_cache=True)
    elif stream == "async-f32":
        reqs = chip_smoke.long_requests(full.vocab_size,
                                        chip_smoke.ASYNC_F32_NEW)
        kw = dict(async_compaction=True)
    elif stream in ("tp", "moe"):
        if stream == "moe":
            model = Model(get_config(chip_smoke.MOE_ARCH).smoke(),
                          device="cpu", seed=0)
        prompts, news = chip_smoke.engine_requests(full.vocab_size)
        n = chip_smoke.TP_REQUESTS
        reqs = [(p, int(m)) for p, m in zip(prompts[:n], news[:n])]
        kw = {}
    elif stream in ("chunked", "engine", "async"):
        prompts, news = chip_smoke.engine_requests(full.vocab_size)
        reqs = [(p, int(n)) for p, n in zip(prompts, news)]
        kw = {"chunked": dict(prefill_chunk=chip_smoke.PREFILL_CHUNK),
              "engine": {}, "async": dict(async_compaction=True)}[stream]
    else:
        raise SystemExit(f"unknown stream {stream!r}: preemption, prefix, "
                         f"chunked, engine, async, async-f32, recovery, tp "
                         f"or moe")
    for n_slabs in slabs:
        eng = PagedServingEngine(model, **{**chip_smoke.POOL, **kw,
                                           "n_slabs": n_slabs},
                                 pool_dtype=torch.float32, device="cpu")
        for p, n in reqs:
            eng.submit(p % model.cfg.vocab_size, n)
        ops.reset_launches()
        eng.run_to_completion()
        eng.pool.check_invariants()
        m = eng.metrics()
        print(json.dumps({"stream": stream, "n_slabs": n_slabs, **{
            k: m[k] for k in ("preemptions", "resumes", "recomputed_tokens",
                              "compactions", "blocks_moved", "wamp",
                              "dispatches", "prefix_hit_rate",
                              "prefill_tokens_saved",
                              "prefill_chunks_dispatched", "gc_planned",
                              "gc_committed", "sub_plans", "hazard_commits",
                              "drains", "dead_destination_waits",
                              "inflight_boundaries", "compaction_debt_moves",
                              "fenced_slabs")
            if k in m}, "move_plans": dict(ops.move_plans),
            "move_launches": ops.launches["segment_move"]}), flush=True)


if __name__ == "__main__":
    main()
