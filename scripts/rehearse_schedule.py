#!/usr/bin/env python3
"""Rehearse the host-side schedule of ``chip_smoke.py``'s engine streams on
the CPU, to size a pool before a run on the card.

    PYTHONPATH=src python3 scripts/rehearse_schedule.py preemption 10 12 16 64
    PYTHONPATH=src python3 scripts/rehearse_schedule.py prefix 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py chunked 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py engine 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py async 30
    PYTHONPATH=src python3 scripts/rehearse_schedule.py async-f32 8

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
tokens) with async compaction.
"""

from __future__ import annotations

import json
import sys
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


def main() -> None:
    stream, slabs = sys.argv[1], [int(a) for a in sys.argv[2:]]
    torch.set_num_threads(1)
    full = get_config("qwen3-1.7b")
    model = Model(full.smoke(), device="cpu", seed=0)
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
    elif stream in ("chunked", "engine", "async"):
        prompts, news = chip_smoke.engine_requests(full.vocab_size)
        reqs = [(p, int(n)) for p, n in zip(prompts, news)]
        kw = {"chunked": dict(prefill_chunk=chip_smoke.PREFILL_CHUNK),
              "engine": {}, "async": dict(async_compaction=True)}[stream]
    else:
        raise SystemExit(f"unknown stream {stream!r}: preemption, prefix, "
                         f"chunked, engine, async or async-f32")
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
