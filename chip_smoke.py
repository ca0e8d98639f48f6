#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``); CUDA present.
2. build   — compile the five CUDA kernels from ``src/repro_torch/kernels/
             csrc`` (one ``nvcc`` per source, started together).
3. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's full-width shapes (qwen3-1.7b: Kh=8, G=2,
             D=128, page_T=16; paged attention also at a long context of
             32 sequences of up to 4,096 tokens, bf16, with the share of
             its bound it reaches; at both shapes also with q's dtype apart
             from the pools' (f32 q over bf16 pools, bf16 over f32), and the
             same-dtype outputs bitwise the earlier kernel's, by sha256),
             with the tolerances of the JAX package's
             kernel tests (f32 2e-5, bf16 2e-2, exact for the copies) and,
             for a mixed pair, a bar from where it rounds
             (``_torch_checks.paged_bar``);
             kernel, plain and library times (median of CUDA-event timings,
             L2 flushed before each launch; a kernel and its yardstick timed
             in alternation) beside the least time the card could take.  Flash attention runs at the engine's prefill
             buckets (S 256, 512, 1024) in bf16 on its tensor-core route and
             at S 1024 in f32 on its CUDA-core route, each line naming the
             route; the compaction move runs a disjoint plan (one launch) and
             an overlapping one (gather and scatter) beside the PyTorch
             expression ``p[:, dst] = p[:, src]``.  Flash attention also runs
             at the prefix-hit shape (512 query rows after a 512-token cached
             prefix, over 1,024 keys) on both routes, and at a chunked
             prefill's last chunk (256 rows at offset 768) in bf16: against
             its plain version, and bit for bit the same rows of the
             ``q_offset = 0`` call over all 1,024 rows, beside
             ``scaled_dot_product_attention`` with the same (lower-right
             causal) mask.  Paged attention and flash also run at the
             moe phase's heads (Qwen3-30B-A3B: G 8 over Kh 4; H 32 / Kh 4
             at S 1,024).
4. engine  — the paged serving engine on the full-width qwen3-1.7b (28
             layers, random bf16 weights from a seed) serving 32 requests,
             with the pool sized so that MDC compaction fires under pressure.
             The kernels' launch counters are zeroed just before and read
             just after; each of the engine's three (paged attention, the
             compaction move, flash attention on its tensor-core route) must
             have grown.  It reports how many compaction plans were staged
             (a destination that is another move's source), and the median
             and largest wall of a dispatch (CUDA events around each
             ``step()``).
5. tokens  — one request at float32 through the engine (the kernels) and
             through the plain ``greedy_decode``: the tokens must be equal,
             or the first mismatch must sit on a near-tie (top-2 logit
             margin below 1e-3).
6. victims — the device route of cleaning-victim selection (the MDC key
             through the ``mdc_priority`` kernel, then top-k) at the paper's
             51,200 segments of 512 pages and at 2**24 segments (a 32 TiB
             store of 2 MiB segments), clean batch 64.  The launch counter
             is zeroed just before the route is driven and read just after.
             Per shape: the kernel against its plain version (the same
             -1 / +inf pattern, finite keys within rtol 1e-6), the victims
             equal as a set to the plain route's on the card, and their keys
             equal as a multiset (rtol 1e-5) to the f64 host selection's;
             kernel, plain and key + top-k times beside the bound.  It and
             the phases below run after the tokens phase, so that the engine
             phase runs in the same process history as before they existed.
7. prefix  — 16 requests sharing one 512-token system prompt (tails of
             64-256 tokens, 32-64 new tokens) through the full-width engine
             four times, cold and with the prefix cache in turns: hit rate,
             prefill tokens saved, shared frames, flash launches with a query
             offset, pool and tree invariants; wall and prefill stream times
             (CUDA events around each admission's prefill); the share of requests
             whose bf16 tokens equal the cold run's (reported: a 256-row GEMM
             need not round like the rows of a 1,024-row one).  Then 4 such
             requests at f32 (TF32 off), hit against cold: equal tokens, or a
             first mismatch on a near-tie of the plain decode.
8. preemption — the engine phase's first 16 requests, with preemption on,
             through a pool small enough to preempt (chosen by rehearsing the
             host schedule on the CPU: ``scripts/rehearse_schedule.py``) and
             one with room to spare: ``preemptions`` >= 1, ``resumes`` equal
             to it, and every request's tokens equal to the big pool's.
9. chunked — the engine phase's 32 requests with chunked prefill (256
             tokens, 16 pages, per fused dispatch: a prompt of 256-1,024
             tokens makes 1-4 chunks at offsets 0, 256, 512, 768) through
             the same pool: every request's token count, one chunk per
             ceil(prompt / 256), >= 1 compaction, pool invariants, all three
             engine kernels launched and flash launches with a query offset;
             wall, tokens/s, dispatches, launches and the median and largest
             dispatch wall beside the engine phase's monolithic run and a
             second, warm one (whose tokens must repeat the first's), and
             the share of requests whose bf16 tokens equal them (reported).
             Then 4 requests of 300-1,000 tokens at f32 (TF32 off), chunked:
             equal to the plain decode, or a first mismatch on a near-tie.
10. async  — the engine phase's 32 requests and pool with asynchronous,
             budgeted compaction (the default clean budget; the moves on a
             side CUDA stream) and ``audit()`` after every dispatch: every
             request's token count, bf16 tokens equal to the engine phase's
             (synchronous) run in every request, the host-determined counters
             (compactions, blocks moved, Wamp, moves planned and committed,
             sub-plans, step boundaries crossed with a move in flight, hazard
             commits, drains, direct and staged plans) equal to the CPU
             rehearsal's (``scripts/rehearse_schedule.py async 30``), no debt
             and no fenced slab left, and ``segment_move`` launched on the
             side stream; wall, tokens/s, dispatches and the median and
             largest dispatch wall beside the engine phase's run and the
             chunked phase's warm rerun, and Wamp beside the synchronous
             run's.  Then the f32 leg's 4 long requests (16-128 new tokens,
             f32 weights and pool, TF32 off) through a pool small enough to
             compact (``rehearse_schedule.py async-f32 8``), async and sync:
             equal tokens, and equal to the plain decode or parting from it
             on a near-tie.
11. recovery — crash safety.  The engine phase's 32 requests through its
             pool with the session journal on and a snapshot every
             ``RECOVERY_SNAPSHOT_EVERY`` dispatches (4 snapshots): bf16
             tokens equal to the engine phase's in 32 of 32 (the journal is
             passive), >= 1 ``mv`` record.  The journal directory is cloned
             the moment three records chosen by rule are appended (a kill
             at that record boundary: right after the first ``mv``, right
             after the first ``snap``, and the first ``emit`` past half the
             records with every slot live); from each clone
             ``recover_engine(..., device="cuda")`` drains the session: the
             bf16 tokens of every request whose ``sub`` survived equal the
             unkilled run's, ``audit()`` passes, flash and paged attention
             launch.  Then a kill inside the async window (the async
             phase's configuration, each side-stream move held back ~50 ms,
             the engine dropped with a move in flight and recovered in the
             same process): tokens equal to the async phase's.  Then the f32
             leg (the async phase's f32 requests and pool, TF32 off), killed
             at its middle record boundary: tokens equal to the unkilled
             run's, and to the plain decode or parting from it on a
             near-tie.  Host counters (records, snapshots, the cuts' seqs,
             records replayed, sequences resumed, requests requeued, tokens
             replayed) equal ``scripts/rehearse_schedule.py recovery 30``'s.
             Reported per cut: ``load_session`` ms and the time to recover
             (from ``recover_engine`` until every resumed sequence has
             re-derived its journaled span).
12. serve  — observability and the serving CLI, in three legs.  (a) The
             engine phase's 32 requests and pool with a tracer, the phase
             split, death calibration and a metrics row every
             ``SERVE_METRICS_EVERY`` dispatches (files under
             ``build/serve/``): bf16 tokens equal to the engine phase's in 32
             of 32, its compactions, blocks moved and Wamp, a Chrome trace
             that passes the schema check of ``tests/test_obs.py`` with the
             engine's event names, ``phase_report()`` counting every
             dispatch, >= 2 metric rows, deaths calibrated, and all three
             engine kernels launched; reported: wall beside the engine
             phase's (the cost of observability, host noise included),
             events and drops, the dispatch wall's p50 / p99 and mean per
             phase, compaction's share of the p99 tail, the misroute rate.
             (b) The same requests through ``launch.serve._open_loop`` at
             ``SERVE_ARRIVAL_RATE`` requests/s (Poisson, seed 0) on a fresh
             engine: every request's token count, pool invariants, flash and
             paged attention launched; reported: TTFT, queue wait and TPOT
             p50 / p99, tokens/s, compactions and the phase split.  (c) The
             CLI, ``launch.serve.main()``, at its default smoke width on the
             card with tracing, the phase log, metrics and calibration: both
             policies ran, every row has tokens, the trace files exist.
13. mixed  — the parameters' dtype apart from the pool's.  (a) Full width:
             the seeded qwen3-1.7b weights at f32 over a bf16 pool and at
             bf16 over an f32 pool (the JAX ``examples/serve_paged.py``
             mix), 4 requests of 300-1,000 tokens each through the engine
             phase's pool, held against the plain greedy decode on the card
             (dense cache in the pool's dtype): tokens equal, or parting on
             a near-tie (top-2 margin < 1e-3 for f32 logits, at most one
             bf16 step for bf16 ones).  (b) Smoke width: f32 parameters
             over the default bf16 pool through ``launch.serve.serve_run``
             on the card and on the CPU (one weight draw): equal rows
             (tokens digest, Wamp, compactions, dispatches, blocks); bf16
             parameters over an f32 pool: every request's token count and
             the CPU's counters, the tokens held to the plain decode as in
             (a) and their share equal to the CPU's reported.
14. sim    — the port's cleaning simulator at the paper's store
             (``configs.paper_store.PAPER``: 51,200 segments of 512 pages,
             26.2 M pages, F 0.8) under 80:20 hot/cold updates and MDC,
             half a store's worth of updates (the first half warm-up; the
             length is the cut, not the store).  At every
             cleaning cycle ``_torch_checks.DeviceVictimCheck`` uploads
             the store's live counts, u_p2 means and eligibility, runs
             ``mdc_priority`` on the card and picks 64 with
             ``policies.torch_select_victims``; the host's f64 pick decides,
             and every device pick outside it must be a near-tie (host key
             within 1e-5 of the host's 64th).  Asserted: >= 1 launch per
             cycle, the store's invariants at the end.  Reported: cycles,
             launches, the kernel's median ms under this traffic, the share
             of cycles with identical sets, host seconds, Wamp and mean E at
             clean beside ``analysis.min_wamp_hotcold(0.8, 0.8, 0.2)``.
15. tp     — tensor-parallel serving on ``torch.distributed``, two ranks
             of ``gloo`` sharing the one card (one process each, spawned by
             ``launch.mesh.spawn_ranks``).  (a) At qwen3-1.7b's heads, each
             rank on 4 of the 8 kv heads: ``paged_attention_sharded`` at
             the kernels phase's shape (B 8, P 64, bf16) and
             ``flash_attention_sharded`` at S 1,024 and at the prefix-hit
             shape (512 rows at offset 512), each bit for bit the
             unsharded kernel's slice of the same heads, its
             ``gather_heads`` the whole unsharded output, and within the
             kernels phase's bars of the plain version on the local heads;
             timed on rank 0 while rank 1 waits, beside the bound and (flash)
             ``scaled_dot_product_attention`` on the local heads.  (b) The
             engine phase's first ``TP_REQUESTS`` requests through a pool of
             ``TP_SLABS`` slabs (it compacts: ``scripts/rehearse_schedule.py
             tp``) at full width, bf16, each rank's model cut to its heads
             (``shard_model``), with ``audit()`` (and the ranks' agreement
             check) every ``TP_AUDIT_EVERY`` dispatches, beside the unsharded
             engine on the same stream with the same audits: the ranks'
             tokens equal, every request finished, the host counters the
             unsharded run's, the tokens equal to it or parting on a
             near-tie of the plain decode (``first_mismatches``), pools
             sharded to 4 kv heads; reported: wall, each rank's launches of
             the two wrappers, and what each process holds on the card once
             its engine is built (``memory_allocated``, weight and pool
             bytes).
             (c) One ``nccl`` rank in this process (world size 1): tokens
             and counters bitwise the unsharded run's.
16. moe    — the MoE family at full width: Qwen3-30B-A3B (48 layers, d
             2,048, 32 q over 4 kv heads, 128 experts of d_ff 768, top-8,
             capacity factor 1.25), random bf16 weights (the router f32)
             drawn on the card from the seed, in a process of its own
             (spawned like the tp ranks; it first asserts that the card has
             room for the weights, the pool and ``MOE_HEADROOM``).  The tp
             phase's 8 requests and 12-slab pool through the engine: the
             host counters of ``scripts/rehearse_schedule.py moe 12`` (4
             compactions), all three engine kernels launched (paged
             attention at G 8, flash at H 32 / Kh 4 on the ``wgmma``
             route).  Each request through the plain path on the card at
             the engine's prompt bucket (so the MoE groups and drops as the
             engine's does): its tokens equal the engine's, or the first
             mismatch sits on a logit near-tie (``near_tie_bar``) of the
             plain path.  Layer 0 of a 1,024-token bucket through the
             port's moe functions: the capacity-dropped picks, and
             ``moe_ffn`` at the prefill and decode shapes called twice,
             bitwise equal.  Reported: the parameter counts, wall and
             dispatch times, peak memory.  (The decode step's device split
             is ``scripts/profile_engine.py --arch qwen3-moe-30b-a3b``.)
             Each of the last ten phases zeroes the launch counters before
             it and reads them after, and fails unless its kernels launched.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))  # _torch_checks: checks shared with the tests

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.paper_store import PAPER  # noqa: E402
from repro_torch.core import analysis, policies  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.layers import flatten, rmsnorm, unflatten  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serving import PagedServingEngine, recover_engine  # noqa: E402
from repro_torch.serving import recovery  # noqa: E402
from repro_torch.serving.engine import shard_model  # noqa: E402
from repro_torch.serving.scheduler import DEFAULT_CLEAN_BUDGET  # noqa: E402
from _torch_checks import (PAGED_SHA256, DeviceVictimCheck,  # noqa: E402
                           check_paged_close, digest, paged_bar, paged_case)
from _torch_tp import local_heads  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, dense bf16
# tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SEED = 0

KERNELS = {
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:76"},
    "segment_compact": {
        "source": "src/repro_torch/kernels/csrc/segment_compact.cu",
        "replaces": "src/repro/kernels/segment_compact.py:33"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96"},
    "mdc_priority": {
        "source": "src/repro_torch/kernels/csrc/mdc_priority.cu",
        "replaces": "src/repro/kernels/mdc_priority.py:43"},
    # the compaction move of src/repro/serving/engine.py:307 _move_pages_fn,
    # whose TPU kernel is segment_compact
    "segment_move": {
        "source": "src/repro_torch/kernels/csrc/segment_move.cu",
        "replaces": "src/repro/kernels/segment_compact.py:33"},
    # the shard_map wrappers: each rank launches the kernel above on its own
    # kv heads (src/repro_torch/kernels/ops.py)
    "paged_attention_sharded": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:112"},
    "flash_attention_sharded": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:144"},
}
TP_KERNELS = ("paged_attention_sharded", "flash_attention_sharded")
# the engine's kernels: each must launch in the engine phase.  segment_compact
# is off the engine's path since the move is one fused kernel (its launches
# there are 0); mdc_priority's path is the victims phase.
ENGINE_KERNELS = ("paged_attention", "segment_move", "flash_attention")
FLASH_BUCKETS = (256, 512, 1024)  # the engine's prefill buckets
# the engine phase's pool and slots; the prefix and preemption phases keep
# them (the preemption phase sizes its own pools)
POOL = dict(n_slabs=30, blocks_per_slab=16, page_T=16, max_batch=8,
            max_seq=2048, streams=1, compact_trigger=2, compact_batch=4,
            max_decode_chunk=32)
PREFIX_LEN = 512             # the shared system prompt: 32 pages of 16
PREEMPT_SLABS = (24, 40)     # a pool that preempts, and one with room
PREFILL_CHUNK = 256          # the chunked phase's budget: 16 pages of 16
# the async phase's host-determined counters, rehearsed on the CPU with
# ``scripts/rehearse_schedule.py async 30`` (the engine phase's stream)
ASYNC_REHEARSED = dict(dispatches=141, compactions=5, blocks_moved=140,
                       gc_planned=140, gc_committed=140, sub_plans=19,
                       inflight_boundaries=19, hazard_commits=0, drains=0,
                       dead_destination_waits=2)
ASYNC_PLANS = {"direct": 19, "staged": 0}
# the async f32 leg: long_requests' prompts with these new tokens through a
# pool that compacts (``rehearse_schedule.py async-f32 8``: 1 compaction,
# 29 moves in 4 sub-plans, 4 step boundaries with a move in flight)
ASYNC_F32_NEW = (16, 64, 32, 128)
ASYNC_F32_SLABS = 8
# the recovery phase: a snapshot every this many dispatches (4 snapshots in
# the engine phase's 146), and its host-determined counters, rehearsed on
# the CPU with ``scripts/rehearse_schedule.py recovery 30``
RECOVERY_SNAPSHOT_EVERY = 36
RECOVERY_REHEARSED = {
    "records": 439, "snapshots": 4,
    "cuts": {"after_first_mv": 133, "after_first_snap": 152,
             "mid_all_live": 220},
    "per_cut": {
        "after_first_mv": dict(snapshot_id=0, records_replayed=134,
                               sequences_resumed=8, requests_requeued=16,
                               tokens_replayed=5971),
        "after_first_snap": dict(snapshot_id=1, records_replayed=0,
                                 sequences_resumed=8, requests_requeued=15,
                                 tokens_replayed=6279),
        "mid_all_live": dict(snapshot_id=1, records_replayed=68,
                             sequences_resumed=8, requests_requeued=10,
                             tokens_replayed=6643)},
    "async": dict(dispatch=49, snapshot_id=0, records_replayed=199,
                  sequences_resumed=8, requests_requeued=11,
                  tokens_replayed=6317),
    "f32_records": 55,
    "f32": dict(records=55, snapshot_id=0, records_replayed=28,
                sequences_resumed=1, requests_requeued=1, tokens_replayed=529),
}
# the async-window kill: the first step boundary with a move in flight from
# this dispatch on
RECOVERY_ASYNC_FROM = 40
# the serve phase: a metrics row every this many dispatches (18 in the
# engine phase's 146), and the open loop's arrival rate, at or below what
# the closed loop sustained on every recorded run (32 requests in 14.8-29.6
# s: 1.08-2.16 requests/s), so the leg measures latency, not a queue that
# grows without bound
SERVE_METRICS_EVERY = 8
SERVE_ARRIVAL_RATE = 1.0
SERVE_EVENTS = {"step", "dispatch", "host_sync", "pool", "req", "req.admit",
                "seg.open", "seg.seal", "seg.evacuate"}
SERVE_CLI_ARGS = ["--requests", "8", "--policies", "mdc", "greedy",
                  "--arrival-rate", "4", "--phase-log", "--metrics-every", "2",
                  "--calibration"]
# paged attention's q dtype apart from the pools': (q, pools)
MIXED_PAIRS = ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))
# the mixed phase's full-width legs: (leg, parameters' dtype, pool dtype)
MIXED_LEGS = (("f32_params_bf16_pool", torch.float32, torch.bfloat16),
              ("bf16_params_f32_pool", torch.bfloat16, torch.float32))
# the sim phase: the paper's store under 80:20 hot/cold updates, half a
# store's worth of them (~45 s of host) with the first half as warm-up
SIM_WORKLOAD = dict(update_frac=0.8, data_frac=0.2)
SIM_UPDATES = PAPER.nseg * PAPER.pages_per_seg // 2
SIM_WARMUP = 0.5
# the tp phase: two gloo ranks on the one card, the engine phase's first 8
# requests through a pool of 12 slabs (``scripts/rehearse_schedule.py tp
# 12``: 4 compactions, 114 moves, 34 dispatches), audit() every 8
TP_RANKS = 2
TP_REQUESTS = 8
TP_SLABS = 12
TP_AUDIT_EVERY = 8
TP_TIMEOUT_S = 300   # the ranks took ~45 s: a hung collective fails the run
COUNTERS = ("dispatches", "blocks_written", "blocks_moved", "compactions",
            "wamp")
# the moe phase: Qwen3-30B-A3B at full width in a process of its own (its
# 61.1 GB of weights and an earlier phase's tensors do not fit on one card
# together), on the tp phase's stream and pool.  The host plan depends only
# on the prompts' lengths: ``scripts/rehearse_schedule.py moe 12`` prints
# these counters
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_REHEARSED = dict(dispatches=34, blocks_written=295, blocks_moved=114,
                     compactions=4, wamp=114 / 295)
MOE_HEADROOM = 8e9   # bytes free beyond the weights and the pool
MOE_TIMEOUT_S = 600


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median of CUDA-event timings of single calls, after warm-up.  Every
    timed call is preceded by a write of 256 MB, which flushes the 50 MB L2
    (the engine finds K/V and weights cold), and by a ~1 ms device-side
    spin, which keeps the device busy while the host enqueues the call, so
    the events time the device's work and not the host's launch gaps.  Given
    several functions (a kernel and its yardstick), their calls alternate
    rep by rep, so that drift of the card's state falls on all of them
    alike.  One synchronise at the end."""

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, *fns):
        """The median ms of the one function, or a list, one per function."""
        for fn in fns:
            for _ in range(self.warmup):
                fn()
        events = [[] for _ in fns]
        for _ in range(self.reps):
            for fn, evs in zip(fns, events):
                self.flush.zero_()
                torch.cuda._sleep(2_000_000)  # clock cycles, ~1 ms
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                evs.append((start, end))
        torch.cuda.synchronize()
        ms = [statistics.median(s.elapsed_time(e) for s, e in evs)
              for evs in events]
        return ms[0] if len(fns) == 1 else ms


def bound(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    """Least time in ms on the card: bytes over the HBM rate or operations
    over the peak rate of the inputs' type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = card()
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def ptxas_report(log: str) -> dict:
    """Per entry function of one library, from ``nvcc -Xptxas -v``:
    registers, spill-store bytes and static shared memory (dynamic shared
    memory is set at launch and not listed)."""
    report = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        smem = re.search(r"(\d+) bytes smem", chunk)
        report[chunk.split("'", 1)[0]] = {
            "registers": int(re.search(r"Used (\d+) registers", chunk).group(1)),
            "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores",
                                               chunk).group(1)),
            "smem_static_bytes": int(smem.group(1)) if smem else 0}
    if shutil.which("c++filt"):  # readable kernel names where binutils has them
        names = subprocess.run(["c++filt"], input="\n".join(report), text=True,
                               capture_output=True, check=True).stdout.splitlines()
        report = {n.replace("(anonymous namespace)::", "").split("(", 1)[0]
                  .removeprefix("void "): r for n, r in zip(names, report.values())}
    return report


def phase_build() -> None:
    t0 = time.perf_counter()
    info = build.build()
    for name in build.SIGNATURES:  # load every library: fails if one is bad
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {n: round(i["seconds"], 2) for n, i in info.items()},
          "ptxas": {n: ptxas_report(i["log"]) for n, i in info.items()}})


def check_paged_attention(dtype, timer, B=8, P=64, q_dtype=None, Kh=8,
                          G=2) -> dict:
    """Decode attention at qwen3-1.7b's heads (Kh 8, G 2, D 128, 16-token
    pages; Qwen3-30B-A3B's are Kh 4, G 8) over B sequences of up to P pages
    each; a full table and a one-token sequence among them
    (``_torch_checks.paged_case``).
    ``dtype`` is the pools', ``q_dtype`` (default the same) q's and the
    output's; each pair is held to its own bar (``paged_bar``), and
    ``bar_share`` is the largest share of it used.  ``launches_per_call``
    counts the kernel's launches in one wrapper call (the design makes it
    1).  A same-dtype output at a shape ``PAGED_SHA256`` holds must be
    bitwise the one it holds."""
    q_dtype = q_dtype or dtype
    D, T = 128, 16
    H = Kh * G
    q, k_pool, v_pool, bt, lens = paged_case(q_dtype, dtype, B, P, Kh, G, D, T,
                                             seed=SEED)
    n0 = ops.launches["paged_attention"]
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    per_call = ops.launches["paged_attention"] - n0
    if per_call != 1:
        raise AssertionError(f"paged_attention: {per_call} launches per call")
    if got.dtype != q_dtype:
        raise AssertionError(f"paged_attention: output {got.dtype}, q {q_dtype}")
    want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
    share = check_paged_close(got, want, paged_bar(q, k_pool, v_pool, bt,
                                                   lens, want))
    sha = {}
    if q_dtype == dtype and (B, P, Kh, G, D, T) in PAGED_SHA256:
        sha = {"sha256": digest(got), "sha256_parent": PAGED_SHA256[
            (B, P, Kh, G, D, T)][dtype == torch.float32]}
        sha["bitwise_parent"] = sha["sha256"] == sha["sha256_parent"]
        if not sha["bitwise_parent"]:
            raise AssertionError(f"paged_attention {dtype} B={B}: output is "
                                 f"not bitwise the earlier kernel's")
    n_tok = int(lens.sum())
    es = torch.tensor([], dtype=dtype).element_size()
    es_q = torch.tensor([], dtype=q_dtype).element_size()
    n_bytes = (2 * n_tok * Kh * D * es + 2 * B * H * D * es_q
               + 4 * int(((lens + T - 1) // T).sum()) + 4 * B)
    b_ms, b_by = bound(n_bytes, 4.0 * n_tok * H * D, dtype)
    kernel_ms = timer(lambda: ops.paged_attention(q, k_pool, v_pool, bt, lens))
    return {"q_dtype": str(q_dtype), "max_abs_err": max_err(got, want),
            "bar_share": share, "launches_per_call": per_call, **sha,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / kernel_ms,
            "shape": {"B": B, "Kh": Kh, "G": G, "D": D, "page_T": T, "P": P,
                      "tokens": n_tok}}


def check_flash_attention(dtype, S, timer, H=16, Kh=8) -> dict:
    """Causal prefill attention at qwen3-1.7b's heads (H 16, Kh 8; Qwen3-
    30B-A3B's are H 32, Kh 4) over S tokens, in the model's (B, S, H, D)
    layout; the launch must take the route that ``ops.flash_route`` names
    for (dtype, D)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, D = 1, 128
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, Kh, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, Kh, D, generator=g, device="cuda").to(dtype)
    route = ops.flash_route(dtype, D)
    before = ops.flash_routes[route]
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if ops.flash_routes[route] != before + 1:
        raise AssertionError(f"flash_attention {dtype} S={S}: not on the "
                             f"{route} route")
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # yardstick: the library's fused attention on the same inputs in its
    # (B, H, S, D) layout, kv heads expanded beforehand so it runs its
    # multi-head path
    qh = q.transpose(1, 2).contiguous()
    k_h = k.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    v_h = v.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (2 * B * H * S * D + 2 * B * Kh * S * D) * es
    flops = 4.0 * B * H * D * S * (S + 1) / 2
    b_ms, b_by = bound(n_bytes, flops, dtype)
    kernel_ms, library_ms = timer(
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qh, k_h, v_h, is_causal=True))
    return {"flash_route": route, "max_abs_err": max_err(got, want),
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, causal=True)),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "H": H, "Kh": Kh, "S": S, "D": D, "causal": True}}


def check_flash_offset(dtype, timer, Sq=512, Skv=1024) -> dict:
    """The prefix-hit shape: Sq query rows at absolute positions q_offset +
    i (q_offset = Skv - Sq, a cached prefix) over Skv keys, causal.  Held to
    the plain version, and bit for bit to the same rows of the q_offset = 0
    call over all Skv rows.  Yardstick: ``scaled_dot_product_attention``
    with ``causal_lower_right``, which is this mask when q_offset = Skv -
    Sq."""
    from torch.nn.attention.bias import causal_lower_right
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Kh, D, off = 1, 16, 8, 128, Skv - Sq
    q_all = torch.randn(B, Skv, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    q = q_all[:, off:]
    route = ops.flash_route(dtype, D)
    before = ops.flash_offsets["nonzero"], ops.flash_routes[route]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    if (ops.flash_offsets["nonzero"], ops.flash_routes[route]) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"flash_attention q_offset {dtype}: not one "
                             f"offset launch on the {route} route")
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    whole = ops.flash_attention(q_all, k, v, causal=True)
    rows_equal = bool(torch.equal(got, whole[:, off:]))
    if not rows_equal:
        raise AssertionError(f"flash_attention q_offset {dtype}: rows differ "
                             f"from the q_offset = 0 call's")
    qh = q.transpose(1, 2).contiguous()
    k_h = k.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    v_h = v.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    mask = causal_lower_right(Sq, Skv)
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (2 * B * H * Sq * D + 2 * B * Kh * Skv * D) * es
    flops = 4.0 * B * H * D * (Sq * off + Sq * (Sq + 1) / 2)
    b_ms, b_by = bound(n_bytes, flops, dtype)
    kernel_ms, library_ms = timer(
        lambda: ops.flash_attention(q, k, v, causal=True, q_offset=off),
        lambda: F.scaled_dot_product_attention(qh, k_h, v_h, attn_mask=mask))
    return {"flash_route": route, "q_offset": off,
            "max_abs_err": max_err(got, want), "rows_bitwise_equal": rows_equal,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, q_offset=off)),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "H": H, "Kh": Kh, "Sq": Sq, "Skv": Skv, "D": D,
                      "causal": True}}


def check_segment_compact(dtype, E, timer) -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, n_pages, moves = 28, 481, 64  # the engine's flattened pool, one plan
    N, M = L * n_pages, L * moves
    if dtype == torch.int32:
        pool = torch.randint(0, 1 << 30, (N, E), generator=g, device="cuda",
                             dtype=torch.int32)
    else:
        pool = torch.randn(N, E, generator=g, device="cuda").to(dtype)
    src = torch.randint(0, N, (M,), generator=g, device="cuda", dtype=torch.int32)
    got = ops.segment_compact(pool, src)
    want = ref.segment_compact_ref(pool, src)
    if not torch.equal(got, want):
        raise AssertionError(f"segment_compact {dtype} E={E}: copy not exact")
    n_bytes = 2 * M * E * pool.element_size() + 4 * M
    b_ms, b_by = bound(n_bytes, 0.0, torch.bfloat16)
    src_l = src.long()
    kernel_ms, library_ms = timer(lambda: ops.segment_compact(pool, src),
                                  lambda: torch.index_select(pool, 0, src_l))
    return {"max_abs_err": 0.0, "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.segment_compact_ref(pool, src)),
            "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"N": N, "M": M, "E": E}}


def check_segment_move(overlap: bool, timer) -> dict:
    """One compaction plan at the engine's shape: 64 moves in every one of
    28 layers of the K and V pools of 481 pages of E = 16,384 bf16 (one
    16-token page of 8 heads x 128).  With ``overlap`` half of the
    destinations are other moves' sources, so the wrapper stages it."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, n_pages, moves, E = 28, 481, 64, 16384
    k_pool, v_pool = (torch.randn(L, n_pages, E, generator=g, device="cuda")
                      .to(torch.bfloat16) for _ in range(2))
    perm = np.random.default_rng(SEED).permutation(n_pages)
    src, dst = perm[:moves], perm[moves:2 * moves].copy()
    if overlap:
        dst[:moves // 2] = np.roll(src, 1)[:moves // 2]
    want = (k_pool.clone(), v_pool.clone())
    ref.segment_move_ref(want, src, dst)
    n0, form = ops.launches["segment_move"], "staged" if overlap else "direct"
    before = ops.move_plans[form]
    ops.segment_move((k_pool, v_pool), src, dst)
    torch.cuda.synchronize()
    if ops.move_plans[form] != before + 1:
        raise AssertionError(f"segment_move: the plan was not moved {form}")
    if not (torch.equal(k_pool, want[0]) and torch.equal(v_pool, want[1])):
        raise AssertionError(f"segment_move {form}: move not exact")
    launches = ops.launches["segment_move"] - n0
    del want
    src_t, dst_t = (torch.from_numpy(a).cuda() for a in (src, dst))

    def expression():  # the PyTorch expression of the same move
        for p in (k_pool, v_pool):
            p[:, dst_t] = p[:, src_t]

    rows = L * moves
    n_bytes = 2 * (2 * rows * E * k_pool.element_size()) + 2 * 4 * rows
    b_ms, b_by = bound(n_bytes, 0.0, torch.bfloat16)
    kernel_ms, expression_ms = timer(
        lambda: ops.segment_move((k_pool, v_pool), src, dst), expression)
    return {"form": form, "launches_per_plan": launches, "max_abs_err": 0.0,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.segment_move_ref((k_pool, v_pool), src, dst)),
            "expression_ms": expression_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"L": L, "n_pages": n_pages, "moves": moves, "E": E}}


def phase_kernels() -> dict:
    timer = Timer()
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = check_paged_attention(dtype, timer)
        emit({"phase": "kernel", "name": "paged_attention", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16:  # the main path runs bf16
            main["paged_attention"] = r
    # long context: 32 sequences of up to 4,096 tokens (~270 MB of K/V),
    # where bytes and not launch latency set the time
    r = check_paged_attention(torch.bfloat16, timer, B=32, P=256)
    emit({"phase": "kernel", "name": "paged_attention", "dtype": "torch.bfloat16", **r})
    # mixed: q (the parameters' dtype) apart from the pools', at both shapes
    for q_dtype, dtype in MIXED_PAIRS:
        for B, P in ((8, 64), (32, 256)):
            r = check_paged_attention(dtype, timer, B=B, P=P, q_dtype=q_dtype)
            emit({"phase": "kernel", "name": "paged_attention", "step": "mixed",
                  "dtype": str(dtype), **r})
    torch.cuda.empty_cache()
    for dtype, S in [(torch.bfloat16, S) for S in FLASH_BUCKETS] + [(torch.float32, 1024)]:
        r = check_flash_attention(dtype, S, timer)
        emit({"phase": "kernel", "name": "flash_attention", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16 and S == max(FLASH_BUCKETS):
            main["flash_attention"] = r
    for dtype in (torch.bfloat16, torch.float32):
        r = check_flash_offset(dtype, timer)
        emit({"phase": "kernel", "name": "flash_attention", "dtype": str(dtype), **r})
    # a chunked prefill's last chunk of a 1,024-token prompt
    r = check_flash_offset(torch.bfloat16, timer, Sq=PREFILL_CHUNK)
    emit({"phase": "kernel", "name": "flash_attention", "dtype": "torch.bfloat16", **r})
    # the moe phase's heads (Qwen3-30B-A3B: 32 q over 4 kv heads): paged
    # attention at G 8 and flash at H 32 / Kh 4, each beside its plain
    # version and bound, flash also beside the library
    moe = get_config(MOE_ARCH)
    Kh, G = moe.n_kv_heads, moe.n_heads // moe.n_kv_heads
    r = check_paged_attention(torch.bfloat16, timer, Kh=Kh, G=G)
    emit({"phase": "kernel", "name": "paged_attention", "model": MOE_ARCH,
          "dtype": "torch.bfloat16", **r})
    main["paged_attention_moe"] = r
    r = check_flash_attention(torch.bfloat16, max(FLASH_BUCKETS), timer,
                              H=moe.n_heads, Kh=Kh)
    emit({"phase": "kernel", "name": "flash_attention", "model": MOE_ARCH,
          "dtype": "torch.bfloat16", **r})
    main["flash_attention_moe"] = r
    for dtype, E in ((torch.bfloat16, 16384), (torch.int32, 16383)):
        r = check_segment_compact(dtype, E, timer)
        emit({"phase": "kernel", "name": "segment_compact", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16:
            main["segment_compact"] = r
    torch.cuda.empty_cache()
    for overlap in (False, True):
        r = check_segment_move(overlap, timer)
        emit({"phase": "kernel", "name": "segment_move", "dtype": "torch.bfloat16", **r})
        if not overlap:  # the summary's time: one launch of the kernel
            main["segment_move"] = r
    del timer
    torch.cuda.empty_cache()
    return main


def check_victims(N: int, timer) -> dict:
    """The device route of victim selection over N segments of S = 512
    pages (bench_kernels.py's paper-scale row: live in [0, S), up2 ~ U(0,
    1e6), u_now = 2e6), k = 64 (the paper's clean batch)."""
    S, k, u_now = 512, 64, 2e6
    g = torch.Generator(device="cuda").manual_seed(SEED)
    live = torch.randint(0, S, (N,), generator=g, device="cuda").float()
    live[::1021] = S  # a few full segments, so all three key branches occur
    up2 = torch.rand(N, generator=g, device="cuda") * 1e6
    # victims among live in [1, S): no empty or full segment, a strict order
    live_v = torch.randint(1, S, (N,), generator=g, device="cuda").float()
    eligible = torch.ones(N, dtype=torch.bool, device="cuda")

    torch.cuda.synchronize()
    ops.reset_launches()
    ids, valid = ops.mdc_select_victims(live_v, up2, u_now, S=S, k=k)
    pkey = policies.torch_key_mdc(live_v, S, up2, u_now)
    pids, pvalid = policies.torch_select_victims(pkey, eligible, k,
                                                 live=live_v, S=S)
    torch.cuda.synchronize()
    launches = ops.launches["mdc_priority"]
    if launches == 0:
        raise AssertionError("the victim route never launched mdc_priority")

    got = ops.mdc_priority(live, up2, u_now, S=S)
    want = ref.mdc_priority_ref(live, up2, u_now, S)
    if not (torch.equal(got == -1, want == -1)
            and torch.equal(torch.isinf(got), torch.isinf(want))):
        raise AssertionError(f"mdc_priority N={N}: -1 / +inf pattern differs")
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)
    err = (got[fin] - want[fin]).abs()

    _, plain_ids = torch.topk(-ref.mdc_priority_ref(live_v, up2, u_now, S), k)
    want_set = set(plain_ids.tolist())
    if not (bool(valid.all()) and bool(pvalid.all())
            and set(ids.tolist()) == want_set == set(pids.tolist())):
        raise AssertionError(f"victims N={N}: kernel route != plain route")
    lv = live_v.cpu().numpy().astype(np.int64)
    u2 = up2.cpu().numpy().astype(np.float64)
    host = policies.select_victims("mdc", k, live=lv, S=S, up2=u2,
                                   seal_time=np.zeros(N), u_now=u_now,
                                   eligible=np.ones(N, bool))
    key64 = policies.key_mdc(live=lv, S=S, up2=u2, u_now=u_now)
    np.testing.assert_allclose(np.sort(key64[ids.cpu().numpy()]),
                               np.sort(key64[host]), rtol=1e-5)

    b_ms, b_by = bound(12 * N, 10.0 * N, torch.float32)
    return {"N": N, "S": S, "k": k, "launches": launches,
            "keys": {"empty": int((want == -1).sum()),
                     "full": int(torch.isinf(want).sum()),
                     "finite": int(fin.sum())},
            "same_pattern": True, "equal_victims": True,
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / want[fin].abs()).max()),
            "kernel_ms": timer(lambda: ops.mdc_priority(live, up2, u_now, S=S)),
            "plain_ms": timer(lambda: ref.mdc_priority_ref(live, up2, u_now, S)),
            "select_ms": timer(lambda: ops.mdc_select_victims(
                live, up2, u_now, S=S, k=k)),
            "plain_select_ms": timer(lambda: torch.topk(
                -ref.mdc_priority_ref(live, up2, u_now, S), k)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def phase_victims() -> tuple[dict, int]:
    """Both shapes; returns the paper-scale result (the kernels line's
    times) and the launches of the route summed over both."""
    timer = Timer()
    results = []
    for N in (51_200, 1 << 24):
        results.append(check_victims(N, timer))
        emit({"phase": "victims", **results[-1]})
    del timer
    torch.cuda.empty_cache()
    return results[0], sum(r["launches"] for r in results)


def long_requests(vocab: int, news=(16, 16, 16, 16)) -> list:
    """The f32 legs' 4 requests: prompts of 300-1,000 tokens (seed 2),
    ``news`` new tokens (16 each in the chunked phase)."""
    rng = np.random.default_rng(SEED + 2)
    return [(rng.integers(1, vocab, int(n)), int(m))
            for n, m in zip(rng.integers(300, 1001, 4), news)]


def engine_requests(vocab: int) -> tuple[list, np.ndarray]:
    """The engine phase's 32 requests: prompts of 256-1024 tokens, 32-128
    new tokens (seed 0)."""
    rng = np.random.default_rng(SEED)
    plens = rng.integers(256, 1025, 32)
    news = rng.integers(32, 129, 32)
    return [rng.integers(1, vocab, p) for p in plens], news


def prefix_requests(vocab: int, n: int = 16) -> list:
    """n requests sharing one PREFIX_LEN-token system prompt, each with its
    own tail of 64-256 tokens and 32-64 new tokens (seed 0)."""
    rng = np.random.default_rng(SEED)
    system = rng.integers(1, vocab, PREFIX_LEN)
    tails, news = rng.integers(64, 257, n), rng.integers(32, 65, n)
    return [(np.concatenate([system, rng.integers(1, vocab, t)]), int(m))
            for t, m in zip(tails, news)]


def phase_engine(cfg) -> dict:
    """32 requests (prompts 256-1024 tokens, 32-128 new tokens) through a
    pool of 30 slabs x 16 pages x 16 tokens: 8 slots of such requests hold
    up to ~9k tokens, so a 7,680-token pool with one open stream fills,
    checkerboards and compacts under pressure (no forced compaction).
    Returns the run (``serve``), for the chunked phase to compare with."""
    model = Model(cfg, device="cuda", seed=SEED)
    prompts, news = engine_requests(cfg.vocab_size)
    run = serve(model, [(p, int(n)) for p, n in zip(prompts, news)])
    del model
    m, launches = run["metrics"], run["launches"]
    if m["compactions"] < 1:
        raise AssertionError("the pool never compacted under pressure")
    missing = [k for k in ENGINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if run["flash_routes"]["wgmma"] == 0:
        raise AssertionError("the prefill's flash attention never took the "
                             "tensor-core route")
    emit({"phase": "engine", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(prompts), "prompt_tokens": int(sum(map(len, prompts))),
          **stream_summary(run), "compactions": m["compactions"],
          "blocks_written": m["blocks_written"],
          "blocks_moved": m["blocks_moved"], "wamp": m["wamp"],
          "flash_routes": run["flash_routes"],
          "staged_plans": run["move_plans"]["staged"],
          "direct_plans": run["move_plans"]["direct"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return run


def oracle_margins(params, prompt, cfg, n_new, cache_dtype=torch.float32,
                   tops=None):
    """The plain greedy decode again, recording each step's top-2 logit
    margin (how close the argmax was to a tie), and each step's top logit
    into ``tops`` where given."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    logits, cache = tfm.prefill(params, toks, cfg, len(prompt) + n_new + 1,
                                cache_dtype=cache_dtype, kernel=False)
    out, margins = [], []
    while True:
        top = torch.topk(logits[0].float(), 2).values
        margins.append(float(top[0] - top[1]))
        if tops is not None:
            tops.append(float(top[0]))
        out.append(int(torch.argmax(logits[0])))
        if len(out) == n_new:
            return out, margins
        logits, cache = tfm.decode_step(
            params, cache, torch.tensor([out[-1]], device=dev), cfg)


def phase_tokens(cfg) -> None:
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    rng = np.random.default_rng(SEED + 1)
    prompt, n_new = rng.integers(1, cfg.vocab_size, 128), 16
    eng = PagedServingEngine(model, n_slabs=4, blocks_per_slab=16, page_T=16,
                             max_batch=1, max_seq=256, pool_dtype=torch.float32,
                             device="cuda")
    rid = eng.submit(prompt, n_new)
    eng.run_to_completion()
    got = eng.finished[rid]
    want = tfm.greedy_decode(model.params, prompt, cfg, n_new,
                             cache_dtype=torch.float32)
    replay, margins = oracle_margins(model.params, prompt, cfg, n_new)
    if replay != want:
        raise AssertionError("the plain decode is not deterministic")
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    at = margins[first] if first is not None else None
    emit({"phase": "tokens", "dtype": "float32", "prompt_len": len(prompt),
          "new_tokens": n_new, "equal": got == want, "first_mismatch": first,
          "margin_at_mismatch": at, "min_margin": min(margins)})
    if first is not None and not at < 1e-3:
        raise AssertionError(f"engine tokens {got} != plain {want} at {first} "
                             f"(top-2 margin {at})")


def timed(fn, events: list):
    """``fn`` with each call bracketed by a pair of CUDA events, appended to
    ``events``."""
    def call(*args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = fn(*args, **kwargs)
        ev[1].record()
        events.append(ev)
        return out
    return call


def serve(model, requests, setup=None, **kw) -> dict:
    """One engine over ``requests`` on the card, launch counters zeroed just
    before and read just after.  Each admission's prefill and each
    ``step()`` that dispatched are bracketed by CUDA events: the stream's
    time from the first launch to the last, host gaps included (the eager
    engine is host-bound), so a dispatch's time is its wall and the largest
    is the longest any decoding slot waited for its next tokens.
    ``setup(engine)`` runs before the first submission."""
    eng = PagedServingEngine(model, **{**POOL, **kw}, device="cuda")
    # what this process holds on the card once the engine is built: its
    # weights and pools, and anything else still alive in it
    memory = {"memory_allocated": torch.cuda.memory_allocated(),
              "param_bytes": sum(t.numel() * t.element_size()
                                 for _, t in flatten(eng.params)),
              "pool_bytes": 2 * eng.k_pools.numel() * eng.k_pools.element_size()}
    if setup is not None:
        setup(eng)
    events, steps = [], []
    eng._start = timed(eng._start, events)
    step = timed(eng.step, steps)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n) for p, n in requests]
    dispatched = []
    for _ in range(100_000):
        before = eng.dispatches
        step()
        dispatched.append(eng.dispatches > before)
        if not eng.has_work():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"launches": dict(ops.launches), "flash_routes": dict(ops.flash_routes),
              "flash_offsets": dict(ops.flash_offsets),
              "move_plans": dict(ops.move_plans),
              "stream_launches": {k: dict(v) for k, v in ops.stream_launches.items()},
              "side_stream": eng._side.cuda_stream if eng._side is not None else None}
    eng.pool.check_invariants()
    if eng.prefix_cache is not None:
        eng.prefix_cache.check_invariants()
    tokens = [eng.finished[r] for r in rids]
    for t, (_, n) in zip(tokens, requests):
        if len(t) != n:
            raise AssertionError(f"a request emitted {len(t)} tokens, want {n}")
    return {"tokens": tokens, "metrics": eng.metrics(), "wall_s": wall,
            "memory": memory,
            "prefill_stream_ms": sum(a.elapsed_time(b) for a, b in events),
            "prefills": len(events),
            "dispatch_ms": [a.elapsed_time(b) for (a, b), d in zip(steps, dispatched)
                            if d], **counts}


def stream_summary(run) -> dict:
    """Throughput and per-dispatch wall of one ``serve`` run."""
    gen = sum(len(t) for t in run["tokens"])
    return {"generated_tokens": gen, "wall_s": run["wall_s"],
            "tokens_per_s": gen / run["wall_s"],
            "dispatches": run["metrics"]["dispatches"],
            "dispatch_ms_median": statistics.median(run["dispatch_ms"]),
            "dispatch_ms_max": max(run["dispatch_ms"]),
            "launches": run["launches"]}


def phase_prefix(cfg) -> dict:
    """bf16 at full width, cold then hit, on the engine phase's pool; then
    the f32 leg (4 requests, f32 weights and pool) whose tokens are held."""
    reqs = prefix_requests(cfg.vocab_size)
    model = Model(cfg, device="cuda", seed=SEED)
    # cold and hit in turns, twice, so that neither sits alone on the
    # first-run costs or on one stretch of the shared host's load
    runs = {"cold": [], "hit": []}
    for _ in range(2):
        for name, on in (("cold", False), ("hit", True)):
            runs[name].append(serve(model, reqs, prefix_cache=on))
    del model
    torch.cuda.empty_cache()
    cold, hit = runs["cold"][-1], runs["hit"][-1]
    m = hit["metrics"]
    if m["prefix_hit_rate"] < 15 / 16 or m["prefill_tokens_saved"] <= 0 \
            or m["frames_shared"] <= 0:
        raise AssertionError(f"prefix cache: hit rate {m['prefix_hit_rate']}, "
                             f"saved {m['prefill_tokens_saved']}, shared "
                             f"{m['frames_shared']}")
    if hit["flash_offsets"]["nonzero"] == 0:
        raise AssertionError("no flash_attention launch with a query offset")
    missing = [k for k in ("flash_attention", "paged_attention")
               if hit["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the prefix path never launched {missing}")
    same = sum(a == b for a, b in zip(hit["tokens"], cold["tokens"]))
    if any(r["tokens"] != hit["tokens"] for r in runs["hit"]) or any(
            r["tokens"] != cold["tokens"] for r in runs["cold"]):
        raise AssertionError("a repeated run gave other tokens")

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = reqs[:4]
    f32 = {name: serve(model, small, prefix_cache=on,
                       pool_dtype=torch.float32)
           for name, on in (("cold", False), ("hit", True))}
    mismatches = []
    for (prompt, n), a, b in zip(small, f32["hit"]["tokens"],
                                 f32["cold"]["tokens"]):
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if first is None:
            continue
        _, margins = oracle_margins(model.params, prompt, cfg, n)
        mismatches.append({"first_mismatch": first,
                           "margin_at_mismatch": margins[first]})
        if not margins[first] < 1e-3:
            raise AssertionError(f"f32 prefix hit: tokens differ from cold at "
                                 f"{first} (plain top-2 margin {margins[first]})")
    if f32["hit"]["metrics"]["prefill_tokens_saved"] <= 0:
        raise AssertionError("f32 leg: no prefix hit")
    del model
    torch.cuda.empty_cache()

    def summary(rs):
        mm, r = rs[-1]["metrics"], rs[-1]
        return {"wall_s": [x["wall_s"] for x in rs],
                "prefill_stream_ms": [x["prefill_stream_ms"] for x in rs],
                "prefills": r["prefills"],
                "prefill_tokens_computed": mm.get("prefill_tokens_computed",
                                                  sum(len(p) for p, _ in reqs)),
                "compactions": mm["compactions"], "launches": r["launches"],
                "flash_offsets": r["flash_offsets"]}

    out = {"phase": "prefix", "model": cfg.name, "dtype": "bfloat16",
           "requests": len(reqs), "shared_prompt_tokens": PREFIX_LEN,
           "prompt_tokens": sum(len(p) for p, _ in reqs),
           "prefix_hit_rate": m["prefix_hit_rate"],
           "prefill_tokens_saved": m["prefill_tokens_saved"],
           "frames_shared": m["frames_shared"],
           "tokens_equal_share": same / len(reqs),
           "cold": summary(runs["cold"]), "hit": summary(runs["hit"]),
           "f32": {"requests": len(small),
                   "equal": f32["hit"]["tokens"] == f32["cold"]["tokens"],
                   "mismatches": mismatches,
                   "prefill_tokens_saved":
                       f32["hit"]["metrics"]["prefill_tokens_saved"]}}
    emit(out)
    return hit["launches"]


def phase_preemption(cfg) -> dict:
    """The engine phase's first 16 requests with preemption on, through a
    pool that forces preemption and one with room to spare: the resumed
    sequences must re-derive their tokens exactly (the decode batch is
    always max_batch rows, and every kernel of it is batch-invariant)."""
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts[:16], news[:16])]
    model = Model(cfg, device="cuda", seed=SEED)
    small, big = (serve(model, reqs, n_slabs=n, preemption=True)
                  for n in PREEMPT_SLABS)
    del model
    torch.cuda.empty_cache()
    ms, mb = small["metrics"], big["metrics"]
    if ms["preemptions"] < 1 or ms["resumes"] != ms["preemptions"]:
        raise AssertionError(f"small pool: {ms['preemptions']} preemptions, "
                             f"{ms['resumes']} resumes")
    if mb["preemptions"] != 0:
        raise AssertionError(f"big pool preempted {mb['preemptions']} times")
    missing = [k for k in ("flash_attention", "paged_attention")
               if small["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the preemption path never launched {missing}")
    diff = [i for i, (a, b) in enumerate(zip(small["tokens"], big["tokens"]))
            if a != b]
    emit({"phase": "preemption", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "pools_slabs": list(PREEMPT_SLABS),
          "preemptions": ms["preemptions"], "resumes": ms["resumes"],
          "recomputed_tokens": ms["recomputed_tokens"],
          "compactions": ms["compactions"], "tokens_equal": not diff,
          "differing_requests": diff, "wall_s": small["wall_s"],
          "big_pool_wall_s": big["wall_s"], "launches": small["launches"]})
    if diff:
        raise AssertionError(f"requests {diff}: tokens differ from the big "
                             f"pool's after preemption")
    return small["launches"]


def near_tie_bar(dtype, top: float) -> float:
    """The top-2 logit margin below which (or, in bf16, at which) the plain
    decode's argmax is a near-tie, for logits of ``dtype``: 1e-3 in f32;
    one bf16 step at the top logit in bf16 (2**(e - 7) for |top| in
    [2**e, 2**(e+1))), the least margin two bf16 logits can have and not be
    equal."""
    if dtype == torch.float32:
        return 1e-3
    return 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0


def first_mismatches(model, cfg, requests, runs,
                     cache_dtype=torch.float32) -> list:
    """Each request whose tokens in ``runs`` part from the plain decode (its
    dense cache in ``cache_dtype``): where, the plain decode's top-2 margin
    there, and whether that margin is a near-tie (``near_tie_bar`` of the
    parameters' dtype, which the logits take)."""
    out = []
    dtype = model.params["embed"].dtype
    for (prompt, n), got in zip(requests, runs):
        want = tfm.greedy_decode(model.params, prompt, cfg, n,
                                 cache_dtype=cache_dtype)
        first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                     None)
        if first is not None:
            tops = []
            _, margins = oracle_margins(model.params, prompt, cfg, n,
                                        cache_dtype, tops)
            bar = near_tie_bar(dtype, tops[first])
            out.append({"first_mismatch": first,
                        "margin_at_mismatch": margins[first],
                        "near_tie_bar": bar,
                        "near_tie": (margins[first] < bar
                                     if dtype == torch.float32
                                     else margins[first] <= bar)})
    return out


def phase_chunked(cfg, mono) -> tuple[dict, dict]:
    """The engine phase's 32 requests with chunked prefill (PREFILL_CHUNK
    tokens per fused dispatch) through the same pool, beside the engine
    phase's monolithic run ``mono`` and a second monolithic run after it
    (``mono`` was the process's first engine run, so its first dispatch
    also pays the first calls of every GEMM shape); then the f32 leg: 4
    requests of 300 to 1,000 tokens (f32 weights and pool, TF32 off) whose
    chunked tokens must be the plain decode's, or part from it on a
    near-tie.  Returns the chunked run's launches and the second
    monolithic run."""
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    model = Model(cfg, device="cuda", seed=SEED)
    run = serve(model, reqs, prefill_chunk=PREFILL_CHUNK)
    again = serve(model, reqs)
    del model
    if again["tokens"] != mono["tokens"]:
        raise AssertionError("a repeated monolithic run gave other tokens")
    torch.cuda.empty_cache()
    m = run["metrics"]
    chunks = sum(-(-len(p) // PREFILL_CHUNK) for p, _ in reqs)
    if m["prefill_chunks_dispatched"] != chunks:
        raise AssertionError(f"{m['prefill_chunks_dispatched']} chunks "
                             f"dispatched, want {chunks}")
    if m["compactions"] < 1:
        raise AssertionError("the chunked run never compacted")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the chunked path never launched {missing}")
    if run["flash_offsets"]["nonzero"] == 0:
        raise AssertionError("no chunk ran flash_attention with a query offset")
    same = sum(a == b for a, b in zip(run["tokens"], mono["tokens"]))

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = long_requests(cfg.vocab_size)
    f32 = serve(model, small, prefill_chunk=PREFILL_CHUNK,
                pool_dtype=torch.float32)
    mismatches = first_mismatches(model, cfg, small, f32["tokens"])
    if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
        raise AssertionError(f"f32 chunked: tokens part from the plain decode "
                             f"off a near-tie: {mismatches}")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "chunked", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "prefill_chunk": PREFILL_CHUNK,
          "prefill_chunks_dispatched": m["prefill_chunks_dispatched"],
          "compactions": m["compactions"], "wamp": m["wamp"],
          "flash_offsets": run["flash_offsets"],
          "tokens_equal_share": same / len(reqs),
          "chunked": stream_summary(run),
          "monolithic": [stream_summary(r) for r in (mono, again)],
          "f32": {"requests": len(small),
                  "prompt_tokens": [len(p) for p, _ in small],
                  "chunks": f32["metrics"]["prefill_chunks_dispatched"],
                  "equal": not mismatches, "mismatches": mismatches}})
    return run["launches"], again


def phase_async(cfg, mono, warm) -> dict:
    """The engine phase's 32 requests and pool with async compaction at the
    default clean budget, ``audit()`` after every dispatch, beside the
    engine phase's synchronous run ``mono`` and the chunked phase's warm
    synchronous rerun ``warm``; then the f32 leg, async against sync and the
    plain decode.  Every check is made before any fails, and the phase's
    line names each failure."""
    t0 = time.perf_counter()
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    model = Model(cfg, device="cuda", seed=SEED)
    run = serve(model, reqs, async_compaction=True, audit_every=1)
    del model
    torch.cuda.empty_cache()
    m, sync_m = run["metrics"], mono["metrics"]
    failures = []
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], mono["tokens"]))
            if a != b]
    if diff:
        failures.append(f"bf16 tokens differ from the synchronous run's in "
                        f"requests {diff}, first request {diff[0]}")
    counters = {k: m[k] for k in ASYNC_REHEARSED}
    if counters != ASYNC_REHEARSED or run["move_plans"] != ASYNC_PLANS:
        failures.append(f"counters {counters} {run['move_plans']} are not the "
                        f"rehearsal's {ASYNC_REHEARSED} {ASYNC_PLANS}")
    if not m["gc_planned"] == m["gc_committed"] > 0:
        failures.append(f"planned {m['gc_planned']} != committed "
                        f"{m['gc_committed']}, or no move")
    if m["compaction_debt_moves"] or m["fenced_slabs"]:
        failures.append(f"left {m['compaction_debt_moves']} moves and "
                        f"{m['fenced_slabs']} fenced slabs")
    if m["inflight_boundaries"] < 1:
        failures.append("no step boundary crossed with a move in flight")
    side = run["stream_launches"]["segment_move"].get(run["side_stream"], 0)
    if side < 1:
        failures.append("segment_move never launched on the side stream")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        failures.append(f"the async path never launched {missing}")

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = long_requests(cfg.vocab_size, ASYNC_F32_NEW)
    kw = dict(n_slabs=ASYNC_F32_SLABS, pool_dtype=torch.float32)
    f32 = serve(model, small, async_compaction=True, audit_every=1, **kw)
    f32_sync = serve(model, small, **kw)
    if f32["tokens"] != f32_sync["tokens"]:
        failures.append("f32 async tokens differ from the sync run's")
    if f32["metrics"]["gc_planned"] == 0:
        failures.append("the f32 leg's pool never compacted")
    mismatches = first_mismatches(model, cfg, small, f32["tokens"])
    if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
        failures.append(f"f32 async tokens part from the plain decode off a "
                        f"near-tie: {mismatches}")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "async", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "clean_budget": DEFAULT_CLEAN_BUDGET,
          "tokens_equal": not diff, "differing_requests": diff,
          **{k: m[k] for k in ("compactions", "blocks_moved", "wamp",
                               "gc_planned", "gc_committed", "sub_plans",
                               "inflight_boundaries", "hazard_commits",
                               "drains", "dead_destination_waits",
                               "compaction_debt_moves", "fenced_slabs")},
          "direct_plans": run["move_plans"]["direct"],
          "staged_plans": run["move_plans"]["staged"],
          "move_launches": run["launches"]["segment_move"],
          "side_stream_move_launches": side,
          "sync_wamp": sync_m["wamp"], "sync_compactions": sync_m["compactions"],
          "wamp_equal": m["wamp"] == sync_m["wamp"],
          "wamp_within_half_percent":
              abs(m["wamp"] - sync_m["wamp"]) <= 0.005 * sync_m["wamp"],
          "async": stream_summary(run),
          "sync": [stream_summary(r) for r in (mono, warm)],
          "f32": {"requests": len(small), "n_slabs": ASYNC_F32_SLABS,
                  "new_tokens": list(ASYNC_F32_NEW),
                  "gc_planned": f32["metrics"]["gc_planned"],
                  "sub_plans": f32["metrics"]["sub_plans"],
                  "inflight_boundaries": f32["metrics"]["inflight_boundaries"],
                  "equal_to_sync": f32["tokens"] == f32_sync["tokens"],
                  "equal_to_plain": not mismatches, "mismatches": mismatches},
          "phase_seconds": time.perf_counter() - t0, "failures": failures})
    if failures:
        raise AssertionError(f"async phase: {failures}")
    return run["launches"]


def recovery_cuts(half: int):
    """The recovery phase's kill points, by rule, as ``pick(engine, seq,
    record)`` → the cut's name or None: right after the first ``mv``
    record, right after the first ``snap`` record, and the first ``emit``
    record at or after record ``half`` with every slot live."""
    seen = set()

    def pick(eng, seq, rec):
        t = rec["t"]
        if t == "mv" and "after_first_mv" not in seen:
            name = "after_first_mv"
        elif t == "snap" and "after_first_snap" not in seen:
            name = "after_first_snap"
        elif (t == "emit" and seq >= half and "mid_all_live" not in seen
              and bool((eng.rid >= 0).all())):
            name = "mid_all_live"
        else:
            return None
        seen.add(name)
        return name
    return pick


def capture(eng, root: Path, pick) -> dict:
    """Clone ``eng``'s journal directory into ``root / name`` the moment a
    record that ``pick`` names is appended: the disk state a kill at that
    record boundary leaves (the journal segments and the snapshot store as
    they were then).  Returns {name: (seq, submissions so far, directory)};
    its ``"kinds"`` entry counts the records of each type."""
    cuts, kinds = {}, {}
    cuts["kinds"] = kinds
    append = eng.journal.append

    def hooked(payload):
        seq = append(payload)
        rec = json.loads(payload)
        kinds[rec["t"]] = kinds.get(rec["t"], 0) + 1
        name = pick(eng, seq, rec)
        if name is not None:
            d = Path(root) / name
            shutil.copytree(eng.journal.root, d)
            cuts[name] = (seq, kinds.get("sub", 0), d)
        return seq

    eng.journal.append = hooked
    return cuts


def recover_drain(model, jdir, **kw) -> tuple[dict, dict]:
    """Recover a killed session from ``jdir`` and drain it.  Returns the
    finished tokens and a summary: the recovery report's counters, the
    ``load_session`` time, the time to recover (from ``recover_engine``
    until every resumed sequence has re-derived its journaled span), the
    drain's wall and the kernels' launches from ``recover_engine`` on."""
    sync = (torch.cuda.synchronize if torch.device(kw["device"]).type == "cuda"
            else (lambda: None))
    t = time.perf_counter()
    recovery.load_session(jdir, stop_token=kw.get("stop_token"))
    load_ms = (time.perf_counter() - t) * 1e3
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng, rep = recover_engine(model, jdir, **kw)
    spans = {r.rid: r.out_n for r in eng._resume}

    def caught_up():
        return all(rid in eng.finished or any(
            eng.rid[i] == rid and not eng._prefilling[i]
            and eng._out_n[i] >= span for i in range(eng.max_batch))
            for rid, span in spans.items())

    recovered_s = None
    for _ in range(100_000):
        if recovered_s is None and caught_up():
            sync()
            recovered_s = time.perf_counter() - t0
        if not eng.has_work():
            break
        eng.step()
    sync()
    wall = time.perf_counter() - t0
    eng.audit()
    finished = dict(eng.finished)
    summary = {k: rep[k] for k in ("snapshot_id", "records_replayed",
                                   "sequences_resumed", "requests_requeued",
                                   "tokens_replayed", "journal_torn_bytes")}
    summary.update(load_session_ms=load_ms, time_to_recover_s=recovered_s,
                   drain_s=wall, launches=dict(ops.launches),
                   journal_records_after=eng.metrics()["journal_records"])
    eng.journal.close()
    return finished, summary


# the counters a recovery's summary must share with the CPU rehearsal
RECOVERY_COUNTERS = ("snapshot_id", "records_replayed", "sequences_resumed",
                     "requests_requeued", "tokens_replayed")


def phase_recovery(cfg, mono) -> dict:
    """Crash safety on the card: the journaled run, three kills in it, a
    kill inside the async window, and the f32 leg (see the module's
    docstring).  Every check is made before any fails, and the phase's
    line names each failure."""
    t0 = time.perf_counter()
    reh = RECOVERY_REHEARSED
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_recovery_"))
    failures, launches = [], {k: 0 for k in KERNELS}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    try:
        model = Model(cfg, device="cuda", seed=SEED)
        held = {}

        def setup(eng):
            held["eng"] = eng
            held["cuts"] = capture(eng, root / "cuts",
                                   recovery_cuts(reh["records"] // 2))

        run = serve(model, reqs, setup=setup, journal_dir=root / "journal",
                    snapshot_every=RECOVERY_SNAPSHOT_EVERY)
        add(run["launches"])
        eng, cuts = held.pop("eng"), held.pop("cuts")
        kinds = cuts.pop("kinds")
        m = run["metrics"]
        gen = sum(len(t) for t in run["tokens"])
        snap_files = [p for p in (root / "journal" / "snap").rglob("*")
                      if p.is_file()]
        journal = {
            "records": m["journal_records"], "bytes": m["journal_bytes"],
            "bytes_per_generated_token": m["journal_bytes"] / gen,
            "journal_wamp": m["journal_wamp"], "snapshots": eng._snap_id,
            "snapshot_store_bytes": sum(p.stat().st_size for p in snap_files),
            "snapshot_store_bytes_written": eng._snap_store.stats.user_bytes,
            "snapshot_store_wamp": eng._snap_store.stats.wamp(),
            "record_kinds": kinds,
            "wall_s": run["wall_s"], "tokens_per_s": gen / run["wall_s"],
            "engine_phase_wall_s": mono["wall_s"],
            "engine_phase_tokens_per_s": gen / mono["wall_s"]}
        eng.journal.close()
        del eng, held
        gc.collect()
        torch.cuda.empty_cache()
        diff = [i for i, (a, b) in enumerate(zip(run["tokens"], mono["tokens"]))
                if a != b]
        if diff:
            failures.append(f"journaled run: tokens differ from the engine "
                            f"phase's in requests {diff}")
        if (m["compactions"] < 1 or run["launches"]["segment_move"] == 0
                or kinds.get("mv", 0) < 1):
            failures.append("the journaled run never moved a page")
        if m["journal_wamp"] != 0.0:
            failures.append(f"journal Wamp {m['journal_wamp']} != 0")
        host = {"records": m["journal_records"], "snapshots": journal["snapshots"],
                "cuts": {n: cuts[n][0] for n in sorted(cuts)}}
        if host != {k: reh[k] for k in host}:
            failures.append(f"journal {host} is not the rehearsal's")

        per_cut = {}
        want = run["tokens"]
        for name in sorted(cuts):
            seq, n_sub, d = cuts[name]
            got, summ = recover_drain(model, d, **POOL, device="cuda")
            add(summ["launches"])
            summ.update(seq=seq, submissions=n_sub)
            per_cut[name] = summ
            bad = [r for r in range(n_sub) if got.get(r) != want[r]]
            if bad:
                failures.append(f"cut {name}: tokens differ in requests {bad}")
            if {k: summ[k] for k in RECOVERY_COUNTERS} != reh["per_cut"][name]:
                failures.append(f"cut {name}: {summ} is not the rehearsal's "
                                f"{reh['per_cut'][name]}")
            if not (summ["launches"]["flash_attention"]
                    and summ["launches"]["paged_attention"]):
                failures.append(f"cut {name}: a recovery kernel never launched")
            gc.collect()
            torch.cuda.empty_cache()

        # a kill inside the async window, recovered in the same process
        akw = dict(POOL, async_compaction=True, audit_every=1, device="cuda")
        eng = PagedServingEngine(model, journal_dir=root / "async", **akw)
        eng.before_side_move = lambda: torch.cuda._sleep(100_000_000)
        for p, n in reqs:
            eng.submit(p, n)
        while eng.has_work() and not (eng.dispatches >= RECOVERY_ASYNC_FROM
                                      and eng._inflight_plans):
            eng.step()
        kill = {"dispatch": eng.dispatches,
                "inflight_plans": len(eng._inflight_plans),
                "inflight_moves": sum(len(p) for p in eng._inflight_plans)}
        if not kill["inflight_moves"]:
            failures.append("async kill: no move in flight")
        eng = None                  # the kill, with the move still running
        gc.collect()
        got, asum = recover_drain(model, root / "async", **akw)
        add(asum["launches"])
        bad = [r for r in range(len(reqs)) if got.get(r) != mono["tokens"][r]]
        if bad:
            failures.append(f"async kill: tokens differ in requests {bad}")
        if {"dispatch": kill["dispatch"],
                **{k: asum[k] for k in RECOVERY_COUNTERS}} != reh["async"]:
            failures.append(f"async kill: {kill} {asum} is not the "
                            f"rehearsal's {reh['async']}")
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
        bf = Model(cfg, device="cuda", seed=SEED).params
        model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
        del bf
        small = long_requests(cfg.vocab_size, ASYNC_F32_NEW)
        fkw = dict(n_slabs=ASYNC_F32_SLABS, pool_dtype=torch.float32)
        held = {}

        def setup32(eng):
            held["cuts"] = capture(
                eng, root / "f32cuts",
                lambda e, seq, rec: "middle" if seq == reh["f32_records"] // 2
                else None)

        run32 = serve(model, small, setup=setup32, journal_dir=root / "f32",
                      **fkw)
        add(run32["launches"])
        seq, n_sub, d = held["cuts"]["middle"]
        f32_records = run32["metrics"]["journal_records"]
        got, fsum = recover_drain(model, d, **{**POOL, **fkw}, device="cuda")
        add(fsum["launches"])
        fsum.update(seq=seq, submissions=n_sub)
        tokens32 = [got[r] for r in range(len(small))]
        if tokens32 != run32["tokens"]:
            failures.append("f32 leg: recovered tokens differ from the "
                            "unkilled run's")
        mismatches = first_mismatches(model, cfg, small, tokens32)
        if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
            failures.append(f"f32 leg: tokens part from the plain decode off "
                            f"a near-tie: {mismatches}")
        if ({"records": f32_records,
             **{k: fsum[k] for k in RECOVERY_COUNTERS}} != reh["f32"]):
            failures.append(f"f32 leg: {fsum} is not the rehearsal's "
                            f"{reh['f32']}")
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "recovery", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "snapshot_every": RECOVERY_SNAPSHOT_EVERY,
          "tokens_equal": not diff, "journal": journal,
          "cuts": per_cut, "estimate_time_to_recover_s": [6, 9],
          "async_kill": {**kill, **asum},
          "f32": {"requests": len(small), "records": f32_records, **fsum,
                  "equal_to_unkilled": tokens32 == run32["tokens"],
                  "equal_to_plain": not mismatches, "mismatches": mismatches},
          "launches": launches, "phase_seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        raise AssertionError(f"recovery phase: {failures}")
    return launches


def check_chrome_trace(doc: dict) -> None:
    """The schema check of ``tests/test_obs.py::_check_chrome_trace``: the
    invariants Perfetto and chrome://tracing rely on."""
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    stacks: dict[tuple, list] = {}
    for ev in doc["traceEvents"]:
        assert ev["ph"] in "BEiCbne", ev
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str) and ev["name"]
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] in "bne":   # async events need an id to form a track
            assert "id" in ev, ev
        lane = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(lane, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks.get(lane), f"E without open B on {lane}: {ev}"
            assert stacks[lane].pop() == ev["name"], \
                f"span close out of order on {lane}: {ev}"
    assert all(not s for s in stacks.values()), f"unclosed spans: {stacks}"
    json.dumps(doc)   # exported document must round-trip as plain JSON


def phase_split(report: dict) -> dict:
    """The dispatch wall's percentiles and per-phase means (ms) of a
    ``phase_report()``, and compaction's share of the p99 tail."""
    return {k: report[k] for k in ("dispatches", "p50_ms", "p99_ms",
                                   "phase_mean_ms", "compaction_share_p99",
                                   "compaction_share_total")}


def phase_serve(cfg, mono, smi) -> dict:
    """Observability and the serving CLI on the card: the instrumented
    closed loop, the open loop and the CLI (see the module's docstring).
    Every check is made before any fails, and the phase's line names each
    failure."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    failures, launches = [], {k: 0 for k in KERNELS}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    model = Model(cfg, device="cuda", seed=SEED)

    # a. the engine phase's run, instrumented
    tracer, held = Tracer(capacity=1 << 18), {}
    run = serve(model, reqs, setup=lambda eng: held.update(eng=eng),
                tracer=tracer, phase_log=True, calibration=True,
                metrics_every=SERVE_METRICS_EVERY,
                metrics_sink=out / "metrics.jsonl")
    add(run["launches"])
    eng = held.pop("eng")
    eng._metrics_logger.close()
    m, mm = run["metrics"], mono["metrics"]
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], mono["tokens"]))
            if a != b]
    if diff:
        failures.append(f"traced run: tokens differ from the engine phase's "
                        f"in requests {diff}")
    counters = ("compactions", "blocks_moved", "wamp")
    if {k: m[k] for k in counters} != {k: mm[k] for k in counters}:
        failures.append(f"traced run: {({k: m[k] for k in counters})} is not "
                        f"the engine phase's {({k: mm[k] for k in counters})}")
    doc = tracer.export(out / "trace.json")
    try:
        check_chrome_trace(doc)
    except AssertionError as e:
        failures.append(f"trace schema: {e}")
    names = {e["name"] for e in doc["traceEvents"]}
    if not SERVE_EVENTS <= names:
        failures.append(f"trace lacks {sorted(SERVE_EVENTS - names)}")
    pr = eng.phase_report()
    if pr["dispatches"] != m["dispatches"]:
        failures.append(f"phase_report counts {pr['dispatches']} dispatches, "
                        f"metrics() {m['dispatches']}")
    rows = (out / "metrics.jsonl").read_text().splitlines()
    if len(rows) < 2:
        failures.append(f"{len(rows)} metric rows")
    cal = eng.calibration.report()
    if cal["deaths"] <= 0:
        failures.append("no death calibrated")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        failures.append(f"traced run never launched {missing}")
    gen = sum(len(t) for t in run["tokens"])
    traced = {"tokens_equal": not diff, **{k: m[k] for k in counters},
              "wall_s": run["wall_s"], "tokens_per_s": gen / run["wall_s"],
              "engine_phase_wall_s": mono["wall_s"],
              "engine_phase_tokens_per_s": gen / mono["wall_s"],
              "wall_over_engine_phase": run["wall_s"] / mono["wall_s"],
              "events": len(tracer), "dropped_events": tracer.dropped,
              "event_counts": {n: sum(e["name"] == n for e in doc["traceEvents"])
                               for n in sorted(SERVE_EVENTS)},
              "phase_split": phase_split(pr),
              "misroute_rate": m["misroute_rate"],
              "calibrated_deaths": cal["deaths"], "unrouted": cal["unrouted"],
              "metric_rows": len(rows), "launches": run["launches"]}
    del eng, held
    gc.collect()
    torch.cuda.empty_cache()

    # b. the open loop at SERVE_ARRIVAL_RATE requests/s
    eng = PagedServingEngine(model, **POOL, phase_log=True, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t_ol = time.perf_counter()
    dispatches, lat = serve_cli._open_loop(eng, reqs, SERVE_ARRIVAL_RATE,
                                           np.random.default_rng(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_ol
    ol_launches = dict(ops.launches)
    add(ol_launches)
    eng.pool.check_invariants()
    got = [eng.finished.get(r, []) for r in range(len(reqs))]
    short = [r for r, (t, (_, n)) in enumerate(zip(got, reqs)) if len(t) != n]
    if short:
        failures.append(f"open loop: requests {short} did not finish with "
                        f"their token counts")
    if not (ol_launches["flash_attention"] and ol_launches["paged_attention"]):
        failures.append("open loop: an attention kernel never launched")
    om = eng.metrics()
    gen = sum(len(t) for t in got)
    open_loop = {**lat, "requests": len(reqs), "wall_s": wall,
                 "tokens_per_s": gen / wall, "driver_steps": dispatches,
                 "dispatches": om["dispatches"],
                 "compactions": om["compactions"], "wamp": om["wamp"],
                 "tokens_equal_share": sum(a == b for a, b in
                                           zip(got, mono["tokens"])) / len(reqs),
                 "phase_split": phase_split(eng.phase_report()),
                 "launches": ol_launches}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # c. the CLI at its default smoke width, in build/serve/ (its metrics
    # files land in the working directory)
    trace = out / "cli_trace.json"
    argv, cwd, text = sys.argv, os.getcwd(), io.StringIO()
    ops.reset_launches()
    sys.argv = ["repro_torch.launch.serve", *SERVE_CLI_ARGS, "--trace",
                str(trace)]
    os.chdir(out)
    try:
        with contextlib.redirect_stdout(text):
            cli_rows = serve_cli.main()
    finally:
        sys.argv = argv
        os.chdir(cwd)
    torch.cuda.synchronize()
    cli_launches = dict(ops.launches)
    add(cli_launches)
    (out / "cli.txt").write_text(text.getvalue())
    policies_ran = [r["policy"] for r in cli_rows]
    if policies_ran != ["mdc", "greedy"]:
        failures.append(f"CLI ran {policies_ran}")
    for r in cli_rows:
        if r["tokens"] <= 0:
            failures.append(f"CLI {r['policy']}: no tokens")
        if not (out / f"cli_trace.json.{r['policy']}").is_file():
            failures.append(f"CLI {r['policy']}: no trace file")
    cli = {r["policy"]: {k: r[k] for k in (
        "tokens", "tok_per_s", "dispatches", "wamp", "compactions",
        "ttft_p50_ms", "ttft_p99_ms", "queue_ms_p99", "tpot_p50_ms",
        "tpot_p99_ms")} for r in cli_rows}
    emit({"phase": "serve", "model": cfg.name, "dtype": "bfloat16",
          "card": smi, "traced": traced, "open_loop": open_loop,
          "cli": {"args": SERVE_CLI_ARGS, "rows": cli,
                  "launches": cli_launches},
          "launches": launches, "phase_seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        raise AssertionError(f"serve phase: {failures}")
    return launches


def smoke_requests(vocab: int, n: int = 12) -> list:
    """The mixed phase's requests: prompts of 4-36 tokens, 4-20 new tokens
    (seed 3), through serve_run's pool of 9 slabs of 4 pages of 8."""
    rng = np.random.default_rng(SEED + 3)
    return [(rng.integers(1, vocab, int(rng.integers(4, 37))),
             int(rng.integers(4, 21))) for _ in range(n)]


def run_engine(model, requests, device, **kw) -> dict:
    """One smoke-width engine over ``requests`` on ``device``: its tokens,
    counters and (on the card) the launches between its first submission
    and its drain."""
    eng = PagedServingEngine(model, n_slabs=9, blocks_per_slab=4, page_T=8,
                             max_batch=4, max_seq=128, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
        ops.reset_launches()
    rids = [eng.submit(p, n) for p, n in requests]
    eng.run_to_completion()
    if device == "cuda":
        torch.cuda.synchronize()
    eng.pool.check_invariants()
    m = eng.metrics()
    return {"tokens": [eng.finished[r] for r in rids],
            "counters": {k: m[k] for k in ("dispatches", "blocks_written",
                                           "blocks_moved", "compactions",
                                           "wamp")},
            "launches": dict(ops.launches) if device == "cuda" else None}


def phase_mixed(cfg, smi) -> dict:
    """The engine with the parameters' dtype apart from the pool's.

    (a) Full width: qwen3-1.7b's seeded weights at f32 over a bf16 pool
    and at bf16 over an f32 pool (the JAX ``examples/serve_paged.py``
    mix), the f32 legs' 4 long requests through the engine phase's pool,
    so the decode runs paged attention's mixed instances at G 2, D 128.
    Each leg is held against the plain greedy decode on the card
    (``kernel=False``, its dense cache in the pool's dtype): a request's
    tokens equal it, or part from it on a near-tie (``near_tie_bar``).
    (b) Smoke width, card against the CPU engine (one weight draw, made on
    the CPU and copied): f32 parameters over the default bf16 pool through
    ``launch.serve.serve_run`` (the mix ``tests/test_torch_serve.py`` holds
    against the JAX package), whose rows must be equal (tokens digest,
    counters); bf16 parameters over an f32 pool on 12 smoke requests,
    with the CPU's counters (host-determined: no stop token) and its
    tokens' share reported, and the card's tokens held against the plain
    decode on the card as in (a).
    Returns the launches of the card's runs."""
    out, launches, failures = {"card": smi}, {k: 0 for k in KERNELS}, []

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    bf = Model(cfg, device="cuda", seed=SEED).params
    small = long_requests(cfg.vocab_size)
    for leg, p_dtype, pool_dtype in MIXED_LEGS:
        model = Model(cfg, unflatten((p, t.to(p_dtype)) for p, t in flatten(bf)))
        run = serve(model, small, pool_dtype=pool_dtype)
        add(run["launches"])
        mism = first_mismatches(model, cfg, small, run["tokens"], pool_dtype)
        out[leg] = {"requests": len(small),
                    "prompt_tokens": [len(p) for p, _ in small],
                    "equal_to_plain": not mism, "mismatches": mism,
                    "paged_attention_launches": run["launches"]["paged_attention"],
                    "compactions": run["metrics"]["compactions"],
                    "stream": stream_summary(run)}
        if not all(x["near_tie"] for x in mism):
            failures.append(f"{leg} at full width: tokens part from the "
                            f"plain decode off a near-tie: {mism}")
        if run["launches"]["paged_attention"] == 0:
            failures.append(f"{leg} at full width: paged attention never "
                            f"launched")
        del model
        torch.cuda.empty_cache()
    del bf

    smoke = cfg.smoke()
    bf = Model(smoke, device="cpu", seed=SEED).params

    def on(device, dtype):
        return Model(smoke, unflatten((p, t.to(device, dtype))
                                      for p, t in flatten(bf)))

    def f32_row(device):
        return serve_cli.serve_run(requests=10, policy="mdc",
                                   model=on(device, torch.float32),
                                   device=device, verbose=False)

    torch.cuda.synchronize()
    ops.reset_launches()
    rows = {"cuda": f32_row("cuda")}
    torch.cuda.synchronize()
    f32_launches = dict(ops.launches)
    add(f32_launches)
    rows["cpu"] = f32_row("cpu")
    keys = ("tokens", "finished_digest", "wamp", "compactions", "dispatches",
            "blocks_moved", "blocks_written")
    equal = all(rows["cuda"][k] == rows["cpu"][k] for k in keys)
    out["smoke_f32_params_bf16_pool"] = {
        "row": {k: rows["cuda"][k] for k in keys}, "equal_to_cpu": equal,
        "paged_attention_launches": f32_launches["paged_attention"]}
    if not equal:
        failures.append(f"f32 parameters over a bf16 pool at smoke width: the "
                        f"card's row {out['smoke_f32_params_bf16_pool']['row']}"
                        f" != the CPU's {({k: rows['cpu'][k] for k in keys})}")
    if f32_launches["paged_attention"] == 0:
        failures.append("f32 over bf16 at smoke width: paged attention never "
                        "launched")

    reqs = smoke_requests(smoke.vocab_size)
    card_model = on("cuda", torch.bfloat16)
    card, cpu = (run_engine(m, reqs, d, pool_dtype=torch.float32)
                 for m, d in ((card_model, "cuda"),
                              (on("cpu", torch.bfloat16), "cpu")))
    add(card["launches"])
    short = [i for i, (t, (_, n)) in enumerate(zip(card["tokens"], reqs))
             if len(t) != n]
    mism = first_mismatches(card_model, smoke, reqs, card["tokens"],
                            torch.float32)
    out["smoke_bf16_params_f32_pool"] = {
        "counters": card["counters"], "cpu_counters": cpu["counters"],
        "tokens_equal_share": sum(a == b for a, b in zip(
            card["tokens"], cpu["tokens"])) / len(reqs),
        "equal_to_plain": not mism, "mismatches": mism,
        "paged_attention_launches": card["launches"]["paged_attention"]}
    if short or card["counters"] != cpu["counters"]:
        failures.append(f"bf16 over f32 at smoke width: requests {short} "
                        f"short, or counters {card['counters']} against the "
                        f"CPU's {cpu['counters']}")
    if not all(x["near_tie"] for x in mism):
        failures.append(f"bf16 over f32 at smoke width: tokens part from the "
                        f"plain decode off a near-tie: {mism}")
    if card["launches"]["paged_attention"] == 0:
        failures.append("bf16 over f32 at smoke width: paged attention never "
                        "launched")
    emit({"phase": "mixed", "model": cfg.name, **out, "launches": launches,
          "failures": failures})
    if failures:
        raise AssertionError(f"mixed phase: {failures}")
    return launches


def phase_sim(smi) -> dict:
    """The port's cleaning simulator at the paper's store (``PAPER``: 51,200
    segments of 512 pages, F 0.8, trigger 32, batch 64, sort buffer 16)
    under 80:20 hot/cold updates and the MDC policy, with every cleaning
    cycle's victim state through ``mdc_priority`` on the card
    (``DeviceVictimCheck``: the host's f64 pick decides; the device's f32
    pick may differ from it only among near-ties).  Launch counters zeroed
    just before ``run_measured`` and read just after; the store's
    invariants checked at the end.  Reports Wamp and mean E at clean over
    the measured window beside the analytic minimum of hot/cold separation
    (``analysis.min_wamp_hotcold``)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(PAPER, seed=SEED)
    sim = Simulator(cfg, workload_name="hot_cold", **SIM_WORKLOAD)
    setup_s = time.perf_counter() - t0
    check = DeviceVictimCheck("cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.perf_counter()
    with check.installed():
        window = sim.run_measured(SIM_UPDATES, warmup_frac=SIM_WARMUP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = dict(ops.launches)
    t2 = time.perf_counter()
    sim.store.check_invariants()
    check_s = time.perf_counter() - t2
    st = sim.store.stats
    bound = analysis.min_wamp_hotcold(cfg.fill_factor, SIM_WORKLOAD["update_frac"],
                                      SIM_WORKLOAD["data_frac"])
    emit({"phase": "sim", "card": smi, "config": dataclasses.asdict(cfg),
          "workload": {"name": "hot_cold", **SIM_WORKLOAD},
          "pages": cfg.nseg * cfg.pages_per_seg, "updates": SIM_UPDATES,
          "warmup_frac": SIM_WARMUP, "clean_trigger": sim.clean_trigger,
          "clean_batch": sim.clean_batch, "cycles": st.cleanings,
          "window_cycles": window.cleanings,
          "mdc_priority_launches": launches["mdc_priority"],
          **check.report(), "wamp": window.wamp(), "mean_E": window.mean_E(),
          "min_wamp_hotcold": bound, "wamp_over_min": window.wamp() / bound,
          "fill_factor": sim.store.fill_factor(), "setup_s": setup_s,
          "host_s": run_s, "updates_per_s": SIM_UPDATES / run_s,
          "invariants_s": check_s, "invariants": "ok"})
    if not check.cycles or check.cycles != st.cleanings:
        raise AssertionError(f"sim: {check.cycles} checked cycles of "
                             f"{st.cleanings}")
    if launches["mdc_priority"] < check.cycles:
        raise AssertionError(f"sim: mdc_priority launched "
                             f"{launches['mdc_priority']} times in "
                             f"{check.cycles} cycles")
    return launches


def tp_paged(rank, mesh) -> tuple:
    """(a) ``paged_attention_sharded`` on this rank's kv heads at the
    kernels phase's shape (B 8, P 64, Kh 8, G 2, D 128, 16-token pages,
    bf16): bit for bit the unsharded kernel's slice of the same heads, its
    gather the whole unsharded output, within ``paged_bar`` of the plain
    version on the local heads.  Returns (result, kernel, plain, library)."""
    n = mesh.size()
    Kh, G, D, T, B, P = 8, 2, 128, 16, 8, 64
    q, k_pool, v_pool, bt, lens = paged_case(torch.bfloat16, torch.bfloat16,
                                             B, P, Kh, G, D, T, seed=SEED)
    ql = local_heads(q, 1, rank, n)
    kl, vl = (local_heads(t, 2, rank, n) for t in (k_pool, v_pool))
    n0 = ops.launches["paged_attention_sharded"]
    got = ops.paged_attention_sharded(ql, kl, vl, bt, lens, mesh=mesh)
    per_call = ops.launches["paged_attention_sharded"] - n0
    whole = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    bitwise = torch.equal(got, local_heads(whole, 1, rank, n))
    gathered = torch.equal(ops.gather_heads(got, mesh), whole)
    if per_call != 1 or not (bitwise and gathered):
        raise AssertionError(f"paged_attention_sharded rank {rank}: "
                             f"{per_call} launches, bitwise {bitwise}, "
                             f"gathered {gathered}")
    want = ref.paged_attention_ref(ql, kl, vl, bt, lens)
    share = check_paged_close(got, want, paged_bar(ql, kl, vl, bt, lens, want))
    n_tok, Hl, Khl = int(lens.sum()), Kh * G // n, Kh // n
    n_bytes = (2 * n_tok * Khl * D * 2 + 2 * B * Hl * D * 2
               + 4 * int(((lens + T - 1) // T).sum()) + 4 * B)
    b_ms, b_by = bound(n_bytes, 4.0 * n_tok * Hl * D, torch.bfloat16)
    result = {"rank": rank, "max_abs_err": max_err(got, want),
              "bar_share": share, "bitwise_unsharded_slice": bitwise,
              "gathered_equal_unsharded": gathered,
              "launches_per_call": per_call, "bound_ms": b_ms,
              "bound_by": b_by,
              "shape": {"B": B, "Kh_local": Khl, "G": G, "D": D,
                        "page_T": T, "P": P, "tokens": n_tok}}
    return (result,
            lambda: ops.paged_attention_sharded(ql, kl, vl, bt, lens,
                                                mesh=mesh),
            lambda: ref.paged_attention_ref(ql, kl, vl, bt, lens), None)


def tp_flash(rank, mesh, Sq: int, Skv: int = 1024) -> tuple:
    """(a) ``flash_attention_sharded`` on this rank's heads (H 16 / Kh 8
    whole, D 128, bf16, the tensor-core route): ``Sq`` query rows at offset
    ``Skv - Sq`` over ``Skv`` keys, causal.  Bit for bit the unsharded
    kernel's slice of the same heads, its gather the whole unsharded
    output, within 2e-2 of the plain version.  Returns (result, kernel,
    plain, library): the library is ``scaled_dot_product_attention`` on the
    local heads (kv heads expanded, lower-right causal mask)."""
    from torch.nn.attention.bias import causal_lower_right
    n = mesh.size()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Kh, D, off = 1, 16, 8, 128, Skv - Sq
    q_all = torch.randn(B, Skv, H, D, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(torch.bfloat16)
    q = q_all[:, off:]
    ql, kl, vl = (local_heads(t, 2, rank, n) for t in (q, k, v))
    r0 = ops.flash_routes["wgmma"]
    got = ops.flash_attention_sharded(ql, kl, vl, mesh=mesh, causal=True,
                                      q_offset=off)
    whole = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    bitwise = torch.equal(got, local_heads(whole, 2, rank, n))
    gathered = torch.equal(ops.gather_heads(got, mesh), whole)
    if ops.flash_routes["wgmma"] != r0 + 2 or not (bitwise and gathered):
        raise AssertionError(f"flash_attention_sharded rank {rank} Sq {Sq}: "
                             f"bitwise {bitwise}, gathered {gathered}, or "
                             f"not on the tensor-core route")
    want = ref.flash_attention_ref(ql, kl, vl, causal=True, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    Hl, Khl = H // n, Kh // n
    qh = ql.transpose(1, 2).contiguous()
    k_h, v_h = (t.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
                for t in (kl, vl))
    mask = causal_lower_right(Sq, Skv)
    n_bytes = (2 * B * Hl * Sq * D + 2 * B * Khl * Skv * D) * 2
    flops = 4.0 * B * Hl * D * (Sq * off + Sq * (Sq + 1) / 2)
    b_ms, b_by = bound(n_bytes, flops, torch.bfloat16)
    result = {"rank": rank, "max_abs_err": max_err(got, want),
              "bitwise_unsharded_slice": bitwise,
              "gathered_equal_unsharded": gathered, "flash_route": "wgmma",
              "q_offset": off, "bound_ms": b_ms, "bound_by": b_by,
              "shape": {"B": B, "H_local": Hl, "Kh_local": Khl, "Sq": Sq,
                        "Skv": Skv, "D": D, "causal": True}}
    return (result,
            lambda: ops.flash_attention_sharded(ql, kl, vl, mesh=mesh,
                                                causal=True, q_offset=off),
            lambda: ref.flash_attention_ref(ql, kl, vl, causal=True,
                                            q_offset=off),
            lambda: F.scaled_dot_product_attention(qh, k_h, v_h,
                                                   attn_mask=mask))


def tp_rank(rank, device, cfg, requests) -> dict:
    """One rank of the tp phase (spawned: ``spawn_ranks`` imports it from
    this module by name).  (a) the wrappers' checks on this rank's heads,
    timed on rank 0 alone while the other rank waits at a barrier; (b)
    the sharded engine over ``requests`` at full width, bf16, launch
    counters zeroed just before it and read just after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(TP_RANKS)
    checks = {"paged": tp_paged(rank, mesh),
              "flash": tp_flash(rank, mesh, 1024),
              "flash_hit": tp_flash(rank, mesh, 512)}
    torch.cuda.synchronize()
    torch.distributed.barrier()
    if rank == 0:
        timer = Timer()
        for result, kernel, plain, library in checks.values():
            if library is None:
                result["kernel_ms"], result["library_ms"] = timer(kernel), None
            else:
                result["kernel_ms"], result["library_ms"] = timer(kernel,
                                                                  library)
            result["plain_ms"] = timer(plain)
        del timer
    torch.distributed.barrier()
    kernels = {k: c[0] for k, c in checks.items()}
    del checks
    torch.cuda.empty_cache()
    # the rank's model holds only its heads of wq / wk / wv
    model = shard_model(Model(cfg, device=device, seed=SEED), mesh)
    held = []
    run = serve(model, requests, setup=held.append, mesh=mesh,
                n_slabs=TP_SLABS, audit_every=TP_AUDIT_EVERY)
    eng = held.pop()
    held_summary = {"pool_sharded": eng._pool_sharded,
                    "pool_shape": list(eng.k_pools.shape), **run["memory"]}
    del eng, model
    return {"kernels": kernels,
            "engine": {"tokens": run["tokens"], "metrics": run["metrics"],
                       "launches": run["launches"],
                       "flash_routes": run["flash_routes"],
                       "stream": stream_summary(run), **held_summary}}


def tp_nccl_one(model, requests) -> dict:
    """(c) The engine over a one-rank ``nccl`` mesh in this process."""
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    store = torch.distributed.FileStore(os.path.join(root, "store"), 1)
    torch.distributed.init_process_group("nccl", store=store, rank=0,
                                         world_size=1)
    try:
        mesh = make_serving_mesh(1)
        return serve(model, requests, mesh=mesh, n_slabs=TP_SLABS,
                     audit_every=TP_AUDIT_EVERY)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def phase_tp(cfg, smi) -> tuple[dict, dict]:
    """Tensor-parallel serving (docstring, phase 15): the unsharded engine
    and the one-rank ``nccl`` engine in this process, then two ``gloo``
    ranks on the card (this process's weights freed first).  Returns the
    rank-0 launches of the sharded run and the wrappers' kernel lines."""
    prompts, news = engine_requests(cfg.vocab_size)
    requests = [(p, int(n)) for p, n in zip(prompts[:TP_REQUESTS],
                                             news[:TP_REQUESTS])]
    model = Model(cfg, device="cuda", seed=SEED)
    base = serve(model, requests, n_slabs=TP_SLABS,
                 audit_every=TP_AUDIT_EVERY)
    nccl = tp_nccl_one(model, requests)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    failures = []
    counters = {k: base["metrics"][k] for k in COUNTERS}
    if base["metrics"]["compactions"] < 1:
        failures.append("the unsharded run never compacted")
    nccl_counters = {k: nccl["metrics"][k] for k in COUNTERS}
    nccl_equal = nccl["tokens"] == base["tokens"] and nccl_counters == counters
    if not nccl_equal:
        failures.append(f"nccl world size 1: tokens or counters "
                        f"{nccl_counters} differ from the unsharded "
                        f"{counters}")
    if min(nccl["launches"][k] for k in TP_KERNELS) == 0:
        failures.append(f"nccl world size 1 never launched a sharded "
                        f"wrapper: {nccl['launches']}")
    t0 = time.perf_counter()
    ranks = spawn_ranks(importlib.import_module("chip_smoke").tp_rank,
                        TP_RANKS, cfg, requests, backend="gloo",
                        device="cuda", timeout_s=TP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    engines = [r["engine"] for r in ranks]
    tokens = engines[0]["tokens"]
    if any(e["tokens"] != tokens for e in engines[1:]):
        failures.append("the ranks' tokens differ")
    for rank, e in enumerate(engines):
        got = {k: e["metrics"][k] for k in COUNTERS}
        if got != counters:
            failures.append(f"rank {rank}: counters {got} != unsharded "
                            f"{counters}")
        if not e["pool_sharded"] or e["pool_shape"][3] != cfg.n_kv_heads // TP_RANKS:
            failures.append(f"rank {rank}: pools {e['pool_shape']} not "
                            f"sharded to {cfg.n_kv_heads // TP_RANKS} kv heads")
        if min(e["launches"][k] for k in TP_KERNELS) == 0:
            failures.append(f"rank {rank} never launched a sharded wrapper: "
                            f"{e['launches']}")
    differ = [i for i, (a, b) in enumerate(zip(tokens, base["tokens"]))
              if a != b]
    mism = []
    if differ:
        model = Model(cfg, device="cuda", seed=SEED)
        mism = first_mismatches(model, cfg, [requests[i] for i in differ],
                                [tokens[i] for i in differ], torch.bfloat16)
        del model
        torch.cuda.empty_cache()
        if not all(x["near_tie"] for x in mism):
            failures.append(f"sharded tokens part from the plain decode off "
                            f"a near-tie: {mism}")
    out = {"phase": "tp", "card": smi, "model": cfg.name, "dtype": "bfloat16",
           "ranks": TP_RANKS, "backend": "gloo", "requests": len(requests),
           "n_slabs": TP_SLABS, "kernels": [r["kernels"] for r in ranks],
           "unsharded": {"counters": counters, **stream_summary(base),
                         "memory": base["memory"]},
           "sharded": {
               "tokens_equal_unsharded": not differ,
               "requests_differing": differ, "mismatches": mism,
               "counters": {k: engines[0]["metrics"][k] for k in COUNTERS},
               "pool_shape": engines[0]["pool_shape"],
               "memory_per_rank": [
                   {k: e[k] for k in ("memory_allocated", "param_bytes",
                                      "pool_bytes")} for e in engines],
               "wrapper_launches_per_rank": [
                   {k: e["launches"][k] for k in TP_KERNELS}
                   for e in engines],
               "streams": [e["stream"] for e in engines],
               "spawn_s": spawn_s},
           "nccl_world_1": {"bitwise_equal": nccl_equal,
                            "counters": nccl_counters,
                            "wrapper_launches": {k: nccl["launches"][k]
                                                 for k in TP_KERNELS},
                            **stream_summary(nccl)},
           "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"tp phase: {failures}")
    lead = ranks[0]["kernels"]
    return engines[0]["launches"], {
        "paged_attention_sharded": lead["paged"],
        "flash_attention_sharded": lead["flash"]}


# ------------------------------------------------------------ moe phase

def moe_plain(params, cfg, prompt, n_new, expect, bucket) -> dict:
    """The plain path on the card for one request: ``tfm.prefill`` of the
    prompt right-padded to ``bucket``, the engine's (``kernel=False``:
    chunked attention; a dense bf16 cache), so its MoE groups its tokens as
    the engine does, then ``tfm.decode_step`` one token at a time, up to the
    first token that differs from ``expect`` (the engine's).  Per emitted
    token: the top-2 logit margin and the top logit."""
    dev = params["embed"].device
    plen = len(prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt, device=dev)
    out, margins, tops = [], [], []
    logits, cache = tfm.prefill(params, toks, cfg,
                                max(bucket, plen + n_new + 1),
                                cache_dtype=torch.bfloat16, true_len=plen,
                                kernel=False)
    while True:
        a, b = torch.topk(logits[0].float(), 2).values.tolist()
        margins.append(a - b)
        tops.append(a)
        out.append(int(torch.argmax(logits[0])))
        if len(out) == n_new or out[-1] != expect[len(out) - 1]:
            break
        logits, cache = tfm.decode_step(
            params, cache, torch.tensor([out[-1]], device=dev), cfg)
    return {"tokens": out, "margins": margins, "tops": tops}


def moe_layer0(model, prompt, bucket) -> dict:
    """Layer 0 of one prompt right-padded to ``bucket`` (the engine's)
    through the port's moe functions: the capacity-dropped picks, and
    ``moe_ffn`` called twice at the prefill shape and at the decode shape
    (8 tokens), bitwise."""
    cfg, params = model.cfg, model.params
    dev = params["embed"].device
    plen = len(prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt, device=dev)
    lp = tfm.layer(params["blocks"], 0)
    x = tfm._embed(params, toks)
    a, _ = att.gqa_prefill(rmsnorm(x, lp["ln1"]), lp["attn"], cfg)
    h = rmsnorm(x + a, lp["ln2"])
    xg, top_p, top_e, cap = moe._route(h, lp["mlp"]["router"], cfg,
                                       cfg.capacity_factor, cfg.moe_groups)
    st_tok, _, _, keep = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts,
                                             cfg.top_k, cap)[1]
    G, Tg = xg.shape[:2]
    real = (torch.arange(G, device=dev)[:, None] * Tg + st_tok) < plen
    repeat = {}
    for name, xs in (("prefill", h), ("decode", h[0, :8, None])):
        y1 = moe.moe_ffn(xs, lp["mlp"], cfg, cfg.capacity_factor,
                         cfg.moe_groups)
        y2 = moe.moe_ffn(xs, lp["mlp"], cfg, cfg.capacity_factor,
                         cfg.moe_groups)
        repeat[name] = bool(torch.equal(y1, y2)
                            and torch.isfinite(y1).all())
    return {"prompt_len": plen, "bucket": bucket, "groups": G,
            "tokens_per_group": Tg, "capacity": cap,
            "picks": int(keep.numel()),
            "dropped_picks": int((~keep).sum()),
            "dropped_real_picks": int((~keep & real).sum()),
            "moe_ffn_bitwise_repeat": repeat}


def moe_rank(rank, device) -> dict:
    """The moe phase's process (spawned by ``phase_moe``): Qwen3-30B-A3B at
    full width, its weights drawn on the card from the seed, through the
    engine on the tp phase's stream and pool, beside the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    prompts, news = engine_requests(cfg.vocab_size)
    requests = [(p, int(n)) for p, n in zip(prompts[:TP_REQUESTS],
                                             news[:TP_REQUESTS])]
    specs = dict(flatten(tfm.model_specs(cfg)))
    weight_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                       for s in specs.values())
    pages = TP_SLABS * POOL["blocks_per_slab"] + 1
    pool_bytes = (2 * cfg.n_layers * pages * POOL["page_T"] * cfg.n_kv_heads
                  * cfg.hd * 2)
    free, total = torch.cuda.mem_get_info()
    if free < weight_bytes + pool_bytes + MOE_HEADROOM:
        raise MemoryError(f"moe: {free / 1e9:.2f} GB free of {total / 1e9:.2f}"
                          f", the weights need {weight_bytes / 1e9:.2f} GB, "
                          f"the pool {pool_bytes / 1e9:.3f} GB, headroom "
                          f"{MOE_HEADROOM / 1e9:.0f} GB")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    out = {"free_gb_before_draw": free / 1e9, "weight_gb": weight_bytes / 1e9,
           "pool_gb": pool_bytes / 1e9, "draw_s": draw_s,
           "n_params": model.n_params(),
           "n_active_params": model.n_active_params(),
           "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9}
    # each prompt's bucket, by the engine's own rule
    buckets = {}
    run = serve(model, requests, n_slabs=TP_SLABS, setup=lambda eng: (
        buckets.update({len(p): eng._prefill_bucket(len(p), 0)[0]
                        for p, _ in requests})))
    out["engine"] = {"tokens": run["tokens"],
                     "counters": {k: run["metrics"][k] for k in COUNTERS},
                     "launches": run["launches"],
                     "flash_routes": run["flash_routes"],
                     "move_plans": run["move_plans"],
                     "stream": stream_summary(run), "memory": run["memory"]}
    long = next(p for p, _ in requests if len(p) > 512)
    out["layer0"] = moe_layer0(model, long, buckets[len(long)])
    t1 = time.perf_counter()
    out["plain"] = [moe_plain(model.params, cfg, p, n, want, buckets[len(p)])
                    for (p, n), want in zip(requests, run["tokens"])]
    out["plain_s"] = time.perf_counter() - t1
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_moe(smi) -> dict:
    """The MoE family at full width (docstring, phase 16), in a process of
    its own.  Returns the launches of its engine run."""
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    r, = spawn_ranks(importlib.import_module("chip_smoke").moe_rank, 1,
                     backend="gloo", device="cuda", timeout_s=MOE_TIMEOUT_S)
    failures = []
    eng, plain = r["engine"], r["plain"]
    if eng["counters"] != MOE_REHEARSED:
        failures.append(f"counters {eng['counters']} != the rehearsal's "
                        f"{MOE_REHEARSED}")
    for k in ENGINE_KERNELS:
        if eng["launches"][k] == 0:
            failures.append(f"the engine never launched {k}")
    if eng["flash_routes"]["wgmma"] == 0:
        failures.append("the prefill's flash never took the wgmma route")
    if not all(r["layer0"]["moe_ffn_bitwise_repeat"].values()):
        failures.append(f"moe_ffn does not repeat bitwise: "
                        f"{r['layer0']['moe_ffn_bitwise_repeat']}")
    parts = []
    for i, (got, want) in enumerate(zip(eng["tokens"], plain)):
        first = next((j for j, (a, b) in enumerate(zip(got, want["tokens"]))
                      if a != b), None)
        if first is None:
            continue
        bar = near_tie_bar(torch.bfloat16, want["tops"][first])
        parts.append({"request": i, "first_mismatch": first,
                      "margin_at_mismatch": want["margins"][first],
                      "near_tie_bar": bar,
                      "near_tie": want["margins"][first] <= bar})
    bad = [p for p in parts if not p["near_tie"]]
    if bad:
        failures.append(f"tokens part from the plain path off a logit "
                        f"near-tie: {bad}")
    out = {"phase": "moe", "card": smi, "model": MOE_ARCH, "dtype": "bfloat16",
           "requests": len(plain), "n_slabs": TP_SLABS,
           "parent_memory_allocated_gb": parent_gb,
           **{k: r[k] for k in ("n_params", "n_active_params", "weight_gb",
                                "pool_gb", "free_gb_before_draw", "draw_s",
                                "memory_allocated_gb",
                                "max_memory_allocated_gb", "layer0",
                                "plain_s")},
           "tokens": eng["tokens"],
           "counters": eng["counters"], "rehearsed": MOE_REHEARSED,
           "flash_routes": eng["flash_routes"],
           "move_plans": eng["move_plans"], "stream": eng["stream"],
           "tokens_equal_plain": not parts,
           "requests_parting": len(parts), "partings": parts,
           "plain_steps": sum(len(w["tokens"]) for w in plain),
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"moe phase: {failures}")
    return eng["launches"]


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    cfg = get_config("qwen3-1.7b")
    mono = phase_engine(cfg)
    launches = dict(mono["launches"])
    torch.cuda.empty_cache()
    phase_tokens(cfg)
    torch.cuda.empty_cache()
    results["mdc_priority"], launches["mdc_priority"] = phase_victims()
    paths = {"prefix": phase_prefix(cfg), "preemption": phase_preemption(cfg)}
    paths["chunked"], warm = phase_chunked(cfg, mono)
    paths["async"] = phase_async(cfg, mono, warm)
    paths["recovery"] = phase_recovery(cfg, mono)
    paths["serve"] = phase_serve(cfg, mono, smi)
    paths["mixed"] = phase_mixed(cfg, smi)
    paths["sim"] = phase_sim(smi)
    torch.cuda.empty_cache()
    paths["tp"], tp_results = phase_tp(cfg, smi)
    results.update(tp_results)
    for name in TP_KERNELS:
        launches[name] = paths["tp"][name]
    torch.cuda.empty_cache()
    paths["moe"] = phase_moe(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "path": ("victims, sim" if name == "mdc_priority" else "engine, moe"
                  if name in ENGINE_KERNELS else "tp" if name in TP_KERNELS
                  else "none"),
         "launches": launches[name],
         "path_launches": {p: n[name] for p, n in paths.items()},
         "ms": results[name]["kernel_ms"],
         **{k: results[name][k] for k in ("max_abs_err", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         # the same kernel at the moe phase's heads (H 32 over Kh 4)
         **({"at_moe_heads": {k: results[f"{name}_moe"][k] for k in (
             "kernel_ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape")}} if f"{name}_moe" in results else {})}
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
