#!/usr/bin/env python3
"""Where the port's serving time goes, on one CUDA card.

    python3 scripts/profile_engine.py [--arch qwen3-moe-30b-a3b]

Builds ``--arch`` at full width (qwen3-1.7b by default; random bf16
weights from a seed) and the paged engine of ``chip_smoke.py``'s engine
phase, then profiles these windows with ``torch.profiler`` (CPU and CUDA
activities):

* decode  — eight slots admitted (prompts of 512 tokens), then dispatches
            of a full batch with no admission in the window;
* prefill — one 1024-token prompt through ``tfm.prefill`` (its flash
            attention on the tensor-core route, ``flash_routes``);
* prefill_cold / prefill_hit — ``chip_smoke.py``'s prefix stream at its
            longest: a 768-token prompt whose first 512 tokens are cached.
            Cold: the whole prompt (bucket 1,024).  Hit: the prefix K/V
            gathered from pool pages as the engine does, then
            ``tfm.prefill_with_prefix`` of the 256-token tail over a
            1,024-key extent (flash attention with ``q_offset`` 512);
* fused_chunk — chunked prefill (256 tokens per dispatch): a 1,024-token
            prompt's four fused dispatches, each one chunk (at offsets 0,
            256, 512, 768) plus the decode of the other slots, 8 tokens
            each (the 8-row decode batch, 5 to 7 slots decoding: after a
            warm-up prompt, one runs unprofiled, the next under the
            profiler);
* async_move — one decode dispatch of an 8-slot batch like the decode
            window's (on an engine with async compaction) with one
            compaction sub-plan (the default clean budget's 8 pages: K and
            V of 28 layers) issued on the engine's side stream just before
            it, as the async pump does.  From the profiler's kernel
            intervals and their streams: the move's device time, the share
            of it that overlaps kernels of the main stream, and the share
            that falls in the main stream's idle gaps.  Beside it, the wall
            of the same dispatch carrying the move synchronously (on the
            main stream, as synchronous compaction moves) against the move
            issued async (median of 5 each, in turns).

Each window runs without the profiler (``wall_ms``; for the prefix pair the
median of five runs in turns) and once under it (``wall_ms_profiled``,
which carries the profiler's own cost).  The decode and fused_chunk windows
also count the calls that wait for the card (``host_syncs``: PyTorch's
sync debug mode, less the window's closing synchronise), and the fused one
splits its unprofiled wall into the chunk and the decode (``chunk_ms``,
``decode_ms``: CUDA events around each, so host gaps count, as the eager
engine is host-bound).  For each window it prints one JSON line: wall ms,
the device's busy ms (sum of kernel times under the profiler), the idle
share against the unprofiled wall, kernel launches, the kernels that take
the most device time, the time of each of the port's own kernels, and the
host operators with the most self CPU time under the profiler (with their
calls).  For the moe family (Qwen3-30B-A3B: 61.1 GB of weights, so nothing
else on the card) each window also splits the MoE FFN's device time
(``moe_ms``, ``moe_share_of_busy``): its router, dispatch and combine,
each the kernels launched inside a ``record_function`` span around that
function, and the expert products with their silu, the FFN's span less
the three.  Measurement only: nothing here is asserted.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import timed  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import CompactionPlan, PagedServingEngine  # noqa: E402
from repro_torch.serving.scheduler import DEFAULT_CLEAN_BUDGET  # noqa: E402


# the device functions of the port's kernels (kernels/csrc), by kernel
PORT_KERNELS = {"flash_attention": "flash_fwd", "paged_attention":
                "paged_attention_kernel", "segment_move": "move_rows",
                "segment_compact": "compact_rows"}
# the MoE FFN's spans under the profiler: label -> the function in ``moe``
MOE_LABELS = {"moe_ffn": "moe_ffn", "moe.route": "_route",
              "moe.dispatch": "_dispatch_group",
              "moe.combine": "_combine_group"}


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the CPU and the card, with each MOE_LABELS
    function run inside a ``record_function`` span of its label."""
    saved = {f: getattr(moe, f) for f in MOE_LABELS.values()}

    def labelled(label, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return call

    for label, f in MOE_LABELS.items():
        setattr(moe, f, labelled(label, saved[f]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield prof
    finally:
        for f, fn in saved.items():
            setattr(moe, f, fn)


def kernel_table(prof, wall_ms: float, n_units: int) -> dict:
    """Device time of the CUDA kernels in a profile, per unit, against the
    wall time of the same window run without the profiler."""
    rows, spans = [], {}
    for e in prof.events():
        # a record_function span also shows on the device's timeline, from
        # its first kernel to its last: kernels only
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name not in MOE_LABELS):
            rows.append((e.name, e.device_time_total / 1e3))
        elif (e.device_type == torch.autograd.DeviceType.CPU
              and e.name in MOE_LABELS):
            spans[e.name] = spans.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(t for _, t in rows)
    by_name: dict[str, float] = {}
    for name, t in rows:
        by_name[name] = by_name.get(name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k: sum(t for n, t in by_name.items() if fn in n) / n_units
            for k, fn in PORT_KERNELS.items()}
    # host side: the operators with the most self CPU time (profiled, so
    # inflated by the profiler's own cost; read them as shares), and calls
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    top_host = {a.key[:60]: [a.self_cpu_time_total / 1e3 / n_units,
                             a.count / n_units] for a in host[:10]}
    out = {"wall_ms": wall_ms / n_units, "device_busy_ms": busy / n_units,
           "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
           "launches": len(rows) / n_units,
           "top_kernels_ms": {n[:80]: t / n_units for n, t in top},
           "top_host_ops_ms_calls": top_host,
           "port_kernels_ms": {k: t for k, t in port.items() if t}}
    if spans:
        split = {"experts_and_silu": spans["moe_ffn"] - sum(
            t for k, t in spans.items() if k != "moe_ffn"), **spans}
        out["moe_ms"] = {k: t / n_units for k, t in split.items()}
        out["moe_share_of_busy"] = {k: t / busy for k, t in split.items()}
    return out


def count_syncs(fn):
    """(fn(), the synchronising CUDA calls it made): PyTorch's sync debug
    mode warns at each call that waits for the device (a read to the host,
    an upload from pageable memory, an explicit synchronise)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def merged(intervals: list) -> list:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(a: float, b: float, union: list) -> float:
    """Length of [a, b] inside the disjoint intervals ``union``."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def async_move(model, cfg) -> None:
    """The async_move window: eight slots admitted (prompts of 512 tokens,
    as in the decode window) on an engine with async compaction, then a
    sub-plan of DEFAULT_CLEAN_BUDGET moves between pages of two slabs no
    sequence holds (the free list's last two, taken last), issued through
    the engine's own ``_issue`` on its side stream, and one dispatch."""
    eng = PagedServingEngine(model, n_slabs=30, blocks_per_slab=16, page_T=16,
                             max_batch=8, max_seq=2048, streams=1,
                             max_decode_chunk=32, async_compaction=True,
                             device="cuda")
    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 512), 400)
    eng.step()
    eng.step()
    S, n = eng.pool.S, DEFAULT_CLEAN_BUDGET
    a, b = eng.pool.core.free_list[:2]
    # the pages hold no block (owner -1), as the plan's owners say
    plan = CompactionPlan(np.arange(a * S, a * S + n),
                          np.arange(b * S, b * S + n), np.full(n, -1))

    def issue_async() -> None:
        eng._issue(plan)
        eng._move_events.pop(id(plan))

    def issue_sync() -> None:
        eng._move_plan(plan)

    def dispatch(issue) -> float:
        t0 = time.perf_counter()
        issue()
        eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    runs = (("sync", issue_sync), ("async", issue_async))
    walls: dict[str, list[float]] = {name: [] for name, _ in runs}
    for _, fn in runs:
        dispatch(fn)  # warm-up
    for _ in range(5):  # in turns: the host's load drifts
        for name, fn in runs:
            walls[name].append(dispatch(fn))
    # three dispatches under one profile: a move the profiler drops (one
    # call on the card missed the first) still leaves two to read
    ops.reset_launches()
    with profiled() as prof:
        wall = [dispatch(issue_async) for _ in range(3)]
    issued = ops.launches["segment_move"]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def stream_of(e):
        sid = getattr(e, "device_resource_id", None)
        return e.thread if sid is None else sid

    move = [e for e in kernels if PORT_KERNELS["segment_move"] in e.name]
    side_ids = {stream_of(e) for e in move}
    main = merged([(e.time_range.start, e.time_range.end) for e in kernels
                   if stream_of(e) not in side_ids])
    move_us = sum(e.time_range.end - e.time_range.start for e in move)
    over_us = sum(covered(e.time_range.start, e.time_range.end, main)
                  for e in move)
    L, page = eng.k_pools.shape[0], eng.k_pools[0, 0]
    print(json.dumps({
        "window": "async_move", "per": "dispatch", "moves": n,
        # each page of K and V in every layer read once and written once
        "move_bytes": 4 * n * L * page.numel() * page.element_size(),
        "move_launches_issued": issued, "move_launches_profiled": len(move),
        "move_streams": len(side_ids),
        "move_device_ms": move_us / 1e3 / len(move) if move else None,
        "move_overlap_share": over_us / move_us if move_us else None,
        "move_in_main_gaps_share": 1 - over_us / move_us if move_us else None,
        "wall_ms_profiled": statistics.median(wall),
        "device_busy_ms": sum(e.time_range.end - e.time_range.start
                              for e in kernels) / 1e3 / len(wall),
        "launches": len(kernels) / len(wall),
        "dispatch_wall_ms": {k: statistics.median(v) for k, v in walls.items()},
        "dispatch_wall_ms_runs": walls}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help="the model, at full width (a name of the port's "
                         "ARCHS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_config(args.arch)
    model = Model(cfg, device="cuda", seed=0)
    eng = PagedServingEngine(model, n_slabs=30, blocks_per_slab=16, page_T=16,
                             max_batch=8, max_seq=2048, streams=1,
                             max_decode_chunk=32, device="cuda")
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 512), 200)
    eng.step()  # admission + prefill of all slots, first dispatch (warm-up)
    eng.step()
    torch.cuda.synchronize()

    def steps(k: int) -> tuple[float, int]:
        """k dispatches of the full batch: (wall ms, token steps)."""
        toks0 = int(eng._out_n.sum())
        t0 = time.perf_counter()
        for _ in range(k):
            eng.step()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                (int(eng._out_n.sum()) - toks0) // eng.max_batch)

    # decode: the next dispatches run a full batch; no admission can happen.
    # The same window once without the profiler (its wall is the one to
    # read) and once under it (for the device-side split).
    plain_ms, plain_steps = steps(3)
    with profiled() as prof:
        wall, token_steps = steps(3)
    (_, sync_steps), syncs = count_syncs(lambda: steps(1))
    print(json.dumps({"window": "decode", "batch": eng.max_batch,
                      "per": "token step",
                      "token_steps": token_steps,
                      "host_syncs": (syncs - 1) / sync_steps,
                      "wall_ms_profiled": wall / token_steps,
                      **kernel_table(prof, plain_ms / plain_steps * token_steps,
                                     token_steps)}), flush=True)

    # prefill: one 1024-token prompt (the engine's bucket for a 1024 prompt)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 1024))).cuda()

    def prefill() -> float:
        t0 = time.perf_counter()
        tfm.prefill(model.params, toks, cfg, 1024)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill()  # warm-up
    ops.reset_launches()
    plain_ms = prefill()
    routes = dict(ops.flash_routes)  # the route of the window's attention
    with profiled() as prof:
        wall = prefill()
    print(json.dumps({"window": "prefill", "tokens": 1024, "per": "prompt",
                      "wall_ms_profiled": wall, "flash_routes": routes,
                      **kernel_table(prof, plain_ms, 1)}), flush=True)

    # prefix hit: 512 cached tokens (32 pages of the engine's pool) + a
    # 256-token tail, against the cold prefill of the whole 768 tokens
    P, tail, T = 512, 256, eng.page_T
    prompt = rng.integers(1, cfg.vocab_size, P + tail)
    cold_toks = torch.zeros(1, 1024, dtype=torch.int64, device="cuda")
    cold_toks[0, :P + tail] = torch.from_numpy(prompt)
    L, _, _, Kh, hd = eng.k_pools.shape
    pages = torch.arange(P // T, device="cuda")

    def cold() -> None:
        tfm.prefill(model.params, cold_toks, cfg, 1024, true_len=P + tail)

    def hit() -> None:
        k_pre = eng.k_pools[:, pages].reshape(L, 1, P, Kh, hd)
        v_pre = eng.v_pools[:, pages].reshape(L, 1, P, Kh, hd)
        tfm.prefill_with_prefix(model.params, cold_toks[:, P:P + tail], cfg,
                                k_pre, v_pre, tail, true_len=tail,
                                kv_len=1024)

    def run(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    windows = (("prefill_cold", cold, P + tail), ("prefill_hit", hit, tail))
    walls: dict[str, list[float]] = {name: [] for name, _, _ in windows}
    for _, fn, _ in windows:
        run(fn)  # warm-up
    for _ in range(5):  # cold and hit in turns: the host's load drifts
        for name, fn, _ in windows:
            walls[name].append(run(fn))
    for name, fn, tokens in windows:
        ops.reset_launches()
        run(fn)
        offsets = dict(ops.flash_offsets)
        with profiled() as prof:
            wall = run(fn)
        print(json.dumps({"window": name, "tokens": tokens, "per": "prompt",
                          "wall_ms_runs": walls[name],
                          "wall_ms_profiled": wall, "flash_offsets": offsets,
                          **kernel_table(prof, statistics.median(walls[name]),
                                         1)}), flush=True)

    # fused_chunk: 5 slots decoding in step, then 1,024-token prompts, one
    # at a time, each prefilling in four 256-token chunks fused with that
    # decode (the first prompt warms the chunk's shapes up).  The 5 are
    # admitted in one monolithic dispatch, so that all sit at 512 tokens
    # and cross a page at the same token: every dispatch then decodes the 8
    # tokens of max_decode_chunk
    del eng
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    eng = PagedServingEngine(model, n_slabs=30, blocks_per_slab=16, page_T=16,
                             max_batch=8, max_seq=2048, streams=1,
                             max_decode_chunk=8, device="cuda")
    for _ in range(5):
        eng.submit(rng.integers(1, cfg.vocab_size, 512), 150)
    eng.step()
    eng.prefill_chunk = 256   # chunked from here on (16 whole pages)
    torch.cuda.synchronize()
    decoded = []              # token steps of each dispatch's decode
    parts = {"chunk": [], "decode": []}   # CUDA events around each part
    chunk, decode = eng._prefill_chunk, eng._decode
    eng._prefill_chunk = timed(chunk, parts["chunk"])
    eng._decode = timed(lambda n: (decoded.append(n), decode(n))[1],
                        parts["decode"])

    def prompt_chunks() -> tuple[float, int, int]:
        """One 1,024-token prompt's fused dispatches: (wall ms, dispatches,
        token steps).  ``parts`` keeps only this prompt's events."""
        for events in parts.values():
            events.clear()
        eng.submit(rng.integers(1, cfg.vocab_size, 1024), 100)
        d0, k0 = eng.dispatches, len(decoded)
        t0 = time.perf_counter()
        eng.step()                   # admits it and runs its first chunk
        while eng._pf is not None:
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        return wall, eng.dispatches - d0, sum(decoded[k0:])

    _, syncs = count_syncs(prompt_chunks)  # also the warm-up
    plain_ms, plain_n, plain_steps = prompt_chunks()
    split = {f"{k}_ms": sum(a.elapsed_time(b) for a, b in v) / plain_n
             for k, v in parts.items()}
    with profiled() as prof:
        wall, n_disp, token_steps = prompt_chunks()
    print(json.dumps({"window": "fused_chunk", "chunk_tokens": 256,
                      "per": "dispatch", "dispatches": n_disp,
                      "token_steps_per_dispatch": token_steps / n_disp,
                      "unprofiled": {"dispatches": plain_n,
                                     "token_steps": plain_steps, **split},
                      "host_syncs": (syncs - 1) / plain_n,
                      "wall_ms_profiled": wall / n_disp,
                      **kernel_table(prof, plain_ms / plain_n * n_disp,
                                     n_disp)}), flush=True)
    del eng
    torch.cuda.empty_cache()
    async_move(model, cfg)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
