"""Serving driver: batched requests through the port's paged engine, with
the paper's cleaning policies selectable for head-to-head Wamp comparison.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 24 --policies mdc greedy age

The port of ``repro.launch.serve``: the same request mix from ``--seed``,
the same rows and digest, the same observability outputs, on ``--device``
(the CUDA card by default; ``--device cpu`` runs every kernel's plain
version).  On the card the kernels are built before the timed loop, so no
compile time lands in tokens/s.

``--mesh N`` serves tensor-parallel over N ranks, one process each
(``launch.mesh.spawn_ranks``; rank r on card ``r % device_count``) in a
process group of ``--dist-backend``: ``nccl`` (the default) wants a card
per rank, ``gloo`` also runs several ranks on one card or on the CPU.
Every rank serves the same requests; rank 0 prints the rows and carries
the trace, the phase log, the metrics series and the calibration.  The
open loop (``--arrival-rate``) is not served under a mesh: its arrivals
follow each rank's own clock, so the ranks would part.
"""

from __future__ import annotations

import argparse
import time
import warnings

import numpy as np

from ..configs import ARCHS, get_config
from ..device import resolve_device
from ..distributed.fault import FailureInjector
from ..models import Model
from .mesh import make_serving_mesh, spawn_ranks
from ..serving import AdmissionShed, PagedServingEngine
from ..serving.engine import shard_model


def _open_loop(eng, reqs, rate: float, rng) -> tuple[int, dict]:
    """Open-loop driver: Poisson arrivals at ``rate`` req/s, *independent*
    of completions — the overload regime, where the arrival process does
    not slow down just because the pool is full.  Returns (dispatches,
    latency metrics): wall-clock TTFT (first token after *scheduled*
    arrival, so queueing and preemption delays are priced in) and TPOT
    (per-token decode latency after the first) percentiles in ms, plus the
    TTFT *queue-wait* component (scheduled arrival → first admission, read
    off the engine's ``admit_wall`` stamps) — separating "the scheduler sat
    on it" from "the prefill took that long to compute".

    All driver timestamps come from ``eng.clock`` (the engine's monotonic,
    pluggable clock), so the queue-wait subtraction against ``admit_wall``
    happens on one timebase.  A token counts as delivered when the
    ``step()`` that read it returns: the engine reads the card once per
    dispatch."""
    arrivals = list(np.cumsum(rng.exponential(1.0 / rate, size=len(reqs))))
    # (prompt, n_new, original arrival) — shed retries re-enter this list
    # scheduled at now + retry_after but keep their first arrival, so the
    # whole shed-and-retry wait is priced into that request's TTFT
    pend = [(p, n, a) for (p, n), a in zip(reqs, arrivals)]
    arr_t, first_t, done_t, n_tok = {}, {}, {}, {}
    shed_retries = 0
    dispatches = 0
    nxt = 0
    t0 = eng.clock()
    while nxt < len(pend) or eng.has_work():
        now = eng.clock() - t0
        while nxt < len(pend) and arrivals[nxt] <= now:
            prompt, n_new, orig = pend[nxt]
            try:
                arr_t[eng.submit(prompt, n_new)] = orig
            except AdmissionShed as shed:
                # a well-behaved client honors the retry-after hint
                shed_retries += 1
                pend.append((prompt, n_new, orig))
                arrivals.append(now + shed.retry_after_s)
            nxt += 1
        if not eng.has_work():  # idle until the next arrival
            time.sleep(min(float(arrivals[nxt]) - now, 2e-3))
            continue
        done = eng.step()
        dispatches += 1
        now = eng.clock() - t0
        for i in np.flatnonzero(eng.rid >= 0):
            if eng._out_n[i] > 0:  # TTFT: survives preemption (out is kept)
                first_t.setdefault(int(eng.rid[i]), now)
        for rid in done:
            first_t.setdefault(rid, now)
            done_t[rid] = now
            n_tok[rid] = len(eng.finished[rid])
    ttft = np.array([first_t[r] - arr_t[r] for r in done_t])
    tpot = np.array([(done_t[r] - first_t[r]) / max(n_tok[r] - 1, 1)
                     for r in done_t])
    queue = np.array([eng.admit_wall[r] - t0 - arr_t[r] for r in done_t
                      if r in eng.admit_wall])

    def pct(a, q):
        return round(float(np.percentile(a, q)) * 1e3, 1) if len(a) else 0.0

    return dispatches, dict(
        arrival_rate=rate, shed_retries=shed_retries,
        ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
        queue_ms_p50=pct(queue, 50), queue_ms_p99=pct(queue, 99),
        tpot_p50_ms=pct(tpot, 50), tpot_p99_ms=pct(tpot, 99))


def serve_run(*, arch: str = "qwen3-1.7b", requests: int = 14,
              policy: str = "mdc", seed: int = 0, n_slabs: int = 9,
              blocks_per_slab: int = 4, page_T: int = 8, max_batch: int = 4,
              n_open: int | None = None, streams: int | None = None,
              demote_survivors: bool = False,
              params=None, model: Model | None = None,
              max_decode_chunk: int = 32, prefix_cache: bool = False,
              prefix_cache_pages: int = 0, shared_prefix_len: int = 0,
              stop_token: int | None = None, preemption: bool = False,
              arrival_rate: float = 0.0, prefill_chunk: int = 0,
              admit_every_dispatch: bool = True,
              journal_dir: str | None = None, snapshot_every: int = 0,
              audit_every: int = 0, injector=None,
              shed_queue_depth: int = 0,
              trace: str | None = None, metrics_every: int = 0,
              metrics_file: str | None = None, calibration: bool = False,
              phase_log: bool = False,
              async_compaction: bool = False, clean_budget: int = 0,
              device=None, mesh=None, verbose: bool = True) -> dict:
    """One engine run over a request stream; returns metrics.

    ``prefix_cache`` turns on shared-prefix KV reuse; ``shared_prefix_len``
    prepends that many common tokens to every prompt (the system-prompt
    workload that makes the cache hit).  ``stop_token`` enables
    data-dependent early termination (output lifetimes become estimates);
    ``preemption`` lets the scheduler evict + resume sequences under pool
    pressure; ``arrival_rate`` > 0 switches to the open-loop Poisson
    driver and adds TTFT/TPOT latency percentiles to the row.
    ``prefill_chunk`` > 0 co-schedules prompt prefill with decode in the
    fused dispatch (that many prompt tokens per dispatch);
    ``admit_every_dispatch`` shrinks dispatches to per-token scheduling
    while work waits under stop-token decode (mid-dispatch exits become
    visible immediately).

    Observability (``repro_torch.obs``): ``trace`` writes a Chrome-trace
    JSON to that path; ``metrics_every`` samples engine metrics to
    ``metrics_file`` (JSONL) every N dispatches; ``calibration`` records
    est-death vs. actual death per block and prints the per-stream report;
    ``phase_log`` records the per-dispatch latency split and attaches
    ``phase_report`` to the returned row.

    ``async_compaction`` lifts cleaning out of the dispatch path: victims
    are fenced and evacuated in budget-sized sub-plans spread across
    dispatches instead of one synchronous burst; ``clean_budget`` caps
    blocks moved per dispatch (0 = the scheduler default).

    ``device``: the CUDA card unless the caller asks for the CPU; a
    ``model`` given must live there.

    ``mesh`` (tensor-parallel, one call per rank with the same arguments):
    each rank serves the same requests on its kv heads; rank 0 alone traces,
    logs phases, samples metrics, calibrates and prints.  The open loop is
    refused under a mesh (its arrivals follow each rank's clock)."""
    if mesh is not None:
        if arrival_rate > 0:
            raise ValueError("the open loop is not served under a mesh: its "
                             "arrivals follow each rank's own clock")
        if mesh.get_local_rank("model") != 0:
            trace, metrics_every, calibration = None, 0, False
            phase_log = verbose = False
    if n_open is not None:
        warnings.warn("n_open= is deprecated; use streams=",
                      DeprecationWarning, stacklevel=2)
        if streams is None:
            streams = n_open
    dev = resolve_device(device)
    if model is None:
        model = Model(get_config(arch).smoke(), device=dev, seed=0)
        if mesh is not None:     # the rank keeps only its heads
            model = shard_model(model, mesh)
    rng = np.random.default_rng(seed)
    tracer = None
    if trace:
        from ..obs import Tracer
        tracer = Tracer(capacity=1 << 18)
    if metrics_every and not metrics_file:
        metrics_file = f"serve_metrics_{policy}.jsonl"
    eng = PagedServingEngine(model, n_slabs=n_slabs,
                             blocks_per_slab=blocks_per_slab, page_T=page_T,
                             max_batch=max_batch, max_seq=256, policy=policy,
                             params=params, compact_trigger=2,
                             compact_batch=3, streams=streams,
                             demote_survivors=demote_survivors,
                             max_decode_chunk=max_decode_chunk,
                             prefix_cache=prefix_cache,
                             prefix_cache_pages=prefix_cache_pages,
                             stop_token=stop_token, preemption=preemption,
                             prefill_chunk=prefill_chunk,
                             admit_every_dispatch=admit_every_dispatch,
                             journal_dir=journal_dir,
                             snapshot_every=snapshot_every,
                             audit_every=audit_every, injector=injector,
                             shed_queue_depth=shed_queue_depth,
                             tracer=tracer, calibration=calibration,
                             metrics_every=metrics_every,
                             metrics_sink=metrics_file,
                             phase_log=phase_log,
                             async_compaction=async_compaction,
                             clean_budget=clean_budget, device=dev, mesh=mesh)
    if dev.type == "cuda":
        # build the kernels outside the timed loop (nvcc, or a load of the
        # cached libraries)
        from ..kernels import build
        build.build()
    # mixed short/long request stream (the checkerboarding driver); with
    # shared_prefix_len, every prompt opens with the same system prompt
    sys_prompt = np.random.default_rng(99).integers(
        1, model.cfg.vocab_size, size=shared_prefix_len)
    reqs = []
    for _ in range(requests):
        plen = int(rng.integers(4, 40))
        nnew = int(rng.choice([4, 8, 12, 24, 48], p=[.3, .25, .2, .15, .1]))
        prompt = rng.integers(1, model.cfg.vocab_size, size=plen)
        reqs.append((np.concatenate([sys_prompt, prompt]), nnew))

    lat: dict = {}
    t0 = eng.clock()
    if arrival_rate > 0:
        dispatches, lat = _open_loop(eng, reqs, arrival_rate, rng)
    else:
        for prompt, nnew in reqs:
            eng.submit(prompt, nnew)
        dispatches = 0
        while eng.has_work():
            eng.step()
            dispatches += 1
    dt = eng.clock() - t0
    # the full metrics dict rides along uniformly
    engine_metrics = eng.metrics()
    m = dict(engine_metrics)
    m.pop("dispatches", None)   # the driver-side count below is reported
    toks = sum(len(v) for v in eng.finished.values())
    # stable digest over the decoded streams (int-tuple hashing does not
    # depend on PYTHONHASHSEED): lets two runs assert bit-identical output
    # without shipping every token through the row
    digest = hash(tuple(sorted((int(r), tuple(int(t) for t in v))
                               for r, v in eng.finished.items())))
    out = dict(policy=policy, requests=requests, dispatches=dispatches,
               tokens=toks, tok_per_s=toks / dt, finished_digest=digest,
               **lat, **m, engine_metrics=engine_metrics)
    if tracer is not None:
        tracer.export(trace)
        if verbose:
            print(f"[serve] trace: {len(tracer)} events "
                  f"({tracer.dropped} dropped) -> {trace}")
    if calibration:
        out["calibration"] = eng.calibration.report()
        if verbose:
            print(eng.calibration.format_report())
    if phase_log:
        out["phase_report"] = eng.phase_report()
        if verbose:
            pr = out["phase_report"]
            if pr.get("dispatches"):
                print(f"[serve] dispatch p50={pr['p50_ms']:.2f}ms "
                      f"p99={pr['p99_ms']:.2f}ms  compaction share of "
                      f"p99 tail={pr['compaction_share_p99']:.1%} "
                      f"(of total {pr['compaction_share_total']:.1%})")
    if verbose:
        extra = ""
        if "prefix_hit_rate" in m:
            extra = (f"  hit={m['prefix_hit_rate']:.2f} "
                     f"prefill_saved={m['prefill_tokens_saved']}")
        if m["preemptions"]:
            extra += (f"  preempt={m['preemptions']} "
                      f"recomputed={m['recomputed_tokens']}")
        if lat:
            extra += (f"  ttft_p99={lat['ttft_p99_ms']:.0f}ms "
                      f"(queue {lat['queue_ms_p99']:.0f}ms) "
                      f"tpot_p50={lat['tpot_p50_ms']:.1f}ms")
        print(f"[serve] {policy:12s} {toks:5d} tok in {dt:6.2f}s "
              f"({out['tok_per_s']:7.1f} tok/s, {dispatches} dispatches)  "
              f"Wamp={m['wamp']:.3f} "
              f"meanE={m['mean_E_compacted']:.3f} "
              f"compactions={m['compactions']}{extra}")
    return out


def main() -> list[dict]:
    """The command line (``sys.argv``); returns one row per policy."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--policies", nargs="*",
                    default=["mdc", "greedy", "age", "cost_benefit"])
    ap.add_argument("--n-open", type=int, default=None,
                    help="deprecated alias for --streams")
    ap.add_argument("--streams", type=int, default=None, metavar="K",
                    help="death streams (open slabs) for SepBIT placement; "
                         "default 4")
    ap.add_argument("--demote", action="store_true",
                    help="demote overdue GC survivors one stream colder "
                         "(SepBIT inference; off by default — KV death "
                         "estimates are absolute clocks, so survival "
                         "usually carries no signal)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="max decode tokens per device dispatch")
    ap.add_argument("--device", default="cuda",
                    help="where the model, the pools and the kernels run: "
                         "the CUDA card (default), or 'cpu' for every "
                         "kernel's plain PyTorch version")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix KV reuse: cache full-page prompt "
                         "prefixes and prefill only the uncached tail")
    ap.add_argument("--prefix-cache-pages", type=int, default=0, metavar="P",
                    help="soft cap on cached pages (LRU eviction above it; "
                         "0 = bounded only by pool pressure); implies "
                         "--prefix-cache")
    ap.add_argument("--shared-prefix-len", type=int, default=0, metavar="S",
                    help="prepend S common system-prompt tokens to every "
                         "request (the workload prefix caching accelerates)")
    ap.add_argument("--stop-token", type=int, default=None, metavar="ID",
                    help="token id that terminates a request early (detected "
                         "on device inside the decode dispatch); output "
                         "lengths become data-dependent, so page death "
                         "estimates switch to the EWMA length predictor")
    ap.add_argument("--preemption", action="store_true",
                    help="under pool pressure, preempt running sequences "
                         "(declining-cost victim key), free their pages and "
                         "resume them later via recompute — admission stays "
                         "live instead of stalling until natural deaths")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="chunked prefill co-scheduled with decode: prefill "
                         "C prompt tokens per dispatch inside the fused "
                         "prefill+decode step (rounded up to whole pages) so "
                         "running decodes never stall behind a long prompt; "
                         "0 = monolithic one-dispatch prefill")
    ap.add_argument("--admit-every-dispatch",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="with work waiting under stop-token decode, shrink "
                         "dispatches to per-token scheduling so a "
                         "mid-dispatch stop-token exit frees its slot at "
                         "the next token instead of the end of the dispatch "
                         "(--no-admit-every-dispatch keeps full "
                         "horizon-length dispatches)")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="crash-safe serving: append per-dispatch session "
                         "records (checksummed, torn-tail-truncated on open) "
                         "to a journal under DIR; a killed run warm-restarts "
                         "via repro_torch.serving.recover_engine with the "
                         "unkilled run's output tokens")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="K",
                    help="with --journal: checkpoint the session state "
                         "through the manifest store every K dispatches and "
                         "truncate the journal behind it (bounds replay "
                         "length; 0 = journal only, full replay)")
    ap.add_argument("--audit", type=int, default=0, metavar="K",
                    help="debug mode: every K dispatches, cross-check pool "
                         "refcounts against block tables + prefix tree and "
                         "verify the journal tail (0 = off)")
    ap.add_argument("--inject-fault", nargs="*", default=[], metavar="OP:P",
                    help="chaos testing: inject retryable faults into engine "
                         "ops with per-op probability, e.g. dispatch:0.02 "
                         "compaction:0.05 (ops: dispatch prefill compaction "
                         "host_sync journal)")
    ap.add_argument("--shed-queue-depth", type=int, default=0, metavar="D",
                    help="load shedding: once admission stalls past "
                         "preemption and D requests queue, submit() raises "
                         "AdmissionShed with a retry-after hint (the open-"
                         "loop driver re-arrives them); 0 = never shed")
    ap.add_argument("--arrival-rate", type=float, default=0.0, metavar="R",
                    help="open-loop mode: submit requests by a Poisson "
                         "process at R req/s (independent of completions) "
                         "and report wall-clock TTFT/TPOT p50/p99; 0 = "
                         "closed loop (submit everything up front)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="export a Chrome-trace/Perfetto JSON of the run to "
                         "FILE (request lifecycles, per-dispatch phase "
                         "spans, segment open/seal/evacuate/clean events); "
                         "with several --policies the policy name is "
                         "suffixed to FILE")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="sample engine metrics (Wamp, free blocks, "
                         "per-stream writes/moves, queue depth, ...) to a "
                         "JSONL file every N dispatches, with per-interval "
                         "deltas (0 = off; see --metrics-file)")
    ap.add_argument("--metrics-file", default=None, metavar="FILE",
                    help="JSONL sink for --metrics-every (default "
                         "serve_metrics_<policy>.jsonl)")
    ap.add_argument("--calibration", action="store_true",
                    help="record est-death vs. actual death per block and "
                         "print the per-stream misroute rate + death-time "
                         "histograms at the end of the run")
    ap.add_argument("--phase-log", action="store_true",
                    help="record the per-dispatch latency split (admit / "
                         "alloc / upload / dispatch / host sync / "
                         "compaction / journal, on the host's clock) and "
                         "print compaction's share of the dispatch p99 tail")
    ap.add_argument("--async-compaction", action="store_true",
                    help="lift cleaning out of the dispatch path: fence "
                         "victims and spread their evacuation over "
                         "budget-sized sub-plans across dispatches "
                         "(planned / in-flight / committed)")
    ap.add_argument("--clean-budget", type=int, default=0, metavar="B",
                    help="async compaction: max blocks moved per dispatch "
                         "at steady state (0 = scheduler default; the "
                         "budget self-raises with the free-slab deficit)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="tensor-parallel serving over N ranks, one process "
                         "each, the kv heads split among them (0 = one "
                         "process, no mesh)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default="nccl",
                    help="process-group backend under --mesh: nccl (one "
                         "card per rank) or gloo (ranks may share a card, "
                         "or run on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.mesh and args.arrival_rate:
        ap.error("--arrival-rate is not served under --mesh")

    if args.mesh:
        if resolve_device(args.device).type == "cuda":
            from ..kernels import build
            build.build()   # once, before the ranks load the libraries
        results = spawn_ranks(_serve_rank, args.mesh, args,
                              backend=args.dist_backend,
                              device=args.device)[0]
    else:
        model = Model(get_config(args.arch).smoke(), device=args.device,
                      seed=0)
        results = _serve_policies(args, model, args.device)
    best = min(results, key=lambda r: r["wamp"])
    print(f"[serve] lowest block-move overhead: {best['policy']} "
          f"(Wamp {best['wamp']:.3f})")
    return results


def _serve_rank(rank, device, args) -> list[dict]:
    """One rank of ``--mesh``: the smoke model drawn from the same seed on
    every rank and cut to the rank's heads, every policy through
    ``serve_run`` on the mesh."""
    mesh = make_serving_mesh(args.mesh, device.type)
    model = shard_model(Model(get_config(args.arch).smoke(), device=device,
                              seed=0), mesh)
    return _serve_policies(args, model, device, mesh)


def _serve_policies(args, model, device, mesh=None) -> list[dict]:
    """One ``serve_run`` row per policy of the parsed command line."""
    injector = None
    if args.inject_fault:
        probs = {}
        for spec in args.inject_fault:
            op, _, p = spec.partition(":")
            probs[op] = float(p or 0.05)
        injector = FailureInjector(transient_prob=probs, seed=args.seed)
    return [serve_run(arch=args.arch, requests=args.requests, policy=p,
                      seed=args.seed, n_open=args.n_open,
                      streams=args.streams,
                      demote_survivors=args.demote, model=model,
                      max_decode_chunk=args.chunk,
                      prefix_cache=args.prefix_cache,
                      prefix_cache_pages=args.prefix_cache_pages,
                      shared_prefix_len=args.shared_prefix_len,
                      stop_token=args.stop_token,
                      preemption=args.preemption,
                      arrival_rate=args.arrival_rate,
                      prefill_chunk=args.prefill_chunk,
                      admit_every_dispatch=args.admit_every_dispatch,
                      journal_dir=(f"{args.journal}/{p}"
                                   if args.journal else None),
                      snapshot_every=args.snapshot_every,
                      audit_every=args.audit, injector=injector,
                      shed_queue_depth=args.shed_queue_depth,
                      trace=(args.trace if len(args.policies) == 1
                             else f"{args.trace}.{p}") if args.trace
                            else None,
                      metrics_every=args.metrics_every,
                      metrics_file=args.metrics_file,
                      calibration=args.calibration,
                      phase_log=args.phase_log,
                      async_compaction=args.async_compaction,
                      clean_budget=args.clean_budget,
                      device=device, mesh=mesh)
            for p in args.policies]


if __name__ == "__main__":
    main()
