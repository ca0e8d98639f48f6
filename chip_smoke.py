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
             its bound it reaches), with the tolerances of the JAX package's
             kernel tests (f32 2e-5, bf16 2e-2, exact for the copies);
             kernel, plain and library times (median of CUDA-event timings,
             L2 flushed before each launch; a kernel and its yardstick timed
             in alternation) beside the least time the card could take.  Flash attention runs at the engine's prefill
             buckets (S 256, 512, 1024) in bf16 on its tensor-core route and
             at S 1024 in f32 on its CUDA-core route, each line naming the
             route; the compaction move runs a disjoint plan (one launch) and
             an overlapping one (gather and scatter) beside the PyTorch
             expression ``p[:, dst] = p[:, src]``.
4. engine  — the paged serving engine on the full-width qwen3-1.7b (28
             layers, random bf16 weights from a seed) serving 32 requests,
             with the pool sized so that MDC compaction fires under pressure.
             The kernels' launch counters are zeroed just before and read
             just after; each of the engine's three (paged attention, the
             compaction move, flash attention on its tensor-core route) must
             have grown.  It reports how many compaction plans were staged
             (a destination that is another move's source).
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
             kernel, plain and key + top-k times beside the bound.  It runs
             last, so that the engine phase runs in the same process history
             as before this phase existed.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import policies  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.layers import flatten, unflatten  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import PagedServingEngine  # noqa: E402

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
}
# the engine's kernels: each must launch in the engine phase.  segment_compact
# is off the engine's path since the move is one fused kernel (its launches
# there are 0); mdc_priority's path is the victims phase.
ENGINE_KERNELS = ("paged_attention", "segment_move", "flash_attention")
FLASH_BUCKETS = (256, 512, 1024)  # the engine's prefill buckets


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


def check_paged_attention(dtype, timer, B=8, P=64) -> dict:
    """Decode attention at qwen3-1.7b's heads (Kh 8, G 2, D 128, 16-token
    pages) over B sequences of up to P pages each; a full table and a
    one-token sequence among them.  ``launches_per_call`` counts the
    kernel's launches in one wrapper call (the design makes it 1)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    Kh, G, D, T = 8, 2, 128, 16
    H = Kh * G
    n_pages = B * P + 1
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(dtype)
    v_pool = torch.randn(n_pages, T, Kh, D, generator=g, device="cuda").to(dtype)
    bt = torch.randperm(B * P, generator=g, device="cuda").view(B, P).to(torch.int32)
    lens = torch.randint(1, P * T + 1, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    lens[0], lens[1] = P * T, 1  # a full table and a one-token sequence
    n0 = ops.launches["paged_attention"]
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    per_call = ops.launches["paged_attention"] - n0
    if per_call != 1:
        raise AssertionError(f"paged_attention: {per_call} launches per call")
    want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    n_tok = int(lens.sum())
    es = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (2 * n_tok * Kh * D * es + 2 * B * H * D * es
               + 4 * int(((lens + T - 1) // T).sum()) + 4 * B)
    b_ms, b_by = bound(n_bytes, 4.0 * n_tok * H * D, dtype)
    kernel_ms = timer(lambda: ops.paged_attention(q, k_pool, v_pool, bt, lens))
    return {"max_abs_err": max_err(got, want), "launches_per_call": per_call,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / kernel_ms,
            "shape": {"B": B, "Kh": Kh, "G": G, "D": D, "page_T": T, "P": P,
                      "tokens": n_tok}}


def check_flash_attention(dtype, S, timer) -> dict:
    """Causal prefill attention at qwen3-1.7b's heads over S tokens, in the
    model's (B, S, H, D) layout; the launch must take the route that
    ``ops.flash_route`` names for (dtype, D)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Kh, D = 1, 16, 8, 128
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
    torch.cuda.empty_cache()
    for dtype, S in [(torch.bfloat16, S) for S in FLASH_BUCKETS] + [(torch.float32, 1024)]:
        r = check_flash_attention(dtype, S, timer)
        emit({"phase": "kernel", "name": "flash_attention", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16 and S == max(FLASH_BUCKETS):
            main["flash_attention"] = r
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


def phase_engine(cfg) -> dict:
    """32 requests (prompts 256-1024 tokens, 32-128 new tokens) through a
    pool of 30 slabs x 16 pages x 16 tokens: 8 slots of such requests hold
    up to ~9k tokens, so a 7,680-token pool with one open stream fills,
    checkerboards and compacts under pressure (no forced compaction)."""
    model = Model(cfg, device="cuda", seed=SEED)
    eng = PagedServingEngine(model, n_slabs=30, blocks_per_slab=16, page_T=16,
                             max_batch=8, max_seq=2048, streams=1,
                             compact_trigger=2, compact_batch=4,
                             max_decode_chunk=32, device="cuda")
    rng = np.random.default_rng(SEED)
    plens = rng.integers(256, 1025, 32)
    news = rng.integers(32, 129, 32)
    prompts = [rng.integers(1, cfg.vocab_size, p) for p in plens]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, int(n)) for p, n in zip(prompts, news)]
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    routes, plans = dict(ops.flash_routes), dict(ops.move_plans)
    for rid, n in zip(rids, news):
        if len(eng.finished[rid]) != n:
            raise AssertionError(f"request {rid}: {len(eng.finished[rid])} "
                                 f"tokens, want {n}")
    eng.pool.check_invariants()
    m = eng.metrics()
    if m["compactions"] < 1:
        raise AssertionError("the pool never compacted under pressure")
    missing = [k for k in ENGINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if routes["wgmma"] == 0:
        raise AssertionError("the prefill's flash attention never took the "
                             "tensor-core route")
    gen = int(news.sum())
    emit({"phase": "engine", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(rids), "prompt_tokens": int(plens.sum()),
          "generated_tokens": gen, "wall_s": wall, "tokens_per_s": gen / wall,
          "compactions": m["compactions"], "blocks_written": m["blocks_written"],
          "blocks_moved": m["blocks_moved"], "wamp": m["wamp"],
          "dispatches": m["dispatches"], "launches": launches,
          "flash_routes": routes, "staged_plans": plans["staged"],
          "direct_plans": plans["direct"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def oracle_margins(params, prompt, cfg, n_new):
    """The plain greedy decode again, recording each step's top-2 logit
    margin (how close the argmax was to a tie)."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    logits, cache = tfm.prefill(params, toks, cfg, len(prompt) + n_new + 1,
                                cache_dtype=torch.float32, kernel=False)
    out, margins = [], []
    while True:
        top = torch.topk(logits[0].float(), 2).values
        margins.append(float(top[0] - top[1]))
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


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    cfg = get_config("qwen3-1.7b")
    launches = phase_engine(cfg)
    torch.cuda.empty_cache()
    phase_tokens(cfg)
    torch.cuda.empty_cache()
    results["mdc_priority"], launches["mdc_priority"] = phase_victims()
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "path": ("victims" if name == "mdc_priority" else "engine"
                  if name in ENGINE_KERNELS else "none"),
         "launches": launches[name], "ms": results[name]["kernel_ms"],
         **{k: results[name][k] for k in ("max_abs_err", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}}
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
