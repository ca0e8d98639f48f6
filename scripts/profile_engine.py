#!/usr/bin/env python3
"""Where the port's serving time goes, on one CUDA card.

    python3 scripts/profile_engine.py

Builds the full-width qwen3-1.7b (random bf16 weights from a seed) and the
paged engine of ``chip_smoke.py``'s engine phase, then profiles two windows
with ``torch.profiler`` (CPU and CUDA activities):

* decode  — eight slots admitted (prompts of 512 tokens), then dispatches
            of a full batch with no admission in the window;
* prefill — one 1024-token prompt through ``tfm.prefill`` (its flash
            attention on the tensor-core route, ``flash_routes``).

Each window runs once without the profiler (``wall_ms``) and once under it
(``wall_ms_profiled``, which carries the profiler's own cost).  For each it
prints one JSON line: wall ms, the device's busy ms (sum of kernel times
under the profiler), the idle share against the unprofiled wall, kernel
launches, the kernels that take the most device time, and the time of
each of the port's own kernels.  Measurement only: nothing here is
asserted.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving import PagedServingEngine  # noqa: E402


# the device functions of the port's kernels (kernels/csrc), by kernel
PORT_KERNELS = {"flash_attention": "flash_fwd", "paged_attention":
                "paged_attention_kernel", "segment_move": "move_rows",
                "segment_compact": "compact_rows"}


def kernel_table(prof, wall_ms: float, n_units: int) -> dict:
    """Device time of the CUDA kernels in a profile, per unit, against the
    wall time of the same window run without the profiler."""
    rows = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.name, e.device_time_total / 1e3))
    busy = sum(t for _, t in rows)
    by_name: dict[str, float] = {}
    for name, t in rows:
        by_name[name] = by_name.get(name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k: sum(t for n, t in by_name.items() if fn in n) / n_units
            for k, fn in PORT_KERNELS.items()}
    return {"wall_ms": wall_ms / n_units, "device_busy_ms": busy / n_units,
            "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "launches": len(rows) / n_units,
            "top_kernels_ms": {n[:80]: t / n_units for n, t in top},
            "port_kernels_ms": {k: t for k, t in port.items() if t}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = get_config("qwen3-1.7b")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, token_steps = steps(3)
    print(json.dumps({"window": "decode", "batch": eng.max_batch,
                      "per": "token step",
                      "token_steps": token_steps,
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = prefill()
    print(json.dumps({"window": "prefill", "tokens": 1024, "per": "prompt",
                      "wall_ms_profiled": wall, "flash_routes": routes,
                      **kernel_table(prof, plain_ms, 1)}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
