#!/usr/bin/env python3
"""What tensor-parallel serving's mesh path adds to a decode step, on one
CUDA card.

    python3 scripts/profile_tp_decode.py

One process in a one-rank ``nccl`` process group (world size 1) and the
full-width qwen3-1.7b (random bf16 weights from a seed).  Two engines as
``profile_engine.py``'s decode window builds them (eight slots, prompts of
512 tokens), one without a mesh and one on the one-rank serving mesh: the
same heads and the same arithmetic, the second through the two sharded
wrappers and ``gather_heads`` (28 all-gathers per token step).  Windows:

* decode — after two warm-up dispatches each, one dispatch of each engine
           in turns, three times (wall per token step, median), then one
           dispatch each under ``torch.profiler`` (the device's busy time,
           launches, the host operators with the most self CPU time) and
           one each counted for the calls that wait for the card
           (``host_syncs``: PyTorch's sync debug mode, less the window's
           closing synchronise);
* gather — the decode step's context, (8, 16, 128) bf16 on the card,
           through ``ops.gather_heads`` and through its parts (the list
           ``all_gather``, ``all_gather_into_tensor``, ``mesh.get_group``,
           the ``torch.cat``), 200 calls each: host µs per call to enqueue
           them, µs per call to the end of the device's work, and the
           synchronising calls of one call; then ``gather_heads`` in five
           rounds of 500 calls (host µs per call in each), to see whether a
           call's cost grows with the collectives the group has run.  The
           window runs before the decode window and after it.

Run it with ``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` as well to see what NCCL's
flight recorder (a record of each collective, on by default) costs.

Prints the card's name and power limit, then one JSON line per window.
Measurement only: nothing here is asserted.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_engine import count_syncs, kernel_table  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import PagedServingEngine  # noqa: E402

LAYERS_GATHERS = 28   # one all-gather per layer per token step


def decode(model, cfg, mesh) -> dict:
    engines = {}
    for name, m in (("unsharded", None), ("mesh1", mesh)):
        eng = PagedServingEngine(model, n_slabs=40, blocks_per_slab=16,
                                 page_T=16, max_batch=8, max_seq=2048,
                                 streams=1, max_decode_chunk=32,
                                 device="cuda", mesh=m)
        rng = np.random.default_rng(0)
        for _ in range(8):
            eng.submit(rng.integers(1, cfg.vocab_size, 512), 400)
        eng.step()   # admission + prefill of all slots, first dispatch
        eng.step()
        torch.cuda.synchronize()
        engines[name] = eng

    def one(eng) -> tuple[float, int]:
        """One dispatch of the full batch: (wall ms, token steps)."""
        toks0 = int(eng._out_n.sum())
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                (int(eng._out_n.sum()) - toks0) // eng.max_batch)

    per_step = {name: [] for name in engines}
    for _ in range(3):   # in turns: the host's load drifts
        for name, eng in engines.items():
            ms, n = one(eng)
            per_step[name].append(ms / n)
    out = {"window": "decode", "batch": 8, "per": "token step",
           "wall_ms_runs": per_step,
           "wall_ms": {k: statistics.median(v) for k, v in per_step.items()}}
    for name, eng in engines.items():
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ms, n = one(eng)
        (_, n_sync), syncs = count_syncs(lambda: one(eng))
        out[name] = {**kernel_table(prof, ms, n), "host_syncs": syncs - 1,
                     "host_syncs_token_steps": n_sync,
                     "launches_two_dispatches": {
                         k: v for k, v in ops.launches.items() if v}}
    w = out["wall_ms"]
    out["mesh_ms_per_gather"] = (w["mesh1"] - w["unsharded"]) / LAYERS_GATHERS
    return out


def gather(mesh) -> dict:
    o = torch.randn(8, 16, 128, device="cuda", dtype=torch.bfloat16)
    group = mesh.get_group("model")
    n = mesh.size()
    parts = [torch.empty_like(o) for _ in range(n)]
    flat = torch.empty((n * o.shape[0],) + tuple(o.shape[1:]), dtype=o.dtype,
                       device=o.device)
    probes = {
        "gather_heads": lambda: ops.gather_heads(o, mesh),
        "all_gather_list": lambda: dist.all_gather(parts, o, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            flat, o, group=group),
        "mesh_get_group": lambda: mesh.get_group("model"),
        "cat": lambda: torch.cat(parts, dim=-2),
    }
    out = {"window": "gather", "shape": list(o.shape), "dtype": "bfloat16",
           "calls": 200, "collectives_before": ops_issued(),
           "TORCH_NCCL_TRACE_BUFFER_SIZE": os.environ.get(
               "TORCH_NCCL_TRACE_BUFFER_SIZE")}
    for name, fn in probes.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        _, syncs = count_syncs(fn)
        out[name] = {"host_us_per_call": host / 200 * 1e6,
                     "us_per_call": total / 200 * 1e6, "host_syncs": syncs}
    # does a call's host cost grow with the collectives the group has run?
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(500):
            ops.gather_heads(o, mesh)
        rounds.append((time.perf_counter() - t0) / 500 * 1e6)
    torch.cuda.synchronize()
    out["gather_heads_host_us_rounds_of_500"] = rounds
    return out


def ops_issued() -> int:
    """Collectives this process's group has issued so far (NCCL's
    sequence number, where the backend tells it)."""
    try:
        pg = dist.distributed_c10d._get_default_group()
        return int(pg._get_sequence_number_for_group())
    except (AttributeError, RuntimeError):
        return -1


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tp_decode: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="profile_tp_") as root:
        store = dist.FileStore(os.path.join(root, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            mesh = make_serving_mesh(1)
            print(json.dumps(gather(mesh)), flush=True)
            cfg = get_config("qwen3-1.7b")
            model = Model(cfg, device="cuda", seed=0)
            print(json.dumps(decode(model, cfg, mesh)), flush=True)
            print(json.dumps(gather(mesh)), flush=True)
        finally:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
