#!/usr/bin/env python3
"""Where a full-width training step's time goes, on one CUDA card.

    python3 scripts/profile_train.py

qwen3-1.7b at full width (random bf16 weights from a seed), the trainer's
step as ``launch.train.train`` runs it: ``Model.loss`` on a batch of the
synthetic stream (B 2 x S 1,024), ``torch.autograd.grad``, the in-place
AdamW update with the JAX trainer's settings.  Windows:

* split — per step, CUDA events between the forward, the backward and the
          update, and the host's wall to the loss on the host; the median of
          the steps after the first, with deterministic algorithms on (as
          ``chip_smoke.py``'s train phase runs) and then off;
* kernels — one step under ``torch.profiler``: the device's busy time, the
          launches, the kernels with the most device time, against the
          unprofiled step's wall;
* snapshot — the checkpoint manager's host copy of the params and the
          moments (``checkpoint.manager.flatten_tree``), seconds and GB/s.

Prints the card's name and power limit, then one JSON line per window.
Measurement only: nothing here is asserted.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))
# before the first cuBLAS handle: deterministic algorithms need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from profile_engine import kernel_table  # noqa: E402
from repro_torch.checkpoint.manager import flatten_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.optim.schedule import cosine_with_warmup  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH, B, S, STEPS, SEED = "qwen3-1.7b", 2, 1024, 6, 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(ARCH)
    model = Model(cfg, params={})
    params = model.init(SEED, device="cuda")
    for t in leaves(params):
        t.requires_grad_(True)
    opt = AdamW(lr=cosine_with_warmup(3e-4, 10, 2 * STEPS + 1), b2=0.95,
                weight_decay=0.1, clip_norm=1.0)
    state = opt.init(params)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=S,
                               global_batch=B, seed=SEED)

    def step():
        nonlocal state
        batch = {"tokens": torch.as_tensor(next(stream)["tokens"],
                                           device="cuda")}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        loss = model.loss(params, batch)
        ev[1].record()
        grads = list(torch.autograd.grad(loss, leaves(params)))
        ev[2].record()
        _, state = opt.update(params, grads, state)
        ev[3].record()
        loss = float(loss.detach())
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        return {"wall_ms": wall * 1e3, "forward_ms": ev[0].elapsed_time(ev[1]),
                "backward_ms": ev[1].elapsed_time(ev[2]),
                "adamw_ms": ev[2].elapsed_time(ev[3]), "loss": loss}

    n_params = model.n_params()
    flops = 6 * n_params * B * S + 6 * B * S * S * cfg.n_heads * cfg.hd \
        * cfg.n_layers
    walls = {}
    for deterministic in (True, False):
        torch.use_deterministic_algorithms(deterministic)
        torch.cuda.reset_peak_memory_stats()
        rows = [step() for _ in range(STEPS)]
        med = {k: statistics.median(r[k] for r in rows[1:])
               for k in ("wall_ms", "forward_ms", "backward_ms", "adamw_ms")}
        walls[deterministic] = med["wall_ms"]
        emit({"window": "split", "deterministic": deterministic,
              "model": ARCH, "batch": B, "seq_len": S, "n_params": n_params,
              "first_step_ms": rows[0]["wall_ms"], **med,
              "device_ms": med["forward_ms"] + med["backward_ms"]
              + med["adamw_ms"],
              "tokens_per_s": B * S / med["wall_ms"] * 1e3,
              "share_of_bf16_peak": flops / (med["wall_ms"] / 1e3) / 989e12,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated() / 1e9,
              "losses": [r["loss"] for r in rows]})

    torch.use_deterministic_algorithms(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    emit({"window": "kernels", "deterministic": True,
          **kernel_table(prof, walls[True], 1)})

    tree = {"params": params, "opt_state": state}
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
    t0 = time.perf_counter()
    flatten_tree(tree)
    dt = time.perf_counter() - t0
    emit({"window": "snapshot", "gb": n_bytes / 1e9, "seconds": dt,
          "gb_per_s": n_bytes / 1e9 / dt})


if __name__ == "__main__":
    main()
