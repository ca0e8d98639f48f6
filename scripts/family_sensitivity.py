#!/usr/bin/env python3
"""How far rounding alone moves the logits of the MLA-MoE, SSM, hybrid and
encoder-decoder families and of yi-34b at full width, by depth, on one
CUDA card.

    python3 scripts/family_sensitivity.py [arch ...]

Each architecture (default: mamba2-1.3b, zamba2-7b, deepseek-v2-lite-16b,
whisper-medium; also yi-34b, the dense arch the yi phase serves, whose
f32 weights fit the card up to 16 of its 60 layers; DeepSeek at the
capacity factor that drops nothing, E /
top_k; Whisper with both stacks cut to the depth and 1,500 frame embeddings
drawn from the seed) at full width from random weights drawn from a seed,
cut to a few depths.  Per depth: one 256-token prompt through
``transformer.prefill`` and 16 ``decode_step``s fed the true next tokens,
against ``forward`` over prompt and fed tokens, in bf16 (bf16 cache) and
with the same weights in f32 (f32 cache); and f32 ``forward`` again with
its embeddings (and frames) perturbed by 1e-7 relative.  Where the f32
decode's gap to forward is about the perturbed forward's, the two paths
compute one function and the gap is the stack's amplification of rounding;
``chip_smoke.py``'s families and encdec phases hold decode to forward at
the depth where that amplification stays below the logits' margins
(``FAMILY_F32_LAYERS``, ``ENCDEC_F32_LAYERS``).

Prints the card's name and power limit, then one JSON line per depth:
max |difference| and top-1 agreement of bf16 decode vs bf16 forward, f32
decode vs f32 forward, perturbed vs unperturbed f32 forward, and bf16
forward vs f32 forward.  Measurement only: nothing here is asserted.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.layers import flatten, unflatten  # noqa: E402

S, N_DECODE, PERTURB, SEED = 256, 16, 1e-7, 0
DEPTHS = {"mamba2-1.3b": (4, 8, 16, 48), "zamba2-7b": (7, 13, 25, 49, 81),
          "deepseek-v2-lite-16b": (4, 8, 16, 27),
          "whisper-medium": (1, 2, 3, 4, 8, 24), "yi-34b": (1, 2, 4, 8, 16)}


def run(params, cfg, toks, cache_dtype, extras=None):
    ex = (None if extras is None
          else {k: v.to(params["embed"].dtype) for k, v in extras.items()})
    full = tfm.forward(params, toks, cfg, ex)[:, S:].float()
    _, cache = tfm.prefill(params, toks[:, :S], cfg, S + N_DECODE + 1, ex,
                           cache_dtype=cache_dtype)
    steps = []
    for j in range(N_DECODE):
        lg, cache = tfm.decode_step(params, cache, toks[:, S + j], cfg)
        steps.append(lg.float())
    return full, torch.stack(steps, 1)


def apart(a, b) -> dict:
    return {"max_abs": float((a - b).abs().max()),
            "top1_agree": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("family_sensitivity: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with torch.no_grad():
        for arch in sys.argv[1:] or [a for a in DEPTHS if a != "yi-34b"]:
            base = get_config(arch)
            if base.n_experts:
                base = base.with_(capacity_factor=base.n_experts / base.top_k)
            for L in DEPTHS[arch]:
                cfg = base.with_(n_layers=L)
                extras = None
                if cfg.family == "encdec":
                    cfg = cfg.with_(n_enc_layers=L)
                    g = torch.Generator(device="cuda").manual_seed(SEED)
                    extras = {"frames": torch.randn(
                        2, cfg.n_frames, cfg.d_model, generator=g,
                        device="cuda")}
                p = Model(cfg, params={}).init(SEED, device="cuda")
                toks = torch.from_numpy(np.random.default_rng(SEED).integers(
                    0, cfg.vocab_size, (2, S + N_DECODE))).cuda()
                fb, db = run(p, cfg, toks, torch.bfloat16, extras)
                items = list(flatten(p))  # to f32 a leaf at a time
                del p
                for i, (k, t) in enumerate(items):
                    items[i] = (k, t.float())
                del t
                p = unflatten(items)
                del items
                torch.cuda.empty_cache()
                f32, d32 = run(p, cfg, toks, torch.float32, extras)
                g = torch.Generator(device="cuda").manual_seed(SEED + 1)

                def nudge(t):
                    return t * (1 + PERTURB * torch.randn(
                        t.shape, generator=g, device="cuda"))

                p["embed"] = nudge(p["embed"])
                if extras is not None:
                    extras = {k: nudge(v) for k, v in extras.items()}
                moved = tfm.forward(p, toks, cfg, extras)[:, S:].float()
                print(json.dumps({
                    "arch": arch, "n_layers": L,
                    **({"n_enc_layers": L} if extras is not None else {}),
                    "logits_max_abs": float(f32.abs().max()),
                    "bf16_decode_vs_forward": apart(db, fb),
                    "f32_decode_vs_forward": apart(d32, f32),
                    "f32_forward_perturbed": apart(moved, f32),
                    "bf16_forward_vs_f32_forward": apart(fb, f32)}),
                    flush=True)
                del p, fb, db, f32, d32, moved
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
