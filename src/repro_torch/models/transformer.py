"""Model assembly for the dense GQA family: parameter specs, the prompt
prefill, and the dense-cache decode that serves as the token oracle.

Parameters keep the JAX package's layout (stacked per-layer leaves with a
leading layers axis; ``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``,
``embed (V, d)``, ``lm_head (d, V)``), and the layer loop is a Python loop
over that axis where the JAX package scans.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import attention as att
from .layers import norm_spec, rmsnorm, spec, sq_relu_mlp, swiglu


def mlp_specs(cfg, layers):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "sq_relu":
        return {"w_up": spec((layers, d, ff)),
                "w_down": spec((layers, ff, d))}
    return {"w_gate": spec((layers, d, ff)),
            "w_up": spec((layers, d, ff)),
            "w_down": spec((layers, ff, d))}


def model_specs(cfg):
    if cfg.family != "dense":
        raise ValueError(f"the port runs the dense family, not {cfg.family!r}")
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    s = {"embed": spec((V, d), scale=0.02), "final_norm": norm_spec(d)}
    if not cfg.tie_embeddings:
        s["lm_head"] = spec((d, V), scale=1.0 / math.sqrt(d))
    s["blocks"] = {"ln1": norm_spec(d, L), "ln2": norm_spec(d, L),
                   "attn": att.attn_specs(cfg, L), "mlp": mlp_specs(cfg, L)}
    return s


def layer(blocks, i: int):
    """The ``i``-th layer's slice of the stacked block parameters."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _block_mlp(h, p, cfg):
    if cfg.mlp_act == "sq_relu":
        return sq_relu_mlp(h, p["w_up"], p["w_down"])
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _embed(params, tokens):
    return params["embed"][tokens]


def _unembed(params, x, cfg):
    x = rmsnorm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def prefill(params, tokens, cfg, max_len, *, cache_dtype=torch.bfloat16,
            true_len=None, kernel: bool = True):
    """Run the whole prompt; return (last-position logits, K/V cache).

    ``tokens`` (B, S) may be right-padded to a bucket: causal masking makes
    the pad invisible to positions < ``true_len``, and the logits are read
    at ``true_len - 1``.  The cache holds K and V (L, B, max_len, Kh, hd)
    in ``cache_dtype`` and ``cur_len`` (B,).  ``kernel`` selects the flash
    kernel (the engine) or the plain chunked attention (the oracle)."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        a, (k, v) = att.gqa_prefill(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                                    kernel=kernel)
        x = x + a
        x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
        ks.append(F.pad(k, (0, 0, 0, 0, 0, max_len - S)).to(cache_dtype))
        vs.append(F.pad(v, (0, 0, 0, 0, 0, max_len - S)).to(cache_dtype))
    n = S if true_len is None else int(true_len)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "cur_len": torch.full((B,), n, dtype=torch.int32,
                                   device=tokens.device)}
    logits = _unembed(params, x[:, n - 1:n], cfg)[:, 0]
    return logits, cache


def decode_step(params, cache, token, cfg):
    """One greedy decode step on plain functions.  token: (B,) int32 (the
    *current* token); returns (logits (B, V), cache).  The cache's K/V are
    written in place and ``cur_len`` advances."""
    cur = cache["cur_len"]
    x = _embed(params, token[:, None])
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        x = x + att.gqa_decode(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                               cache["k"][i], cache["v"][i], cur)
        x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
    logits = _unembed(params, x, cfg)[:, 0]
    cache["cur_len"] = cur + 1
    return logits, cache


def greedy_decode(params, prompt, cfg, max_new_tokens, *, stop_token=None,
                  cache_dtype=torch.bfloat16):
    """Stop-aware dense-cache greedy decode on plain functions: the token
    oracle of the paged engine (which never calls it).

    Returns the emitted token list — the prefill's last-position argmax
    first, then one token per :func:`decode_step` — truncated at (and
    including) the first ``stop_token``, else after ``max_new_tokens``."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    max_len = len(prompt) + max_new_tokens + 1
    logits, cache = prefill(params, toks, cfg, max_len,
                            cache_dtype=cache_dtype, kernel=False)
    out = [int(torch.argmax(logits[0]))]
    while len(out) < max_new_tokens and (stop_token is None
                                         or out[-1] != stop_token):
        logits, cache = decode_step(
            params, cache, torch.tensor([out[-1]], dtype=torch.int64,
                                        device=dev), cfg)
        out.append(int(torch.argmax(logits[0])))
    return out
