"""Model assembly for the GQA families the engine serves, dense and MoE
(a top-k routed FFN, :mod:`.moe`, in place of the dense MLP): parameter
specs, the training forward, the prompt prefill (whole, the tail after a
cached prefix, or one chunk of it), and the dense-cache decode that serves
as the token oracle.

Parameters keep the JAX package's layout (stacked per-layer leaves with a
leading layers axis; ``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``,
``embed (V, d)``, ``lm_head (d, V)``), and the layer loop is a Python loop
over that axis where the JAX package scans.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import attention as att
from . import moe as moe_mod
from .layers import (flatten, norm_spec, rmsnorm, spec, sq_relu_mlp, swiglu,
                     unflatten)


def mlp_specs(cfg, layers):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "sq_relu":
        return {"w_up": spec((layers, d, ff)),
                "w_down": spec((layers, ff, d))}
    return {"w_gate": spec((layers, d, ff)),
            "w_up": spec((layers, d, ff)),
            "w_down": spec((layers, ff, d))}


def model_specs(cfg):
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the port runs the dense and moe families, not "
                         f"{cfg.family!r}")
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    s = {"embed": spec((V, d), scale=0.02), "final_norm": norm_spec(d)}
    if not cfg.tie_embeddings:
        s["lm_head"] = spec((d, V), scale=1.0 / math.sqrt(d))
    s["blocks"] = {"ln1": norm_spec(d, L), "ln2": norm_spec(d, L),
                   "attn": att.attn_specs(cfg, L),
                   "mlp": (moe_mod.moe_specs(cfg, L) if cfg.family == "moe"
                           else mlp_specs(cfg, L))}
    return s


def layer(blocks, i: int):
    """The ``i``-th layer's slice of the stacked block parameters."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _block_mlp(h, p, cfg):
    if cfg.family == "moe":
        return moe_mod.moe_ffn(h, p, cfg, cfg.capacity_factor, cfg.moe_groups)
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


# ------------------------------------------------------- remat policy

def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpoint policy of ``remat="dots"``, JAX's
    ``dots_with_no_batch_dims_saveable``: keep the outputs of products
    without batch dims (the projections and the MLP, which reach aten as
    ``mm`` / ``addmm`` or as a ``bmm`` over one batch) and recompute the
    rest, the attention's batched products included."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg):
    """``fn`` with the config's activation checkpointing: ``"none"``,
    ``"full"`` (recompute the whole block in the backward) or ``"dots"``
    (recompute all but the products without batch dims)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=ctx)
    raise ValueError(cfg.remat)


# --------------------------------------------------------------- forwards

def unstack_layers(blocks, n_layers: int) -> list:
    """Per-layer views of the stacked block parameters, one ``unbind`` per
    leaf: autograd then stacks the layers' gradients into each leaf's
    gradient once, where slicing a layer out of the leaf per layer would
    scatter every layer's gradient into a zeroed leaf-sized buffer."""
    per = [(path, t.unbind(0)) for path, t in flatten(blocks)]
    return [unflatten((path, ts[i]) for path, ts in per)
            for i in range(n_layers)]


def _train_block(x, lp, cfg):
    x = x + att.gqa_train(rmsnorm(x, lp["ln1"]), lp["attn"], cfg, causal=True)
    return x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)


def forward(params, tokens, cfg, extras=None):
    """Training/scoring forward: tokens (B, S) -> logits (B, S, V), through
    autograd when the params require grad.  The dense and moe families; the
    others come with ROADMAP item 15.  (``extras`` feeds the VLM and
    encoder-decoder families only, which the port has not.)"""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"the port's forward runs the dense and moe families; "
            f"{cfg.family!r} comes with ROADMAP item 15")
    x = _embed(params, tokens)
    block = _maybe_remat(functools.partial(_train_block, cfg=cfg), cfg)
    for lp in unstack_layers(params["blocks"], cfg.n_layers):
        x = block(x, lp)
    return _unembed(params, x, cfg)


def prefill(params, tokens, cfg, max_len, *, cache_dtype=torch.bfloat16,
            true_len=None, kernel: bool = True, mesh=None):
    """Run the whole prompt; return (last-position logits, K/V cache).

    ``tokens`` (B, S) may be right-padded to a bucket: causal masking makes
    the pad invisible to positions < ``true_len``, and the logits are read
    at ``true_len - 1``.  The cache holds K and V (L, B, max_len, Kh, hd)
    in ``cache_dtype`` and ``cur_len`` (B,).  ``kernel`` selects the flash
    kernel (the engine) or the plain chunked attention (the oracle).
    ``mesh``: tensor-parallel serving, the attention parameters and the
    returned K/V being this rank's heads (``attention`` module)."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        a, (k, v) = att.gqa_prefill(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                                    kernel=kernel, mesh=mesh)
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


def prefill_with_prefix(params, tokens, cfg, prefix_k, prefix_v, max_len, *,
                        true_len=None, kv_len=None,
                        cache_dtype=torch.bfloat16, kernel: bool = True,
                        mesh=None):
    """Tail-only prefill over cached prefix K/V (the prefix-cache hit path).

    ``tokens`` (B, S) is the *uncached tail* of the prompt (right-padded to
    its bucket, true length ``true_len``); ``prefix_k``/``prefix_v``
    (L, B, P, Kh, hd) hold the first ``P`` positions' K/V, e.g. gathered
    from the serving pool's shared prefix pages.  Row for row this computes
    what :func:`prefill`'s positions ``[P, P+true_len)`` compute, through
    :func:`attention.gqa_prefill_cont`; ``kv_len`` must be the *full
    prompt's* padded bucket for the attention to see the same key extent.

    Returns (last-tail-position logits, K tail cache (L, B, max_len, Kh,
    hd), V tail cache) — only the tail's K/V, for the engine to scatter
    into its own pages.  ``mesh`` as in :func:`prefill`."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        a, (k, v) = att.gqa_prefill_cont(rmsnorm(x, lp["ln1"]), lp["attn"],
                                         cfg, prefix_k[i], prefix_v[i],
                                         kv_len=kv_len, kernel=kernel,
                                         mesh=mesh)
        x = x + a
        x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
        ks.append(F.pad(k, (0, 0, 0, 0, 0, max_len - S)).to(cache_dtype))
        vs.append(F.pad(v, (0, 0, 0, 0, 0, max_len - S)).to(cache_dtype))
    n = S if true_len is None else int(true_len)
    logits = _unembed(params, x[:, n - 1:n], cfg)[:, 0]
    return logits, torch.stack(ks), torch.stack(vs)


def prefill_chunk(params, tokens, cfg, ext_k, ext_v, pos0: int,
                  last_idx: int | None, *, kernel: bool = True, mesh=None):
    """One fixed-size chunk of a prompt prefill (chunked prefill):
    :func:`prefill_with_prefix` generalized from a continuation at a cached
    prefix boundary to one at any chunk boundary.

    ``tokens`` (B, S) is one chunk of the prompt starting at absolute
    position ``pos0`` (the last chunk right-padded past the prompt end).
    ``ext_k``/``ext_v`` (L, B, kv_len, Kh, hd) are the prompt's full padded
    key extent, gathered from the serving pool once for all layers: rows
    ``< pos0`` hold the earlier chunks' K/V, later rows are stale and
    causally masked.  Each layer writes its fresh chunk K/V into its rows
    (:func:`attention.gqa_prefill_chunk`), in place when the extent has the
    compute dtype (otherwise the extent is cast once, here), and attends
    its layer's view of the buffer as it lies.

    Returns (the logits of row ``last_idx`` — the prompt's last token, on
    the final chunk; None when ``last_idx`` is None —, k_chunk (L, B, S,
    Kh, hd), v_chunk): only this chunk's K/V, for the engine to scatter
    into the chunk's pages.  ``mesh`` as in :func:`prefill`."""
    x = _embed(params, tokens)
    if ext_k.dtype != x.dtype:
        ext_k, ext_v = ext_k.to(x.dtype), ext_v.to(x.dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["blocks"], i)
        a, (k, v) = att.gqa_prefill_chunk(rmsnorm(x, lp["ln1"]), lp["attn"],
                                          cfg, ext_k[i], ext_v[i], pos0,
                                          kernel=kernel, mesh=mesh)
        x = x + a
        x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
        ks.append(k)
        vs.append(v)
    logits = (None if last_idx is None else
              _unembed(params, x[:, last_idx:last_idx + 1], cfg)[:, 0])
    return logits, torch.stack(ks), torch.stack(vs)


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
