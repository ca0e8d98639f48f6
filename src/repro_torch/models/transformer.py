"""Model assembly: parameter specs, the training forward, the prompt
prefill and the dense-cache decode, one implementation parameterized by
``ModelConfig.family``:

  dense    — GQA attention + MLP                        (qwen3, granite, yi,
                                                         nemotron, internvl2)
  moe      — GQA attention + top-k MoE (:mod:`.moe`)    (qwen3-moe)
  mla_moe  — DeepSeek MLA + (shared + routed) MoE       (deepseek-v2-lite)
  ssm      — Mamba2 / SSD (:mod:`.ssm`)                 (mamba2-1.3b)
  hybrid   — Mamba2 backbone + a weight-tied shared attention block after
             every ``attn_period`` layers               (zamba2-7b)
  encdec   — non-causal encoder over precomputed frame embeddings +
             decoder (causal self + cross attention)    (whisper)

InternVL2's stub vision frontend prepends its precomputed patch embeddings,
projected by ``vision_proj``, to the text rows (``extras["patches"]``);
Whisper's encoder reads ``extras["frames"]``.

The paged serving engine runs dense and moe, through the prefill of a whole
prompt, of the tail after a cached prefix and of one chunk of it; every
family runs :func:`forward` (training), :func:`prefill`, :func:`decode_step`
over the contiguous cache of :func:`init_cache` and :func:`greedy_decode`
(the token oracle).  The VLM's prefill serves text only: the reference's
prefill with patches builds a cache its decode misreads (:func:`prefill`).

Parameters keep the JAX package's layout (stacked per-layer leaves with a
leading layers axis; ``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``,
``embed (V, d)``, ``lm_head (d, V)``; the hybrid's ``shared_attn`` with a
leading 1-sized layers axis), and the layer loop is a Python loop over that
axis where the JAX package scans.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import attention as att
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (flatten, norm_spec, rmsnorm, spec, sq_relu_mlp, swiglu,
                     unflatten)

FAMILIES = ("dense", "moe", "mla_moe", "ssm", "hybrid", "encdec")
VISION_DIM = 1024  # stub vision-frontend embedding width (internvl2)


def mlp_specs(cfg, layers):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "sq_relu":
        return {"w_up": spec((layers, d, ff), ("layers", "embed", "ff")),
                "w_down": spec((layers, ff, d), ("layers", "ff", "embed"))}
    return {"w_gate": spec((layers, d, ff), ("layers", "embed", "ff")),
            "w_up": spec((layers, d, ff), ("layers", "embed", "ff")),
            "w_down": spec((layers, ff, d), ("layers", "ff", "embed"))}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


def model_specs(cfg):
    _check_family(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    s = {"embed": spec((V, d), ("vocab", "embed"), scale=0.02),
         "final_norm": norm_spec(d)}
    if not cfg.tie_embeddings:
        s["lm_head"] = spec((d, V), ("embed", "vocab"),
                            scale=1.0 / math.sqrt(d))
    if cfg.n_patches:
        s["vision_proj"] = spec((VISION_DIM, d), (None, "embed"))
    fam = cfg.family
    if fam == "encdec":
        Le = cfg.n_enc_layers
        s["enc_blocks"] = {"ln1": norm_spec(d, Le), "ln2": norm_spec(d, Le),
                           "attn": att.attn_specs(cfg, Le),
                           "mlp": mlp_specs(cfg, Le)}
        s["blocks"] = {"ln1": norm_spec(d, L), "ln2": norm_spec(d, L),
                       "ln3": norm_spec(d, L),
                       "attn": att.attn_specs(cfg, L),
                       "cross": att.attn_specs(cfg, L),
                       "mlp": mlp_specs(cfg, L)}
    elif fam in ("dense", "moe", "mla_moe"):
        s["blocks"] = {"ln1": norm_spec(d, L), "ln2": norm_spec(d, L),
                       "attn": (att.mla_specs(cfg, L) if fam == "mla_moe"
                                else att.attn_specs(cfg, L)),
                       "mlp": (mlp_specs(cfg, L) if fam == "dense"
                               else moe_mod.moe_specs(cfg, L))}
    else:  # ssm, hybrid
        s["blocks"] = {"ln": norm_spec(d, L), "ssm": ssm_mod.ssm_specs(cfg, L)}
        if fam == "hybrid":
            s["shared_attn"] = {"ln1": norm_spec(d, 1), "ln2": norm_spec(d, 1),
                                "attn": att.attn_specs(cfg, 1),
                                "mlp": mlp_specs(cfg, 1)}
    return s


def layer(blocks, i: int):
    """The ``i``-th layer's slice of the stacked block parameters."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _mlp(h, p, cfg):
    if cfg.mlp_act == "sq_relu":
        return sq_relu_mlp(h, p["w_up"], p["w_down"])
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _block_mlp(h, p, cfg):
    if cfg.family in ("moe", "mla_moe"):
        return moe_mod.moe_ffn(h, p, cfg, cfg.capacity_factor, cfg.moe_groups)
    return _mlp(h, p, cfg)


def _embed(params, tokens, cfg=None, extras=None):
    """The token embeddings (B, S, d); for the VLM with ``extras["patches"]``
    (B, n_patches, VISION_DIM) their projection first: (B, n_patches + S,
    d)."""
    x = params["embed"][tokens]
    if (cfg is not None and cfg.n_patches and extras is not None
            and "patches" in extras):
        vis = torch.matmul(*att._promote(extras["patches"],
                                         params["vision_proj"]))
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    return x


def _frames(extras, x):
    """The encoder's input, ``extras["frames"]`` (B, n_frames, d) in the
    residual stream's dtype."""
    if extras is None or "frames" not in extras:
        raise ValueError("encdec: extras must hold the encoder's 'frames'")
    return extras["frames"].to(x.dtype)


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
    attn = att.mla_train if cfg.family == "mla_moe" else functools.partial(
        att.gqa_train, causal=True)
    x = x + attn(rmsnorm(x, lp["ln1"]), lp["attn"], cfg)
    return x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)


def _ssm_block(x, lp, cfg):
    return x + ssm_mod.mamba2_seq(rmsnorm(x, lp["ln"]), lp["ssm"], cfg)


def _shared_attn_block(x, sq, cfg):
    """Zamba2's weight-tied attention + MLP block; ``sq`` is the one layer
    of ``shared_attn``."""
    x = x + att.gqa_train(rmsnorm(x, sq["ln1"]), sq["attn"], cfg, causal=True)
    return x + _mlp(rmsnorm(x, sq["ln2"]), sq["mlp"], cfg)


def _enc_block(x, lp, cfg, kernel: bool = False):
    """An encoder layer: non-causal self-attention (the flash kernel with
    ``kernel``, else the plain chunked attention) and the MLP."""
    x = x + att.gqa_train(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                          causal=False, kernel=kernel)
    return x + _mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)


def _dec_block(x, lp, xe, cfg):
    """A decoder layer of training: causal self-attention, cross attention
    onto the encoder's output ``xe``, the MLP."""
    x = x + att.gqa_train(rmsnorm(x, lp["ln1"]), lp["attn"], cfg, causal=True)
    x = x + att.gqa_cross(rmsnorm(x, lp["ln2"]), lp["cross"],
                          att.cross_kv(xe, lp["cross"]), cfg)
    return x + _mlp(rmsnorm(x, lp["ln3"]), lp["mlp"], cfg)


def _shared_attn(params, cfg):
    """The hybrid's one layer of ``shared_attn``; None for other families."""
    return layer(params["shared_attn"], 0) if cfg.family == "hybrid" else None


def _hybrid_split(cfg):
    """The shared attention after each group of ``attn_period`` SSM layers:
    (groups, period, tail), e.g. 13 groups of 6 and a tail of 3 at 81."""
    g = cfg.attn_period
    n_groups = cfg.n_layers // g
    return n_groups, g, cfg.n_layers - n_groups * g


def _ssm_order(cfg):
    """The SSM families' blocks in order: ``("ssm", layer)``, and for the
    hybrid ``("attn", group)`` after each group."""
    if cfg.family == "ssm":
        yield from (("ssm", i) for i in range(cfg.n_layers))
        return
    n_groups, g, _ = _hybrid_split(cfg)
    for gi in range(n_groups):
        for j in range(g):
            yield "ssm", gi * g + j
        yield "attn", gi
    for i in range(n_groups * g, cfg.n_layers):
        yield "ssm", i


def forward(params, tokens, cfg, extras=None, part=None):
    """Training/scoring forward: tokens (B, S) -> logits (B, S[+patches],
    V), through autograd when the params require grad.  ``extras``:
    ``"frames"`` (B, n_frames, d) for the encoder-decoder (required),
    ``"patches"`` (B, n_patches, VISION_DIM) for the VLM (optional; their
    rows come first).  ``part``: a ``distributed.partition.Partition``,
    this rank's part of the partitioned train step
    (:func:`partitioned_forward`; every family but the encoder-decoder and
    the VLM with patches)."""
    _check_family(cfg)
    if part is not None:
        return partitioned_forward(params, tokens, cfg, part)
    x = _embed(params, tokens, cfg, extras)
    layers = unstack_layers(params["blocks"], cfg.n_layers)
    if cfg.family == "encdec":
        xe = _frames(extras, x)
        enc = _maybe_remat(functools.partial(_enc_block, cfg=cfg), cfg)
        for lp in unstack_layers(params["enc_blocks"], cfg.n_enc_layers):
            xe = enc(xe, lp)
        dec = _maybe_remat(functools.partial(_dec_block, cfg=cfg), cfg)
        for lp in layers:
            x = dec(x, lp, xe)
        return _unembed(params, x, cfg)
    if cfg.family in ("dense", "moe", "mla_moe"):
        block = _maybe_remat(functools.partial(_train_block, cfg=cfg), cfg)
        for lp in layers:
            x = block(x, lp)
        return _unembed(params, x, cfg)
    block = _maybe_remat(functools.partial(_ssm_block, cfg=cfg), cfg)
    sq = _shared_attn(params, cfg)
    for kind, i in _ssm_order(cfg):
        x = (block(x, layers[i]) if kind == "ssm"
             else _shared_attn_block(x, sq, cfg))
    return _unembed(params, x, cfg)


# ------------------------------------------- the partitioned train step

def _tp_block(x, lp, cfg, part, stack: str = "blocks"):
    """A dense, MoE or MLA-MoE layer on the partitioned route (or, with
    ``stack="shared_attn"``, the hybrid's shared block): ``x`` is this
    rank's positions of the residual stream, ``lp`` the layer's views of
    this rank's shards, gathered here for the layer.  The attention and the
    MLP run over the whole sequence on this rank's heads and columns (the
    MoE FFN on its experts and its shared experts' columns), and their
    partial outputs go back to this rank's positions."""
    w = part.layer(lp, stack)
    h = part.enter(rmsnorm(x, w["ln1"]))
    if cfg.family == "mla_moe":
        a = att.mla_train(h, w["attn"], cfg, **part.mla_args())
    else:
        a = att.gqa_train(h, w["attn"], cfg, causal=True)
    x = x + part.leave(a, part.heads_cut)
    h = part.enter(rmsnorm(x, w["ln2"]))
    if cfg.family in ("moe", "mla_moe"):
        return x + part.leave(moe_mod.moe_ffn(
            h, w["mlp"], cfg, cfg.capacity_factor, cfg.moe_groups,
            **part.moe_args()), part.experts_cut)
    return x + part.leave(_mlp(h, w["mlp"], cfg), part.ff_cut)


def _tp_ssm_block(x, lp, cfg, part):
    """An SSM layer on the partitioned route: the block's input gathered
    along the sequence, the scan on this rank's heads over the whole
    sequence, ``out_proj``'s partial sums back to this rank's positions."""
    w = part.layer(lp)
    h = part.enter(rmsnorm(x, w["ln"]))
    y = ssm_mod.mamba2_seq(h, w["ssm"], cfg, **part.ssm_args())
    return x + part.leave(y, part.channels_cut)


def _tp_embed(params, tokens, part):
    """This rank's positions of the embeddings: a vocab-parallel lookup
    (the rows outside its vocabulary slice masked, the partial rows
    reduce-scattered onto the sequence), or, over a whole vocabulary, the
    lookup of its own positions."""
    w = part.weight(params, "embed")
    if not part.vocab_cut:
        return w[tokens[:, part.seq_slice(tokens.shape[1])]]
    ids = tokens - part.vocab.start
    inside = (ids >= 0) & (ids < w.shape[0])
    x = w[ids.clamp(0, w.shape[0] - 1)].masked_fill(~inside[..., None], 0)
    return part.leave(x, True)


def _tp_unembed(params, x, cfg, part):
    """The logits of this rank's vocabulary slice at every position, or,
    over a whole vocabulary, of the whole vocabulary at its positions."""
    x = rmsnorm(x, part.weight(params, "final_norm"))
    if part.vocab_cut:
        x = part.enter(x)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, part.weight(params, "embed"))
    return x @ part.weight(params, "lm_head")


def partitioned_forward(params, tokens, cfg, part):
    """The forward as one rank of the partitioned train step
    (``distributed.partition``; every family but the encoder-decoder and
    the VLM with patches): ``params`` this rank's shards, ``tokens`` its
    rows; the logits are (B, S, V / |model|) where "model" cuts the
    vocabulary, else (B, S / |model|, V).  Each layer's FSDP weights are
    gathered for it and kept by autograd as their shards (``part.hooks``);
    the hybrid's shared block gathers its weights at each use, and autograd
    sums their gradient over the uses."""
    x = _tp_embed(params, tokens, part)
    layers = unstack_layers(params["blocks"], cfg.n_layers)
    with part.hooks:
        if cfg.family in ("dense", "moe", "mla_moe"):
            block = _maybe_remat(functools.partial(_tp_block, cfg=cfg,
                                                   part=part), cfg)
            for lp in layers:
                x = block(x, lp)
        else:
            block = _maybe_remat(functools.partial(_tp_ssm_block, cfg=cfg,
                                                   part=part), cfg)
            shared = functools.partial(_tp_block, cfg=cfg, part=part,
                                       stack="shared_attn")
            sq = _shared_attn(params, cfg)
            for kind, i in _ssm_order(cfg):
                x = block(x, layers[i]) if kind == "ssm" else shared(x, sq)
        return _tp_unembed(params, x, cfg, part)


# ------------------------------------------------------------- the cache

def cache_spec(cfg, batch, max_len, dtype=torch.bfloat16) -> dict:
    """``{name: (shape, dtype)}`` of the contiguous decode cache: K / V
    (layers, batch, max_len, kv heads, hd) for dense and moe; the latent
    ``c`` (layers, batch, max_len, kv_lora_rank) and ``r`` (..., rope) for
    mla_moe; for ssm and hybrid the f32 ``state`` (layers, batch, heads,
    head_dim, state) and the conv windows ``conv_x`` / ``conv_bc``
    (layers, batch, CONV_K - 1, ...) in ``dtype``, and for hybrid K / V per
    group of layers; for encdec the decoder's K / V and the cross
    attention's encoder-side ``xk`` / ``xv`` (layers, batch, n_frames, kv
    heads, hd); ``cur_len`` (batch,) int32."""
    _check_family(cfg)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    di = cfg.ssm_expand * cfg.d_model
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    fam = cfg.family
    out = {}
    if fam in ("dense", "moe", "encdec"):
        out["k"] = out["v"] = ((L, batch, max_len, K, hd), dtype)
        if fam == "encdec":
            out["xk"] = out["xv"] = ((L, batch, cfg.n_frames, K, hd), dtype)
    elif fam == "mla_moe":
        out["c"] = ((L, batch, max_len, cfg.kv_lora_rank), dtype)
        out["r"] = ((L, batch, max_len, cfg.qk_rope_dim), dtype)
    else:
        out["state"] = ((L, batch, H, P, N), torch.float32)
        out["conv_x"] = ((L, batch, ssm_mod.CONV_K - 1, di), dtype)
        out["conv_bc"] = ((L, batch, ssm_mod.CONV_K - 1, 2 * N), dtype)
        if fam == "hybrid":
            n_groups = _hybrid_split(cfg)[0]
            out["k"] = out["v"] = ((n_groups, batch, max_len, K, hd), dtype)
    out["cur_len"] = ((batch,), torch.int32)
    return out


def cache_axes(cfg) -> dict:
    """The logical axes of each leaf of :func:`cache_spec` (the JAX
    ``cache_spec``'s second result): K / V and the cross attention's
    ``xk`` / ``xv`` ("layers", "batch", "seq_kv", "kv", "head_dim"), MLA's
    latent over "lora", the SSM state over "heads", the conv windows over
    "ff", ``cur_len`` over "batch"."""
    _check_family(cfg)
    kv = ("layers", "batch", "seq_kv", "kv", "head_dim")
    fam = cfg.family
    out = {}
    if fam in ("dense", "moe", "encdec"):
        out["k"] = out["v"] = kv
        if fam == "encdec":
            out["xk"] = out["xv"] = kv
    elif fam == "mla_moe":
        out["c"] = ("layers", "batch", "seq_kv", "lora")
        out["r"] = ("layers", "batch", "seq_kv", None)
    else:
        out["state"] = ("layers", "batch", "heads", None, None)
        out["conv_x"] = out["conv_bc"] = ("layers", "batch", None, "ff")
        if fam == "hybrid":
            out["k"] = out["v"] = kv
    out["cur_len"] = ("batch",)
    return out


def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, *, device=None):
    """A zeroed cache of :func:`cache_spec` on ``device`` (default: the
    CPU, as ``torch.zeros``)."""
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in cache_spec(cfg, batch, max_len,
                                                dtype).items()}


# --------------------------------------------------------------- prefill

def prefill(params, tokens, cfg, max_len, extras=None, *,
            cache_dtype=torch.bfloat16, true_len=None, kernel: bool = True,
            mesh=None):
    """Run the whole prompt; return (last-position logits, the decode
    cache of :func:`cache_spec`).  ``extras``: the encoder-decoder's
    ``"frames"``; the encoder runs first, and each decoder layer keeps its
    cross attention's ``xk`` / ``xv`` in the cache dtype.

    The VLM's ``"patches"`` raise: the reference's prefill measures the
    cache and ``cur_len`` by the text tokens while it embeds n_patches +
    S rows, so its decode would write over a text row at a rope position
    n_patches short.  The text-only prefill is the dense one.

    For the attention families ``tokens`` (B, S) may be right-padded to a
    bucket: causal masking makes the pad invisible to positions <
    ``true_len``, and the logits are read at ``true_len - 1``.  The SSM
    families take the unpadded prompt (their recurrent state would absorb
    pad tokens), so for them ``true_len`` must be S or None.  ``kernel``
    selects the flash kernel (the engine; the hybrid's shared attention)
    or the plain chunked attention (the oracle), for the encoder and the
    cross attention on the kernel's non-causal route; MLA attends through
    the plain chunked attention either way (``attention`` module).  ``mesh``:
    tensor-parallel serving of dense and moe, the attention parameters and
    the returned K/V being this rank's heads (``attention`` module)."""
    _check_family(cfg)
    fam = cfg.family
    B, S = tokens.shape
    if fam in ("ssm", "hybrid") and true_len not in (None, S):
        raise ValueError(f"{fam}: prefill takes the unpadded prompt "
                         f"(true_len {true_len}, {S} tokens)")
    if mesh is not None and fam not in ("dense", "moe"):
        raise ValueError(f"{fam}: no tensor-parallel prefill")
    if cfg.n_patches and extras is not None and "patches" in extras:
        raise ValueError(
            f"{cfg.name}: prefill serves text only; with patches the "
            f"reference's cache holds {S} positions of {cfg.n_patches + S} "
            f"embedded rows and its decode misplaces them")
    x = _embed(params, tokens)

    def pad(t):  # (B, S, ...) -> (B, max_len, ...) in the cache dtype
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, max_len - S)).to(
            cache_dtype)

    cols: dict = {}

    def keep(**kw):
        for name, t in kw.items():
            cols.setdefault(name, []).append(t)

    if fam == "encdec":
        xe = _frames(extras, x)
        for i in range(cfg.n_enc_layers):
            xe = _enc_block(xe, layer(params["enc_blocks"], i), cfg,
                            kernel=kernel)
        for i in range(cfg.n_layers):
            lp = layer(params["blocks"], i)
            a, (k, v) = att.gqa_prefill(rmsnorm(x, lp["ln1"]), lp["attn"],
                                        cfg, kernel=kernel)
            x = x + a
            xk, xv = att.cross_kv(xe, lp["cross"])
            x = x + att.gqa_cross(rmsnorm(x, lp["ln2"]), lp["cross"],
                                  (xk, xv), cfg, kernel=kernel)
            x = x + _mlp(rmsnorm(x, lp["ln3"]), lp["mlp"], cfg)
            keep(k=pad(k), v=pad(v), xk=xk.to(cache_dtype),
                 xv=xv.to(cache_dtype))
    elif fam in ("dense", "moe", "mla_moe"):
        for i in range(cfg.n_layers):
            lp = layer(params["blocks"], i)
            h = rmsnorm(x, lp["ln1"])
            if fam == "mla_moe":
                a, (c, r) = att.mla_prefill(h, lp["attn"], cfg)
                keep(c=pad(c), r=pad(r))
            else:
                a, (k, v) = att.gqa_prefill(h, lp["attn"], cfg,
                                            kernel=kernel, mesh=mesh)
                keep(k=pad(k), v=pad(v))
            x = x + a
            x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
    else:
        sq = _shared_attn(params, cfg)
        for kind, i in _ssm_order(cfg):
            if kind == "ssm":
                lp = layer(params["blocks"], i)
                y, st, (cx, cbc) = ssm_mod.mamba2_seq(
                    rmsnorm(x, lp["ln"]), lp["ssm"], cfg, return_state=True)
                x = x + y
                keep(state=st, conv_x=cx.to(cache_dtype),
                     conv_bc=cbc.to(cache_dtype))
            else:
                a, (k, v) = att.gqa_prefill(rmsnorm(x, sq["ln1"]),
                                            sq["attn"], cfg, kernel=kernel)
                x = x + a
                x = x + _mlp(rmsnorm(x, sq["ln2"]), sq["mlp"], cfg)
                keep(k=pad(k), v=pad(v))
    n = S if true_len is None else int(true_len)
    cache = {name: torch.stack(ts) for name, ts in cols.items()}
    cache["cur_len"] = torch.full((B,), n, dtype=torch.int32,
                                  device=tokens.device)
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
    into its own pages.  ``mesh`` as in :func:`prefill`.  The paged
    engine's families only (dense, moe)."""
    assert cfg.family in ("dense", "moe"), cfg.family
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
    into the chunk's pages.  ``mesh`` as in :func:`prefill`.  The paged
    engine's families only (dense, moe)."""
    assert cfg.family in ("dense", "moe"), cfg.family
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


def _ssm_decode(x, lp, cfg, cache, i: int):
    """Layer ``i``'s SSM block on one token; its cache rows are written in
    place."""
    y, st, (cx, cbc) = ssm_mod.mamba2_decode(
        rmsnorm(x, lp["ln"]), lp["ssm"], cfg, cache["state"][i],
        (cache["conv_x"][i], cache["conv_bc"][i]))
    cache["state"][i] = st
    cache["conv_x"][i] = cx
    cache["conv_bc"][i] = cbc
    return x + y


def decode_step(params, cache, token, cfg):
    """One greedy decode step on plain functions.  token: (B,) int32 (the
    *current* token); returns (logits (B, V), cache).  The cache (of
    :func:`cache_spec`) is written in place and ``cur_len`` advances."""
    _check_family(cfg)
    fam = cfg.family
    cur = cache["cur_len"]
    x = _embed(params, token[:, None])
    if fam == "encdec":
        B = token.shape[0]
        for i in range(cfg.n_layers):
            lp = layer(params["blocks"], i)
            x = x + att.gqa_decode(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                                   cache["k"][i], cache["v"][i], cur)
            # cross attention over the cached (rounded) encoder K/V, every
            # frame valid
            xk, xv = cache["xk"][i], cache["xv"][i]
            q = torch.einsum("bsd,dhe->bshe", rmsnorm(x, lp["ln2"]),
                             lp["cross"]["wq"])
            c = att.decode_attention(
                q, xk, xv, torch.full((B,), xk.shape[1], dtype=torch.int32,
                                      device=x.device))
            x = x + torch.einsum("bshe,hed->bsd", c, lp["cross"]["wo"])
            x = x + _mlp(rmsnorm(x, lp["ln3"]), lp["mlp"], cfg)
    elif fam in ("dense", "moe", "mla_moe"):
        for i in range(cfg.n_layers):
            lp = layer(params["blocks"], i)
            h = rmsnorm(x, lp["ln1"])
            if fam == "mla_moe":
                x = x + att.mla_decode(h, lp["attn"], cfg, cache["c"][i],
                                       cache["r"][i], cur)
            else:
                x = x + att.gqa_decode(h, lp["attn"], cfg, cache["k"][i],
                                       cache["v"][i], cur)
            x = x + _block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
    else:
        sq = _shared_attn(params, cfg)
        for kind, i in _ssm_order(cfg):
            if kind == "ssm":
                x = _ssm_decode(x, layer(params["blocks"], i), cfg, cache, i)
            else:
                x = x + att.gqa_decode(rmsnorm(x, sq["ln1"]), sq["attn"], cfg,
                                       cache["k"][i], cache["v"][i], cur)
                x = x + _mlp(rmsnorm(x, sq["ln2"]), sq["mlp"], cfg)
    logits = _unembed(params, x, cfg)[:, 0]
    cache["cur_len"] = cur + 1
    return logits, cache


def greedy_decode(params, prompt, cfg, max_new_tokens, *, stop_token=None,
                  extras=None, cache_dtype=torch.bfloat16):
    """Stop-aware dense-cache greedy decode on plain functions: the token
    oracle of the paged engine (which never calls it).

    Returns the emitted token list — the prefill's last-position argmax
    first, then one token per :func:`decode_step` — truncated at (and
    including) the first ``stop_token``, else after ``max_new_tokens``.
    ``extras`` as in :func:`prefill` (a batch of one)."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    max_len = len(prompt) + max_new_tokens + 1
    logits, cache = prefill(params, toks, cfg, max_len, extras,
                            cache_dtype=cache_dtype, kernel=False)
    out = [int(torch.argmax(logits[0]))]
    while len(out) < max_new_tokens and (stop_token is None
                                         or out[-1] != stop_token):
        logits, cache = decode_step(
            params, cache, torch.tensor([out[-1]], dtype=torch.int64,
                                        device=dev), cfg)
        out.append(int(torch.argmax(logits[0])))
    return out
