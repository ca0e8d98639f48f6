"""GQA attention: the projections, the plain chunked attention, and the
prefill / decode wrappers of the dense serving path; DeepSeek's MLA (its
own section below).

``gqa_prefill``, ``gqa_prefill_cont`` (the tail after a cached prefix) and
``gqa_prefill_chunk`` (one chunk of a chunked prefill) run their attention
through the hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`), and so do an
encoder-decoder prefill's encoder (``gqa_train(..., causal=False,
kernel=True)``) and cross attention (``gqa_cross(..., kernel=True)``) on
the kernel's non-causal route; ``chunked_attention`` is the plain
online-softmax function the JAX package lowers through XLA, kept here for
the token oracle (``transformer.greedy_decode``) and for training
(``gqa_train``, differentiated by autograd: the JAX package has no backward
kernel, and neither has the port).

Tensor-parallel serving passes ``mesh`` (a ``"model"`` ``DeviceMesh``) with
parameters whose ``wq`` / ``wk`` / ``wv`` hold this rank's heads: the
projections give the local heads, the flash kernel attends them
(``ops.flash_attention_sharded``), and ``ops.gather_heads`` joins every
rank's heads before the replicated ``wo``, the JAX package's
``gather_heads=True``.  The K/V returned are the local heads.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from .layers import apply_rope, rmsnorm, rope_cos_sin, spec

NEG_INF = -1e30


def attn_specs(cfg, layers):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": spec((layers, d, H, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": spec((layers, d, K, hd), ("layers", "embed", "kv", "head_dim")),
        "wv": spec((layers, d, K, hd), ("layers", "embed", "kv", "head_dim")),
        "wo": spec((layers, H, hd, d), ("layers", "heads", "head_dim", "embed"),
                   scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        s["q_norm"] = spec((layers, hd), ("layers", "head_dim"), scale=-1.0,
                           dtype=torch.float32)
        s["k_norm"] = spec((layers, hd), ("layers", "head_dim"), scale=-1.0,
                           dtype=torch.float32)
    return s


# --------------------------------------------------------------- core math

def chunked_attention(q, k, v, *, causal, q_offset=0, q_block=1024,
                      kv_block=1024):
    """Online-softmax attention over (q_block × kv_block) tiles.

    q: (B, Sq, H, Dk); k: (B, Skv, Kh, Dk); v: (B, Skv, Kh, Dv) with
    H % Kh == 0.  ``q_offset`` is the absolute position of q[0].
    Returns (B, Sq, H, Dv)."""
    B, Sq0, H, Dk = q.shape
    _, Skv0, Kh, Dv = v.shape
    G = H // Kh
    qb = min(q_block, Sq0)
    kvb = min(kv_block, Skv0)
    # pad ragged tails; padded kv columns are masked out, padded q rows sliced
    pq = (-Sq0) % qb
    pkv = (-Skv0) % kvb
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
    Sq, Skv = Sq0 + pq, Skv0 + pkv
    nq, nkv = Sq // qb, Skv // kvb
    scale = 1.0 / math.sqrt(Dk)
    dev = q.device

    qg = q.reshape(B, nq, qb, Kh, G, Dk)
    ks = k.reshape(B, nkv, kvb, Kh, Dk)
    vs = v.reshape(B, nkv, kvb, Kh, Dv)
    q_pos = q_offset + torch.arange(Sq, device=dev).reshape(nq, qb)
    k_pos = torch.arange(Skv, device=dev).reshape(nkv, kvb)

    outs = []
    for qi in range(nq):
        qblk = qg[:, qi].float()  # (B, qb, Kh, G, Dk)
        m = torch.full((B, Kh, G, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kh, G, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kh, G, qb, Dv), dtype=torch.float32, device=dev)
        for kj in range(nkv):
            kblk, vblk = ks[:, kj], vs[:, kj]
            logits = torch.einsum("bqkgd,btkd->bkgqt", qblk,
                                  kblk.float()) * scale
            mask = k_pos[kj][None, :] < Skv0  # padded kv columns
            if causal:
                mask = mask & (q_pos[qi][:, None] >= k_pos[kj][None, :])
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))  # (B, Kh, G, qb, Dv)
    # (nq, B, Kh, G, qb, Dv) -> (B, Sq, H, Dv)
    out = torch.stack(outs, 0).movedim(0, 1).permute(0, 1, 4, 2, 3, 5)
    return out.reshape(B, Sq, H, Dv)[:, :Sq0]


def decode_attention(q, K, V, kv_len):
    """Single-step decode. q: (B,1,H,Dk); K:(B,T,Kh,Dk); V:(B,T,Kh,Dv);
    kv_len: (B,) number of valid cache entries (including current token)."""
    B, T, Kh, Dk = K.shape
    H = q.shape[2]
    G = H // Kh
    qg = q.reshape(B, 1, Kh, G, Dk)
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(),
                          K.float()) / math.sqrt(Dk)
    valid = torch.arange(T, device=q.device)[None] < kv_len[:, None]  # (B, T)
    logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(V.dtype).float(), V.float())
    return out.reshape(B, 1, H, V.shape[-1]).to(q.dtype)


# ------------------------------------------------------------ GQA wrapper

def _project_qkv(x, p, cfg, positions):
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dke->bske", x, p["wk"])
    v = torch.einsum("bsd,dke->bske", x, p["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _attend(q, k, v, cfg, *, kernel: bool, mesh=None, q_offset: int = 0,
            causal: bool = True):
    """Attention of a prefill's rows (row i at ``q_offset + i``; causal, or
    every row over every key), through the flash kernel or the plain
    chunked attention; under a ``mesh`` over the local heads, then
    gathered across the ranks."""
    if kernel:
        out = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  mesh=mesh)
    else:
        out = chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                q_block=cfg.q_block, kv_block=cfg.kv_block)
    return out if mesh is None else ops.gather_heads(out, mesh)


def gqa_train(x, p, cfg, *, causal=True, kernel: bool = False):
    """Full-sequence self-attention: the plain chunked attention at the
    config's ``q_block`` / ``kv_block`` (training, the oracle), or with
    ``kernel`` the flash kernel (the encoder of an encoder-decoder
    prefill, ``causal=False``)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _attend(q, k, v, cfg, kernel=kernel, causal=causal)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def gqa_prefill(x, p, cfg, *, kernel: bool = True, mesh=None):
    """Causal self-attention over a whole prompt; also returns the K/V to
    serve from.  ``kernel=True`` attends through ``ops.flash_attention``
    (the CUDA kernel on the card); ``kernel=False`` through the plain
    ``chunked_attention`` (the token oracle's path).  ``mesh``: this rank's
    heads, gathered before ``wo`` (module docstring)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    out = _attend(q, k, v, cfg, kernel=kernel, mesh=mesh)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), (k, v)


def gqa_prefill_cont(x, p, cfg, k_pre, v_pre, *, kv_len: int | None = None,
                     kernel: bool = True, mesh=None):
    """Prefill *continuation*: ``x`` holds positions ``[P, P+S)`` of a
    sequence whose first ``P`` positions already have cached K/V
    (``k_pre``/``v_pre``: (B, P, Kh, hd), e.g. gathered from the serving
    pool's shared prefix pages).  Only the tail's Q/K/V are computed; the
    attention runs over ``concat(prefix, tail)`` with ``q_offset=P``, which
    is the mask and the per-row arithmetic of a whole prefill's rows
    ``[P, P+S)`` — the prefix must be *unpadded* so key positions line up.

    ``kv_len``: the key extent the attention sees.  For bit-identity with a
    whole prefill it must be the *full prompt's padded bucket*, the extent
    the whole prefill attends over; the tail K/V is zero-padded (or its pad
    rows cut) to ``kv_len - P``, and every such row is causally masked for
    the real rows.  ``kernel`` and ``mesh`` as in :func:`gqa_prefill`.

    Returns (attn out, (k_tail, v_tail))."""
    B, S, _ = x.shape
    P = k_pre.shape[1]
    positions = P + torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    kt, vt = k, v
    if kv_len is not None:
        ext = kv_len - P
        assert ext >= 1
        if S < ext:   # masked zeros out to the full prompt's bucket
            pad = (0, 0, 0, 0, 0, ext - S)
            kt = torch.nn.functional.pad(kt, pad)
            vt = torch.nn.functional.pad(vt, pad)
        elif S > ext:  # only pad rows (>= plen - P) are cut, all masked
            kt, vt = kt[:, :ext], vt[:, :ext]
    k_cat = torch.cat([k_pre.to(k.dtype), kt], dim=1)
    v_cat = torch.cat([v_pre.to(v.dtype), vt], dim=1)
    out = _attend(q, k_cat, v_cat, cfg, kernel=kernel, mesh=mesh, q_offset=P)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), (k, v)


def gqa_prefill_chunk(x, p, cfg, k_ext, v_ext, pos0: int, *,
                      kernel: bool = True, mesh=None):
    """Prefill continuation at any chunk boundary ``pos0`` (chunked
    prefill).  ``x`` holds positions ``[pos0, pos0 + S)`` of a prompt whose
    earlier chunks' K/V sit in the serving pool; ``k_ext``/``v_ext``
    (B, kv_len, Kh, hd) are the prompt's full padded key extent gathered
    from the pool pages: rows ``< pos0`` are the earlier chunks' values,
    later rows stale pool content that the causal mask hides.

    The fresh chunk K/V are spliced into the extent at ``pos0`` in the
    compute dtype, before any pool round trip, and the rows past ``kv_len``
    (pad rows of a final chunk) are cut.  An extent already in the compute
    dtype is written in place (the engine gathers a fresh one per chunk);
    another dtype is cast to a copy first.  With ``kv_len`` the full
    prompt's padded bucket, each row attends the key extent a whole prefill
    of the prompt attends, so its result is that prefill's row.  ``kernel``
    and ``mesh`` as in :func:`gqa_prefill`.

    Returns (attn out, (k_chunk, v_chunk))."""
    B, S, _ = x.shape
    kv_len = k_ext.shape[1]
    if not 0 <= pos0 < kv_len:
        raise ValueError(f"chunk start {pos0} outside the key extent {kv_len}")
    positions = pos0 + torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    if k_ext.dtype != k.dtype:
        k_ext, v_ext = k_ext.to(k.dtype), v_ext.to(v.dtype)
    n = min(S, kv_len - pos0)
    k_ext[:, pos0:pos0 + n] = k[:, :n]
    v_ext[:, pos0:pos0 + n] = v[:, :n]
    out = _attend(q, k_ext, v_ext, cfg, kernel=kernel, mesh=mesh,
                  q_offset=pos0)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), (k, v)


def gqa_decode(x, p, cfg, cache_k, cache_v, cur_len):
    """One-token decode. x: (B,1,d). cache_[kv]: (B,T,Kh,hd), written in
    place at position cur_len (B,).  Returns the attention output."""
    B = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg, cur_len[:, None])
    rows = torch.arange(B, device=x.device)
    cache_k[rows, cur_len] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, cur_len] = v[:, 0].to(cache_v.dtype)
    out = decode_attention(q, cache_k, cache_v, cur_len + 1)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def gqa_cross(x, p, enc_kv, cfg, *, kernel: bool = False):
    """Cross attention of the decoder's rows onto precomputed encoder K/V
    (:func:`cross_kv`), non-causal; the query has neither rope nor
    ``q_norm``.  ``kernel`` as in :func:`gqa_prefill` (the flash kernel's
    non-causal route), else the plain chunked attention."""
    k, v = enc_kv
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    out = _attend(q, k, v, cfg, kernel=kernel, causal=False)
    return torch.einsum("bshe,hed->bsd", out, p["wo"])


def cross_kv(xe, p):
    """The encoder-side K/V (B, frames, Kh, hd) of cross attention, without
    rope or ``k_norm``."""
    k = torch.einsum("bsd,dke->bske", xe, p["wk"])
    v = torch.einsum("bsd,dke->bske", xe, p["wv"])
    return k, v


# ------------------------------------------------------------------- MLA --
#
# DeepSeek's multi-head latent attention.  Training and prefill attend in
# the decompressed form through the plain ``chunked_attention``: their q·k
# dimension is nope + rope (192 at DeepSeek-V2-Lite) and their v dimension
# 128, a shape no instance of the flash kernel takes (later work: flash at
# Dqk 192 / Dv 128).  The decode scores the latent cache directly (the
# absorbed form), as the JAX package's does.

def _promote(*ts):
    """``ts`` cast to their promoted dtype (JAX's promotion of a mixed
    product, e.g. a bf16 cache's context against f32 weights;
    ``torch.einsum`` takes one dtype)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def mla_specs(cfg, layers):
    d = cfg.d_model
    H = cfg.n_heads
    r = cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": spec((layers, d, H, nd + rd),
                   ("layers", "embed", "heads", "head_dim")),
        "w_dkv": spec((layers, d, r), ("layers", "embed", "lora")),
        "kv_norm": spec((layers, r), ("layers", "lora"), scale=-1.0,
                        dtype=torch.float32),
        "w_kr": spec((layers, d, rd), ("layers", "embed", "head_dim")),
        "w_uk": spec((layers, r, H, nd), ("layers", "lora", "heads", "head_dim")),
        "w_uv": spec((layers, r, H, vd), ("layers", "lora", "heads", "head_dim")),
        "wo": spec((layers, H, vd, d), ("layers", "heads", "head_dim", "embed"),
                   scale=1.0 / math.sqrt(H * vd)),
    }


def _mla_qc(x, p, cfg, positions, kv_mean=None):
    nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    c_kv = rmsnorm(torch.einsum("bsd,dr->bsr", x, p["w_dkv"]), p["kv_norm"],
                   across=kv_mean)
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_kr"])[:, :, None, :]  # 1 shared head
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_full(x, p, cfg, *, kv_mean=None, heads_sum=None):
    """The decompressed attention of a whole sequence: (out, (c_kv,
    k_rope)).  ``kv_mean`` / ``heads_sum``: :func:`mla_train` on a rank."""
    B, S, _ = x.shape
    rd = cfg.qk_rope_dim
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope, c_kv, k_rope = _mla_qc(x, p, cfg, positions, kv_mean)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])
    if heads_sum is not None:
        k_nope, v = heads_sum(k_nope), heads_sum(v)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], rd)], dim=-1)
    out = chunked_attention(q, k, v, causal=True,
                            q_block=cfg.q_block, kv_block=cfg.kv_block)
    return torch.einsum("bshe,hed->bsd", out, p["wo"]), (c_kv, k_rope)


def mla_train(x, p, cfg, *, kv_mean=None, heads_sum=None):
    """Full-sequence MLA (decompressed form; cache-free).

    A rank of the partitioned train step passes ``p`` with its query heads
    (``wq``, ``wo``) and its slice of the latent rank (``w_dkv``,
    ``kv_norm``, and ``w_uk`` / ``w_uv`` on their rank, every head), ``w_kr``
    whole; the result is its heads' partial sum of ``wo``, the caller's to
    sum over the ranks.  ``kv_mean`` takes the latent norm's mean of
    squares over its slice to the whole rank's; ``heads_sum`` takes
    ``k_nope`` / ``v``, partial sums over its slice of the rank, to the
    sums of its query heads."""
    return _mla_full(x, p, cfg, kv_mean=kv_mean, heads_sum=heads_sum)[0]


def mla_prefill(x, p, cfg):
    """MLA prefill returning the latent cache (c_kv (B,S,r), k_rope
    (B,S,rope)): the cache is r + rope wide instead of 2·H·hd."""
    return _mla_full(x, p, cfg)


def mla_decode(x, p, cfg, cache_c, cache_r, cur_len):
    """Absorbed-form MLA decode: score directly against the latent cache.

    cache_c: (B,T,r); cache_r: (B,T,rope), both written in place at
    ``cur_len`` (B,).  The scores are bf16 (or f32) products accumulated in
    f32, the JAX package's ``preferred_element_type``; the probabilities
    are cast to the cache's dtype before the context product.  Returns the
    attention output."""
    B = x.shape[0]
    q_nope, q_rope, c_kv, k_rope = _mla_qc(x, p, cfg, cur_len[:, None])
    rows = torch.arange(B, device=x.device)
    cache_c[rows, cur_len] = c_kv[:, 0].to(cache_c.dtype)
    cache_r[rows, cur_len] = k_rope[:, 0].to(cache_r.dtype)

    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, p["w_uk"])
    logits = (torch.einsum("bqhr,btr->bhqt", q_abs.float(), cache_c.float())
              + torch.einsum("bqhp,btp->bhqt", q_rope.float(),
                             cache_r.float())) * scale
    T = cache_c.shape[1]
    valid = torch.arange(T, device=x.device)[None] < (cur_len + 1)[:, None]
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqt,btr->bqhr", probs.to(cache_c.dtype), cache_c)
    out = torch.einsum("bqhr,rhv->bqhv", *_promote(ctx, p["w_uv"]))
    return torch.einsum("bshe,hed->bsd", *_promote(out, p["wo"]))
