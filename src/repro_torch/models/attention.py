"""GQA attention: the projections, the plain chunked attention, and the
prefill / decode wrappers of the dense serving path.

``gqa_prefill`` runs its attention through the hand-written flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`); ``chunked_attention`` is
the plain online-softmax function the JAX package lowers through XLA, kept
here for the token oracle (``transformer.greedy_decode``).
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
        "wq": spec((layers, d, H, hd)),
        "wk": spec((layers, d, K, hd)),
        "wv": spec((layers, d, K, hd)),
        "wo": spec((layers, H, hd, d), scale=1.0 / math.sqrt(H * hd)),
    }
    if cfg.qk_norm:
        s["q_norm"] = spec((layers, hd), scale=-1.0, dtype=torch.float32)
        s["k_norm"] = spec((layers, hd), scale=-1.0, dtype=torch.float32)
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


def gqa_prefill(x, p, cfg, *, kernel: bool = True):
    """Causal self-attention over a whole prompt; also returns the K/V to
    serve from.  ``kernel=True`` attends through ``ops.flash_attention``
    (the CUDA kernel on the card); ``kernel=False`` through the plain
    ``chunked_attention`` (the token oracle's path)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(x, p, cfg, positions)
    if kernel:
        out = ops.flash_attention(q, k, v, causal=True)
    else:
        out = chunked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                kv_block=cfg.kv_block)
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
