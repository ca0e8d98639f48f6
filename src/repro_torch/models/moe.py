"""Mixture-of-Experts FFN: top-k routing, grouped sort-based dispatch (a port
of ``repro.models.moe``; the trainer's load-balance loss is not ported).

GShard-style grouping: the T = B·S tokens split into G = gcd(T, moe_groups)
groups of contiguous tokens, and the sort, the position of each pick inside
its expert and the capacity are group-local.  An expert takes at most
``capacity`` picks per group and drops the later ones, so where the capacity
binds the result depends on the grouping, i.e. on T: a caller that wants the
JAX package's tokens calls it at the same shapes (the engine's prompt
bucket, chunk and decode batch).

Where the JAX package ``vmap``s the dispatch over the groups, this module
runs every group in one set of batched tensor ops.  The expert products are
the reference's dense products over all experts, as ``bmm`` over the expert
axis: every call reads every expert's weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import spec, swiglu


def moe_specs(cfg, layers):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {
        "router": spec((layers, d, E), dtype=torch.float32),
        "w_gate": spec((layers, E, d, ff)),
        "w_up": spec((layers, E, d, ff)),
        "w_down": spec((layers, E, ff, d)),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        s["shared_gate"] = spec((layers, d, sff))
        s["shared_up"] = spec((layers, d, sff))
        s["shared_down"] = spec((layers, sff, d))
    return s


def _dispatch_group(xt, top_e, top_p, E, k, capacity):
    """Dispatch of every group at once.  xt: (G, T, d); top_e / top_p:
    (G, T, k).  Returns (gathered (G, E, capacity, d), combine metadata
    ``(st_tok, slot, sw, keep)``, each (G, T·k) in the order of a stable
    sort by expert, as the JAX ``_dispatch_group`` returns them per group)."""
    G, T, d = xt.shape
    dev = xt.device
    flat_e = top_e.reshape(G, T * k)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k).expand(G, -1)
    flat_w = top_p.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st_tok = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    # per-group bincount, as one bincount over (group, expert)
    g_off = torch.arange(G, device=dev)[:, None] * E
    counts = torch.bincount((se + g_off).reshape(-1),
                            minlength=G * E).reshape(G, E)
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(T * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos < capacity
    slot = torch.where(keep, se * capacity + pos, E * capacity)
    # dropped picks all land on the extra last row, which is cut off
    gathered = xt.new_zeros((G, E * capacity + 1, d))
    gathered.scatter_(1, slot[..., None].expand(-1, -1, d),
                      torch.gather(xt, 1, st_tok[..., None].expand(-1, -1, d)))
    return (gathered[:, :-1].reshape(G, E, capacity, d),
            (st_tok, slot, sw, keep))


def _combine_group(y, meta, T):
    """y: (G, E, capacity, d) expert outputs -> (G, T, d).

    The reference's sum, ``zeros.at[st_tok].add(y[slot] · w)``, in a fixed
    order and without atomics: each token's k picks are gathered in the
    sorted order (ascending expert) and added one after another onto zeros
    in the compute dtype, a dropped pick weighing 0.  A scatter-add on CUDA
    would add them in no fixed order, and the bf16 output would not repeat
    bit for bit from run to run."""
    st_tok, slot, sw, keep = meta
    G, E, C, d = y.shape
    k = st_tok.shape[1] // T
    yflat = y.reshape(G, E * C, d)
    contrib = torch.where(keep, sw, 0.0).to(yflat.dtype)
    slot_safe = torch.clamp(slot, max=E * C - 1)
    # each token's picks, in sorted order: a stable sort by token
    by_tok = torch.argsort(st_tok, dim=-1, stable=True)
    tok_slot = torch.gather(slot_safe, 1, by_tok)
    tok_w = torch.gather(contrib, 1, by_tok)
    parts = (torch.gather(yflat, 1, tok_slot[..., None].expand(-1, -1, d))
             * tok_w[..., None]).reshape(G, T, k, d)
    out = torch.zeros((G, T, d), dtype=y.dtype, device=y.device)
    for i in range(k):
        out = out + parts[:, :, i]
    return out


def _route(x, router, cfg, capacity_factor, moe_groups):
    """The grouping and the router of :func:`moe_ffn`: x (B, S, d) as
    (G, Tg, d) groups, each token's top-k f32 probabilities renormalised and
    its experts (G, Tg, k), and the capacity."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = math.gcd(T, moe_groups)
    Tg = T // G
    xg = x.reshape(G, Tg, d)

    logits = xg.float() @ router                       # the router is f32
    probs = torch.softmax(logits, dim=-1)              # (G, Tg, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)        # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ceil + clamp to [1, Tg]: capacity == Tg holds the worst case, so
    # decode-sized groups and no-drop configs never drop.
    capacity = min(Tg, max(1, math.ceil(Tg * k * capacity_factor / E)))
    return xg, top_p, top_e, capacity


def moe_ffn(x, p, cfg, capacity_factor=1.25, moe_groups=32):
    """x: (B, S, d) -> (B, S, d).  Dropping MoE with per-group capacity."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xg, top_p, top_e, capacity = _route(x, p["router"], cfg,
                                           capacity_factor, moe_groups)
    G = xg.shape[0]
    gathered, meta = _dispatch_group(xg, top_e, top_p, E, k, capacity)

    # every expert's products over its (G · capacity) rows
    xe = gathered.transpose(0, 1).reshape(E, G * capacity, d)
    g = torch.bmm(xe, p["w_gate"])
    u = torch.bmm(xe, p["w_up"])
    h = F.silu(g.float()).to(u.dtype) * u
    y = torch.bmm(h, p["w_down"]).reshape(E, G, capacity, d).transpose(0, 1)

    out = _combine_group(y, meta, xg.shape[1]).reshape(B, S, d)

    if cfg.n_shared_experts:
        xt = x.reshape(B * S, d)
        out = out + swiglu(xt, p["shared_gate"], p["shared_up"],
                           p["shared_down"]).reshape(B, S, d)
    return out
