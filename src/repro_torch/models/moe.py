"""Mixture-of-Experts FFN: top-k routing, grouped sort-based dispatch, and
the trainer's load-balance loss (a port of ``repro.models.moe``).

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

**On a mesh** a rank holds its rows of the global batch, and the JAX
program's groups are the global batch's, cut over the batch's ranks: a
rank runs its contiguous share of them (:func:`rank_groups`), each of the
global group's tokens at the global capacity, so it computes what the
JAX program's device computes.  A rank of the partitioned train step
(``distributed.partition``, experts over "model") calls :func:`moe_ffn`
with ``experts=``: its ``w_*`` and ``router`` leaves hold those experts
only, ``whole_logits`` gathers the router's logits over the expert dim (the
softmax and top-k run over all of them, as the JAX program's do), the
dispatch keeps this rank's experts' picks, the products run on them alone,
and the combine is their partial sum, the caller's to sum over the ranks.
Its shared experts' leaves hold its columns of their ff, so their output
is a partial sum too, added to the combine's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import spec, swiglu


def moe_specs(cfg, layers):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {
        "router": spec((layers, d, E), ("layers", "embed", "experts"),
                       dtype=torch.float32),
        "w_gate": spec((layers, E, d, ff), ("layers", "experts", "embed", "ff")),
        "w_up": spec((layers, E, d, ff), ("layers", "experts", "embed", "ff")),
        "w_down": spec((layers, E, ff, d), ("layers", "experts", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        s["shared_gate"] = spec((layers, d, sff), ("layers", "embed", "ff"))
        s["shared_up"] = spec((layers, d, sff), ("layers", "embed", "ff"))
        s["shared_down"] = spec((layers, sff, d), ("layers", "ff", "embed"))
    return s


def _count(idx, n: int):
    """``torch.bincount(idx, minlength=n)`` for ``idx`` in ``[0, n)``: the
    int64 count of each value, as a scatter-add into ``n`` zeros, so its
    length is ``n`` by construction (``bincount``'s depends on the data, and
    it has no ``meta`` kernel).  Integer sums, so the order of the adds
    changes nothing."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def rank_groups(tokens: int, moe_groups: int, ranks: int,
                name: str = "moe") -> int:
    """The dispatch groups of one of ``ranks`` batch ranks: the global
    batch of ``tokens`` tokens makes ``G = gcd(tokens, moe_groups)``
    groups of contiguous tokens, and each rank's rows are ``G / ranks`` of
    them.  Raises ``ValueError`` naming ``name`` where G does not divide
    over the ranks (a rank would cut a group)."""
    G = math.gcd(tokens, moe_groups)
    if G % ranks:
        raise ValueError(f"{name}: the {tokens} tokens' {G} dispatch groups "
                         f"do not divide over {ranks} batch ranks")
    return G // ranks


def _dispatch_group(xt, top_e, top_p, E, k, capacity, *, experts=None):
    """Dispatch of every group at once.  xt: (G, T, d); top_e / top_p:
    (G, T, k).  Returns (gathered (G, E, capacity, d), combine metadata
    ``(st_tok, slot, sw, keep)``, each (G, T·k) in the order of a stable
    sort by expert, as the JAX ``_dispatch_group`` returns them per group).
    With ``experts`` (a slice of the E) only those experts' rows are
    gathered, (G, len, capacity, d), and only their kept picks are kept,
    their slots counted from the slice's first expert."""
    G, T, d = xt.shape
    dev = xt.device
    flat_e = top_e.reshape(G, T * k)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k).expand(G, -1)
    flat_w = top_p.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st_tok = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    # per-group bincount, as one count over (group, expert) of fixed length
    g_off = torch.arange(G, device=dev)[:, None] * E
    counts = _count((se + g_off).reshape(-1), G * E).reshape(G, E)
    starts = torch.cumsum(counts, 1) - counts
    pos = torch.arange(T * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos < capacity
    if experts is not None:
        keep = keep & (se >= experts.start) & (se < experts.stop)
        se = se - experts.start
        E = experts.stop - experts.start
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


def _route(x, router, cfg, capacity_factor, moe_groups, whole_logits=None):
    """The grouping and the router of :func:`moe_ffn`: x (B, S, d) as
    (G, Tg, d) groups, each token's top-k f32 probabilities renormalised and
    its experts (G, Tg, k), and the capacity.  ``whole_logits`` takes the
    logits of the experts ``router`` holds to those of all E."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = math.gcd(T, moe_groups)
    Tg = T // G
    xg = x.reshape(G, Tg, d)

    logits = xg.float() @ router                       # the router is f32
    if whole_logits is not None:
        logits = whole_logits(logits)
    probs = torch.softmax(logits, dim=-1)              # (G, Tg, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)        # (G, Tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ceil + clamp to [1, Tg]: capacity == Tg holds the worst case, so
    # decode-sized groups and no-drop configs never drop.
    capacity = min(Tg, max(1, math.ceil(Tg * k * capacity_factor / E)))
    return xg, top_p, top_e, capacity


def moe_ffn(x, p, cfg, capacity_factor=1.25, moe_groups=32, *,
            experts=None, whole_logits=None):
    """x: (B, S, d) -> (B, S, d).  Dropping MoE with per-group capacity.

    ``experts`` (a slice of the E): ``p``'s routed leaves hold only those
    experts (``router`` their columns, ``w_*`` their rows), and the result
    is their picks' partial sum (module docstring); ``whole_logits`` takes
    the router's logits of those experts to all E's."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xg, top_p, top_e, capacity = _route(x, p["router"], cfg,
                                        capacity_factor, moe_groups,
                                        whole_logits)
    G = xg.shape[0]
    kw = {} if experts is None else {"experts": experts}
    gathered, meta = _dispatch_group(xg, top_e, top_p, E, k, capacity, **kw)
    E = gathered.shape[1]

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


def aux_load_balance_loss(x, p, cfg):
    """Switch-style auxiliary load-balance loss (used by the trainer)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.topk(probs, cfg.top_k, dim=-1).indices
    E = cfg.n_experts
    frac_tokens = (_count(top_e.reshape(-1), E).float()
                   / (B * S * cfg.top_k))
    frac_probs = probs.mean(dim=0)
    return E * torch.sum(frac_tokens * frac_probs)
