"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth of one CUDA kernel, written in
the most obvious gather / O(S²) form and following
``repro.kernels.ref`` line for line.  The wrappers in :mod:`.ops` take them
for CPU tensors; ``chip_smoke.py`` holds every kernel against them on the
card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Naive softmax attention with GQA head-group broadcast.

    q: (B, Sq, H, D); k/v: (B, Skv, Kh, D) with H % Kh == 0.
    Returns (B, Sq, H, D) in q.dtype; softmax math in f32.
    """
    B, Sq, H, D = q.shape
    _, Skv, Kh, _ = k.shape
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, D)
    logits = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float())
    logits = logits / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_tables, seq_lens):
    """Decode attention over a paged KV pool.

    q: (B, H, D) — one query token per sequence.
    k_pool/v_pool: (num_pages, T, Kh, D) — the log-structured slab pool.
    block_tables: (B, P) int32 — physical page id of each logical page
                  (entries beyond the sequence's pages may be arbitrary).
    seq_lens: (B,) int32 — valid KV tokens per sequence.
    Returns (B, H, D).
    """
    B, H, D = q.shape
    _, T, Kh, _ = k_pool.shape
    P = block_tables.shape[1]
    G = H // Kh
    bt = block_tables.long()
    k_seq = k_pool[bt].reshape(B, P * T, Kh, D)
    v_seq = v_pool[bt].reshape(B, P * T, Kh, D)
    qg = q.reshape(B, Kh, G, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_seq.float())
    logits = logits / math.sqrt(D)
    valid = (torch.arange(P * T, device=q.device)[None]
             < seq_lens.to(q.device)[:, None])
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_seq.dtype).float(),
                       v_seq.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_split_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                              n_split: int = 8):
    """The CUDA kernel's split-KV schedule, in plain PyTorch; only the tests
    use it.  Arguments and result as :func:`paged_attention_ref`.

    Logical page j of a sequence goes to split ``j % n_split``.  Each split
    takes the partial (m, l, acc) of its live tokens: m their max logit, l
    the sum and acc the p-weighted sum of V under that max.  The partials
    are combined in split order under their common max, with the TPU
    kernel's guards: a split with no live token (m = -inf) adds nothing and
    l is floored at 1e-30, so a zero-length sequence gives zeros (where the
    dense softmax of :func:`paged_attention_ref` gives the mean of V).
    Softmax math in f32, p kept in f32 as in the kernel.
    """
    B, H, D = q.shape
    _, T, Kh, _ = k_pool.shape
    P = block_tables.shape[1]
    G = H // Kh
    bt = block_tables.long()
    qg = q.reshape(B, Kh, G, D).float()
    lens = seq_lens.to(q.device).long()
    valid = (torch.arange(P * T, device=q.device).view(P, T)[None]
             < lens[:, None, None])                               # (B, P, T)
    parts = []
    for r in range(min(n_split, P)):
        pages = torch.arange(r, P, n_split, device=q.device)
        k = k_pool[bt[:, pages]].float().flatten(1, 2)            # (B, n*T, Kh, D)
        v = v_pool[bt[:, pages]].float().flatten(1, 2)
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(D)
        s = torch.where(valid[:, pages].flatten(1)[:, None, None], s, -math.inf)
        m = s.amax(-1)
        p = torch.where(m[..., None] == -math.inf, 0.0,
                        torch.exp(s - m[..., None]))
        parts.append((m, p.sum(-1), torch.einsum("bkgt,btkd->bkgd", p, v)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros(B, Kh, G, D, device=q.device)
    for m, l_r, acc_r in parts:
        f = torch.where(m == -math.inf, 0.0, torch.exp(m - M))
        l = l + f * l_r
        acc = acc + f[..., None] * acc_r
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def segment_compact_ref(pool, src_idx):
    """The cleaner's data path: relocate live blocks into fresh slabs.

    pool: (N, E) block payloads; src_idx: (M,) int32 source block per
    destination slot.  Returns (M, E) = pool[src_idx].
    """
    return pool[src_idx.long()]


def segment_move_ref(pools, src, dst):
    """The compaction move of the paged engine, in place: for each pool
    (L, n_pages, ...), ``pool[:, dst] = pool[:, src]``, the sources gathered
    (a copy) before any destination is written, so a destination that is
    another move's source receives the old content.

    pools: (K, V); src / dst: (M,) page ids (a tensor or a sequence).
    """
    for p in pools:
        s = torch.as_tensor(src, dtype=torch.long, device=p.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=p.device)
        p[:, d] = p[:, s].clone()


def mdc_priority_ref(live, up2, u_now, S):
    """Paper §5.1.3 declining-cost key, fixed-size pages (see core.policies).

    live: (N,) live-page counts; up2: (N,) penultimate-update clocks;
    u_now: scalar clock; S: pages per segment.  Returns the (N,) f32 key,
    smaller = cleaned earlier: -1 for an empty segment, +inf for a full one.
    All arithmetic in f32, in the JAX reference's order.
    """
    C = live.float()
    A = float(S) - C
    u = torch.tensor(u_now, dtype=torch.float32).item()  # u_now rounded to f32
    interval = torch.clamp(u - up2.float(), min=1.0)
    r = C / torch.clamp(A, min=1e-12)
    decline = torch.where(A > 0, r * r / (torch.clamp(C, min=1.0) * interval),
                          math.inf)
    return torch.where(C == 0, -1.0, decline)
