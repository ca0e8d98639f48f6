"""Gradient compression with error feedback — a distributed-optimization
option for bandwidth-bound meshes (int8 quantization or top-k
sparsification).  A port of ``repro.optim.grad``.

Used *around* the cross-replica reduction: compress → all-reduce fewer bytes →
decompress; the residual is fed back into the next step so the compression
bias vanishes in expectation (error-feedback SGD).  Trees are nested
containers of tensors (:mod:`repro_torch.tree`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..tree import tree_map


class EFState(NamedTuple):
    residual: Any  # same tree as grads, f32


def init_error_feedback(params) -> EFState:
    return EFState(tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params))


def quantize_int8(x):
    """Per-tensor symmetric int8 quantization; returns (q, scale).  Rounds
    half to even, as ``jnp.round``."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _is_payload(x):
    return (isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "dtype")
            and x[0].dtype == torch.int8)


def compress_grads_int8(grads, ef: EFState):
    """grads+residual -> (int8 payload tree, new EF state).

    The int8 payload is what crosses the wire (8× fewer bytes than f32);
    the quantization error stays local in the residual.
    """
    payload = tree_map(lambda g, r: quantize_int8(g.float() + r),
                       grads, ef.residual)
    new_res = tree_map(
        lambda qs, g, r: g.float() + r - dequantize_int8(*qs),
        payload, grads, ef.residual, is_leaf=_is_payload)
    return payload, EFState(new_res)


def decompress_grads_int8(payload):
    return tree_map(lambda qs: dequantize_int8(*qs), payload,
                    is_leaf=_is_payload)


def topk_sparsify(x, frac: float):
    """Keep the top-|frac| magnitude entries (flat); returns dense masked x
    (the wire format would be (values, indices) — the dense mask models the
    same information loss)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, 0.0)


def compress_grads_topk(grads, ef: EFState, frac: float = 0.1):
    kept = tree_map(lambda g, r: topk_sparsify(g.float() + r, frac),
                    grads, ef.residual)
    new_res = tree_map(lambda g, r, k: g.float() + r - k,
                       grads, ef.residual, kept)
    return kept, EFState(new_res)
