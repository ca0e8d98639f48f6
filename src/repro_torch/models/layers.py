"""Primitive layers and the parameter-spec machinery.

Parameters are declared as ``Spec`` leaves (shape, dtype, init scale) in the
same nested-dict layout as the JAX package (``repro.models.layers``), so a
JAX parameter tree maps onto the port's leaf by leaf (see
:mod:`repro_torch.bridge`).  The primitives keep the JAX package's dtype
casts: norms, rotary embedding and the gate nonlinearity run in float32 and
cast back to the activation dtype.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..device import resolve_device


class Spec(NamedTuple):
    shape: tuple
    dtype: Any
    scale: float  # stddev for normal init; 0 ⇒ zeros; -1 ⇒ ones


def spec(shape, scale=None, dtype=torch.bfloat16):
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-1] if len(shape) else 1)
    return Spec(tuple(int(s) for s in shape), dtype, float(scale))


def norm_spec(dim, layers=None):
    shape = (layers, dim) if layers else (dim,)
    return Spec(shape, torch.float32, -1.0)


def flatten(tree, prefix=()):
    """Leaves of a nested dict as ``(path tuple, leaf)``, keys sorted (the
    order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def unflatten(items):
    """Inverse of :func:`flatten`: ``(path tuple, leaf)`` pairs → nested dict."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# A leaf of at least this many elements is drawn one slice of its leading
# (layers) axis at a time: drawn whole in float32, one of Qwen3-30B-A3B's
# expert leaves (9.66 G elements) would not fit beside its bf16 result on
# an 80 GB card.  Every leaf of the dense configs the tests and the chip
# run draw lies below it (the largest, qwen3-1.7b's w_gate, holds 352 M),
# so those are drawn whole.
SLICED_DRAW_ELEMENTS = 1 << 30


def init_params(specs, generator: torch.Generator, *, device=None):
    """Materialize a spec tree: N(0, scale²) drawn in float32 from
    ``generator`` and cast to each leaf's dtype (zeros / ones for the
    sentinel scales).  A leaf of ``SLICED_DRAW_ELEMENTS`` or more is drawn
    slice by slice of its leading axis, so the draw holds one slice's
    float32 at a time.  ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    out = []
    for path, s in flatten(specs):
        if s.scale == 0.0:
            t = torch.zeros(s.shape, dtype=s.dtype, device=dev)
        elif s.scale == -1.0:
            t = torch.ones(s.shape, dtype=s.dtype, device=dev)
        elif math.prod(s.shape) >= SLICED_DRAW_ELEMENTS:
            t = torch.empty(s.shape, dtype=s.dtype, device=dev)
            for i in range(s.shape[0]):
                t[i].copy_(torch.randn(s.shape[1:], generator=generator,
                                       device=dev, dtype=torch.float32)
                           .mul_(s.scale))
        else:
            t = (torch.randn(s.shape, generator=generator, device=dev,
                             dtype=torch.float32) * s.scale).to(s.dtype)
        out.append((path, t))
    return unflatten(out)


# ---------------------------------------------------------------- primitives

def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_cos_sin(positions, dim, theta):
    """positions: (...,) int; returns cos/sin of shape (..., dim//2), f32."""
    half = dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., dim); rotate-half convention; cos/sin broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g.float()).to(x.dtype) * u) @ w_down


def sq_relu_mlp(x, w_up, w_down):
    """Squared-ReLU MLP (nemotron-4)."""
    h = torch.square(torch.relu((x @ w_up).float())).to(x.dtype)
    return h @ w_down
