"""Primitive layers and the parameter-spec machinery.

Parameters are declared as ``Spec`` leaves (shape, dtype, logical axes,
init scale) in the same nested-dict layout as the JAX package
(``repro.models.layers``), so a JAX parameter tree maps onto the port's
leaf by leaf (see :mod:`repro_torch.bridge`).  The logical axes (one name
per dim: "embed", "vocab", "heads", "kv", "head_dim", "ff", "experts",
"layers", "lora", or None) are the JAX call sites' own, and
:mod:`repro_torch.distributed.sharding` resolves them to mesh axes.  The
primitives keep the JAX package's dtype casts: norms, rotary embedding and
the gate nonlinearity run in float32 and cast back to the activation dtype.
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
    axes: tuple   # logical axis names, len == len(shape)
    scale: float  # stddev for normal init; 0 ⇒ zeros; -1 ⇒ ones


def spec(shape, axes=None, scale=None, dtype=torch.bfloat16):
    """A leaf's spec; ``axes`` None names no dim (every dim replicates)."""
    axes = (None,) * len(shape) if axes is None else tuple(axes)
    assert len(shape) == len(axes), (shape, axes)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[-1] if len(shape) else 1)
    return Spec(tuple(int(s) for s in shape), dtype, axes, float(scale))


def norm_spec(dim, layers=None):
    shape = (layers, dim) if layers else (dim,)
    axes = ("layers", "embed") if layers else ("embed",)
    return Spec(shape, torch.float32, axes, -1.0)


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


def abstract_params(specs):
    """The spec tree as ``meta`` tensors: shapes and dtypes, no storage (a
    checkpoint restore's template)."""
    return unflatten((path, torch.empty(s.shape, dtype=s.dtype, device="meta"))
                     for path, s in flatten(specs))


def logical_axes(specs):
    """The spec tree's logical axes: a tuple of names per leaf."""
    return unflatten((path, s.axes) for path, s in flatten(specs))


# ---------------------------------------------------------------- primitives

def rmsnorm(x, w, eps=1e-6, *, across=None):
    """RMS norm over the last dim, in f32.  ``across``: where that dim is
    cut over ranks (``x`` and ``w`` this rank's equal slice of it), a
    function taking this rank's mean of squares to the mean over every
    rank's, the whole dim's."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    if across is not None:
        var = across(var)
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


def softmax_cross_entropy(logits, labels, mask=None):
    """logits (..., V) any float dtype; labels int; mean NLL in f32 over the
    unmasked positions.

    The label logit is picked with a gather, which is exact on one device;
    the JAX function's iota-mask reduction exists for a vocabulary sharded
    over a mesh (:func:`token_nll`), and would build a (..., V) iota here.
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_nll(logits, labels, *, vocab_start: int = 0, vocab_sum=None,
              vocab_max=None):
    """Each position's NLL in f32 by the JAX function's iota-mask reduction,
    for logits (..., V_local) holding vocabulary rows ``vocab_start`` on
    (the partitioned train step's vocab-parallel loss): the label's logit
    is the sum of the logits whose vocabulary position equals it, so a
    rank whose slice lacks the label adds 0.  ``vocab_max`` / ``vocab_sum``
    take a (...,) value to its max / sum over the vocabulary's slices (None:
    the whole vocabulary is here); the max is a constant of the backward."""
    lf = logits.float()
    m = lf.detach().amax(-1)
    if vocab_max is not None:
        m = vocab_max(m)
    se = torch.exp(lf - m[..., None]).sum(-1)
    pos = torch.arange(vocab_start, vocab_start + lf.shape[-1],
                       device=lf.device)
    ll = torch.where(pos == labels[..., None], lf, 0.0).sum(-1)
    if vocab_sum is not None:
        se, ll = vocab_sum(torch.stack([se, ll])).unbind(0)
    return m + torch.log(se) - ll
