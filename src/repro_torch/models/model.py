"""The model as an ``nn.Module`` holding its parameters at the JAX package's
layout, the training loss, and the dry-run's ``meta`` stand-ins for the
parameters (:meth:`Model.abstract`) and the inputs (:func:`input_specs`)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import transformer as tfm
from .layers import (abstract_params, flatten, init_params, logical_axes,
                     softmax_cross_entropy, token_nll, unflatten)


class Model(nn.Module):
    """Holds one parameter tree (nested dict, the JAX layout) as frozen
    ``nn.Parameter``s named by their path (``"blocks/attn/wq"``).

    ``params`` given (e.g. from :func:`repro_torch.bridge.params_from_jax`)
    are taken as they are, on their own device; otherwise the tree is drawn
    from ``torch.Generator(device).manual_seed(seed)``.  ``device=None``
    means the CUDA card and raises without one.

    The serving parameters stay frozen: no serving path builds an autograd
    graph.  Training holds its own leaves with ``requires_grad`` and passes
    them to :meth:`loss` / :meth:`forward`, the JAX ``Model``'s functional
    signatures; its model is ``Model(cfg, params={})``, which holds none."""

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = self.init(seed, device=device)
        for path, t in flatten(params):
            self.register_parameter("/".join(path),
                                    nn.Parameter(t, requires_grad=False))

    @property
    def params(self) -> dict:
        """The parameter tree as nested dicts (views of the module's
        parameters, so ``.to()`` and ``state_dict()`` stay in step)."""
        return unflatten((tuple(name.split("/")), p)
                         for name, p in self.named_parameters())

    def init(self, seed: int = 0, *, device=None) -> dict:
        """A fresh parameter tree drawn from
        ``torch.Generator(device).manual_seed(seed)`` (the module keeps
        none of it)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_params(tfm.model_specs(self.cfg), gen, device=dev)

    def abstract(self) -> dict:
        """The configuration's parameter tree as ``meta`` tensors (shapes
        and dtypes, no storage), whatever the module holds."""
        return abstract_params(tfm.model_specs(self.cfg))

    def axes(self) -> dict:
        """The logical axes of every parameter (the JAX ``Model.axes()``):
        a tuple of names per leaf, in the parameter tree's layout."""
        return logical_axes(tfm.model_specs(self.cfg))

    def n_params(self) -> int:
        """Parameters of the configuration, counted from its spec tree (a
        rank's sharded model counts them whole, as the JAX ``Model``)."""
        return sum(math.prod(s.shape)
                   for _, s in flatten(tfm.model_specs(self.cfg)))

    def n_active_params(self) -> int:
        """Active params per token (MoE and MLA-MoE discount inactive
        experts): the routed experts' ``w_*`` leaves count ``top_k`` of
        ``n_experts``; the shared experts and the router count whole."""
        cfg = self.cfg
        total = self.n_params()
        if not cfg.n_experts:
            return total
        expert = sum(math.prod(s.shape) for k, s in
                     tfm.model_specs(cfg)["blocks"]["mlp"].items()
                     if k.startswith("w_"))
        return total - expert + expert * cfg.top_k // cfg.n_experts

    def greedy_decode(self, prompt, max_new_tokens, **kw):
        return tfm.greedy_decode(self.params, prompt, self.cfg,
                                 max_new_tokens, **kw)

    # -- the contiguous decode cache ----------------------------------------
    def prefill(self, params, tokens, max_len, extras=None, **kw):
        """:func:`transformer.prefill` (the JAX ``Model.prefill``'s
        signature; ``kw``: ``cache_dtype``, ``true_len``, ``kernel``)."""
        return tfm.prefill(params, tokens, self.cfg, max_len, extras, **kw)

    def decode_step(self, params, cache, token):
        return tfm.decode_step(params, cache, token, self.cfg)

    def init_cache(self, batch, max_len, dtype=torch.bfloat16):
        """A zeroed decode cache on the parameters' device."""
        return tfm.init_cache(self.cfg, batch, max_len, dtype,
                              device=self.params["embed"].device)

    def cache_spec(self, batch, max_len, dtype=torch.bfloat16):
        return tfm.cache_spec(self.cfg, batch, max_len, dtype)

    def cache_axes(self) -> dict:
        """The logical axes of :meth:`cache_spec`'s leaves."""
        return tfm.cache_axes(self.cfg)

    # -- training ----------------------------------------------------------
    def forward(self, params, tokens, extras=None):
        return tfm.forward(params, tokens, self.cfg, extras)

    def loss(self, params, batch, part=None):
        """Next-token cross-entropy of ``batch["tokens"]`` (B, S), the mean
        over B·(S-1) positions in f32, for every family; the batch's
        ``"frames"`` / ``"patches"`` go to :func:`transformer.forward` as
        its extras, and the vision positions' logits are dropped.  The JAX
        ``Model.loss`` adds its MoE aux term as ``+ 0.0`` (the load-balance
        loss, ``moe.aux_load_balance_loss``, is the trainer's to add), so
        this adds none.

        ``part``: a ``distributed.partition.Partition``: ``params`` are this
        rank's shards and ``batch`` its rows, and the loss (the mean over
        its rows, the same on every "model" rank) is vocab-parallel
        (:func:`partitioned_loss`)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if part is not None:
            return partitioned_loss(
                tfm.forward(params, tokens, cfg, part=part), tokens, part)
        extras = {k: v for k, v in batch.items() if k in ("frames", "patches")}
        logits = tfm.forward(params, tokens, cfg, extras or None)
        if cfg.n_patches and extras:
            logits = logits[:, cfg.n_patches:]  # drop the vision positions
        return softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])


def partitioned_loss(logits, tokens, part):
    """The next-token loss of :func:`transformer.partitioned_forward`'s
    logits: over a vocabulary cut over "model", every position's NLL by the
    iota-mask reduction, its max, sum of exponentials and label logit
    all-reduced as (B, S) values; over a whole vocabulary, the NLL of this
    rank's positions (the last position has no label), summed over the
    sequence's ranks."""
    B, S = tokens.shape
    if part.vocab_cut:
        return token_nll(logits[:, :-1], tokens[:, 1:],
                         vocab_start=part.vocab.start,
                         vocab_sum=part.vocab_sum,
                         vocab_max=part.vocab_max).mean()
    sl = part.seq_slice(S)
    labels = torch.roll(tokens, -1, 1)[:, sl]
    has_label = torch.arange(S, device=tokens.device)[sl] < S - 1
    nll = torch.where(has_label, token_nll(logits, labels), 0.0)
    return part.seq_sum(nll.sum()) / (B * (S - 1))


# ------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """``meta`` stand-ins and logical axes for every model input, as the JAX
    ``input_specs``: train / prefill take the token batch (int32), the
    encoder-decoder's frames and the VLM's patch embeddings (bf16); decode
    takes the current token (its cache comes from :meth:`Model.cache_spec`)."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    specs, axes = {}, {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = sds((B, S), torch.int32)
        axes["tokens"] = ("batch", "seq")
        if cfg.family == "encdec":
            specs["frames"] = sds((B, cfg.n_frames, cfg.d_model),
                                  torch.bfloat16)
            axes["frames"] = ("batch", None, "embed")
        if cfg.n_patches:
            specs["patches"] = sds((B, cfg.n_patches, tfm.VISION_DIM),
                                   torch.bfloat16)
            axes["patches"] = ("batch", None, None)
    else:  # decode
        specs["token"] = sds((B,), torch.int32)
        axes["token"] = ("batch",)
    return specs, axes
