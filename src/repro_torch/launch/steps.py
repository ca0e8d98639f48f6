"""Step factories: the train, prefill and decode steps of a (config × shape)
cell, and :func:`build_cell`, which builds one ready to call.  A port of
``repro.launch.steps``: the trainer runs :func:`make_train_fn`, and the
dry-run (``launch/dryrun.py``) and ``chip_smoke.py``'s dryrun phase run
the cells of :func:`build_cell`, on ``meta`` tensors or on a device.  There
is no mesh: the port trains on one device, and its serving mesh is the
engine's."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels import ops
from ..models import Model, input_specs
from ..models import transformer as tfm
from ..optim import AdamW
from ..tree import leaves, tree_map


def make_train_fn(model: Model, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.
    The params (leaves with ``requires_grad``) and the moments are updated
    in place; the loss comes back detached, a 0-d f32 tensor on the
    params' device (reading it waits for the step)."""
    def train_step(params, opt_state, batch):
        loss = model.loss(params, batch)
        # the gradients as a list in the params' leaf order, which is how
        # AdamW.update walks a gradient tree
        grads = list(torch.autograd.grad(loss, leaves(params)))
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return train_step


def make_decode_fn(model: Model):
    """``serve_step(params, cache, token) -> (argmax tokens (B,) int32,
    cache)``: one :meth:`Model.decode_step`, the cache written in place."""
    def serve_step(params, cache, token):
        logits, cache = model.decode_step(params, cache, token)
        return torch.argmax(logits, -1).to(torch.int32), cache

    return serve_step


def make_prefill_fn(model: Model, max_len: int):
    """``prefill_step(params, batch) -> (argmax tokens (B,) int32, cache)``:
    :meth:`Model.prefill` of ``batch["tokens"]`` into a cache of
    ``max_len`` positions, the batch's other entries as its extras, the
    attention through the flash kernel wherever it has an instance of the
    config's head dim (up to 128), else through the plain chunked
    attention, as MLA's prefill (Nemotron-4's head dim is 192)."""
    kernel = model.cfg.hd <= max(ops.FLASH_DIMS["simt"])

    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, cache = model.prefill(params, batch["tokens"], max_len,
                                      extras or None, kernel=kernel)
        return torch.argmax(logits, -1).to(torch.int32), cache

    return prefill_step


def _inputs(cfg: ModelConfig, shape: ShapeConfig, device, seed: int) -> dict:
    """:func:`input_specs` on ``device``: ``meta`` as they are, otherwise
    tokens uniform over the vocabulary and N(0, 1) embeddings drawn from
    ``seed``."""
    specs, _ = input_specs(cfg, shape)
    if device.type == "meta":
        return specs
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, t in specs.items():
        if t.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, t.shape,
                                      generator=gen, device=device,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(t.shape, generator=gen, device=device,
                                    dtype=torch.float32).to(t.dtype)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta",
               opt: AdamW | None = None, *, seed: int = 0):
    """``(fn, args)``, ready for ``fn(*args)``: the cell's step and its
    arguments on ``device`` (``"meta"``: shapes only, no storage; otherwise
    the parameters drawn from ``seed`` and the inputs from ``seed + 1``).

    * train: ``make_train_fn``'s step over the parameters (with
      ``requires_grad``), AdamW's state (``abstract_state`` on ``meta``; the
      JAX cell's ``AdamW(lr=1e-4, weight_decay=0.1, clip_norm=1.0)`` unless
      ``opt``) and the batch;
    * prefill: ``make_prefill_fn``'s step into a cache of ``seq_len``
      positions, over the parameters and the prompt batch;
    * decode: ``make_decode_fn``'s step over the parameters, a cache of
      ``seq_len`` positions (:func:`transformer.cache_spec`; on a device
      zeroed, with ``seq_len - 1`` positions filled) and the current token.
    """
    device = torch.device(device)
    model = Model(cfg, params={})
    meta = device.type == "meta"
    params = model.abstract() if meta else model.init(seed, device=device)
    batch = _inputs(cfg, shape, device, seed + 1)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        params = tree_map(lambda p: p.requires_grad_(True), params)
        opt = opt or AdamW(lr=1e-4, weight_decay=0.1, clip_norm=1.0)
        state = opt.abstract_state(params) if meta else opt.init(params)
        return make_train_fn(model, opt), (params, state, batch)
    if shape.kind == "prefill":
        return make_prefill_fn(model, max_len=S), (params, batch)
    if meta:
        cache = {name: torch.empty(shp, dtype=dt, device="meta")
                 for name, (shp, dt) in tfm.cache_spec(cfg, B, S).items()}
    else:
        cache = tfm.init_cache(cfg, B, S, device=device)
        cache["cur_len"].fill_(S - 1)
    return make_decode_fn(model), (params, cache, batch["token"])
