"""Step factories: the train, prefill and decode steps of a (config × shape)
cell, and :func:`build_cell`, which builds one ready to call.  A port of
``repro.launch.steps``: the trainer runs :func:`make_train_fn`, and the
dry-run (``launch/dryrun.py``) and ``chip_smoke.py``'s dryrun and mesh
phases run the cells of :func:`build_cell`, on ``meta`` tensors or on a
device.

**On a mesh** (``mesh=``: a ``("data", "model")`` or ``("pod", "data",
"model")`` ``DeviceMesh``, or such a mesh given as sizes only) every
argument and every result of a step is this rank's shard under
``distributed.sharding.DEFAULT_RULES``, the JAX cell's in- and
out-shardings: the parameters and both AdamW moments, the batch (cut over
``("pod", "data")`` or ``("data",)``, as the resolver gives its batch dim),
the decode cache (its batch, and its length over "model").  The train
step's loss comes back averaged over the batch's ranks, and it updates its
own shards in place, clipped by the whole gradient's global norm (the
one-device step's scale).  The work in between takes one of two routes,
which :func:`compute_route` names (the dry-run records it as
``"compute"``):

* **partitioned** — the train step of the dense (but the VLM stub, whose
  patches it does not take), MoE, MLA-MoE, SSM and hybrid families: the
  JAX program's work per device under GSPMD (``distributed.partition``).
  Each rank runs its batch slice on its own heads, kv heads, MLP columns
  (MoE: routed experts and the shared experts' columns; MLA: its slice of
  the latent rank; SSM: its channels and heads, B and C gathered whole)
  and vocabulary rows (a dim the rules leave whole it computes whole),
  with the residual stream cut over "model" along the sequence between
  blocks, a vocab-parallel embedding and loss (no rank holds the (B, S, V)
  logits whole), and each layer's FSDP weights gathered over "data" for
  its forward and again for its backward, its gradient reduce-scattered
  back to the shard; the peak holds one layer's whole weights, never the
  tree's.  Each leaf's gradient is then summed over the axes its spec
  does not cut, and the global norm is the shards' sums of squares, a
  leaf held whole by several ranks counted once.
* **replicated** — the train step of the encoder-decoder family and of
  the VLM stub, and every prefill and decode step: data-parallel.  Each
  step all-gathers every leaf over the mesh axes it is cut on
  (``distributed.collectives.gather``), runs the one-device step on its
  slice of the batch at full width, and cuts what it returns back to its
  shard; a train step all-reduces the whole gradients, in their own dtype
  as the JAX step's (bf16 for bf16 params), to their mean over the
  batch's ranks.  This is not the JAX program: its compute is replicated
  over "model", and a rank's peak holds the whole parameters and
  gradient.

On both routes a rank's MoE layers dispatch in the JAX program's groups:
the global batch's, of which a rank's rows hold a contiguous share
(:func:`rank_model`), so a train, prefill or decode step of a batch cut
over the mesh computes what one device computes on the whole batch (a
decode step's tokens are its rows).

A (1, 1) mesh runs the one-device step, bit for bit.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.collectives import all_reduce_mean, gather
from ..distributed.partition import Partition
from ..distributed.sharding import (DEFAULT_RULES, mesh_axes, tree_specs,
                                    resolve_spec, shard_spec, shard_view,
                                    spec_shards)
from ..kernels import ops
from ..models import Model, input_specs
from ..models import transformer as tfm
from ..models.moe import rank_groups
from ..optim import AdamW
from ..optim.adamw import global_norm
from ..tree import leaves, tree_map


def batch_split(axes: tuple, spec: tuple) -> tuple:
    """``(the batch dim's spec entry, the spec with it replaced by None)``
    of a leaf with logical ``axes``: a step gets its batch slice already
    cut, and gathers and re-cuts only the other dims."""
    spec = tuple(spec) + (None,) * (len(axes) - len(spec))
    if "batch" not in axes:
        return None, spec
    d = axes.index("batch")
    return spec[d], spec[:d] + (None,) + spec[d + 1:]


def batch_part(global_batch: int, mesh):
    """The spec entry the batch dim of ``global_batch`` resolves to: the
    ranks whose mean a train step's gradient and loss are."""
    spec = resolve_spec((global_batch,), ("batch",), mesh, DEFAULT_RULES)
    return spec[0] if spec else None


def _unflatten_like(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _gather_params(model: Model, mesh):
    """``gather_all(params)``: this rank's parameter shards -> the whole
    parameter tree (transient), without autograd."""
    specs = tree_specs(model.axes(), model.abstract(), mesh)

    @torch.no_grad()
    def gather_all(params):
        return _unflatten_like(params, [gather(t, sp, mesh) for t, sp in
                                        zip(leaves(params), specs)])
    return gather_all


def _cache_layout(model: Model, global_batch: int, max_len: int,
                  mesh) -> dict:
    """{name: the spec of a cache leaf without its batch entry} for the
    cache of ``global_batch`` x ``max_len``."""
    axes = model.cache_axes()
    return {name: batch_split(axes[name], resolve_spec(
                shape, axes[name], mesh, DEFAULT_RULES))[1]
            for name, (shape, _) in tfm.cache_spec(model.cfg, global_batch,
                                                   max_len).items()}


def compute_route(cfg: ModelConfig, kind: str, mesh) -> str:
    """How a ``kind`` step of ``cfg`` computes on ``mesh`` (module
    docstring): ``"one-device"`` without a mesh, ``"partitioned"`` for the
    train step of every family but the encoder-decoder and the VLM stub,
    else ``"replicated"``."""
    if mesh is None:
        return "one-device"
    if kind == "train" and cfg.family != "encdec" and not cfg.n_patches:
        return "partitioned"
    return "replicated"


def rank_model(model: Model, tokens: int, ranks: int) -> Model:
    """The model one of ``ranks`` batch ranks runs on its rows of a global
    batch of ``tokens`` tokens: for the MoE families, its config's
    ``moe_groups`` set to this rank's share of the global batch's dispatch
    groups (``models.moe.rank_groups``; ``moe_ffn`` then cuts the rank's
    tokens into exactly those groups, each of the global group's size and
    capacity), else ``model`` itself.  Raises ``ValueError`` naming the
    config where the groups do not divide over the ranks."""
    cfg = model.cfg
    if not cfg.n_experts or ranks == 1:
        return model
    return Model(cfg.with_(moe_groups=rank_groups(
        tokens, cfg.moe_groups, ranks, cfg.name)), params={})


def make_train_fn(model: Model, opt: AdamW, mesh=None, *,
                  global_batch: int | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.
    The params (leaves with ``requires_grad``) and the moments are updated
    in place; the loss comes back detached, a 0-d f32 tensor on the
    params' device (reading it waits for the step).  ``train_step.compute``
    names its route (:func:`compute_route`).

    On ``mesh`` (module docstring) the params and moments are this rank's
    shards, ``batch`` is its slice of a global batch of ``global_batch``
    rows, and the loss is the mean over the batch's ranks: replicated for
    the encoder-decoder and the VLM stub, partitioned for the others.  On
    a (1, 1) mesh the step is the one-device step, bit for bit."""
    route = compute_route(model.cfg, "train", mesh)
    if mesh is None or spec_shards(tuple(mesh_axes(mesh)), mesh) == 1:
        def train_step(params, opt_state, batch):
            loss = model.loss(params, batch)
            # the gradients as a list in the params' leaf order, which is
            # how AdamW.update walks a gradient tree
            grads = list(torch.autograd.grad(loss, leaves(params)))
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss.detach()

        train_step.compute = route
        return train_step
    part = batch_part(global_batch, mesh)
    if route == "partitioned":
        return _partitioned_train_fn(model, opt, mesh, part, global_batch)
    # no config with experts is an encoder-decoder or takes patches, so no
    # replicated train step dispatches in groups (rank_model)
    assert not model.cfg.n_experts, model.cfg.name

    specs = tree_specs(model.axes(), model.abstract(), mesh)
    gather_all = _gather_params(model, mesh)

    def sharded_step(params, opt_state, batch):
        whole = gather_all(params)
        flat = leaves(whole)
        for t in flat:
            if not t.requires_grad:   # a gathered leaf, not a shard itself
                t.requires_grad_(True)
        loss = model.loss(whole, batch)
        grads = list(torch.autograd.grad(loss, flat))
        del whole, flat
        with torch.no_grad():
            for g in grads:
                all_reduce_mean(g, part, mesh)
            gnorm = global_norm(grads)
            shards = [shard_view(g, sp, mesh) for g, sp in zip(grads, specs)]
        params, opt_state = opt.update(params, shards, opt_state, gnorm=gnorm)
        return params, opt_state, all_reduce_mean(loss.detach(), part, mesh)

    sharded_step.compute = route
    return sharded_step


def partitioned_grads(model: Model, part: Partition, params, batch):
    """``(loss, grads)`` of the partitioned route: this rank's loss (the
    mean over its rows) and the gradient of the mean over the batch's
    ranks, as this rank's shard of each leaf (a list in leaf order)."""
    loss = model.loss(params, batch, part=part)
    scale = part.loss_scale()
    grads = list(torch.autograd.grad(loss / scale if scale > 1 else loss,
                                     leaves(params)))
    with torch.no_grad():
        part.reduce_grads(grads)
    return loss, grads


def _partitioned_train_fn(model: Model, opt: AdamW, mesh, batch_ranks,
                          global_batch: int):
    """The partitioned train step (module docstring): ``batch_ranks``, the
    spec entry of the ranks whose mean the loss is."""
    part = Partition(model, mesh)
    n_batch = spec_shards((batch_ranks,), mesh)

    def partitioned_step(params, opt_state, batch):
        rows = rank_model(model, global_batch * batch["tokens"].shape[1],
                          n_batch)
        loss, grads = partitioned_grads(rows, part, params, batch)
        with torch.no_grad():
            gnorm = part.global_norm(grads)
        params, opt_state = opt.update(params, grads, opt_state, gnorm=gnorm)
        return params, opt_state, all_reduce_mean(loss.detach(), batch_ranks,
                                                  mesh)

    partitioned_step.compute = "partitioned"
    return partitioned_step


def make_decode_fn(model: Model, mesh=None, *, global_batch: int | None = None,
                   max_len: int | None = None):
    """``serve_step(params, cache, token) -> (argmax tokens (B,) int32,
    cache)``: one :meth:`Model.decode_step`, the cache written in place.

    On ``mesh`` the params are this rank's shards, the cache (of
    ``global_batch`` x ``max_len``) its shard and ``token`` its batch
    slice: the cache is gathered over the axes it is cut on besides the
    batch's, decoded for the rank's rows (a MoE layer in the global
    batch's dispatch groups, :func:`rank_model`), and cut back to its shard
    (a new tensor where a dim besides the batch is cut)."""
    if mesh is None:
        def serve_step(params, cache, token):
            logits, cache = model.decode_step(params, cache, token)
            return torch.argmax(logits, -1).to(torch.int32), cache

        return serve_step

    gather_all = _gather_params(model, mesh)
    layout = _cache_layout(model, global_batch, max_len, mesh)
    # one token per row: the global batch's tokens are its rows
    rows = rank_model(model, global_batch, spec_shards(
        (batch_part(global_batch, mesh),), mesh))

    def sharded_step(params, cache, token):
        cache = {k: gather(v, layout[k], mesh) for k, v in cache.items()}
        logits, cache = rows.decode_step(gather_all(params), cache, token)
        cache = {k: shard_spec(v, layout[k], mesh) for k, v in cache.items()}
        return torch.argmax(logits, -1).to(torch.int32), cache

    return sharded_step


def make_prefill_fn(model: Model, max_len: int, mesh=None, *,
                    global_batch: int | None = None):
    """``prefill_step(params, batch) -> (argmax tokens (B,) int32, cache)``:
    :meth:`Model.prefill` of ``batch["tokens"]`` into a cache of
    ``max_len`` positions, the batch's other entries as its extras, the
    attention through the flash kernel wherever a route of it takes the
    config's head dim (Nemotron-4's 192 included), else through the plain
    chunked attention (MLA's prefill attends through it in any case).

    On ``mesh`` the params are this rank's shards and ``batch`` its slice
    of ``global_batch`` rows; it prefills its rows whole (flash on each
    rank, as on one device; a MoE layer in the global batch's dispatch
    groups, :func:`rank_model`) and keeps its shard of the cache."""
    # every head dim a flash route takes is one of the CUDA cores' (bf16
    # from 64 up goes to the tensor cores' instance of it)
    kernel = model.cfg.hd in ops.FLASH_DIMS["simt"]
    if mesh is not None:
        gather_all = _gather_params(model, mesh)
        layout = _cache_layout(model, global_batch, max_len, mesh)
        n_batch = spec_shards((batch_part(global_batch, mesh),), mesh)

    def prefill_step(params, batch):
        rows = model
        if mesh is not None:
            params = gather_all(params)
            rows = rank_model(model, global_batch * batch["tokens"].shape[1],
                              n_batch)
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        logits, cache = rows.prefill(params, batch["tokens"], max_len,
                                     extras or None, kernel=kernel)
        if mesh is not None:
            cache = {k: shard_spec(v, layout[k], mesh)
                     for k, v in cache.items()}
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


def shard_batch(batch: dict, axes: dict, mesh) -> dict:
    """This rank's slice of a global batch (``input_specs``' logical
    ``axes``): each input cut along its batch dim only, a contiguous copy.
    An input whose other dims the rules would also cut (frames on "embed"
    where the batch takes no mesh axis) stays whole along them: the step
    computes on whole rows."""
    out = {}
    for name, t in batch.items():
        part, _ = batch_split(axes[name], resolve_spec(
            tuple(t.shape), axes[name], mesh, DEFAULT_RULES))
        d = axes[name].index("batch")
        out[name] = shard_spec(t, (None,) * d + (part,), mesh)
    return out


def build_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta",
               opt: AdamW | None = None, *, mesh=None, seed: int = 0):
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

    On ``mesh`` (a ``DeviceMesh``, or sizes only with ``device="meta"``:
    rank 0's arguments) the arguments are this rank's: the parameter and
    moment shards, its slice of the batch, its shard of the decode cache
    (module docstring).  Every rank draws the same whole tree from
    ``seed`` and keeps its shard."""
    device = torch.device(device)
    model = Model(cfg, params={})
    meta = device.type == "meta"
    if isinstance(mesh, dict) and not meta:
        raise ValueError("a mesh given as sizes only builds meta cells")
    params = model.abstract() if meta else model.init(seed, device=device)
    batch = _inputs(cfg, shape, device, seed + 1)
    B, S = shape.global_batch, shape.seq_len
    if mesh is not None:
        specs = tree_specs(model.axes(), params, mesh)
        params = _unflatten_like(params, [shard_spec(t, sp, mesh) for t, sp
                                          in zip(leaves(params), specs)])
        batch = shard_batch(batch, input_specs(cfg, shape)[1], mesh)
    step_kw = {} if mesh is None else dict(mesh=mesh, global_batch=B)
    if shape.kind == "train":
        params = tree_map(lambda p: p.requires_grad_(True), params)
        opt = opt or AdamW(lr=1e-4, weight_decay=0.1, clip_norm=1.0)
        state = opt.abstract_state(params) if meta else opt.init(params)
        return make_train_fn(model, opt, **step_kw), (params, state, batch)
    if shape.kind == "prefill":
        return make_prefill_fn(model, max_len=S, **step_kw), (params, batch)
    if meta:
        cache = {name: torch.empty(shp, dtype=dt, device="meta")
                 for name, (shp, dt) in tfm.cache_spec(cfg, B, S).items()}
    else:
        cache = tfm.init_cache(cfg, B, S, device=device)
        cache["cur_len"].fill_(S - 1)
    if mesh is not None:
        axes = model.cache_axes()
        cache = {k: shard_spec(v, resolve_spec(tuple(v.shape), axes[k], mesh,
                                               DEFAULT_RULES), mesh)
                 for k, v in cache.items()}
        step_kw["max_len"] = S
    return make_decode_fn(model, **step_kw), (params, cache, batch["token"])
