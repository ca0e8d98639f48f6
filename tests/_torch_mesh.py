"""Rank functions of the port's training-mesh checks, shared by
``tests/test_torch_elastic.py`` (ranks on the CPU),
``tests/test_torch_cuda.py`` (ranks on the card) and ``chip_smoke.py``.

``launch.mesh.spawn_ranks`` starts each rank in a fresh process that
imports its function by name, so they live here and not in a test module
(which imports JAX).  Nothing here imports JAX.
"""

from __future__ import annotations

import gc
import os
import weakref

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (mesh_axes, resolve_spec,
                                              shard_spec, spec_shards,
                                              tree_bytes_per_device,
                                              tree_specs)
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh
from repro_torch.launch.steps import make_train_fn, shard_batch
from repro_torch.launch.train import TOKENS_AXES, _opt_axes, train
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, leaves_with_path, tree_map

ARCH = "qwen3-1.7b"
CKPT = dict(keep_last=2, async_save=False, seg_bytes=1 << 20,
            chunk_bytes=64 << 10)


def _shards(tree, axes, mesh):
    """This rank's shard of each leaf of a whole tree."""
    it = iter(tree_specs(axes, tree, mesh))
    return tree_map(lambda t: shard_spec(t, next(it), mesh), tree)


def _whole(tree, axes, template, mesh):
    """Each leaf of a tree of this rank's shards gathered whole."""
    it = iter(tree_specs(axes, template, mesh))
    return tree_map(lambda t: collectives.gather(t.detach(), next(it), mesh),
                    tree)


def sharded_steps(rank, device, shape, params, batches, opt_kw,
                  ckpt_root, cfg=None) -> dict:
    """``len(batches)`` sharded train steps of ``cfg`` (default: the smoke
    ``ARCH``) on a ``shape`` (data, model) mesh from the whole ``params``
    (every rank gets the same), each batch the global one; then a save of
    params and moments from the mesh into ``ckpt_root`` (None: no save).
    Returns the losses, the step's route, the shape of each leaf this rank
    holds, rank 0's gathered params, and the bytes this rank holds beside
    ``tree_bytes_per_device``."""
    mesh = make_debug_mesh(*shape, device.type)
    model = Model(cfg or get_config(ARCH).smoke(), params={})
    opt = AdamW(**opt_kw)
    axes = model.axes()
    # a copy: the spawned ranks share the storage of `params`
    p = _shards(tree_map(lambda t: t.to(device, copy=True), params), axes,
                mesh)
    for t in leaves(p):
        t.requires_grad_(True)
    state = opt.init(p)
    step = make_train_fn(model, opt, mesh,
                         global_batch=batches[0]["tokens"].shape[0])
    losses = []
    for b in batches:
        b = shard_batch({k: v.to(device) for k, v in b.items()},
                        TOKENS_AXES, mesh)
        p, state, loss = step(p, state, b)
        losses.append(float(loss))
    held = sum(t.numel() * t.element_size() for t in leaves(p))
    whole = _whole(p, axes, params, mesh)
    out = {"losses": losses, "held_bytes": held, "route": step.compute,
           "shapes": {"/".join(k): tuple(t.shape)
                      for k, t in leaves_with_path(p)},
           "per_device_bytes": tree_bytes_per_device(axes, params, mesh)}
    if ckpt_root is not None:
        mgr = CheckpointManager(ckpt_root, **CKPT)
        tree = {"params": p, "opt_state": state}
        mgr.save(1, tree, mesh=mesh, specs=tree_specs(
            {"params": axes, "opt_state": _opt_axes(model)},
            {"params": params, "opt_state": opt.abstract_state(params)},
            mesh))
    if rank == 0:
        out["params"] = tree_map(lambda t: t.cpu(), whole)
    return out


def restore_onto(rank, device, shape, ckpt_root, want, step_batch,
                 opt_kw) -> dict:
    """Restore the params of ``ckpt_root`` onto a ``shape`` mesh (or
    ``"host"``: the trainer's ``make_host_mesh``, every rank on "data"):
    each leaf held against this rank's slice of ``want`` (the saved whole
    params) bit for bit, the bytes this rank holds against its shards' per
    ``tree_bytes_per_device``; then, given ``step_batch``, restore params
    and moments and take a train step."""
    mesh = (make_host_mesh(device.type) if shape == "host"
            else make_debug_mesh(*shape, device.type))
    model = Model(get_config(ARCH).smoke(), params={})
    axes = model.axes()
    template = tree_map(lambda t: torch.empty_like(t, device="meta"), want)
    mgr = CheckpointManager(ckpt_root, **CKPT)
    got = mgr.restore({"params": template}, 1, device=device, mesh=mesh,
                      axes={"params": axes})["params"]
    specs = tree_specs(axes, template, mesh)
    bitwise = all(torch.equal(g.cpu(), shard_spec(w, sp, mesh))
                  for g, w, sp in zip(leaves(got), leaves(want), specs))
    out = {"bitwise": bitwise, "mesh": mesh_axes(mesh),
           "held_bytes": sum(t.numel() * t.element_size()
                             for t in leaves(got)),
           "per_device_bytes": tree_bytes_per_device(axes, template, mesh),
           "cut_leaves": sum(spec_shards(sp, mesh) > 1 for sp in specs)}
    if step_batch is not None:
        opt = AdamW(**opt_kw)
        full = {"params": template,
                "opt_state": opt.abstract_state(template)}
        st = mgr.restore(full, 1, device=device, mesh=mesh, axes={
            "params": axes, "opt_state": _opt_axes(model)})
        p, state = st["params"], st["opt_state"]
        state = state._replace(step=state.step.cpu())
        for t in leaves(p):
            t.requires_grad_(True)
        step = make_train_fn(model, opt, mesh, global_batch=step_batch[
            "tokens"].shape[0])
        b = shard_batch({k: v.to(device) for k, v in step_batch.items()},
                        TOKENS_AXES, mesh)
        _, _, loss = step(p, state, b)
        out["loss"] = float(loss)
    return out


def restart_runs(rank, device, shape, kw, ckpt_root) -> dict:
    """``train`` on a ``shape`` mesh twice: clean, and with ``kw``'s
    failure, checkpointing into ``ckpt_root``; both logs' losses."""
    mesh = make_debug_mesh(*shape, device.type)
    clean = train(device=device, mesh=mesh, verbose=False,
                  **{k: v for k, v in kw.items() if k != "fail_at"})
    faulty = train(device=device, mesh=mesh, verbose=False,
                   ckpt_dir=ckpt_root, **kw)
    return {"clean": clean["loss"], "faulty": faulty["loss"],
            "restarts": faulty["restarts"],
            "resumed_from": faulty["resumed_from"]}


def joint_axis_round_trip(rank, device) -> dict:
    """On a (pod 2, data 2, model 1) mesh: a tensor cut over the joint
    ("pod", "data") axis gathers back whole, each rank holding rows
    ``pod * 2 + data``; an all-reduce over it is the mean of the four
    ranks' values."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(device.type, (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    whole = torch.arange(8 * 3, dtype=torch.float32, device=device).reshape(
        8, 3)
    spec = resolve_spec((8, 3), ("batch", None), mesh, {
        "batch": [("pod", "data"), ("data",)]})
    mine = shard_spec(whole, spec, mesh)
    back = collectives.gather(mine, spec, mesh)
    x = torch.full((2,), float(dist.get_rank()), device=device)
    collectives.all_reduce_mean(x, spec[0], mesh)
    return {"spec": spec, "rows": mine[:, 0].tolist(),
            "round_trip": torch.equal(back, whole),
            "mean": x.tolist()}


def grow_back_and_restart(rank, device, ckpt_root, want, step_batch, opt_kw,
                          train_kw, restart_root) -> dict:
    """One spawn of 2 x 2 ranks: :func:`restore_onto` with a step,
    :func:`restart_runs`, then :func:`joint_axis_round_trip` on the same
    four ranks."""
    return {"grown": restore_onto(rank, device, (2, 2), ckpt_root, want,
                                  step_batch, opt_kw),
            "restart": restart_runs(rank, device, (2, 2), train_kw,
                                    restart_root),
            "joint": joint_axis_round_trip(rank, device)}


def deterministic() -> None:
    """Deterministic kernels and no TF32, before a rank's first cuBLAS call
    (``chip_smoke.py``'s train phase's settings)."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def one_by_one_against_one_device(rank, device, params, batches,
                                  opt_kw) -> dict:
    """The same steps from the same params on one device and on a (1, 1)
    mesh (a one-rank process group): each run's losses and whole params."""
    deterministic()
    model = Model(get_config(ARCH).smoke(), params={})
    out = {}
    for name, mesh in (("one", None), ("mesh", make_debug_mesh(
            1, 1, device.type))):
        p = tree_map(lambda t: t.to(device, copy=True).requires_grad_(True),
                     params)
        opt = AdamW(**opt_kw)
        state = opt.init(p)
        step = (make_train_fn(model, opt) if mesh is None else
                make_train_fn(model, opt, mesh,
                              global_batch=batches[0]["tokens"].shape[0]))
        losses = []
        for b in batches:
            p, state, loss = step(p, state, {k: v.to(device)
                                             for k, v in b.items()})
            losses.append(float(loss))
        out[name] = {"losses": losses,
                     "params": tree_map(lambda t: t.detach().cpu(), p)}
    return out


def round_trip(rank, device, whole) -> dict:
    """On a (2, 1) mesh: this rank's shard of each leaf of ``whole``
    gathered back (bitwise the leaf?), and the mean of the ranks' numbers
    over "data"."""
    mesh = make_debug_mesh(2, 1, device.type)
    model = Model(get_config(ARCH).smoke(), params={})
    specs = tree_specs(model.axes(), whole, mesh)
    equal = []
    for t, sp in zip(leaves(whole), specs):
        t = t.to(device)
        mine = shard_spec(t, sp, mesh)
        equal.append(torch.equal(collectives.gather(mine, sp, mesh), t))
    x = torch.full((3,), float(rank), device=device)
    collectives.all_reduce_mean(x, "data", mesh)
    return {"gathered_equal": equal, "cut": sum(
        spec_shards(sp, mesh) > 1 for sp in specs), "mean": x.tolist()}


def partitioned_grads(rank, device, shape, cfg, params, batch) -> dict:
    """On a ``shape`` (data, model) mesh, the partitioned route's loss and
    gradient for ``cfg`` from the whole ``params`` and the global
    ``batch``: this rank's loss and its shard of each leaf's gradient
    (reduced, as the step hands them to AdamW), by leaf path, and the
    route ``make_train_fn`` names."""
    from repro_torch.distributed.partition import Partition
    from repro_torch.launch.steps import (batch_part, rank_model,
                                          partitioned_grads as grads_of)
    mesh = make_debug_mesh(*shape, device.type)
    model = Model(cfg, params={})
    p = _shards(tree_map(lambda t: t.to(device, copy=True), params),
                model.axes(), mesh)
    for t in leaves(p):
        t.requires_grad_(True)
    b = shard_batch({k: v.to(device) for k, v in batch.items()},
                    TOKENS_AXES, mesh)
    B, S = batch["tokens"].shape
    # a MoE layer in the global batch's groups, as the step's
    rows = rank_model(model, B * S, spec_shards((batch_part(B, mesh),), mesh))
    loss, grads = grads_of(rows, Partition(model, mesh), p, b)
    route = make_train_fn(model, AdamW(), mesh, global_batch=B).compute
    out = {"loss": float(loss.detach()), "route": route, "coords": dict(zip(
        mesh.mesh_dim_names, mesh.get_coordinate())),
        "grads": {"/".join(path): g.cpu() for (path, _), g in zip(
            leaves_with_path(p), grads)}}
    # the shards this rank's graph read, once it is dropped and a second
    # graph (on fresh copies) has run
    held = [weakref.ref(t) for t in leaves(p)]
    del p, loss, grads
    p = _shards(tree_map(lambda t: t.to(device, copy=True), params),
                model.axes(), mesh)
    for t in leaves(p):
        t.requires_grad_(True)
    grads_of(rows, Partition(model, mesh), p, b)
    gc.collect()
    out["shards_alive"] = sum(r() is not None for r in held)
    return out


def steps_of_cases(rank, device, shape, cases, batches, opt_kw,
                   grad_cases=None) -> dict:
    """:func:`sharded_steps` for each case of ``cases`` ({name: (cfg,
    params)}) on one spawn's ranks, in order: {name: its result}; then
    :func:`partitioned_grads` on ``batches[0]`` for each case of
    ``grad_cases`` (the same form), under ``"grads"``."""
    out = {name: sharded_steps(rank, device, shape, params, batches,
                               opt_kw, None, cfg)
           for name, (cfg, params) in cases.items()}
    out["grads"] = {name: partitioned_grads(rank, device, shape, cfg,
                                            params, batches[0])
                    for name, (cfg, params) in (grad_cases or {}).items()}
    return out


def mesh_prefill(rank, device, shape, cfg, params, tokens,
                 max_len) -> dict:
    """``launch.steps.make_prefill_fn``'s step on a ``shape`` (data, model)
    mesh: this rank's shards of the whole ``params``, its rows of the
    global ``tokens``; its argmax tokens and its shard of the cache."""
    from repro_torch.launch.steps import make_prefill_fn
    mesh = make_debug_mesh(*shape, device.type)
    model = Model(cfg, params={})
    p = _shards(tree_map(lambda t: t.to(device, copy=True), params),
                model.axes(), mesh)
    b = shard_batch({"tokens": tokens.to(device)}, TOKENS_AXES, mesh)
    step = make_prefill_fn(model, max_len, mesh,
                           global_batch=tokens.shape[0])
    with torch.no_grad():
        toks, cache = step(p, b)
    return {"tokens": toks.cpu(), "cache": {k: v.cpu()
                                            for k, v in cache.items()}}


def megatron_ops(rank, device) -> dict:
    """On a (1, 2) mesh: each of the partitioned step's operators forward
    and backward on a rank-dependent input, and the upstream gradient ones;
    every result as a list."""
    mesh = make_debug_mesh(1, 2, device.type)
    x = (torch.arange(8.0, device=device).reshape(2, 4) + 10 * rank)
    out = {}
    for name, fn in (("copy_to", lambda t: collectives.copy_to(t, "model",
                                                               mesh)),
                     ("reduce_from", lambda t: collectives.reduce_from(
                         t, "model", mesh)),
                     ("gather_from", lambda t: collectives.gather_from(
                         t, 1, "model", mesh)),
                     ("scatter_to", lambda t: collectives.scatter_to(
                         t, 1, "model", mesh)),
                     ("fsdp_gather", lambda t: collectives.fsdp_gather(
                         t, 0, "model", mesh, collectives.FsdpHooks()))):
        t = x.clone().requires_grad_(True)
        y = fn(t)
        y.backward(torch.ones_like(y) * (rank + 1))
        out[name] = {"y": y.detach().cpu().tolist(),
                     "grad": t.grad.cpu().tolist()}
    m = torch.tensor([1.0 + rank, 5.0 - rank], device=device)
    out["max"] = collectives.all_reduce(m, "model", mesh, op="max").tolist()
    return out


def count_train_cell(rank, device, shape, cfg, cell) -> dict:
    """This rank's train cell (``build_cell`` on ``device`` at a ``shape``
    (data, model) mesh) run once under a counter: its summary."""
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.op_cost import OpCost
    mesh = make_debug_mesh(*shape, device.type)
    fn, args = build_cell(cfg, cell, device, mesh=mesh)
    with OpCost(inputs=args) as oc:
        fn(*args)
    return oc.summary()


def mesh_decode(rank, device, shape, cfg, params, cache, token,
                max_len: int, steps: int) -> dict:
    """``launch.steps.make_decode_fn``'s step on a ``shape`` (data, model)
    mesh, ``steps`` times from the global ``cache`` (of ``max_len``
    positions) and current ``token``
    (each next token the step's argmax): this rank's shards of the whole
    ``params`` and ``cache``, its rows of ``token``.  Returns its argmax
    tokens and its rows' logits per step (read off ``Model.decode_step``
    as the step calls it)."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    from repro_torch.launch.steps import make_decode_fn
    mesh = make_debug_mesh(*shape, device.type)
    model = Model(cfg, params={})
    p = _shards(tree_map(lambda t: t.to(device, copy=True), params),
                model.axes(), mesh)
    axes = model.cache_axes()
    c = {k: shard_spec(v.to(device, copy=True), resolve_spec(
        tuple(v.shape), axes[k], mesh, DEFAULT_RULES), mesh)
        for k, v in cache.items()}
    tok = shard_batch({"token": token.to(device)}, {"token": ("batch",)},
                      mesh)["token"]
    seen = []
    decode = Model.decode_step

    def spy(self, *args):
        out = decode(self, *args)
        seen.append(out[0].detach().cpu())
        return out

    Model.decode_step = spy
    try:
        step = make_decode_fn(model, mesh, global_batch=token.shape[0],
                              max_len=max_len)
        toks = []
        with torch.no_grad():
            for _ in range(steps):
                tok, c = step(p, c, tok)
                toks.append(tok.cpu())
    finally:
        Model.decode_step = decode
    return {"tokens": toks, "logits": seen}
