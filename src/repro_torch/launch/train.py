"""Training driver: data pipeline -> train step -> log-structured checkpoints,
with straggler detection, failure injection and restart/resume.  A port of
``repro.launch.train``, on one device (the CUDA card unless ``--device
cpu``) or, with ``mesh=``, once per rank of a ``("data", "model")`` mesh
(``--mesh DATAxMODEL`` spawns the ranks): each rank holds its shard of the
params and moments (``distributed.sharding.DEFAULT_RULES``), takes its
slice of each global batch and runs ``launch.steps.make_train_fn``'s step
on the mesh: the partitioned route for the dense family (tensor-parallel
products over "model" with a sequence-parallel residual and a
vocab-parallel loss, each layer's FSDP weights gathered over "data"), the
replicated route for the others (data-parallel compute, repeated over
"model"; see that module); rank 0 prints the route.  Checkpoints are saved
from the mesh and restored onto it, re-sharded (``checkpoint.manager``).

Every piece of state survives a mid-run failure: params and optimizer via
the MDC checkpoint store, the data cursor by construction (batch =
f(seed, step)).  Each attempt starts from its own copy of the params (drawn
from the seed, or copied from ``params=``), so the in-place update of one
attempt never leaks into a restart from step 0; an attempt that resumes
restores onto ``meta``-tensor templates, so the card never holds a drawn
state beside the restored one.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 30 --save-every 10 --fail-at 17
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 1x2 --dist-backend gloo --steps 12 --seq-len 32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --mesh 2x2 --dist-backend gloo --steps 12 --save-every 4 --fail-at 7

On one card, two ranks sharing it on a (1, 2) mesh (each holds half the
model): ``PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x2
--dist-backend gloo --steps 12 --seq-len 32``.  The sequence must divide
over "model".
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config
from ..data import SyntheticLMStream
from ..device import resolve_device
from ..distributed.fault import (FailureInjector, SimulatedFailure,
                                 StragglerDetector, run_with_restarts)
from ..distributed.sharding import mesh_axes, shard_spec, tree_specs
from ..models import Model
from ..models import transformer as tfm
from ..models.layers import abstract_params
from ..optim import AdamW
from ..optim.adamw import AdamWState
from ..optim.schedule import cosine_with_warmup
from ..tree import leaves, tree_map
from .mesh import make_debug_mesh, make_host_mesh, spawn_ranks
from .steps import make_train_fn, shard_batch

TOKENS_AXES = {"tokens": ("batch", "seq")}


def train(*, arch: str = "qwen3-1.7b", smoke: bool = True, steps: int = 30,
          global_batch: int = 4, seq_len: int = 128, lr: float = 3e-4,
          warmup: int = 10, ckpt_dir: str | None = None, save_every: int = 10,
          keep_last: int = 3, fail_at: tuple = (), max_restarts: int = 3,
          log_every: int = 5, seed: int = 0, ckpt_policy: str = "mdc",
          verbose: bool = True, device=None, params=None,
          ckpt_seg_bytes: int = 1 << 20,
          ckpt_chunk_bytes: int = 64 << 10, mesh=None) -> dict:
    """The JAX ``train()``'s arguments and defaults, plus ``device`` (None:
    the CUDA card, raising without one), ``params`` (a parameter tree to
    start from, e.g. a JAX draw through ``bridge.params_from_jax``; else
    the tree is drawn from ``seed``) and the checkpoint store's segment and
    chunk sizes, the JAX trainer's fixed 1 MiB and 64 KiB by default (a
    full-width state of tens of GB wants larger ones: at 64 KiB a 20 GB
    save is ~312k chunks, each with the store's per-chunk host work).

    Returns the JAX log (``loss``, ``restarts``, ``resumed_from``,
    ``final_loss``, ``steps_replayed``, ``stragglers``, ``ckpt_wamp``,
    ``ckpt_stats``, ``params``) and ``step_s``, each step's wall seconds up
    to its loss on the host, and ``ckpt_timings`` (the manager's snapshot,
    write and restore seconds).

    ``mesh``: this rank's ``DeviceMesh`` (every rank of it calls
    ``train`` with the same arguments); the losses are the means over the
    batch's ranks, ``params`` in the log are this rank's shards, and the
    checkpoint counters are rank 0's (the only writer)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = Model(cfg, params={})  # the trainer holds the leaves
    opt = AdamW(lr=cosine_with_warmup(lr, warmup, steps), b2=0.95,
                weight_decay=0.1, clip_norm=1.0)
    train_step = make_train_fn(model, opt, mesh, global_batch=global_batch)
    # the whole state's shapes, the restore's template; on a mesh with its
    # logical axes and its leaves' specs
    shapes = (abstract_params(tfm.model_specs(cfg)) if params is None
              else tree_map(lambda t: torch.empty_like(t, device="meta"),
                            params))
    template = {"params": shapes, "opt_state": opt.abstract_state(shapes)}
    axes = {"params": model.axes(), "opt_state": _opt_axes(model)}
    specs = p_specs = None
    if mesh is not None:
        specs = tree_specs(axes, template, mesh)
        p_specs = tree_specs(axes["params"], shapes, mesh)
    verbose = verbose and (mesh is None or dist.get_rank() == 0)
    if verbose and mesh is not None:
        print(f"[train] {arch} on mesh {mesh_axes(mesh)}: the "
              f"{train_step.compute} step")

    manager = (CheckpointManager(ckpt_dir, keep_last=keep_last,
                                 policy=ckpt_policy, seg_bytes=ckpt_seg_bytes,
                                 chunk_bytes=ckpt_chunk_bytes)
               if ckpt_dir else None)
    injector = FailureInjector(fail_at_steps=tuple(fail_at))
    detector = StragglerDetector(threshold=4.0)
    log: dict = {"loss": [], "restarts": 0, "resumed_from": [], "step_s": []}

    def make_state(attempt: int):
        start = (manager.latest_step(mesh=mesh) if manager is not None
                 else None)
        if start is None:
            start = 0
            p = (model.init(seed, device=dev) if params is None else
                 tree_map(lambda t: t.detach().to(dev, copy=True), params))
            if mesh is not None:   # keep this rank's shard of each leaf
                it = iter(p_specs)
                p = tree_map(lambda t: shard_spec(t, next(it), mesh), p)
            opt_state = opt.init(p)
        else:
            restored = manager.restore(template, start, device=dev,
                                       mesh=mesh, axes=axes)
            p, opt_state = restored["params"], restored["opt_state"]
            # the step counter stays on the host (optim.adamw)
            opt_state = opt_state._replace(step=opt_state.step.cpu())
            log["resumed_from"].append(start)
            if verbose:
                print(f"[train] attempt {attempt}: resumed step {start}")
        for t in leaves(p):
            t.requires_grad_(True)
        stream = SyntheticLMStream(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=seed, start_step=start)
        return dict(params=p, opt_state=opt_state, stream=stream, start=start)

    def loop(state):
        params_, opt_state = state["params"], state["opt_state"]
        stream = state["stream"]
        tokens_per_step = global_batch * seq_len
        for step in range(state["start"], steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(stream).items()}
            if mesh is not None:
                batch = shard_batch(batch, TOKENS_AXES, mesh)
            try:
                injector.check(step)
            except SimulatedFailure:
                stream.close()
                log["restarts"] += 1
                raise
            params_, opt_state, loss = train_step(params_, opt_state, batch)
            loss = float(loss)  # waits for the step
            dt = time.perf_counter() - t0
            detector.observe(step, dt)
            log["loss"].append(loss)
            log["step_s"].append(dt)
            if manager is not None and (step + 1) % save_every == 0:
                # flat save of both trees under one manifest
                manager.save(step + 1, {"params": params_,
                                        "opt_state": opt_state},
                             mesh=mesh, specs=specs)
            if verbose and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"{tokens_per_step/dt:9.0f} tok/s {dt*1e3:7.1f} ms")
        stream.close()
        if manager is not None:
            manager.save(steps, {"params": params_, "opt_state": opt_state},
                         mesh=mesh, specs=specs)
            manager.wait()
        return dict(params=params_, opt_state=opt_state,
                    final_loss=log["loss"][-1])

    result, rstats = run_with_restarts(make_state, loop,
                                       max_restarts=max_restarts,
                                       restored_step=lambda st: st["start"])
    log["final_loss"] = result["final_loss"]
    log["steps_replayed"] = rstats.steps_replayed
    log["stragglers"] = detector.stragglers
    if manager is not None:
        log["ckpt_wamp"] = manager.wamp()
        log["ckpt_stats"] = manager.stats()
        log["ckpt_timings"] = manager.timings
    log["params"] = tree_map(lambda t: t.detach(), result["params"])
    return log


def _opt_axes(model: Model) -> AdamWState:
    """Logical axes of the AdamW state: the step replicates, the moments
    mirror the params' axes (the JAX trainer's ``_opt_axes``)."""
    return AdamWState((), model.axes(), model.axes())


def _mesh_shape(text: str):
    """``--mesh``: ``"host"``, or ``DATAxMODEL`` as ``(n_data, n_model)``."""
    if text.lower() == "host":
        return "host"
    n_data, n_model = (int(x) for x in text.lower().split("x"))
    return n_data, n_model


def _train_rank(rank, device, shape, kw) -> dict:
    """One rank of ``--mesh``: ``train`` on a ``("data", "model")`` mesh
    over the spawned process group (``"host"``: every rank on "data"); the
    log without its parameters."""
    mesh = (make_host_mesh(device.type) if shape == "host"
            else make_debug_mesh(*shape, device.type))
    log = train(device=device, mesh=mesh, **kw)
    log.pop("params")
    return log


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    ap.add_argument("--mesh", type=_mesh_shape, default=None,
                    metavar="DATAxMODEL|host",
                    help="train on a (data, model) mesh of that many ranks, "
                         "one process each (e.g. 2x2); 'host': one rank per "
                         "card of this machine (one on the CPU), every rank "
                         "on data")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default="nccl",
                    help="with --mesh: nccl for one rank per card, gloo for "
                         "ranks on the CPU or sharing a card")
    args = ap.parse_args()
    kw = dict(arch=args.arch, smoke=args.smoke, steps=args.steps,
              global_batch=args.global_batch, seq_len=args.seq_len,
              lr=args.lr, ckpt_dir=args.ckpt_dir,
              save_every=args.save_every, fail_at=tuple(args.fail_at),
              seed=args.seed)
    if args.mesh is None:
        log = train(device=args.device, **kw)
    else:
        dev = resolve_device(args.device)
        if args.mesh == "host":
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
        else:
            n = args.mesh[0] * args.mesh[1]
        log = spawn_ranks(_train_rank, n, args.mesh, kw,
                          backend=args.dist_backend,
                          device=dev.type)[0]
    print(f"[train] done: final loss {log['final_loss']:.4f}, "
          f"restarts {log['restarts']}"
          + (f", ckpt Wamp {log['ckpt_wamp']:.3f}" if "ckpt_wamp" in log else ""))


if __name__ == "__main__":
    main()
