"""The meshes and the ranks that run on them.

Tensor-parallel serving runs one process per rank (SPMD): every rank runs
the same host planner over the same requests and holds its slice of the kv
heads, and the ranks meet only in the all-gathers of the per-head context
(``kernels.ops.gather_heads``) and the engine's agreement check.

Training runs one process per rank on a ``("data", "model")`` mesh
(:func:`make_debug_mesh`, :func:`make_host_mesh`): each rank holds its
shard of every parameter and moment (``distributed.sharding.DEFAULT_RULES``)
and runs the step of ``launch.steps.make_train_fn(..., mesh=)``.  The JAX
package's production meshes, 16 x 16 and 2 x 16 x 16 TPU chips, are given
as sizes (:func:`make_production_mesh`): the dry-run counts rank 0's step
on them without spawning a rank.

The backend is the caller's choice and nothing switches it on its own:
``nccl`` for one rank per card, ``gloo`` for ranks on the CPU and for
several ranks sharing one card.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist


def make_serving_mesh(n: int, device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` named ``"model"`` over the initialised default
    process group (heads shard over it, everything else replicates).
    ``device_type`` is the ranks' devices' type (``"cpu"`` for ranks on
    the CPU).  Raises unless the group holds exactly ``n`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    _need_group("make_serving_mesh", n)
    return init_device_mesh(device_type, (n,), mesh_dim_names=("model",))


def _need_group(what: str, n: int):
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised process group: run "
                           f"the ranks through spawn_ranks")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"{what} wants {n} ranks but the process group "
                         f"holds {world}")


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` of ``n_data`` x ``n_model``
    ranks (rank r at data r // n_model, model r % n_model) over the
    initialised default process group, which must hold exactly that many
    (``spawn_ranks`` starts them).  ``device_type``: the ranks' devices'
    type (``"cpu"`` for ranks on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    _need_group("make_debug_mesh", n_data * n_model)
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(device_type: str = "cuda"):
    """Every rank of the process group on "data" (the JAX trainer's
    ``make_host_mesh``: ``(n, 1)`` over ``("data", "model")``)."""
    return make_debug_mesh(dist.get_world_size() if dist.is_initialized()
                           else 1, 1, device_type)


def make_production_mesh(*, multi_pod: bool = False) -> dict[str, int]:
    """The JAX package's production meshes as axis sizes: 16 x 16 chips
    (one pod), or 2 pods of them.  A mesh given as sizes runs no rank: the
    dry-run counts rank 0's step on it (``distributed.collectives``)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def rank_device(rank: int, device) -> torch.device:
    """Where rank ``rank`` runs: the CPU, or for ``"cuda"`` the card
    ``rank % device_count`` (several ranks share a card when there are
    fewer cards than ranks)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu'")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, n, backend, device, root, args):
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)   # n ranks share the host's cores
    store = dist.FileStore(os.path.join(root, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n)
    try:
        out = fn(rank, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, n: int, *args, backend: str, device,
                timeout_s: float | None = None) -> list:
    """Run ``fn(rank, device, *args)`` in ``n`` fresh processes, one per
    rank, inside a process group of ``backend`` (``"nccl"`` or
    ``"gloo"``) over a ``FileStore`` in a temporary directory; returns the
    ranks' results in rank order.  ``fn`` must be importable by name (a
    module-level function) and its result picklable.  ``device`` is
    ``"cpu"`` or ``"cuda"`` (rank r on card ``r % device_count``); with
    ``nccl`` there must be a card for each rank.  If a rank fails, the
    others are stopped and this raises; past ``timeout_s`` seconds (None:
    no limit) every rank is killed and this raises ``TimeoutError``."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if torch.device(device).type != "cuda" or cards < n:
            raise ValueError(f"nccl runs one rank per card: {n} ranks on "
                             f"{cards} cards of {device!r}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as root:
        ctx = torch.multiprocessing.spawn(
            _rank_main, args=(fn, n, backend, str(device), root, args),
            nprocs=n, join=False)
        end = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(None if end is None
                           else max(end - time.monotonic(), 0.0)):
            if end is not None and time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"{n} ranks of {fn.__name__} still ran "
                                   f"after {timeout_s} s")
        out = []
        for r in range(n):
            with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
