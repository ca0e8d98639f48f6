"""The collectives of training on a mesh: gather a leaf from its shards,
and all-reduce to the mean over a spec entry's ranks (a rank's shard of a
leaf is :func:`repro_torch.distributed.sharding.shard_spec`).

Each has two routes, chosen by the mesh:

* **a ``DeviceMesh``** (``gloo`` ranks on the CPU or sharing one card, or
  one ``nccl`` rank per card): the collective runs over the process group
  of the spec entry's mesh axes.  One axis is the ``DeviceMesh``'s own
  group; a joint entry (``("pod", "data")``) is a group built here with
  ``dist.new_group`` (not ``DeviceMesh``'s private flattening) over the
  ranks that share every other coordinate, in row-major order of the joint
  axes, once per mesh and kept on it (every rank of the mesh builds every
  such group, in the same order, on its first use);
* **a mesh given as sizes only** (``{"data": 16, "model": 16}``): rank 0
  of a mesh that no process group backs, for the dry-run's count.  It
  takes ``meta`` tensors only (anything else raises), moves no data, and
  returns what the collective would: the gathered shape, the reduced
  tensor.

On both routes, while a counter is active (:mod:`repro_torch.kernels.work`)
each collective is charged as one call with its kind and payload, as
``kernels.ops.gather_heads`` is: an all-gather's payload is its gathered
output's bytes, an all-reduce's its tensor's bytes (the counter counts an
all-reduce twice, for the ring's send and receive, as ``HloCost`` does).
An all-gather also charges its ranks' parts, which it receives before it
joins them, as scratch (``all_gather``: no bytes of its own, the payload
live beside its output while it runs), so the count's peak is the card's.
The ops a route runs inside the call are hidden from the counter, so a
rank's step counts alike on ``meta`` and on the card.  A collective over a
group of one rank is no collective: nothing runs and nothing is charged.
"""

from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from ..kernels import work
from .sharding import mesh_coords, part_axes, spec_shards

def axis_group(mesh, axes: tuple[str, ...]):
    """The process group of the ranks that share this rank's coordinates on
    every mesh axis but ``axes``, ordered row-major over ``axes``."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    # the joint groups this rank belongs to live on the mesh they cut
    if not hasattr(mesh, "_joint_groups"):
        mesh._joint_groups = {}
    key = tuple(axes)
    if key not in mesh._joint_groups:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        rest = ranks.shape[:len(names) - len(axes)]
        ranks = ranks.reshape(*rest, -1)
        mine = mesh_coords(mesh)
        here = tuple(mine[a] for a in names if a not in axes)
        for idx in itertools.product(*(range(n) for n in rest)):
            members = ranks[idx].tolist()
            # a group's ranks are its members in ascending order
            if members != sorted(members):
                raise ValueError(f"joint axes {axes} must follow the mesh's "
                                 f"dim order {names}")
            g = dist.new_group(members)
            if idx == here:
                mesh._joint_groups[key] = g
    return mesh._joint_groups[key]


def _check_route(mesh, t, what: str) -> None:
    if isinstance(mesh, dict) and t.device.type != "meta":
        raise ValueError(f"{what}: a mesh given as sizes only takes meta "
                         f"tensors, not {t.device.type} ones")


def _all_gather(t, dim: int, axes, mesh, n: int):
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    if t.device.type != "meta":
        dist.all_gather(parts, t, group=axis_group(mesh, axes))
    return torch.cat(parts, dim=dim)


def gather(t, spec: tuple, mesh):
    """The whole leaf from this rank's shard ``t`` of a leaf of ``spec``:
    one all-gather per dim the spec cuts, last dim first, each along its
    dim over its entry's ranks in their row-major order.  ``t`` itself
    where ``spec`` cuts nothing."""
    _check_route(mesh, t, "gather")
    for d in reversed(range(len(spec))):
        axes = part_axes(spec[d])
        n = spec_shards((spec[d],), mesh)
        if n == 1:
            continue
        if work.counters:
            payload = n * t.numel() * t.element_size()
            parts = work.KernelWork(0, 0.0, work.dtype_name(t.dtype),
                                    products=False, scratch=payload)
            t = work.charged(lambda: [("all_gather", parts)], _all_gather,
                             t, d, axes, mesh, n,
                             collective=("all-gather", payload))
        else:
            t = _all_gather(t, d, axes, mesh, n)
    return t


def _all_reduce(t, axes, mesh):
    if t.device.type != "meta":
        dist.all_reduce(t, group=axis_group(mesh, axes))
    return t


def all_reduce_mean(t, part, mesh):
    """``t`` summed over the ranks of spec entry ``part`` and divided by
    their number, in place (each rank holds the same result); ``t`` as it
    is where ``part`` names no axis or a group of one."""
    _check_route(mesh, t, "all_reduce_mean")
    axes = part_axes(part)
    n = spec_shards((part,), mesh)
    if n == 1:
        return t
    if work.counters:
        work.charged(list, _all_reduce, t, axes, mesh,
                     collective=("all-reduce", t.numel() * t.element_size()))
    else:
        _all_reduce(t, axes, mesh)
    return t.div_(n)
