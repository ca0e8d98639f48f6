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

**The partitioned train step's operators** (``launch.steps``, the dense
family) are autograd Functions over a spec entry's ranks, each the
backward of another: :func:`copy_to` (identity, all-reduce in the
backward), :func:`reduce_from` (all-reduce, identity in the backward),
:func:`gather_from` (all-gather along a dim, reduce-scatter in the
backward) and :func:`scatter_to` (reduce-scatter along a dim, all-gather in
the backward), Megatron's four; and :func:`fsdp_gather`, a leaf's shard
gathered over its FSDP axis, whose backward reduce-scatters the gradient
back to the shard, and which, under :class:`FsdpHooks`, autograd keeps as
the shard and gathers again when the backward needs it.  Each is charged
as the collective it means (a reduce-scatter's payload is its output's
bytes, as ``HloCost`` reads its result shape; the chunks it sends are
scratch).
"""

from __future__ import annotations

import itertools
import weakref

import torch
import torch.distributed as dist

from ..kernels import work
from .sharding import mesh_axes, mesh_coords, part_axes, spec_shards


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


def all_gather(t, dim: int, part, mesh):
    """``t`` joined along ``dim`` with the same tensors of the ranks of
    spec entry ``part``, in their row-major order; ``t`` itself over a
    group of one."""
    _check_route(mesh, t, "all_gather")
    axes = part_axes(part)
    n = spec_shards((part,), mesh)
    if n == 1:
        return t
    if not work.counters:
        return _all_gather(t, dim, axes, mesh, n)
    payload = n * t.numel() * t.element_size()
    parts = work.KernelWork(0, 0.0, work.dtype_name(t.dtype),
                            products=False, scratch=payload)
    return work.charged(lambda: [("all_gather", parts)], _all_gather,
                        t, dim, axes, mesh, n,
                        collective=("all-gather", payload))


def gather(t, spec: tuple, mesh):
    """The whole leaf from this rank's shard ``t`` of a leaf of ``spec``:
    one all-gather per dim the spec cuts, last dim first, each along its
    dim over its entry's ranks in their row-major order.  ``t`` itself
    where ``spec`` cuts nothing."""
    _check_route(mesh, t, "gather")
    for d in reversed(range(len(spec))):
        t = all_gather(t, d, spec[d], mesh)
    return t


def _index(axes, mesh) -> int:
    """This rank's place among the ranks of ``axes`` (row-major)."""
    sizes, coords = mesh_axes(mesh), mesh_coords(mesh)
    i = 0
    for a in axes:
        i = i * sizes[a] + int(coords[a])
    return i


def _reduce_scatter(t, dim: int, axes, mesh, n: int):
    k = t.shape[dim] // n
    shape = t.shape[:dim] + (k,) + t.shape[dim + 1:]
    out = t.new_empty(shape)
    if t.device.type != "meta":
        dist.reduce_scatter(out, [c.contiguous() for c in t.chunk(n, dim)],
                            group=axis_group(mesh, axes))
    return out


def reduce_scatter(t, dim: int, part, mesh):
    """``t`` summed over the ranks of spec entry ``part``, and this rank's
    part of the sum along ``dim`` (the ``_index``-th of equal parts); ``t``
    itself over a group of one."""
    _check_route(mesh, t, "reduce_scatter")
    axes = part_axes(part)
    n = spec_shards((part,), mesh)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide over {n} ranks")
    if not work.counters:
        return _reduce_scatter(t, dim, axes, mesh, n)
    nbytes = t.numel() * t.element_size()
    chunks = work.KernelWork(0, 0.0, work.dtype_name(t.dtype),
                             products=False, scratch=nbytes)
    return work.charged(lambda: [("reduce_scatter", chunks)],
                        _reduce_scatter, t, dim, axes, mesh, n,
                        collective=("reduce-scatter", nbytes // n))


def _all_reduce(t, axes, mesh, op=None):
    if t.device.type != "meta":
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM,
                        group=axis_group(mesh, axes))
    return t


def all_reduce(t, part, mesh, op: str = "sum"):
    """``t`` reduced (``"sum"`` or ``"max"``) over the ranks of spec entry
    ``part``, in place; ``t`` as it is over a group of one."""
    _check_route(mesh, t, "all_reduce")
    axes = part_axes(part)
    if spec_shards((part,), mesh) == 1:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if work.counters:
        return work.charged(list, _all_reduce, t, axes, mesh, rop,
                            collective=("all-reduce",
                                        t.numel() * t.element_size()))
    return _all_reduce(t, axes, mesh, rop)


def all_reduce_mean(t, part, mesh):
    """``t`` summed over the ranks of spec entry ``part`` and divided by
    their number, in place (each rank holds the same result); ``t`` as it
    is where ``part`` names no axis or a group of one."""
    _check_route(mesh, t, "all_reduce_mean")
    n = spec_shards((part,), mesh)
    if n == 1:
        return t
    return all_reduce(t, part, mesh).div_(n)


# ----------------------------------- the partitioned step's operators

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part, mesh):
        ctx.args = (part, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, part, mesh):
        return all_reduce(x.clone(), part, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, part, mesh):
        ctx.args = (dim, part, mesh)
        return all_gather(x, dim, part, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, part, mesh):
        ctx.args = (dim, part, mesh)
        return reduce_scatter(x, dim, part, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


def _one(part, mesh) -> bool:
    return spec_shards((part,), mesh) == 1


def copy_to(x, part, mesh):
    """``x`` as it is; its gradient summed over ``part``'s ranks (the
    input of a product whose weight is cut over them)."""
    return x if _one(part, mesh) else _CopyTo.apply(x, part, mesh)


def reduce_from(x, part, mesh):
    """``x`` summed over ``part``'s ranks (partial sums made whole); its
    gradient as it is."""
    return x if _one(part, mesh) else _ReduceFrom.apply(x, part, mesh)


def gather_from(x, dim: int, part, mesh):
    """``x`` all-gathered along ``dim`` over ``part``'s ranks; its gradient
    reduce-scattered back to this rank's part."""
    return x if _one(part, mesh) else _GatherFrom.apply(x, dim, part, mesh)


def scatter_to(x, dim: int, part, mesh):
    """``x`` reduce-scattered along ``dim`` over ``part``'s ranks; its
    gradient all-gathered."""
    return x if _one(part, mesh) else _ScatterTo.apply(x, dim, part, mesh)


class FsdpHooks(torch.autograd.graph.saved_tensors_hooks):
    """While active, a tensor that autograd saves for the backward and that
    is (a view of) a weight :func:`fsdp_gather` gathered is kept as the
    shard it came from, and gathered again when the backward unpacks it: a
    layer's gathered weights are freed when its forward ends, as JAX's
    per-layer FSDP gathers are."""

    def __init__(self):
        self.sources: dict = {}   # id(storage) -> (weakref, gather args)
        super().__init__(self._pack, self._unpack)

    def add(self, whole, shard, dim, part, mesh) -> None:
        st = whole.untyped_storage()
        key = id(st)
        self.sources[key] = (weakref.ref(st), (shard.detach(), dim, part,
                                               mesh))
        weakref.finalize(st, self.sources.pop, key, None)

    def _pack(self, t):
        src = self.sources.get(id(t.untyped_storage()))
        if src is None or src[0]() is not t.untyped_storage():
            # an alias of ``t``, not ``t``: an output its own node saves,
            # packed as itself, holds that node in a cycle that Python's
            # collector cannot see, so a node the backward never runs (an
            # unused output's) and every tensor it reaches, the params
            # among them, would never be freed
            return t.detach()
        return src[1], tuple(t.shape), t.stride(), t.storage_offset()

    @staticmethod
    def _unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        (shard, dim, part, mesh), shape, stride, offset = packed
        return all_gather(shard, dim, part, mesh).as_strided(shape, stride,
                                                             offset)


def fsdp_gather(shard, dim: int, part, mesh, hooks: FsdpHooks):
    """A weight's shard gathered whole along ``dim`` over ``part``'s ranks
    (its FSDP axis), its gradient reduce-scattered back to the shard's
    part; while ``hooks`` are active, saved by autograd as the shard."""
    if _one(part, mesh):
        return shard
    whole = _GatherFrom.apply(shard, dim, part, mesh)
    hooks.add(whole, shard, dim, part, mesh)
    return whole
