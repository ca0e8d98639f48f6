"""Logical-axis sharding rules, divisibility-safe.

A copy of the JAX package's ``distributed/sharding.py`` (``DEFAULT_RULES``,
``SERVING_RULES``, ``resolve_spec``, ``spec_shards``,
``tree_bytes_per_device``; ``tree_specs`` for its ``tree_shardings``) that
works on mesh axis names and sizes instead of ``jax.sharding``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a plain
``{axis name: size}`` mapping (a mesh given as sizes only: the dry-run's
256- and 512-rank meshes, counted as rank 0 without spawning a rank).  A
spec is a tuple with one entry per leading dim, trailing Nones stripped,
as ``tuple(PartitionSpec)`` reads: None (replicated), a mesh axis name, or
a tuple of names (a joint axis, e.g. ``("pod", "data")``).

Rules map each logical axis to an ordered list of mesh-axis candidates
(tuples are joint shardings, tried as a whole).  The resolver walks a
tensor's dims left to right and gives each the first candidate whose mesh
axes are (a) in the mesh, (b) not taken by an earlier dim of the same
tensor and (c) divide the dim's size; anything else replicates instead of
failing (kv heads that a mesh does not divide keep whole pools on every
rank).

Two rule sets, each with its own callers: :data:`SERVING_RULES`, the
serving engine's, which :func:`resolve_spec` takes unless given others and
which :func:`shard` (the engine's slicer) always takes; and
:data:`DEFAULT_RULES`, the JAX package's training and dry-run rules, which
:func:`tree_specs` and :func:`tree_bytes_per_device` always take (the
training step, the checkpoint manager and the dry-run call them, and pass
``DEFAULT_RULES`` where they call :func:`resolve_spec` themselves).

The JAX ``logical_constraint`` has no counterpart: it only steers GSPMD's
choice of collectives inside one jitted program, and the port's ranks run
eager programs whose collectives are explicit
(:mod:`repro_torch.distributed.collectives`).
"""

from __future__ import annotations

import math
from typing import Any

from ..tree import leaves, tree_map

# Preference-ordered candidates per logical axis: the JAX package's
# DEFAULT_RULES.  FSDP on "embed" over "data"; heads, kv, ff, vocab,
# experts, the MLA latent and the decode cache's length over "model"; the
# batch over "pod" x "data" (row-major: a rank's index is pod * |data| +
# data) or "data" alone; kv heads fall back to "data" where "model" is
# taken (a long-context decode cache at batch 1 shards its length on
# "model").
DEFAULT_RULES: dict[Any, list[tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "seq": [],
    "seq_act": [("model",)],
    "seq_kv": [("model",)],
    "vocab": [("model",)],
    "embed": [("data",)],
    "heads": [("model",)],
    "kv": [("model",), ("data",)],
    "head_dim": [],
    "ff": [("model",)],
    "experts": [("model",)],
    "lora": [("model",)],
    "layers": [],
    "state": [],
    None: [],
}

# Serving (tensor-parallel decode) rules: only the per-head axes shard, and
# only over "model".  Everything else (embed, ff, vocab, batch) replicates,
# so every cross-head contraction of the decode step is computed in full on
# every rank, after an all-gather of the per-head context: no floating-point
# reduction changes its order, which keeps the sharded engine's tokens those
# of the one-device engine.
SERVING_RULES: dict[Any, list[tuple[str, ...]]] = {
    "heads": [("model",)],
    "kv": [("model",)],
    None: [],
}

# logical axes of the serving engine's paged K/V pools, layout (layers,
# n_pages, page_T, kv_heads, head_dim): pages stay global (one host plan
# drives every rank), the kv heads shard
KV_POOL_AXES = ("layers", None, None, "kv", None)
# the head-sharded serving parameters and their logical axes; every other
# parameter replicates
HEAD_SHARDED_PARAMS = {
    "wq": ("layers", "embed", "heads", "head_dim"),
    "wk": ("layers", "embed", "kv", "head_dim"),
    "wv": ("layers", "embed", "kv", "head_dim"),
}


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with named dims, or of a
    mapping given as such."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def part_axes(part) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, else its names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def resolve_spec(shape: tuple, axes: tuple, mesh,
                 rules: dict = SERVING_RULES) -> tuple:
    """The spec of a tensor of ``shape`` with logical ``axes`` on ``mesh``
    under ``rules`` (the engine's unless given others)."""
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts = []
    for size, ax in zip(shape, axes):
        choice = None
        for cand in rules.get(ax, ()):
            if not all(m in sizes and m not in used for m in cand):
                continue
            if size > 0 and size % math.prod(sizes[m] for m in cand) == 0:
                choice = cand
                break
        if choice:
            used.update(choice)
            parts.append(choice if len(choice) > 1 else choice[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_shards(spec: tuple, mesh) -> int:
    """How many shards a tensor of ``spec`` is cut into."""
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for p in spec for a in part_axes(p))


def is_axes(x) -> bool:
    """Whether ``x`` is one leaf's logical axes (a tuple of names or
    None), the ``is_leaf`` of a tree walk over an axes tree."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(axes_tree, tree, mesh) -> list:
    """Logical-axes tree + tree of tensors (``meta`` ones will do) -> one
    spec per leaf, in ``tree``'s leaf order, under :data:`DEFAULT_RULES`
    (the JAX ``tree_shardings``)."""
    return [resolve_spec(tuple(t.shape), ax, mesh, DEFAULT_RULES)
            for ax, t in zip(leaves(axes_tree, is_leaf=is_axes),
                             leaves(tree))]


def tree_bytes_per_device(axes_tree, abstract_tree, mesh) -> int:
    """Per-device bytes of a sharded tree of tensors (``meta`` ones will
    do) under :data:`DEFAULT_RULES`: each leaf's bytes over its shards,
    rounded down as the JAX function does."""

    def one(ax, t):
        spec = resolve_spec(tuple(t.shape), ax, mesh, DEFAULT_RULES)
        return t.numel() * t.element_size() // spec_shards(spec, mesh)

    return sum(leaves(tree_map(one, axes_tree, abstract_tree,
                               is_leaf=is_axes)))


def mesh_coords(mesh) -> dict[str, int]:
    """This process's coordinates on a ``DeviceMesh`` ({axis name:
    index}); on a mesh given as sizes only, rank 0's (every index 0)."""
    if isinstance(mesh, dict):
        return {name: 0 for name in mesh}
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def rank_slice(size: int, part, mesh, coords: dict[str, int]) -> slice:
    """The slice of a dim of ``size`` that the rank at mesh ``coords``
    holds, for a spec entry ``part`` (None: the whole dim; an axis name or
    a joint tuple: that entry's ``coords``-th of its equal parts, a joint
    entry's index row-major over its axes: ``("pod", "data")``, pod *
    |data| + data)."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in part_axes(part):
        idx = idx * sizes[a] + int(coords[a])
        n *= sizes[a]
    step = size // n
    return slice(idx * step, (idx + 1) * step)


def shard_view(t, spec: tuple, mesh, coords: dict[str, int] | None = None):
    """The view of ``t`` that the rank at ``coords`` (default: this
    process's place, rank 0's on a mesh given as sizes) holds under
    ``spec``; ``t`` itself where ``spec`` cuts nothing."""
    if spec_shards(spec, mesh) == 1:
        return t
    coords = mesh_coords(mesh) if coords is None else coords
    return t[tuple(rank_slice(t.shape[d], p, mesh, coords)
                   for d, p in enumerate(spec))]


def shard_spec(t, spec: tuple, mesh, coords: dict[str, int] | None = None):
    """:func:`shard_view` as a contiguous copy where ``spec`` cuts a dim
    (so the whole tensor can be freed), else ``t`` itself."""
    v = shard_view(t, spec, mesh, coords)
    return t if v is t else v.contiguous()


def shard(t, axes: tuple, mesh, coords: dict[str, int] | None = None):
    """This rank's slice of ``t`` (logical ``axes``) on the serving
    ``mesh`` under :data:`SERVING_RULES`, as a contiguous copy where any
    dim is cut, else ``t`` itself.  ``coords`` defaults to this process's
    place on the ``DeviceMesh``."""
    return shard_spec(t, resolve_spec(tuple(t.shape), axes, mesh,
                                      SERVING_RULES), mesh, coords)
