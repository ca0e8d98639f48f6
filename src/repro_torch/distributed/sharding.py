"""Logical-axis sharding rules of tensor-parallel serving, divisibility-safe.

A trimmed copy of the JAX package's ``distributed/sharding.py``
(``SERVING_RULES``, ``resolve_spec``, ``spec_shards``) that works on mesh axis
names and sizes instead of ``jax.sharding``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a plain
``{axis name: size}`` mapping.  A spec is a tuple with one entry per leading
dim (a mesh axis name or None), trailing Nones stripped, as
``tuple(PartitionSpec)`` reads.

The resolver walks a tensor's dims left to right and gives each the mesh axis
of its logical axis where that axis is (a) in the mesh, (b) not taken by an
earlier dim of the same tensor and (c) divides the dim's size; anything else
replicates instead of failing (kv heads that a mesh does not divide keep
whole pools on every rank).
"""

from __future__ import annotations

# Serving (tensor-parallel decode) rules, logical axis -> mesh axis: only the
# per-head axes shard, and only over "model".  Everything else (embed, ff,
# vocab, batch) replicates, so every cross-head contraction of the decode
# step is computed in full on every rank, after an all-gather of the per-head
# context: no floating-point reduction changes its order, which keeps the
# sharded engine's tokens those of the one-device engine.
SERVING_RULES: dict[str, str] = {"heads": "model", "kv": "model"}

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


def resolve_spec(shape: tuple, axes: tuple, mesh) -> tuple:
    """The spec of a tensor of ``shape`` with logical ``axes`` on ``mesh``
    under :data:`SERVING_RULES`."""
    sizes = mesh_axes(mesh)
    used: set[str] = set()
    parts = []
    for size, ax in zip(shape, axes):
        m = SERVING_RULES.get(ax)
        if m in sizes and m not in used and size > 0 and size % sizes[m] == 0:
            used.add(m)
            parts.append(m)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def spec_shards(spec: tuple, mesh) -> int:
    """How many shards a tensor of ``spec`` is cut into."""
    sizes = mesh_axes(mesh)
    n = 1
    for p in spec:
        if p is not None:
            n *= sizes[p]
    return n


def rank_slice(size: int, part, mesh, coords: dict[str, int]) -> slice:
    """The slice of a dim of ``size`` that the rank at mesh ``coords``
    ({axis name: index}) holds, for a spec entry ``part`` (None: the whole
    dim; an axis name: that axis's ``coords``-th of its equal parts)."""
    if part is None:
        return slice(0, size)
    step = size // mesh_axes(mesh)[part]
    idx = int(coords[part])
    return slice(idx * step, (idx + 1) * step)


def mesh_coords(mesh) -> dict[str, int]:
    """This process's coordinates on a ``DeviceMesh``: {axis name: index}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard(t, axes: tuple, mesh, coords: dict[str, int] | None = None):
    """This rank's slice of ``t`` (logical ``axes``) on ``mesh``, as a
    contiguous copy where any dim is cut, else ``t`` itself.  ``coords``
    defaults to this process's place on the ``DeviceMesh``."""
    spec = resolve_spec(tuple(t.shape), axes, mesh)
    if all(p is None for p in spec):
        return t
    coords = mesh_coords(mesh) if coords is None else coords
    index = tuple(rank_slice(t.shape[d], p, mesh, coords)
                  for d, p in enumerate(spec))
    return t[index].contiguous()
