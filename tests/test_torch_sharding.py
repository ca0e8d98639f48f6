"""The port's training-mesh sharding against the JAX package's, in process
(no ranks): the resolver under ``DEFAULT_RULES`` on meshes given as sizes,
the logical axes of every arch's parameters and decode cache, the
per-device bytes at the JAX production meshes, and the collectives' route
for a mesh given as sizes only (``meta`` tensors, the collective charged).

JAX's ``resolve_spec`` reads only a mesh's ``axis_names`` and ``shape``, so
a duck-typed mesh (``tests/test_sharding.py``'s ``_FakeMesh``) lets it run
on the 256- and 512-device meshes without devices.  The JAX side runs on
the CPU (``JAX_PLATFORMS=cpu``).
"""

import types

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jax_sharding
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro_torch.configs import ARCHS, SHAPES, get_config, skip_reason
from repro_torch.distributed import collectives, sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW
from repro_torch.roofline.op_cost import OpCost
from repro_torch.tree import leaves, leaves_with_path


def fake_mesh(sizes: dict):
    """What JAX's resolver and ``tree_bytes_per_device`` read of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes), shape=dict(sizes))


MESHES = [{"data": 5, "model": 3}, {"model": 8},
          {"pod": 2, "data": 3, "model": 4}]
AXIS_NAMES = [None, "batch", "seq", "seq_act", "seq_kv", "vocab", "embed",
              "heads", "kv", "head_dim", "ff", "experts", "lora", "layers",
              "state"]
PRODUCTION = {"single": make_production_mesh(multi_pod=False),
              "multi": make_production_mesh(multi_pod=True)}


def _check_resolver(sizes, shape, axes):
    want = jax_sharding.resolve_spec(shape, axes, fake_mesh(sizes),
                                     jax_sharding.DEFAULT_RULES)
    got = sharding.resolve_spec(shape, axes, sizes, sharding.DEFAULT_RULES)
    assert got == tuple(want), (shape, axes, sizes)
    assert sharding.spec_shards(got, sizes) == jax_sharding.spec_shards(
        want, fake_mesh(sizes))


@given(st.integers(0, len(MESHES) - 1),
       st.lists(st.tuples(st.sampled_from(AXIS_NAMES), st.integers(0, 48)),
                min_size=1, max_size=5))
@settings(max_examples=200, deadline=None)
def test_resolver_matches_jax_property(mi, dims):
    _check_resolver(MESHES[mi], tuple(s for _, s in dims),
                    tuple(a for a, _ in dims))


@pytest.mark.parametrize("sizes", MESHES, ids=lambda m: "x".join(
    f"{k}{v}" for k, v in m.items()))
def test_resolver_matches_jax_on_drawn_cases(sizes):
    """The property's body over 400 cases drawn from a seeded generator
    (dims a product of the mesh's sizes half the time, so joint and
    single candidates both divide), which runs without hypothesis."""
    rng = np.random.default_rng(sum(sizes.values()))
    factors = [1, 2, 3, 4, 5, 8, 16]
    for _ in range(400):
        n = int(rng.integers(1, 6))
        axes = tuple(AXIS_NAMES[i] for i in rng.integers(0, len(AXIS_NAMES),
                                                          n))
        shape = tuple(int(rng.choice(factors) * rng.choice(factors))
                      if rng.random() < 0.5 else int(rng.integers(0, 49))
                      for _ in range(n))
        _check_resolver(sizes, shape, axes)


def test_joint_candidate_and_fallbacks():
    """The batch takes ("pod", "data") where both divide, "data" alone
    where only it does, and nothing where neither; embed cannot reuse a
    taken "data"; kv falls back to "data" where "model" is taken."""
    mesh = {"pod": 2, "data": 4, "model": 8}
    rs = lambda shape, axes: sharding.resolve_spec(  # noqa: E731
        shape, axes, mesh, sharding.DEFAULT_RULES)
    assert rs((16, 64), ("batch", "embed")) == (("pod", "data"),)
    assert rs((4, 64), ("batch", "embed")) == ("data",)
    assert rs((3, 64), ("batch", "embed")) == (None, "data")
    assert rs((2, 1, 64, 8, 128), ("layers", "batch", "seq_kv", "kv",
                                   "head_dim")) == (None, None, "model",
                                                    "data")
    # the serving rules stay the default of resolve_spec
    assert sharding.resolve_spec((2, 16, 32, 128), (
        "layers", "heads", "head_dim", "embed"), mesh) == (None, "model")


def test_joint_rank_slices_are_row_major():
    """A rank's index on ("pod", "data") is pod * |data| + data."""
    mesh = {"pod": 2, "data": 3, "model": 4}
    seen = []
    for pod in range(2):
        for data in range(3):
            sl = sharding.rank_slice(12, ("pod", "data"), mesh,
                                     {"pod": pod, "data": data, "model": 0})
            seen.append((sl.start, sl.stop))
    assert seen == [(2 * i, 2 * i + 2) for i in range(6)]


def _flat(tree) -> dict:
    return {"/".join(p): v for p, v in leaves_with_path(
        tree, is_leaf=sharding.is_axes)}


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_are_the_jax_ones(arch):
    """``Model.axes()`` and the decode cache's axes at full width, flat
    path by flat path; the spec tree draws what it drew before it had
    axes (``init_params`` unchanged)."""
    cfg, jm = get_config(arch), JModel(j_get_config(arch))
    m = Model(cfg, params={})
    assert _flat(m.axes()) == _flat(jm.axes())
    _, j_axes = jm.cache_spec(2, 64)
    assert _flat(m.cache_axes()) == _flat(j_axes)
    shapes = {k: tuple(t.shape) for k, t in _flat(m.abstract()).items()}
    assert shapes.keys() == _flat(m.axes()).keys()
    assert all(len(shapes[k]) == len(ax) for k, ax in _flat(m.axes()).items())


def _cache_meta(cfg, B, S):
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in tfm.cache_spec(cfg, B, S).items()}


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_per_device_are_the_jax_ones(arch, mesh_kind):
    """Params, both moments and each applicable shape's decode cache at
    the JAX production mesh: the port's ``tree_bytes_per_device`` equals
    JAX's on the same abstract trees, and the dry-run's record keys carry
    them."""
    sizes = PRODUCTION[mesh_kind]
    fm = fake_mesh(sizes)
    cfg, jm = get_config(arch), JModel(j_get_config(arch))
    m = Model(cfg, params={})
    p_abs, j_abs = m.abstract(), jm.abstract()
    assert sharding.tree_bytes_per_device(m.axes(), p_abs, sizes) == (
        jax_sharding.tree_bytes_per_device(jm.axes(), j_abs, fm))
    mu, j_mu = AdamW().abstract_state(p_abs).mu, JAdamW().abstract_state(
        j_abs).mu
    assert sharding.tree_bytes_per_device(m.axes(), mu, sizes) == (
        jax_sharding.tree_bytes_per_device(jm.axes(), j_mu, fm))
    for name, shape in SHAPES.items():
        if skip_reason(cfg, name) or shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        c_abs, c_axes = jm.cache_spec(B, S)
        want = jax_sharding.tree_bytes_per_device(c_axes, c_abs, fm)
        assert sharding.tree_bytes_per_device(
            m.cache_axes(), _cache_meta(cfg, B, S), sizes) == want, name
        rec = dryrun.bytes_per_device(m, shape, sizes)
        assert rec["cache_bytes_per_device"] == want
    rec = dryrun.bytes_per_device(m, SHAPES["train_4k"], sizes)
    assert rec["opt_bytes_per_device"] == 2 * (
        jax_sharding.tree_bytes_per_device(jm.axes(), j_mu, fm))


def test_gather_round_trip_on_sizes_only_mesh():
    """Rank 0's shards of the smoke tree, gathered on a mesh given as
    sizes: every leaf comes back at its whole shape, and the counter is
    charged one all-gather per cut dim, its payload the gathered bytes."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    m = Model(get_config("qwen3-1.7b").smoke(), params={})
    whole = m.abstract()
    specs = sharding.tree_specs(m.axes(), whole, sizes)
    shards = [sharding.shard_spec(t, sp, sizes) for t, sp in
              zip(leaves(whole), specs)]
    assert sum(t.numel() * t.element_size() for t in shards) == (
        sharding.tree_bytes_per_device(m.axes(), whole, sizes))
    want_calls, want_bytes = 0, 0
    for t, sp in zip(leaves(whole), specs):
        n = 1
        for d in reversed(range(len(sp))):
            k = sharding.spec_shards((sp[d],), sizes)
            if k > 1:
                n *= k
                want_calls += 1
                want_bytes += t.numel() * t.element_size() * n // (
                    sharding.spec_shards(sp, sizes))
    with OpCost() as oc:
        back = [collectives.gather(t, sp, sizes) for t, sp in
                zip(shards, specs)]
    assert [tuple(t.shape) for t in back] == [tuple(t.shape)
                                              for t in leaves(whole)]
    s = oc.summary()
    assert want_calls > 0
    assert s["collective_counts"] == {"all-gather": want_calls}
    assert s["collective_bytes_per_device"] == {"all-gather": want_bytes}
    # the parts each gather receives before it joins them: scratch only
    assert s["kernel_charges"] == {"all_gather": {
        "calls": want_calls, "bytes": 0, "flops": {}}}
    assert s["flops_per_device"] == 0


def test_all_reduce_on_sizes_only_mesh_is_charged_twice():
    sizes = {"pod": 2, "data": 2, "model": 2}
    t = torch.empty(4, 8, dtype=torch.float32, device="meta")
    with OpCost() as oc:
        collectives.all_reduce_mean(t, ("pod", "data"), sizes)
        collectives.all_reduce_mean(t, "model", {"data": 2, "model": 1})
    s = oc.summary()
    assert s["collective_counts"] == {"all-reduce": 1}
    assert s["collective_bytes_per_device"] == {"all-reduce": 2 * 4 * 8 * 4}


def test_sizes_only_route_takes_meta_tensors_only():
    with pytest.raises(ValueError, match="meta"):
        collectives.gather(torch.zeros(4, 2), ("data",), {"data": 2})
    with pytest.raises(ValueError, match="meta"):
        collectives.all_reduce_mean(torch.zeros(2), "data", {"data": 2})
    with pytest.raises(ValueError, match="sizes only"):
        from repro_torch.launch.steps import build_cell
        build_cell(get_config("qwen3-1.7b").smoke(),
                   SHAPES["train_4k"].scaled_for_smoke(), "cpu",
                   mesh={"data": 2, "model": 1})
