"""The port's configs and parameters against the JAX package's.

The same JAX parameter tree goes through the bridge into the port; at f32
(and at bf16, through the uint16 view) every leaf must arrive bit-exact, and
the port's own ``init_params`` must draw the JAX package's shapes, dtypes
and scales.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import flatten, init_params

_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_equals_jax_field_for_field(name, smoke):
    mine, theirs = get_config(name), jax_get_config(name)
    if smoke:
        mine, theirs = mine.smoke(), theirs.smoke()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.hd == theirs.hd


def test_get_config_rejects_families_outside_the_slice():
    with pytest.raises(KeyError, match="mamba2"):
        get_config("mamba2-1.3b")


@pytest.mark.parametrize("name", ARCHS)
def test_param_specs_match_jax_layout(name):
    """Full-size spec trees (no arrays materialized): same paths, shapes,
    dtypes and init scales as the JAX package."""
    cfg = get_config(name)
    mine = dict(flatten(tfm.model_specs(cfg)))
    theirs = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            JaxModel(jax_get_config(name)).specs(),
            is_leaf=lambda x: hasattr(x, "axes"))[0]:
        theirs[tuple(p.key for p in path)] = s
    assert mine.keys() == theirs.keys()
    for path, s in mine.items():
        t = theirs[path]
        assert s.shape == t.shape, path
        assert s.dtype == _DTYPES[jnp.dtype(t.dtype)], path
        assert s.scale == pytest.approx(t.scale), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_params_round_trip_bit_exact(dtype):
    cfg = jax_get_config("qwen3-1.7b").smoke()
    params = JaxModel(cfg).init(jax.random.PRNGKey(0))
    if dtype == "float32":
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    host = jax.tree.map(np.asarray, params)
    mine = params_from_jax(host)
    theirs = dict(flatten(host))
    got = dict(flatten(mine))
    assert got.keys() == theirs.keys()
    for path, t in got.items():
        a = theirs[path]
        assert tuple(t.shape) == a.shape, path
        assert t.dtype == _DTYPES[jnp.dtype(a.dtype)], path
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                          a.view(np.uint16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))
    # and the Model holds them as they came, under the same paths
    model = Model(get_config("qwen3-1.7b").smoke(), mine)
    for path, t in flatten(model.params):
        assert torch.equal(t, dict(flatten(mine))[path]), path


def test_init_params_draws_the_jax_shapes_dtypes_and_scales():
    cfg = get_config("qwen3-1.7b").smoke()
    gen = torch.Generator().manual_seed(0)
    mine = dict(flatten(init_params(tfm.model_specs(cfg), gen, device="cpu")))
    theirs = dict(flatten(jax.tree.map(
        np.asarray, JaxModel(jax_get_config("qwen3-1.7b").smoke()).init(
            jax.random.PRNGKey(0)))))
    specs = dict(flatten(tfm.model_specs(cfg)))
    for path, t in mine.items():
        a = theirs[path]
        assert tuple(t.shape) == a.shape and t.dtype == _DTYPES[a.dtype], path
        s = specs[path].scale
        if s == -1.0:
            assert torch.all(t == 1), path
        else:  # N(0, s²): the sample std is within a few percent of s
            assert float(t.float().std()) == pytest.approx(s, rel=0.1), path
            assert float(np.asarray(a, np.float32).std()) == pytest.approx(
                s, rel=0.1), path


def test_init_params_is_seeded():
    cfg = get_config("qwen3-1.7b").smoke()
    a = Model(cfg, device="cpu", seed=3).params
    b = Model(cfg, device="cpu", seed=3).params
    c = Model(cfg, device="cpu", seed=4).params
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])


def test_jax_model_spec_tree_is_what_jtfm_builds():
    # guards the comparison above: the JAX Model's specs are tfm.model_specs
    cfg = jax_get_config("qwen3-1.7b").smoke()
    assert (jax.tree_util.tree_structure(JaxModel(cfg).specs(),
                                         is_leaf=lambda x: hasattr(x, "axes"))
            == jax.tree_util.tree_structure(jtfm.model_specs(cfg),
                                            is_leaf=lambda x: hasattr(x, "axes")))
