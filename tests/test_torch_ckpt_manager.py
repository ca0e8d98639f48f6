"""The port's checkpoint manager against the JAX package's.

* ``flatten_tree`` gives the JAX manager's exact keys (and values) for a
  ``{"params", "opt_state"}`` tree of the smoke model at its default bf16.
* A checkpoint written by the JAX manager restores bit for bit in the port,
  bf16 leaves included, and one written by the port restores bit for bit in
  JAX; the port's store writes bf16 leaves under the dtype name
  ``"bfloat16"``, as the JAX store does.
* A write that fails in the background thread is raised by the next
  ``wait()`` / ``save()``.
* ``restore`` puts each leaf on the asked device in the template's dtype,
  from ``meta``-tensor templates.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import LogStructuredCheckpointStore as JaxStore
from repro.checkpoint import flatten_tree as jax_flatten_tree
from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import opt_state_from_jax, params_from_jax
from repro_torch.checkpoint import (BFloat16Bits, CheckpointManager,
                                    LogStructuredCheckpointStore,
                                    flatten_tree, unflatten_like)
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import abstract_params
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, leaves_with_path

STORE = dict(seg_bytes=1 << 16, chunk_bytes=4 << 10)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """The same {"params", "opt_state"} state in both packages: the smoke
    model's bf16 draw and AdamW moments after one update."""
    cfg = jax_get_config("qwen3-1.7b").smoke()
    params = JaxModel(cfg).init(jax.random.PRNGKey(2))
    opt = JaxAdamW(lr=1e-3)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, st = opt.update(params, grads, opt.init(params))
    jtree = {"params": params, "opt_state": st}
    host = jax.tree.map(np.asarray, jtree)
    tree = {"params": params_from_jax(host["params"]),
            "opt_state": opt_state_from_jax(host["opt_state"])}
    return jtree, tree


def _bits(a) -> np.ndarray:
    """The raw bytes of a leaf (numpy, JAX or torch) as uint8."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


def _template():
    """Shapes and dtypes only: meta params and the moments AdamW makes."""
    p = abstract_params(tfm.model_specs(get_config("qwen3-1.7b").smoke()))
    return {"params": p, "opt_state": AdamW().init(p)}


def test_flatten_tree_gives_the_jax_keys_and_values(trees):
    jtree, tree = trees
    jflat, flat = jax_flatten_tree(jtree), flatten_tree(tree)
    assert list(flat) == list(jflat)
    assert "opt_state/.step" in flat and "opt_state/.mu/blocks/attn/wq" in flat
    for k, a in flat.items():
        assert _bits(a).tobytes() == _bits(jflat[k]).tobytes(), k
        bf16 = jflat[k].dtype == jnp.bfloat16
        assert isinstance(a, BFloat16Bits) == bf16, k
        if not bf16:
            assert a.dtype == jflat[k].dtype, k
    back = unflatten_like(tree, flat)
    for (path, a), (_, b) in zip(leaves_with_path(back),
                                 leaves_with_path(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_jax_checkpoint_restores_bitwise_in_the_port(trees, tmp_path):
    jtree, _ = trees
    jm = JaxManager(tmp_path, keep_last=2, **STORE)
    jm.save(7, jtree)
    jm.wait()
    got = CheckpointManager(tmp_path, keep_last=2, **STORE).restore(
        _template(), device="cpu")
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jtree)))
    n_bf16 = 0
    for path, t in leaves_with_path(got):
        w = want[path]
        assert t.device.type == "cpu" and t.shape == tuple(w.shape), path
        assert (t.dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16), path
        n_bf16 += t.dtype == torch.bfloat16
        assert _bits(t).tobytes() == _bits(w).tobytes(), path
    assert n_bf16 >= 8
    assert int(got["opt_state"].step) == 1


def test_port_checkpoint_restores_bitwise_in_jax(trees, tmp_path):
    jtree, tree = trees
    pm = CheckpointManager(tmp_path, keep_last=2, **STORE)
    pm.save(3, tree)
    pm.wait()
    manifest = json.loads((tmp_path / "manifests" /
                           "step_000000003.json").read_text())
    assert manifest["leaves"]["params/blocks/attn/wq"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["params/final_norm"]["dtype"] == "float32"
    got = JaxManager(tmp_path, keep_last=2, **STORE).restore(jtree, 3)
    want = dict(leaves_with_path(tree))
    for path, a in leaves_with_path(jax.tree.map(np.asarray, got)):
        assert _bits(a).tobytes() == _bits(want[path]).tobytes(), path
    assert got["params"]["embed"].dtype == jnp.bfloat16


def test_store_restores_bf16_as_bits_for_both_packages(tmp_path):
    bits = np.arange(0x3f00, 0x3f00 + 24, dtype=np.uint16).reshape(4, 6)
    store = LogStructuredCheckpointStore(tmp_path, **STORE)
    store.save(1, {"w": bits.view(BFloat16Bits), "n": np.arange(5)})
    back = store.restore(1)
    assert isinstance(back["w"], BFloat16Bits)
    np.testing.assert_array_equal(back["w"].view(np.uint16), bits)
    assert not isinstance(back["n"], BFloat16Bits)
    jback = JaxStore(tmp_path, **STORE).restore(1)
    assert jback["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(jback["w"].view(np.uint16), bits)


def test_background_write_failure_is_raised_by_the_next_wait(tmp_path,
                                                              monkeypatch):
    mgr = CheckpointManager(tmp_path, **STORE)
    tree = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(mgr.store, "save", broken)
    mgr.save(1, tree)  # returns: the write runs in the background
    with pytest.raises(RuntimeError, match="background checkpoint save "
                       "failed") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.wait()  # raised once
    mgr.save(2, tree)
    with pytest.raises(RuntimeError):
        mgr.save(3, tree)  # the next save surfaces the previous failure
    with pytest.raises(RuntimeError):
        mgr.save(4, tree, block=True)


def test_snapshot_is_a_copy_taken_before_save_returns(tmp_path):
    """The background thread writes the values of the moment of ``save``:
    an in-place update right after it does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, **STORE)
    w = torch.arange(2048, dtype=torch.float32)
    mgr.save(1, {"w": w})
    w.mul_(-1)  # the next step's in-place update
    got = mgr.restore({"w": torch.empty(2048, device="meta")}, 1,
                      device="cpu")
    assert torch.equal(got["w"], torch.arange(2048, dtype=torch.float32))
    assert len(mgr.timings["snapshot_s"]) == len(mgr.timings["write_s"]) == 1


def test_restore_casts_to_the_template_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path, **STORE)
    mgr.save(1, {"a": torch.linspace(-2, 2, 9, dtype=torch.float32),
                 "b": [torch.ones(3, dtype=torch.bfloat16)]})
    tmpl = {"a": torch.empty(9, dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty(3, dtype=torch.float32, device="meta")]}
    got = mgr.restore(tmpl, device="cpu")
    assert got["a"].dtype == torch.bfloat16 and got["b"][0].dtype == \
        torch.float32
    assert torch.equal(got["a"], torch.linspace(-2, 2, 9).to(torch.bfloat16))
    assert isinstance(got["b"], list)
    assert mgr.latest_step() == 1 and mgr.wamp() == 0.0
    assert all(t.device.type == "cpu" for t in leaves(got))
