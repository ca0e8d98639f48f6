"""The port's training forward, loss and gradients against the JAX package's, with both sides' parameters cast to float32 (the CPU computes
f32 products in f32).

* ``forward`` and ``Model.loss`` for the dense and moe smoke configs (the
  moe one without drops, at the smoke capacity factor 4.0, and with drops,
  at 1.0): logits within 2e-5, loss within 2e-5; the gradients of the loss
  (``jax.grad`` against autograd) within 1e-4 of each leaf's max-abs.
* ``aux_load_balance_loss`` within 1e-6.
* ``remat`` ``"full"`` and ``"dots"`` give ``"none"``'s loss and gradients
  bit for bit.

The train step and ``train()`` are held in ``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model, moe
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaves, leaves_with_path

TOL = dict(rtol=2e-5, atol=2e-5)
CASES = {"dense": ("qwen3-1.7b", None), "moe": ("qwen3-moe-30b-a3b", None),
         "moe-drops": ("qwen3-moe-30b-a3b", 1.0)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, capacity_factor):
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    if capacity_factor is not None:
        jcfg = jcfg.with_(capacity_factor=capacity_factor)
        cfg = cfg.with_(capacity_factor=capacity_factor)
    return jcfg, cfg


def _f32_pair(jcfg, seed=0):
    """JAX f32 params and the port's copy of them, leaves requiring grad."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(seed)))
    p = params_from_jax(jax.tree.map(np.asarray, jp))
    for t in leaves(p):
        t.requires_grad_(True)
    return jp, p


def _tokens(vocab, shape=(2, 64), seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    jcfg, cfg = _configs(*CASES[case])
    jm, model = JaxModel(jcfg), Model(cfg, params={})
    jp, p = _f32_pair(jcfg)
    toks = _tokens(cfg.vocab_size)

    @jax.jit
    def jax_side(params, tokens):
        return (jax.value_and_grad(jm.loss)(params, {"tokens": tokens}),
                jm.forward(params, tokens))

    (jloss, jgrads), jlogits = jax_side(jp, jnp.asarray(toks))
    logits = model.forward(p, torch.from_numpy(toks))
    loss = model.loss(p, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves(p))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for (path, _), g in zip(leaves_with_path(p), grads):
        w = want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg="/".join(path))
    if cfg.family == "moe":  # the capacity binds in the drops case only
        with torch.no_grad():
            x = tfm._embed(p, torch.from_numpy(toks))
            xg, top_p, top_e, cap = moe._route(
                x, p["blocks"]["mlp"]["router"][0], cfg, cfg.capacity_factor,
                cfg.moe_groups)
            keep = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts,
                                       cfg.top_k, cap)[1][3]
        assert bool((~keep).any()) == (case == "moe-drops")


def test_aux_load_balance_loss_matches_jax():
    jcfg, cfg = _configs("qwen3-moe-30b-a3b", None)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, cfg.n_experts)) * 0.3
              ).astype(np.float32)
    got = moe.aux_load_balance_loss(torch.from_numpy(x),
                                    {"router": torch.from_numpy(router)}, cfg)
    want = jmoe.aux_load_balance_loss(jnp.asarray(x),
                                      {"router": jnp.asarray(router)}, jcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_grads(remat):
    jcfg, cfg = _configs("qwen3-1.7b", None)
    _, p = _f32_pair(jcfg)
    toks = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size))}
    out = []
    for r in ("none", remat):
        loss = Model(cfg.with_(remat=r), params={}).loss(p, toks)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves(p))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_forward_refuses_other_families():
    """Every family of the JAX package runs in the port; only a family the
    JAX package does not know raises, as JAX's ``ValueError(family)``."""
    cfg = get_config("qwen3-1.7b").smoke().with_(family="retnet")
    with pytest.raises(ValueError, match="retnet"):
        tfm.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)
