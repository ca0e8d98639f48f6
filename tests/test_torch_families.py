"""The MLA-MoE, SSM and hybrid families end to end against the JAX package,
at smoke width with f32 parameters (the CPU computes f32 products in f32).

Cases: deepseek-v2-lite-16b (``mla_moe``), mamba2-1.3b (``ssm``), zamba2-7b
(``hybrid``, 4 layers at period 2: two groups, no tail) and zamba2-7b at 5
layers (two groups and a tail layer).  The same JAX draw goes through the
bridge into the port.

* ``forward`` logits within ``BAR`` of their max-abs, ``Model.loss``
  within 2e-5 (rtol and atol); the gradients of the loss within
  ``GRAD_BAR`` of each leaf's max-abs.
* ``prefill`` of a 21-token prompt (ragged against the smoke SSD chunk of
  16), then 8 ``decode_step``s fed the true next tokens, f32 cache, from the
  port's own cache and from the JAX prefill's cache carried over by
  ``bridge.cache_from_jax``: logits and caches within ``BAR`` of the
  max-abs of JAX's (its jitted ``decode_step``).
* ``greedy_decode``: the tokens of JAX's (prefill, then its jitted
  ``decode_step`` and argmax), or a first mismatch where the JAX logits'
  top-2 margin is below 1e-3.
* The full configs' ``n_params`` / ``n_active_params`` equal JAX's.
* One ``make_train_fn`` step (the JAX trainer's AdamW) against JAX's step: loss within 1e-5 relative; updated params within 1e-4, but for at
  most 1e-3 of a leaf's elements, which stay within 2·lr + 1e-4.  AdamW's
  first update is lr·g/(|g| + eps) per element: where a gradient is within
  rounding of 0 its sign can differ between the packages, and the update
  with it (mamba2's ``in_x`` measured one such element in 131k, 3.4e-4
  apart).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro.optim import AdamW as JaxAdamW
from repro_torch.bridge import cache_from_jax, params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_fn
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, leaves_with_path

TOL = dict(rtol=2e-5, atol=2e-5)
CASES = {"mla_moe": ("deepseek-v2-lite-16b", {}),
         "ssm": ("mamba2-1.3b", {}),
         "hybrid": ("zamba2-7b", {}),
         "hybrid-tail": ("zamba2-7b", {"n_layers": 5})}
PROMPT, N_DECODE = 21, 8
# Bars relative to the max-abs of JAX's output.  XLA's and ATen's f32
# matmuls round the projections a few ulps apart, and a stack of random
# smoke SSM blocks multiplies that by ~2.5 per layer: mamba2's smoke config
# measured 3.1e-6, 1.1e-5 and 2.9e-5 of the logits' max-abs at 2, 4 and 5
# layers (gradients 7.4e-6, 5.0e-5, 1.8e-4 of a leaf's).  So the 2-layer
# families are held to 2e-5 (measured: mla_moe 3.7e-6, ssm 3.1e-6) and the
# hybrid's 4 and 5 SSM layers to 1e-4 (measured 1.9e-5 and 3.5e-5); the
# gradients to 1e-4 and 1e-3 (measured at most 8.3e-6 and 2.0e-4).
BAR = {"mla_moe": 2e-5, "ssm": 2e-5, "hybrid": 1e-4, "hybrid-tail": 1e-4}
GRAD_BAR = {"mla_moe": 1e-4, "ssm": 1e-4, "hybrid": 1e-3,
            "hybrid-tail": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(case):
    arch, kw = CASES[case]
    return (jax_get_config(arch).smoke().with_(**kw),
            get_config(arch).smoke().with_(**kw))


def _f32_pair(jcfg, seed=0):
    """JAX f32 params and the port's copy of them."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, bar, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * float(np.abs(want).max()),
                               err_msg=name)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_hybrid_tail_case_has_a_tail():
    jcfg, cfg = _configs("hybrid-tail")
    assert tfm._hybrid_split(cfg) == jtfm._hybrid_split(jcfg) == (2, 2, 1)
    assert tfm._hybrid_split(_configs("hybrid")[1])[2] == 0


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """JAX's f32 draw, a (2, 40) token batch, and the jitted loss, its
    gradients and the logits on them: shared by the forward test and the
    train-step test (the train step is ``value_and_grad`` then
    ``AdamW.update``)."""
    jcfg, cfg = _configs(case)
    jm = JaxModel(jcfg)
    jp, _ = _f32_pair(jcfg)
    toks = _tokens(cfg.vocab_size, (2, 40))

    @jax.jit
    def run(params, tokens):
        return (jax.value_and_grad(jm.loss)(params, {"tokens": tokens}),
                jm.forward(params, tokens))

    (jloss, jgrads), jlogits = run(jp, jnp.asarray(toks))
    return jp, toks, jloss, jgrads, jlogits


def _port_params(jp):
    p = params_from_jax(jax.tree.map(np.asarray, jp))
    for t in leaves(p):
        t.requires_grad_(True)
    return p


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    cfg = _configs(case)[1]
    model = Model(cfg, params={})
    jp, toks, jloss, jgrads, jlogits = _jax_side(case)
    p = _port_params(jp)
    logits = model.forward(p, torch.from_numpy(toks))
    loss = model.loss(p, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves(p))
    _close(logits.detach().numpy(), jlogits, BAR[case])
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for (path, _), g in zip(leaves_with_path(p), grads):
        w = want[path]
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), w, GRAD_BAR[case], "/".join(path))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax_from_either_cache(case):
    jcfg, cfg = _configs(case)
    jp, p = _f32_pair(jcfg, seed=1)
    toks = _tokens(cfg.vocab_size, (2, PROMPT + N_DECODE), seed=2)
    max_len = PROMPT + N_DECODE + 3
    jlog, jcache = jtfm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jcfg,
                                max_len, cache_dtype=jnp.float32)
    log, cache = tfm.prefill(p, torch.from_numpy(toks[:, :PROMPT]), cfg,
                             max_len, cache_dtype=torch.float32)
    _close(log.numpy(), jlog, BAR[case])
    want_spec = tfm.cache_spec(cfg, 2, max_len, torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in want_spec.items()}
    carried = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert carried.keys() == cache.keys()
    jstep = jax.jit(lambda pp, cc, t: jtfm.decode_step(pp, cc, t, jcfg))
    for t in range(PROMPT, PROMPT + N_DECODE):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        tok = torch.from_numpy(toks[:, t])
        log, cache = tfm.decode_step(p, cache, tok, cfg)
        log2, carried = tfm.decode_step(p, carried, tok, cfg)
        _close(log.numpy(), jlog, BAR[case])
        _close(log2.numpy(), jlog, BAR[case])
    for name, c in cache.items():
        _close(c.numpy(), jcache[name], BAR[case], name)
        _close(carried[name].numpy(), jcache[name], BAR[case], name)
    assert int(cache["cur_len"][0]) == PROMPT + N_DECODE


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_decode_matches_the_jax_oracle(case):
    jcfg, cfg = _configs(case)
    jp, p = _f32_pair(jcfg, seed=3)
    prompt = _tokens(cfg.vocab_size, (13,), seed=4).tolist()
    n_new = 8
    got = tfm.greedy_decode(p, prompt, cfg, n_new, cache_dtype=torch.float32)
    # the JAX oracle's loop (``jtfm.greedy_decode``) with a jitted step
    jlog, jcache = jtfm.prefill(jp, jnp.asarray([prompt], jnp.int32), jcfg,
                                len(prompt) + n_new + 1,
                                cache_dtype=jnp.float32)
    jstep = jax.jit(lambda pp, cc, t: jtfm.decode_step(pp, cc, t, jcfg))
    want, margins = [], []
    while True:
        row = np.asarray(jlog[0])
        top2 = np.sort(row)[-2:]
        margins.append(float(top2[1] - top2[0]))
        want.append(int(np.argmax(row)))
        if len(want) == n_new:
            break
        jlog, jcache = jstep(jp, jcache, jnp.asarray([want[-1]], jnp.int32))
    assert len(got) == n_new
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    assert first is None or margins[first] < 1e-3, (got, want, margins)


@pytest.mark.parametrize("arch", sorted({a for a, _ in CASES.values()}))
def test_full_config_param_counts_equal_jax(arch):
    mine = Model(get_config(arch), params={})
    theirs = JaxModel(jax_get_config(arch))
    assert mine.n_params() == theirs.n_params()
    assert mine.n_active_params() == theirs.n_active_params()


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    """One step of the JAX trainer's AdamW (b2 0.95, weight decay 0.1,
    clip 1.0) at f32 on the same batch: JAX's ``make_train_fn`` step is its
    ``value_and_grad`` (jitted, :func:`_jax_side`) then ``AdamW.update``."""
    cfg = _configs(case)[1]
    jp, toks, jloss, jgrads, _ = _jax_side(case)
    p = _port_params(jp)
    lr = 1e-3
    kw = dict(lr=lr, b2=0.95, weight_decay=0.1, clip_norm=1.0)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jp, _ = jax.jit(jopt.update)(jp, jgrads, jopt.init(jp))
    step = make_train_fn(Model(cfg, params={}), opt)
    p, st, loss = step(p, opt.init(p), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(st.step) == 1
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jp)))
    n_apart = n = 0
    for path, t in leaves_with_path(p):
        apart = np.abs(t.detach().numpy() - want[path])
        assert apart.max() <= 2 * lr + 1e-4, path
        n_apart += int((apart > 1e-4).sum())
        n += apart.size
    assert n_apart <= 1e-3 * n, (n_apart, n)
