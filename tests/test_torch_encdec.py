"""The encoder-decoder family (whisper-medium) and the VLM stub
(internvl2-76b) end to end against the JAX package, at smoke width with f32
parameters (the CPU computes f32 products in f32).

Cases: ``encdec`` (whisper-medium smoke: 2 encoder and 2 decoder layers over
16 frames) and ``vlm`` (internvl2-76b smoke: the dense backbone with 4
patches prepended).  The same JAX draw goes through the bridge into the
port; frames and patches are drawn with numpy from a seed.

* ``forward`` logits within 2e-5 of their max-abs, ``Model.loss`` within
  2e-5 (rtol and atol), the loss's gradients within 1e-4 of each leaf's
  max-abs (``jax.value_and_grad``); one AdamW step (``make_train_fn``)
  against JAX's.
* ``prefill`` of a 21-token prompt, unpadded and right-padded to a bucket
  of 24 with ``true_len``, then 8 ``decode_step``s fed the true next
  tokens, f32 cache, from the port's own cache and from JAX's carried over
  by ``bridge.cache_from_jax``: logits and every cache leaf (``xk`` /
  ``xv`` among them) within 2e-5 of the max-abs of JAX's (its jitted
  ``decode_step``).  The VLM serves text only (its prefill refuses
  patches, below).
* ``prefill(kernel=True)`` (the flash wrapper, whose plain version runs on
  the CPU) against ``kernel=False`` (the chunked attention), and the
  wrapper's calls: per decoder layer one causal; for whisper per encoder
  layer and per cross attention one non-causal.
* ``greedy_decode``: the tokens of JAX's oracle loop (its jitted step), or
  a first mismatch on a top-2 margin below 1e-3.
* The full configs' parameter counts equal JAX's.
* The VLM's prefill raises on patches (``Model.prefill``, ``greedy_decode``
  too), and a JAX-only test pins the reference fault it guards against: a
  cache of ``max_len + n_patches`` positions with ``cur_len`` the text
  length.
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
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_fn
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import flatten
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, leaves_with_path

TOL = dict(rtol=2e-5, atol=2e-5)
BAR = 2e-5        # of the max-abs of JAX's output
GRAD_BAR = 1e-4   # of a leaf's max-abs
CASES = {"encdec": "whisper-medium", "vlm": "internvl2-76b"}
PROMPT, BUCKET, N_DECODE = 21, 24, 8
N_PARAMS = {"whisper-medium": 1012313088, "internvl2-76b": 70562095104}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(case):
    arch = CASES[case]
    return jax_get_config(arch).smoke(), get_config(arch).smoke()


def _f32_pair(jcfg, seed=0):
    """JAX f32 params and the port's copy of them."""
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(seed)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, bar=BAR, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * float(np.abs(want).max()),
                               err_msg=name)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _extras(cfg, B, seed=0, patches=True):
    """numpy f32 ``frames`` (whisper) or ``patches`` (the VLM, unless
    ``patches`` is False), drawn from the seed; None where there are
    none."""
    rng = np.random.default_rng(100 + seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    if cfg.n_patches and patches:
        return {"patches": rng.standard_normal(
            (B, cfg.n_patches, tfm.VISION_DIM)).astype(np.float32)}
    return None


def _jx(extras):
    return None if extras is None else {k: jnp.asarray(v)
                                        for k, v in extras.items()}


def _tx(extras):
    return None if extras is None else {k: torch.from_numpy(v)
                                        for k, v in extras.items()}


def _port_params(jp):
    p = params_from_jax(jax.tree.map(np.asarray, jp))
    for t in leaves(p):
        t.requires_grad_(True)
    return p


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """JAX's f32 draw, a (2, 24) token batch with its frames or patches,
    and the jitted loss, its gradients and the logits on them: shared by
    the forward test and the train-step test."""
    jcfg, cfg = _configs(case)
    jm = JaxModel(jcfg)
    jp, _ = _f32_pair(jcfg)
    toks = _tokens(cfg.vocab_size, (2, 24))
    extras = _extras(cfg, 2)

    @jax.jit
    def run(params, batch):
        return (jax.value_and_grad(jm.loss)(params, batch),
                jm.forward(params, batch["tokens"],
                           {k: v for k, v in batch.items() if k != "tokens"}))

    (jloss, jgrads), jlogits = run(jp, {"tokens": jnp.asarray(toks),
                                        **_jx(extras)})
    return jp, toks, extras, jloss, jgrads, jlogits


def _batch(toks, extras):
    return {"tokens": torch.from_numpy(toks), **_tx(extras)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_loss_and_grads_match_jax(case):
    cfg = _configs(case)[1]
    model = Model(cfg, params={})
    jp, toks, extras, jloss, jgrads, jlogits = _jax_side(case)
    p = _port_params(jp)
    logits = model.forward(p, torch.from_numpy(toks), _tx(extras))
    assert logits.shape == (2, toks.shape[1] + cfg.n_patches, cfg.vocab_size)
    loss = model.loss(p, _batch(toks, extras))
    grads = torch.autograd.grad(loss, leaves(p))
    _close(logits.detach().numpy(), jlogits)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(leaves_with_path(jax.tree.map(np.asarray, jgrads)))
    assert len(want) == len(grads)
    for (path, _), g in zip(leaves_with_path(p), grads):
        assert torch.isfinite(g).all(), path
        _close(g.numpy(), want[path], GRAD_BAR, "/".join(path))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    """One step of the JAX trainer's AdamW (b2 0.95, weight decay 0.1,
    clip 1.0) at f32 on the same batch, frames or patches included: JAX's
    step is its ``value_and_grad`` (jitted, :func:`_jax_side`) then
    ``AdamW.update``.  Updated params within 1e-4, but for at most 1e-3 of
    the elements (a gradient within rounding of 0 can flip AdamW's first
    update, lr·g/(|g| + eps)), which stay within 2·lr + 1e-4."""
    cfg = _configs(case)[1]
    jp, toks, extras, jloss, jgrads, _ = _jax_side(case)
    p = _port_params(jp)
    lr = 1e-3
    kw = dict(lr=lr, b2=0.95, weight_decay=0.1, clip_norm=1.0)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jp, _ = jax.jit(jopt.update)(jp, jgrads, jopt.init(jp))
    step = make_train_fn(Model(cfg, params={}), opt)
    p, st, loss = step(p, opt.init(p), _batch(toks, extras))
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


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "bucket"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax_from_either_cache(case, bucketed):
    jcfg, cfg = _configs(case)
    jp, p = _f32_pair(jcfg, seed=1)
    toks = _tokens(cfg.vocab_size, (2, PROMPT + N_DECODE), seed=2)
    extras = _extras(cfg, 2, seed=1, patches=False)
    max_len = PROMPT + N_DECODE + 3
    prompt = toks[:, :PROMPT]
    true_len = None
    if bucketed:  # right-padded to the bucket, read at true_len - 1
        prompt = np.pad(prompt, ((0, 0), (0, BUCKET - PROMPT)))
        true_len = PROMPT
    jlog, jcache = jtfm.prefill(jp, jnp.asarray(prompt), jcfg, max_len,
                                _jx(extras), cache_dtype=jnp.float32,
                                true_len=true_len)
    log, cache = tfm.prefill(p, torch.from_numpy(prompt), cfg, max_len,
                             _tx(extras), cache_dtype=torch.float32,
                             true_len=true_len, kernel=False)
    _close(log.numpy(), jlog)
    want_spec = tfm.cache_spec(cfg, 2, max_len, torch.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(s), dt) for k, (s, dt) in want_spec.items()}
    carried = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert carried.keys() == cache.keys()
    if cfg.family == "encdec":
        for name in ("xk", "xv"):
            _close(cache[name].numpy(), jcache[name], name=name)
    jstep = jax.jit(lambda pp, cc, t: jtfm.decode_step(pp, cc, t, jcfg))
    for t in range(PROMPT, PROMPT + N_DECODE):
        jlog, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t]))
        tok = torch.from_numpy(toks[:, t])
        log, cache = tfm.decode_step(p, cache, tok, cfg)
        log2, carried = tfm.decode_step(p, carried, tok, cfg)
        _close(log.numpy(), jlog)
        _close(log2.numpy(), jlog)
    for name, c in cache.items():
        _close(c.numpy(), jcache[name], name=name)
        _close(carried[name].numpy(), jcache[name], name=name)
    assert int(cache["cur_len"][0]) == PROMPT + N_DECODE


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_prefill_matches_the_plain_prefill(case, monkeypatch):
    """``kernel=True`` on the CPU: the flash wrapper (its plain version
    here) where ``kernel=False`` runs the chunked attention; whisper's
    encoder and cross attention on the non-causal route."""
    jcfg, cfg = _configs(case)
    _, p = _f32_pair(jcfg, seed=5)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, PROMPT), seed=6))
    extras = _tx(_extras(cfg, 2, seed=5, patches=False))
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    kw = dict(cache_dtype=torch.float32)
    log_k, cache_k = tfm.prefill(p, toks, cfg, PROMPT + 4, extras,
                                 kernel=True, **kw)
    n_kernel = len(calls)
    log_p, cache_p = tfm.prefill(p, toks, cfg, PROMPT + 4, extras,
                                 kernel=False, **kw)
    assert len(calls) == n_kernel
    _close(log_k.numpy(), log_p.numpy())
    for name, c in cache_k.items():
        _close(c.numpy(), cache_p[name].numpy(), name=name)
    L, F = cfg.n_layers, cfg.n_frames
    want = [(True, PROMPT, PROMPT)] * L
    if cfg.family == "encdec":
        want += ([(False, F, F)] * cfg.n_enc_layers
                 + [(False, PROMPT, F)] * L)
    assert sorted(calls) == sorted(want)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_decode_matches_the_jax_oracle(case):
    jcfg, cfg = _configs(case)
    jp, p = _f32_pair(jcfg, seed=3)
    prompt = _tokens(cfg.vocab_size, (13,), seed=4).tolist()
    extras = _extras(cfg, 1, seed=3, patches=False)
    n_new = 8
    model = Model(cfg, p)
    got = model.greedy_decode(prompt, n_new, extras=_tx(extras),
                              cache_dtype=torch.float32)
    # the JAX oracle's loop (``jtfm.greedy_decode``) with a jitted step
    jlog, jcache = jtfm.prefill(jp, jnp.asarray([prompt], jnp.int32), jcfg,
                                len(prompt) + n_new + 1, _jx(extras),
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


@pytest.mark.parametrize("arch", sorted(N_PARAMS))
def test_full_config_param_counts_equal_jax(arch):
    mine = Model(get_config(arch), params={})
    theirs = JaxModel(jax_get_config(arch))
    assert mine.n_params() == theirs.n_params() == N_PARAMS[arch]
    assert mine.n_active_params() == theirs.n_active_params()


@pytest.mark.parametrize("case", list(CASES))
def test_bridge_carries_the_new_leaves_bit_exact(case):
    """``enc_blocks`` and the decoder's ``cross`` / ``ln3`` (whisper),
    ``vision_proj`` (the VLM) come across in bf16, bit for bit, and the
    model facade's ``prefill`` / ``decode_step`` run on them."""
    jcfg, cfg = _configs(case)
    host = jax.tree.map(np.asarray, JaxModel(jcfg).init(
        jax.random.PRNGKey(7)))
    mine = dict(flatten(params_from_jax(host)))
    theirs = dict(flatten(host))
    assert mine.keys() == theirs.keys()
    new = [k for k in mine if k[0] in ("enc_blocks", "vision_proj")
           or k[:2] in (("blocks", "cross"), ("blocks", "ln3"))]
    assert new, case
    for path in mine:
        a, t = theirs[path], mine[path]
        bits = (t.view(torch.uint16).numpy(), a.view(np.uint16)) if (
            a.dtype.name == "bfloat16") else (t.numpy(), a)
        np.testing.assert_array_equal(*bits, err_msg=str(path))
    model = Model(cfg, params_from_jax(host))
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (1, 6), seed=8))
    logits, cache = model.prefill(model.params, toks, 8,
                                  _tx(_extras(cfg, 1, patches=False)))
    logits, cache = model.decode_step(model.params, cache, toks[:, -1])
    assert logits.shape == (1, cfg.vocab_size)
    assert int(cache["cur_len"][0]) == 7


def test_encdec_needs_its_frames():
    cfg = _configs("encdec")[1]
    p = Model(cfg, device="cpu").params
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="frames"):
        tfm.forward(p, toks, cfg)
    with pytest.raises(ValueError, match="frames"):
        tfm.prefill(p, toks, cfg, 8)


def test_vlm_prefill_refuses_patches():
    """The VLM serves its text-only path: a prefill given patches raises,
    through the model facade and the token oracle too."""
    cfg = _configs("vlm")[1]
    model = Model(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    patches = _tx(_extras(cfg, 1))
    with pytest.raises(ValueError, match="patches"):
        tfm.prefill(model.params, toks, cfg, 12, patches)
    with pytest.raises(ValueError, match="patches"):
        model.prefill(model.params, toks, 12, patches)
    with pytest.raises(ValueError, match="patches"):
        model.greedy_decode([1, 2, 3], 2, extras=patches)


def test_reference_vlm_prefill_misplaces_its_cache():
    """The reference fault the port's guard stands for (JAX only): with
    patches, ``prefill`` embeds n_patches + S rows but pads its K/V by
    ``max_len - S`` and sets ``cur_len`` to S, so the cache holds
    ``max_len + n_patches`` positions and decode writes over a text row."""
    jcfg = _configs("vlm")[0]
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    S, max_len = 8, 12
    toks = jnp.asarray(_tokens(jcfg.vocab_size, (1, S)))
    extras = {"patches": jnp.asarray(_extras(jcfg, 1)["patches"])}
    _, cache = jtfm.prefill(jp, toks, jcfg, max_len, extras)
    spec, _ = jtfm.cache_spec(jcfg, 1, max_len)
    assert spec["k"].shape[2] == max_len
    assert cache["k"].shape[2] == max_len + jcfg.n_patches
    assert int(cache["cur_len"][0]) == S
