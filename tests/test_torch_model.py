"""The port's dense model against the JAX package's, on the qwen3-1.7b smoke
config with both sides' parameters cast to float32 (TF32 plays no part: the
CPU computes float32 products in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as att
from repro_torch.models import layers
from repro_torch.models import transformer as tfm

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX f32 params, port cfg, port Model) from one PRNGKey."""
    jcfg = jax_get_config("qwen3-1.7b").smoke()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_config("qwen3-1.7b").smoke()
    model = Model(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, cfg, model


def test_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.arange(10)[None].repeat(2, 0)
    cos, sin = layers.rope_cos_sin(torch.from_numpy(pos), 64, 1e6)
    jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), 64, 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), **TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    xr = rng.standard_normal((2, 10, 3, 64), np.float32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(xr), cos[:, :, None], sin[:, :, None]).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr), jcos[:, :, None],
                                      jsin[:, :, None])), **TOL)
    wg, wu = (rng.standard_normal((64, 96), np.float32) * 0.1 for _ in range(2))
    wd = rng.standard_normal((96, 64), np.float32) * 0.1
    np.testing.assert_allclose(
        layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))).numpy(),
        np.asarray(jlayers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))),
        **TOL)
    np.testing.assert_allclose(
        layers.sq_relu_mlp(*(torch.from_numpy(a) for a in (x, wg, wd))).numpy(),
        np.asarray(jlayers.sq_relu_mlp(*(jnp.asarray(a) for a in (x, wg, wd)))),
        **TOL)


@pytest.mark.parametrize("causal,q_offset,Sq,Skv", [
    (True, 0, 100, 100), (False, 0, 64, 150), (True, 37, 50, 87)])
def test_chunked_attention_matches_jax(causal, q_offset, Sq, Skv):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, Sq, 4, 32), np.float32)
    k = rng.standard_normal((2, Skv, 2, 32), np.float32)
    v = rng.standard_normal((2, Skv, 2, 32), np.float32)
    got = att.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, q_offset=q_offset, q_block=32,
                                kv_block=48)
    want = jatt.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  causal=causal, q_offset=q_offset, q_block=32,
                                  kv_block=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("plen,bucket", [(20, 20), (20, 32), (64, 64)],
                         ids=["exact", "padded-bucket", "two-blocks"])
def test_prefill_logits_and_kv_match_jax(pair, plen, bucket):
    """Logits and K/V of the port's prefill (whose attention is the flash
    kernel's plain version on the CPU) against ``tfm.prefill``, whose
    attention is the chunked XLA path; a bucket-padded prompt reads its
    logits at ``true_len - 1``."""
    jcfg, jp, cfg, model = pair
    rng = np.random.default_rng(plen + bucket)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = rng.integers(1, cfg.vocab_size, plen)
    max_len = bucket + 16
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jcfg, max_len,
                          cache_dtype=jnp.float32, true_len=plen)
    tl, tc = tfm.prefill(model.params, torch.from_numpy(toks), cfg, max_len,
                         cache_dtype=torch.float32, true_len=plen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)
    assert tc["cur_len"].tolist() == np.asarray(jc["cur_len"]).tolist()


def test_decode_steps_match_jax(pair):
    jcfg, jp, cfg, model = pair
    prompt = (np.arange(3, 30) * 5) % cfg.vocab_size
    toks = prompt[None].astype(np.int32)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jcfg, 40,
                          cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(model.params, torch.from_numpy(toks), cfg, 40,
                         cache_dtype=torch.float32)
    for _ in range(5):
        nxt = int(np.argmax(np.asarray(jl)[0]))
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray([nxt], jnp.int32), jcfg)
        tl, tc = tfm.decode_step(model.params, tc,
                                 torch.tensor([nxt], dtype=torch.int32), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)


@pytest.mark.parametrize("stop", [False, True], ids=["to-cap", "stop-token"])
def test_greedy_decode_tokens_equal_jax(pair, stop):
    jcfg, jp, cfg, model = pair
    prompt = np.arange(1, 21) % cfg.vocab_size
    full = jtfm.greedy_decode(jp, prompt, jcfg, 12, cache_dtype=jnp.float32)
    stop_token = full[5] if stop else None
    want = (jtfm.greedy_decode(jp, prompt, jcfg, 12, stop_token=stop_token,
                               cache_dtype=jnp.float32) if stop else full)
    got = model.greedy_decode(prompt, 12, stop_token=stop_token,
                              cache_dtype=torch.float32)
    assert got == want
    if stop:
        assert got[-1] == stop_token and len(got) <= 6
