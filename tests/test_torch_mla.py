"""The port's MLA (DeepSeek's multi-head latent attention) against the JAX
package's, at f32.

One layer's MLA leaves drawn with numpy (``kv_norm`` away from its ones
init) go through ``repro.models.attention`` and
``repro_torch.models.attention``: ``mla_train``, ``mla_prefill`` with its
latent cache (c_kv, k_rope), and the absorbed-form ``mla_decode`` step by
step from that cache, its cache rows written in place, against JAX's and
against the decompressed form's rows.  Bars: 2e-5 (rtol and atol) against
JAX; 1e-4 between the absorbed and the decompressed form (the products
associate differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jatt
from repro_torch.configs import get_config
from repro_torch.models import attention as att

TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    return (jax_get_config(ARCH).smoke().with_(**kw),
            get_config(ARCH).smoke().with_(**kw))


def _mla_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    g = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)
    tree = {"wq": g(d, H, nd + rd, sc=d ** -0.5), "w_dkv": g(d, r, sc=d ** -0.5),
            "kv_norm": 1.0 + g(r, sc=0.1), "w_kr": g(d, rd, sc=d ** -0.5),
            "w_uk": g(r, H, nd, sc=r ** -0.5), "w_uv": g(r, H, vd, sc=r ** -0.5),
            "wo": g(H, vd, d, sc=(H * vd) ** -0.5)}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_mla_specs_match_jax():
    jcfg, cfg = _configs()
    mine, theirs = att.mla_specs(cfg, 3), jatt.mla_specs(jcfg, 3)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].shape == theirs[k].shape, k
        assert mine[k].scale == pytest.approx(theirs[k].scale), k
        assert (mine[k].dtype == torch.float32) == (
            theirs[k].dtype == jnp.float32), k


@pytest.mark.parametrize("S,block", [(40, 64), (80, 32)])
def test_mla_train_and_prefill_match_jax(S, block):
    """One kv block and several (a ragged last block at 80 over 32)."""
    jcfg, cfg = _configs(q_block=block, kv_block=block)
    jp, p = _mla_params(cfg)
    x = _x(cfg, 2, S)
    jy = jatt.mla_train(jnp.asarray(x), jp, jcfg)
    y = att.mla_train(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    jy2, (jc, jr) = jatt.mla_prefill(jnp.asarray(x), jp, jcfg)
    y2, (c, r) = att.mla_prefill(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
    assert c.shape == (2, S, cfg.kv_lora_rank) and r.shape == (
        2, S, cfg.qk_rope_dim)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL)


def test_mla_decode_matches_jax_and_the_decompressed_form():
    """From a 24-token prefill's latent cache, 8 absorbed-form steps (the
    rows of two sequences at different lengths), the cache written in
    place at ``cur_len``; against JAX's step and the train form's rows."""
    jcfg, cfg = _configs()
    jp, p = _mla_params(cfg, seed=2)
    B, P, n, T = 2, 24, 8, 40
    x = _x(cfg, B, P + n, seed=3)
    whole = att.mla_train(torch.from_numpy(x), p, cfg).numpy()
    _, (c, r) = att.mla_prefill(torch.from_numpy(x[:, :P]), p, cfg)
    cache_c = torch.zeros((B, T, cfg.kv_lora_rank))
    cache_r = torch.zeros((B, T, cfg.qk_rope_dim))
    cache_c[:, :P], cache_r[:, :P] = c, r
    jc, jr = jnp.asarray(cache_c.numpy()), jnp.asarray(cache_r.numpy())
    jdec = jax.jit(lambda xt, cc, cr, cur: jatt.mla_decode(xt, jp, jcfg, cc,
                                                           cr, cur))
    for t in range(P, P + n):
        cur = np.full((B,), t, np.int32)
        jy, jc, jr = jdec(jnp.asarray(x[:, t:t + 1]), jc, jr, jnp.asarray(cur))
        y = att.mla_decode(torch.from_numpy(x[:, t:t + 1]), p, cfg, cache_c,
                           cache_r, torch.from_numpy(cur))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(cache_c.numpy(), np.asarray(jc), **TOL)
        np.testing.assert_allclose(cache_r.numpy(), np.asarray(jr), **TOL)
        np.testing.assert_allclose(y.numpy()[:, 0], whole[:, t], rtol=1e-4,
                                   atol=1e-4)
    assert not cache_c[:, P + n:].any()  # one row written per step


def test_mla_decode_at_bf16_rounds_where_jax_does():
    """bf16 activations and weights over a bf16 cache: the scores are
    products accumulated in f32 (JAX's ``preferred_element_type``), the
    probabilities cast to bf16 before the context product.  Against JAX at
    bf16 within one bf16 step of the output's scale."""
    jcfg, cfg = _configs()
    jp, p = _mla_params(cfg, seed=4)
    jp = {k: v if k == "kv_norm" else v.astype(jnp.bfloat16)
          for k, v in jp.items()}
    p = {k: v if k == "kv_norm" else v.to(torch.bfloat16)
         for k, v in p.items()}
    B, T, t = 2, 16, 11
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((B, T, cfg.kv_lora_rank)).astype(np.float32)
    cr = rng.standard_normal((B, T, cfg.qk_rope_dim)).astype(np.float32)
    cur = np.full((B,), t, np.int32)
    jy, _, _ = jatt.mla_decode(jnp.asarray(x, jnp.bfloat16), jp, jcfg,
                               jnp.asarray(cc, jnp.bfloat16),
                               jnp.asarray(cr, jnp.bfloat16), jnp.asarray(cur))
    y = att.mla_decode(torch.from_numpy(x).to(torch.bfloat16), p, cfg,
                       torch.from_numpy(cc).to(torch.bfloat16),
                       torch.from_numpy(cr).to(torch.bfloat16),
                       torch.from_numpy(cur))
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(want).max()))
