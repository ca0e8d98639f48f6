"""The port's Mamba2 / SSD module against the JAX package's, at f32.

The same numpy-seeded inputs go through ``repro.models.ssm`` and
``repro_torch.models.ssm`` (both plain: the JAX package lowers SSD through
XLA).  Bars: 2e-5 (rtol and atol) on every output, the f32 rounding of
sums over a chunk and across chunks taken in another order; the gradients
of ``ssd_scan`` (the ``-inf`` above ``_segsum``'s diagonal under autograd)
within 1e-5 of each input's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized tensors: one intra-op thread, and no oversubscription of
    the CPU by test files running side by side in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(B, L, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, L, H, P)).astype(f),
            (np.abs(rng.standard_normal((B, L, H))) * 0.5).astype(f),
            -np.exp(rng.standard_normal(H)).astype(f),
            rng.standard_normal((B, L, N)).astype(f),
            rng.standard_normal((B, L, N)).astype(f))


def _ssm_params(cfg, seed=0):
    """One layer's SSM leaves at f32, A_log / dt_bias / D / gate_norm drawn
    away from their constant init so each term shows."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    di, H, N = cfg.ssm_expand * d, cfg.ssm_heads, cfg.ssm_state
    g = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return {"in_z": g(d, di, sc=d ** -0.5), "in_x": g(d, di, sc=d ** -0.5),
            "in_bc": g(d, 2 * N, sc=d ** -0.5), "in_dt": g(d, H, sc=d ** -0.5),
            "conv_x": g(ssm.CONV_K, di, sc=0.5),
            "conv_bc": g(ssm.CONV_K, 2 * N, sc=0.5),
            "A_log": g(H, sc=0.5), "dt_bias": g(H, sc=0.5),
            "D": 1.0 + g(H, sc=0.1), "gate_norm": 1.0 + g(di, sc=0.1),
            "out_proj": g(di, d, sc=di ** -0.5)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


@pytest.mark.parametrize("L,chunk", [(64, 16), (64, 64), (48, 16), (12, 16),
                                     (128, 32)])
def test_ssd_scan_matches_jax(L, chunk):
    """Several lengths and chunk sizes, one chunk or many, and a chunk
    wider than the sequence (Q = L)."""
    args = _scan_inputs(2, L, 4, 8, 16)
    jy, js = jssm.ssd_scan(*map(jnp.asarray, args), chunk)
    y, s = ssm.ssd_scan(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    assert s.dtype == torch.float32


def test_ssd_scan_gradients_match_jax():
    """Through the -inf above ``_segsum``'s diagonal: finite gradients, the
    JAX package's."""
    args = _scan_inputs(1, 32, 2, 4, 8, seed=1)

    def jloss(*a):
        y, s = jssm.ssd_scan(*a, 8)
        return jnp.sum(y * y) + jnp.sum(s)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = ssm.ssd_scan(*ts, 8)
    g = torch.autograd.grad((y * y).sum() + s.sum(), ts)
    for got, want in zip(g, jg):
        want = np.asarray(want)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 3, 16)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(jssm._segsum(jnp.asarray(a))),
                               **TOL)
    u = rng.standard_normal((2, 20, 24)).astype(np.float32)
    w = rng.standard_normal((ssm.CONV_K, 24)).astype(np.float32)
    np.testing.assert_allclose(
        ssm._causal_conv(torch.from_numpy(u), torch.from_numpy(w)).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(u), jnp.asarray(w))), **TOL)


def test_softplus_is_jaxs():
    """``logaddexp(x, 0)`` on both sides: within one f32 ulp everywhere
    (2**-22 relative bounds an ulp at any magnitude), above 20 too (where
    ``F.softplus`` would return x itself)."""
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    np.testing.assert_allclose(
        ssm.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("L", [48, 40, 9])
def test_mamba2_seq_with_state_matches_jax(L):
    """A chunk multiple, a ragged length (the pad to a chunk multiple) and
    one shorter than a chunk; the final state and the conv windows too."""
    jcfg, cfg = (jax_get_config("mamba2-1.3b").smoke(),
                 get_config("mamba2-1.3b").smoke())
    jp, p = _both(_ssm_params(cfg))
    x = np.random.default_rng(3).standard_normal(
        (2, L, cfg.d_model)).astype(np.float32)
    jout, jst, (jcx, jcbc) = jssm.mamba2_seq(jnp.asarray(x), jp, jcfg,
                                             return_state=True)
    out, st, (cx, cbc) = ssm.mamba2_seq(torch.from_numpy(x), p, cfg,
                                        return_state=True)
    for got, want in ((out, jout), (st, jst), (cx, jcx), (cbc, jcbc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        ssm.mamba2_seq(torch.from_numpy(x), p, cfg).numpy(),
        np.asarray(jout), **TOL)


def test_mamba2_decode_steps_match_jax_and_the_sequence_form():
    """From a 20-token prefix's state, 12 decode steps against the JAX
    decode, and against the sequence form's rows over the whole 32."""
    jcfg, cfg = (jax_get_config("mamba2-1.3b").smoke(),
                 get_config("mamba2-1.3b").smoke())
    jp, p = _both(_ssm_params(cfg, seed=4))
    x = np.random.default_rng(5).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    P = 20
    _, jst, jbuf = jssm.mamba2_seq(jnp.asarray(x[:, :P]), jp, jcfg,
                                   return_state=True)
    _, st, buf = ssm.mamba2_seq(torch.from_numpy(x[:, :P]), p, cfg,
                                return_state=True)
    whole = ssm.mamba2_seq(torch.from_numpy(x), p, cfg).numpy()
    jdec = jax.jit(lambda xt, s, b: jssm.mamba2_decode(xt, jp, jcfg, s, b))
    for t in range(P, 32):
        jy, jst, jbuf = jdec(jnp.asarray(x[:, t:t + 1]), jst, jbuf)
        y, st, buf = ssm.mamba2_decode(torch.from_numpy(x[:, t:t + 1]), p,
                                       cfg, st, buf)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
        np.testing.assert_allclose(y.numpy()[:, 0], whole[:, t], rtol=1e-4,
                                   atol=1e-4)
