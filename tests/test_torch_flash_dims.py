"""The flash kernel's head dims off 64 / 128 against the JAX package's.

Zamba2-7B's head dim of 112 and Nemotron-4-340B's of 192 run the kernel at
D itself, with no padding: the tensor cores take bf16 at every multiple of
16 from 64 to 128 and at 192, the CUDA cores f32 at every multiple of 16 up
to 128 and at 192 (and bf16 below 64).  On the CPU the port's wrapper runs
its plain version, which is held here to the JAX Pallas kernel in interpret
mode at the bars of ``tests/test_kernels.py`` (f32 2e-5, bf16 2e-2), over
ragged Sq and Skv, causal and not, and with a query offset (against the
rows of the JAX kernel's call over the whole prompt: the Pallas kernel has
no offset).  On ``meta`` a call charges the kernel's own work at D and
nothing else, and a head dim no route takes raises.  The prefill step of a
smoke config at head dim 192 takes the kernel, counts its charges on
``meta`` and matches the JAX prefill.  Inputs come from numpy with a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import ops, work
from repro_torch.launch.steps import build_cell
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.roofline.op_cost import OpCost

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small operations: one intra-op thread runs them faster than many,
    and keeps test files that run side by side from oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a CPU tensor of the same dtype."""
    return (jnp.asarray(a).astype(JNP[dtype]),
            torch.from_numpy(a).to(TORCH[dtype]))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _inputs(rng, B, Sq, Skv, H, Kh, D, dtype):
    return [both(rng.standard_normal(s, np.float32), dtype)
            for s in ((B, Sq, H, D), (B, Skv, Kh, D), (B, Skv, Kh, D))]


# ------------------------------------------------- the wrapper against JAX

SHAPE_CASES = {
    "causal": (1, 40, 40, 4, 2, True),      # ragged: 40 = 2 x 16 + 8
    "cross": (2, 24, 56, 2, 1, False),      # Skv > Sq, MQA
    "square": (1, 33, 33, 2, 2, False),     # non-causal, ragged, MHA
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [112, 192])
@pytest.mark.parametrize("case", SHAPE_CASES)
def test_plain_matches_pallas_at_the_new_head_dims(case, D, dtype):
    B, Sq, Skv, H, Kh, causal = SHAPE_CASES[case]
    rng = np.random.default_rng(D + Sq)
    (jq, q), (jk, k), (jv, v) = _inputs(rng, B, Sq, Skv, H, Kh, D, dtype)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, D)
    want = jops.flash_attention(jq, jk, jv, causal=causal, q_block=16,
                                kv_block=16)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,q_offset,Skv", [(112, 24, 56), (192, 17, 40)])
def test_q_offset_rows_match_the_pallas_whole_call(D, q_offset, Skv, dtype):
    """Rows at absolute positions ``q_offset + i`` over a ragged key extent
    longer than the prompt: the JAX kernel's rows ``q_offset:`` of its call
    over all ``q_offset + Sq`` rows."""
    B, Sq, H, Kh = 1, 13, 4, 2
    rng = np.random.default_rng(D)
    (jq, q), (jk, k), (jv, v) = _inputs(rng, B, q_offset + Sq, Skv, H, Kh,
                                        D, dtype)
    got = ops.flash_attention(q[:, q_offset:], k, v, causal=True,
                              q_offset=q_offset)
    whole = jops.flash_attention(jq, jk, jv, causal=True, q_block=16,
                                 kv_block=16)
    np.testing.assert_allclose(f32(got), f32(whole)[:, q_offset:],
                               **TOL[dtype])


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128, 192])
def test_every_head_dim_has_its_route(D):
    """f32 on the CUDA cores at every dim; bf16 on the tensor cores from 64
    up and on the CUDA cores below."""
    assert ops.flash_route(torch.float32, D) == "simt"
    assert ops.flash_route(torch.bfloat16, D) == ("wgmma" if D >= 64
                                                  else "simt")


# ------------------------------------------------------- the meta route

def _meta(B, S, H, Kh, D, dtype):
    return (torch.empty(B, S, H, D, dtype=dtype, device="meta"),
            torch.empty(B, S, Kh, D, dtype=dtype, device="meta"),
            torch.empty(B, S, Kh, D, dtype=dtype, device="meta"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,H,Kh", [(112, 32, 32), (192, 96, 8)],
                         ids=["zamba2", "nemotron"])
def test_meta_call_charges_the_kernel_at_d_alone(D, H, Kh, dtype):
    """At Zamba2's and Nemotron-4's heads a call charges the kernel's own
    work at D, no pad, and holds nothing beyond its output at its peak;
    nothing launches."""
    q, k, v = _meta(2, 1024, H, Kh, D, dtype)
    before = dict(ops.launches), dict(ops.flash_routes)
    with OpCost() as oc:
        out = ops.flash_attention(q, k, v, causal=True)
    assert (dict(ops.launches), dict(ops.flash_routes)) == before
    assert out.device.type == "meta" and out.shape == q.shape
    w = work.flash_attention(B=2, H=H, Kh=Kh, Sq=1024, Skv=1024, D=D,
                             dtype=dtype, causal=True)
    s = oc.summary()
    assert s["kernel_charges"] == {"flash_attention": {
        "calls": 1, "bytes": w.bytes, "flops": {w.dtype: w.flops}}}
    assert s["hbm_bytes_per_device"] == w.bytes
    assert s["peak_live_bytes"] == out.numel() * out.element_size()


@pytest.mark.parametrize("D", [40, 144, 160, 256])
def test_meta_refuses_a_head_dim_no_route_takes(D):
    q, k, v = _meta(1, 8, 4, 2, D, torch.bfloat16)
    with pytest.raises(ValueError, match=f"no route takes head dim {D}"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match=f"no route takes head dim {D}"):
        ops.flash_attention(q.float(), k.float(), v.float())


# ------------------------------------------------ the prefill at head dim 192

def _d192(get):
    cfg = get("nemotron-4-340b").smoke()
    return dataclasses.replace(cfg, head_dim=192)


def test_prefill_fn_at_head_dim_192_counts_flash_on_meta():
    """Nemotron-4's smoke config at its real head dim: ``make_prefill_fn``
    takes the kernel, one charge per layer, and the count is the CPU's."""
    cfg = _d192(get_config)
    assert cfg.hd == 192
    shape = SHAPES["prefill_32k"].scaled_for_smoke()
    counts = {}
    for where in ("meta", "cpu"):
        fn, args = build_cell(cfg, shape, where)
        with OpCost(inputs=args) as oc:
            fn(*args)
        counts[where] = oc.summary()
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta["kernel_charges"]["flash_attention"]["calls"] == cfg.n_layers
    for key in ("flops_by_dtype", "hbm_bytes_per_device", "kernel_charges",
                "peak_live_bytes"):
        assert meta[key] == cpu[key], key


def test_prefill_at_head_dim_192_matches_jax():
    """The prefill step's logits and K/V at head dim 192 (the kernel's plain
    version on the CPU) against the JAX prefill (chunked XLA attention), f32
    parameters from one PRNGKey, a ragged prompt in a padded bucket."""
    jcfg = _d192(jax_get_config)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    cfg = _d192(get_config)
    model = Model(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(192)
    toks = np.zeros((2, 32), np.int32)
    toks[:, :27] = rng.integers(1, cfg.vocab_size, (2, 27))
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jcfg, 48,
                          cache_dtype=jnp.float32, true_len=27)
    tl, tc = tfm.prefill(model.params, torch.from_numpy(toks), cfg, 48,
                         cache_dtype=torch.float32, true_len=27)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               **TOL["float32"])
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               **TOL["float32"])
