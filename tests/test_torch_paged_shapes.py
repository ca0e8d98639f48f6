"""Paged attention at any query-head group and at every head dim flash
takes, against the JAX package.

The TPU kernel takes any (G, D): its blocks are ``(1, 1, G, D)`` and
``(1, T, 1, D)``.  The port's wrapper takes any G >= 1 and every D of
``ops.PAGED_DIMS`` (flash's dims), and raises a ``ValueError`` naming them
for any other D, on ``meta`` as on the card.  Here, on the CPU:

* the ``meta`` route's shape checks at yi-34b's G 7, Nemotron-4-340B's
  G 12 / D 192 and other groups;
* the plain version (the wrapper's CPU route) against the Pallas kernel in
  interpret mode and the JAX plain reference, and the plain model of the
  CUDA kernel's split schedule against both, at G 7 / D 128 and G 12 /
  D 192, at ``tests/test_kernels.py``'s bars (f32 2e-5, bf16 2e-2);
* the CPU engine on the smoke qwen3-1.7b widened to 14 q over 2 kv heads
  (G 7), f32 params and pool, against the JAX engine: tokens and pool
  counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JaxModel
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta_case(B, Kh, G, D, T=16, P=4, dtype=torch.bfloat16):
    m = dict(device="meta")
    return (torch.empty(B, Kh * G, D, dtype=dtype, **m),
            torch.empty(B * P + 1, T, Kh, D, dtype=dtype, **m),
            torch.empty(B * P + 1, T, Kh, D, dtype=dtype, **m),
            torch.empty(B, P, dtype=torch.int32, **m),
            torch.empty(B, dtype=torch.int32, **m))


@pytest.mark.parametrize("D", [128, 192])
@pytest.mark.parametrize("G", [3, 5, 6, 7, 12, 16])
def test_meta_route_takes_any_group(G, D):
    out = ops.paged_attention(*_meta_case(3, 2, G, D))
    assert out.device.type == "meta" and tuple(out.shape) == (3, 2 * G, D)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("D", [200, 24, 256])
def test_an_untaken_head_dim_raises_naming_what_is_taken(D):
    with pytest.raises(ValueError, match=f"head dim {D}") as err:
        ops.paged_attention(*_meta_case(2, 2, 7, D))
    assert str(ops.PAGED_DIMS) in str(err.value)
    assert ops.PAGED_DIMS == ops.FLASH_DIMS["simt"]


def _both(a, dtype):
    return jnp.asarray(a).astype(JNP[dtype]), torch.from_numpy(a).to(
        TORCH[dtype])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,D", [(7, 128), (12, 192)], ids=str)
def test_plain_and_split_model_match_pallas_and_ref(G, D, dtype):
    """Ragged rows: zero-length, one token, exactly 8 pages, 8·2 + 1 pages,
    a full table of 20 (the split model's edges)."""
    rng = np.random.default_rng(G * 100 + D)
    Kh, T, P = 2, 8, 20
    lens_np = np.array([0, 1, 64, 136, 160], np.int32)
    B = len(lens_np)
    n_pages = B * P + 3
    jq, q = _both(rng.standard_normal((B, Kh * G, D), np.float32), dtype)
    jkp, kp = _both(rng.standard_normal((n_pages, T, Kh, D), np.float32),
                    dtype)
    jvp, vp = _both(rng.standard_normal((n_pages, T, Kh, D), np.float32),
                    dtype)
    bt_np = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    bt, lens = torch.from_numpy(bt_np), torch.from_numpy(lens_np)
    args = (jq, jkp, jvp, jnp.asarray(bt_np), jnp.asarray(lens_np))
    pallas = _f32(jops.paged_attention(*args))
    dense = _f32(jref.paged_attention_ref(*args))
    live = lens_np > 0
    got = ops.paged_attention(q, kp, vp, bt, lens)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Kh * G, D)
    np.testing.assert_allclose(_f32(got)[live], pallas[live], **TOL[dtype])
    np.testing.assert_allclose(_f32(got)[live], dense[live], **TOL[dtype])
    split = ref.paged_attention_split_ref(q, kp, vp, bt, lens)
    np.testing.assert_allclose(_f32(split), pallas, **TOL[dtype])
    assert not _f32(split)[~live].any()


def test_engine_at_group_seven_matches_jax_engine():
    """The smoke qwen3-1.7b at 14 q over 2 kv heads (G 7, as yi-34b's 56
    over 8), f32 params and pool, a stream whose pool compacts (a
    ``pool.compact()`` forced every third step): tokens and counters equal
    the JAX engine's."""
    kw = dict(n_heads=14, n_kv_heads=2)
    jcfg = jax_get_config("qwen3-1.7b").smoke()
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **kw})
    cfg = get_config("qwen3-1.7b").smoke().with_(**kw)
    assert cfg.n_heads // cfg.n_kv_heads == 7
    jm = JaxModel(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(2)))
    model = Model(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(5)
    requests = [(rng.integers(1, cfg.vocab_size, size=n), m)
                for n, m in [(19, 10), (5, 8), (11, 6), (3, 12)]]
    ekw = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
               max_seq=96, policy="mdc", streams=1, compact_trigger=2,
               compact_batch=3)
    engines = (JaxEngine(jm, params=jp, use_pallas=False,
                         pool_dtype=jnp.float32, **ekw),
               PagedServingEngine(model, pool_dtype=torch.float32,
                                  device="cpu", **ekw))
    tokens, counters = [], []
    n0 = ops.launches["paged_attention"]
    for eng in engines:
        rids = [eng.submit(p, n) for p, n in requests]
        for step in range(10_000):
            eng.step()
            if step % 3 == 2:
                eng.pool.compact()
            if not eng.has_work():
                break
        tokens.append([eng.finished[r] for r in rids])
        m = eng.metrics()
        counters.append({k: m[k] for k in COUNTERS})
    assert tokens[1] == tokens[0]
    assert [len(t) for t in tokens[1]] == [10, 8, 6, 12]
    assert counters[1] == counters[0] and counters[1]["blocks_moved"] > 0
    assert ops.launches["paged_attention"] == n0   # the CPU route launches none
