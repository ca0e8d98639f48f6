"""The port's MoE family (Qwen3-30B-A3B) against the JAX package's.

* ``moe_ffn`` — against ``repro.models.moe.moe_ffn`` at f32 (2e-5) over
  token counts, capacity factors that drop and that do not, and with and
  without a shared expert; the dispatch metadata (which token sits in which
  sorted pick, its expert slot, whether it was kept) exactly;
* model — the smoke MoE model bridged from the JAX parameters at f32:
  ``prefill`` / ``prefill_with_prefix`` / ``prefill_chunk`` /
  ``decode_step`` logits within 2e-5 of the JAX ones, greedy tokens equal,
  and the parameter counts;
* engine — the port's paged engine at ``pool_dtype`` float32 against the
  JAX engine on a compacting, a chunked, a prefix-hit and a
  capacity-dropping stream (tokens and pool counters), and, at the smoke
  config's no-drop capacity, the port's chunked and hit engines against its
  own monolithic and cold ones.

The smoke config's capacity factor (4.0 over 8 experts, top-2) holds every
pick; at 1.0 a 64-token prompt bucket in groups of two tokens drops the
second of two picks of one expert, so those streams run prompts of more than
32 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tfm
from repro_torch.serving import PagedServingEngine

ARCH = "qwen3-moe-30b-a3b"
# traced once per shape: eager calls retrace the layer scan every time
jax_decode_step = jax.jit(jtfm.decode_step, static_argnums=3)
TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp",
            "dispatches")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config(ARCH).smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config(ARCH).smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _with(models, **kw):
    """The same parameters under a config changed by ``kw``."""
    jm, jp, model = models
    return (JaxModel(jm.cfg.with_(**kw)), jp,
            Model(model.cfg.with_(**kw), model.params))


# ------------------------------------------------------------------ moe_ffn

def _ffn_case(seed, T, shared, d=128, E=8, ff=96):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) * 0.3,
         "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(ff),
         "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(ff),
         "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(d)}
    if shared:
        sff = ff * shared
        p.update(shared_gate=rng.standard_normal((d, sff)) / np.sqrt(sff),
                 shared_up=rng.standard_normal((d, sff)) / np.sqrt(sff),
                 shared_down=rng.standard_normal((sff, d)) / np.sqrt(d))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, T // 2, d)).astype(np.float32)
    return x, p


def _jax_dispatch(x, router, cfg, cf, groups):
    """The JAX ``moe_ffn``'s routing and dispatch, step by step."""
    B, S, d = x.shape
    T = B * S
    G = np.gcd(T, groups)
    Tg = T // G
    xg = jnp.asarray(x).reshape(G, Tg, d)
    probs = jax.nn.softmax(xg @ jnp.asarray(router)[None], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    cap = min(Tg, max(1, int(np.ceil(Tg * cfg.top_k * cf / cfg.n_experts))))
    gathered, meta = jax.vmap(lambda a, b, c: jmoe._dispatch_group(
        a, b, c, cfg.n_experts, cfg.top_k, cap))(xg, top_e, top_p)
    return np.asarray(top_e), cap, np.asarray(gathered), meta


def _port_dispatch(x, router, cfg, cf, groups):
    xg, top_p, top_e, cap = moe._route(torch.from_numpy(x),
                                       torch.from_numpy(router), cfg, cf,
                                       groups)
    gathered, meta = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts,
                                         cfg.top_k, cap)
    return top_e.numpy(), cap, gathered.numpy(), meta


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [4.0, 1.0, 0.5])
@pytest.mark.parametrize("T", [8, 24, 64, 256])
def test_moe_ffn_matches_jax(T, cf, shared):
    """Output within 2e-5 of the JAX function; the routing, the capacity,
    the gathered rows and the metadata ``st_tok`` / ``slot`` / ``keep``
    exactly, ``sw`` within 2e-5.  Where the capacity binds (T > 32 at
    capacity factors 1.0 and 0.5) some pick is dropped."""
    cfg = get_config(ARCH).smoke().with_(n_shared_experts=shared)
    jcfg = jax_get_config(ARCH).smoke().with_(n_shared_experts=shared)
    x, p = _ffn_case(T * 10 + shared, T, shared)
    got = moe.moe_ffn(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()},
                      cfg, cf, cfg.moe_groups)
    want = jmoe.moe_ffn(jnp.asarray(x),
                        {k: jnp.asarray(v) for k, v in p.items()},
                        jcfg, cf, jcfg.moe_groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    je, jcap, jgath, jmeta = _jax_dispatch(x, p["router"], jcfg, cf,
                                           jcfg.moe_groups)
    te, cap, gath, meta = _port_dispatch(x, p["router"], cfg, cf,
                                         cfg.moe_groups)
    assert (te == je).all(), "a top-k tie broken apart"
    assert cap == jcap
    np.testing.assert_array_equal(gath, jgath)
    (st_tok, slot, sw, keep), (jst, jslot, jsw, jkeep) = meta, jmeta
    np.testing.assert_array_equal(st_tok.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(sw.numpy(), np.asarray(jsw), **TOL)
    if T > 32 and cf < 4.0:
        assert not keep.all()
    if cf == 4.0:
        assert keep.all()


def test_combine_sums_each_token_in_ascending_expert_order():
    """The combine is the reference's scatter-add written as a gather: on
    bf16 it equals zeros + the picks added one by one in sorted order."""
    cfg = get_config(ARCH).smoke()
    x, p = _ffn_case(3, 64, 0)
    xg = torch.from_numpy(x).reshape(32, 2, -1).to(torch.bfloat16)
    probs = torch.softmax(xg.float() @ torch.from_numpy(p["router"]), -1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    gathered, meta = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts,
                                         cfg.top_k, 1)
    y = torch.randn(gathered.shape, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    got = moe._combine_group(y, meta, 2)
    st_tok, slot, sw, keep = meta
    E_cap = y.shape[1] * y.shape[2]
    want = torch.zeros_like(got)
    for g in range(y.shape[0]):
        yflat = y[g].reshape(E_cap, -1)
        for j in range(st_tok.shape[1]):   # sorted order
            w = (sw[g, j] if keep[g, j] else torch.tensor(0.0)).to(y.dtype)
            row = yflat[min(int(slot[g, j]), E_cap - 1)] * w
            want[g, st_tok[g, j]] = want[g, st_tok[g, j]] + row
    assert torch.equal(got, want)


# -------------------------------------------------------------------- model

@pytest.mark.parametrize("cf", [4.0, 1.0], ids=["no-drop", "drops"])
def test_prefill_logits_and_kv_match_jax(models, cf):
    """A 48-token prompt in its 64-token bucket (32 groups of two tokens):
    logits and K/V against ``tfm.prefill``, at the smoke capacity and at
    one that drops."""
    jm, jp, model = _with(models, capacity_factor=cf)
    cfg = model.cfg
    plen, bucket = 48, 64
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = np.random.default_rng(4).integers(1, cfg.vocab_size, plen)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks), jm.cfg, bucket + 8,
                          cache_dtype=jnp.float32, true_len=plen)
    tl, tc = tfm.prefill(model.params, torch.from_numpy(toks), cfg,
                         bucket + 8, cache_dtype=torch.float32, true_len=plen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **TOL)


def test_prefix_and_chunk_prefills_match_jax(models):
    """A 40-token prompt: its 16-token tail after a 24-token cached prefix
    (``prefill_with_prefix``) and its chunks of 16 at 0, 16 and 32
    (``prefill_chunk``) against the JAX functions."""
    jm, jp, model = models
    cfg, params = model.cfg, model.params
    prompt = np.random.default_rng(5).integers(1, cfg.vocab_size, 40)
    bucket = 64
    toks = np.zeros(bucket, np.int64)
    toks[:40] = prompt
    _, cache = tfm.prefill(params, torch.from_numpy(toks)[None], cfg, bucket,
                           cache_dtype=torch.float32, true_len=40)
    P, tail = 24, 16
    k_pre, v_pre = cache["k"][:, :, :P], cache["v"][:, :, :P]
    t = np.zeros(tail, np.int64)
    t[:40 - P] = prompt[P:]
    logits, ks, vs = tfm.prefill_with_prefix(
        params, torch.from_numpy(t)[None], cfg, k_pre, v_pre, tail,
        true_len=40 - P, kv_len=bucket, cache_dtype=torch.float32)
    jlogits, jks, jvs = jtfm.prefill_with_prefix(
        jp, jnp.asarray(t, jnp.int32)[None], jm.cfg,
        jnp.asarray(k_pre.numpy()), jnp.asarray(v_pre.numpy()), tail,
        true_len=40 - P, kv_len=bucket, cache_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), **TOL)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
    for pos0 in (0, 16, 32):
        ext_k, ext_v = cache["k"].clone(), cache["v"].clone()
        chunk = toks[pos0:pos0 + 16]
        last_idx = 40 - 1 - pos0 if pos0 == 32 else None
        logits, ks, vs = tfm.prefill_chunk(
            params, torch.from_numpy(chunk)[None], cfg, ext_k, ext_v, pos0,
            last_idx)
        jlogits, jks, jvs = jtfm.prefill_chunk(
            jp, jnp.asarray(chunk, jnp.int32)[None], jm.cfg,
            jnp.asarray(cache["k"].numpy()), jnp.asarray(cache["v"].numpy()),
            pos0, last_idx or 0)
        np.testing.assert_allclose(ks.numpy(), np.asarray(jks), **TOL)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
        if last_idx is not None:
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)


def test_decode_steps_and_greedy_tokens_match_jax(models):
    """Five decode steps of a batch of three (three groups of one token)
    against ``tfm.decode_step``; greedy tokens equal."""
    jm, jp, model = models
    cfg = model.cfg
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, (3, 20))
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks, jnp.int32), jm.cfg, 32,
                          cache_dtype=jnp.float32)
    tl, tc = tfm.prefill(model.params, torch.from_numpy(toks), cfg, 32,
                         cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc = jax_decode_step(jp, jc, jnp.asarray(nxt), jm.cfg)
        tl, tc = tfm.decode_step(model.params, tc, torch.from_numpy(nxt), cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the greedy tokens of row 0 through the JAX functions, one at a time
    # (what ``jtfm.greedy_decode`` runs, without its per-call tracing)
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks[:1], jnp.int32), jm.cfg, 32,
                          cache_dtype=jnp.float32)
    want = [int(np.argmax(np.asarray(jl)[0]))]
    while len(want) < 10:
        jl, jc = jax_decode_step(jp, jc, jnp.asarray(want[-1:], jnp.int32),
                                 jm.cfg)
        want.append(int(np.argmax(np.asarray(jl)[0])))
    assert model.greedy_decode(toks[0], 10, cache_dtype=torch.float32) == want


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_counts_match_jax(smoke):
    """``n_params`` / ``n_active_params`` equal the JAX ``Model``'s; at full
    width the active count sits in ``test_models.py``'s "A3B" band."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    mine = Model(cfg, {})   # the counts read the config, not the tensors
    jm = JaxModel(jcfg)
    assert mine.n_params() == jm.n_params()
    assert mine.n_active_params() == jm.n_active_params()
    if not smoke:
        assert 2e9 < mine.n_active_params() < 5e9
        assert mine.n_active_params() < mine.n_params() / 5


def test_large_leaves_are_drawn_slice_by_slice(monkeypatch):
    """A leaf of ``SLICED_DRAW_ELEMENTS`` or more is drawn one slice of its
    leading axis at a time from the same generator; a smaller one whole, as
    before the threshold existed."""
    specs = {"a": layers.spec((3, 4, 5)), "b": layers.spec((6,), scale=0.5)}

    def draw():
        return layers.init_params(specs, torch.Generator().manual_seed(1),
                                  device="cpu")

    g = torch.Generator().manual_seed(1)
    whole = (torch.randn((3, 4, 5), generator=g) * specs["a"].scale
             ).to(torch.bfloat16)
    b = (torch.randn((6,), generator=g) * 0.5).to(torch.bfloat16)
    got = draw()
    assert torch.equal(got["a"], whole) and torch.equal(got["b"], b)
    monkeypatch.setattr(layers, "SLICED_DRAW_ELEMENTS", 60)
    g = torch.Generator().manual_seed(1)
    sliced = torch.stack([(torch.randn((4, 5), generator=g)
                           * specs["a"].scale).to(torch.bfloat16)
                          for _ in range(3)])
    b = (torch.randn((6,), generator=g) * 0.5).to(torch.bfloat16)
    got = draw()
    assert torch.equal(got["a"], sliced) and torch.equal(got["b"], b)


def test_only_the_moe_expert_leaves_are_drawn_in_slices():
    """Every leaf of the dense configs the port draws at full width (on
    the card) or at smoke width lies below the threshold, so their weights
    are drawn as before; the full MoE config's expert leaves lie above."""
    big = {}
    for name in ("qwen3-1.7b", ARCH):
        for cfg in (get_config(name), get_config(name).smoke()):
            for path, s in layers.flatten(tfm.model_specs(cfg)):
                if np.prod(s.shape) >= layers.SLICED_DRAW_ELEMENTS:
                    big.setdefault(cfg.name, set()).add("/".join(path))
    assert big == {ARCH: {"blocks/mlp/w_gate", "blocks/mlp/w_up",
                          "blocks/mlp/w_down"}}


# ------------------------------------------------------------------- engine

SERVE_KW = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", streams=1, compact_trigger=2,
                compact_batch=3, max_decode_chunk=8)
CHUNKED_KW = dict(n_slabs=8, blocks_per_slab=4, page_T=8, max_batch=3,
                  max_seq=96, policy="mdc", compact_trigger=1,
                  compact_batch=2)
PREFIX_KW = dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=3,
                 max_seq=96, policy="mdc", streams=1, compact_trigger=2,
                 compact_batch=3)
DROP_KW = dict(n_slabs=10, blocks_per_slab=4, page_T=8, max_batch=3,
               max_seq=160, policy="mdc", streams=1, compact_trigger=2,
               compact_batch=3)


def _serve_reqs(vocab):   # test_sharded_serving.py::_serve's stream
    rng = np.random.default_rng(3)
    return [(rng.integers(1, vocab, size=plen), n_new) for plen, n_new in
            zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]


def _chunked_reqs(vocab, n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 60))),
             int(rng.integers(4, 25))) for _ in range(n)]


def _prefix_reqs(vocab, n_req=6, sys_len=24, seed=1):
    rng = np.random.default_rng(seed)
    sys_prompt = np.random.default_rng(42).integers(1, vocab, size=sys_len)
    return [(np.concatenate([sys_prompt, rng.integers(
        1, vocab, size=int(rng.integers(3, 14)))]), int(rng.integers(4, 12)))
        for _ in range(n_req)]


def _drop_reqs(vocab, n=5, seed=7):
    """Prompts of 33-100 tokens: buckets of 64 and 128, groups of 2 and 4."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(33, 101))),
             int(rng.integers(4, 12))) for _ in range(n)]


def _run(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    for _ in range(10_000):
        eng.step()
        if not eng.has_work():
            break
    else:
        raise AssertionError("engine did not drain")
    eng.pool.check_invariants()
    if eng.prefix_cache is not None:
        eng.prefix_cache.check_invariants()
    return [eng.finished[r] for r in rids]


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS}


def _port(model, **kw):
    return PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                              **kw)


def _jax(jm, jp, **kw):
    return JaxEngine(jm, params=jp, use_pallas=False, pool_dtype=jnp.float32,
                     **kw)


STREAMS = {
    "compacting": (SERVE_KW, _serve_reqs),
    "chunked": (dict(CHUNKED_KW, prefill_chunk=16), _chunked_reqs),
    "prefix": (dict(PREFIX_KW, prefix_cache=True), _prefix_reqs),
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_engine_matches_jax_engine(models, stream):
    """The port's engine gives the JAX MoE engine's tokens and pool
    counters: compaction under pressure, chunked prefill fused with decode,
    prefix-cache hits."""
    jm, jp, model = models
    kw, reqs = STREAMS[stream]
    reqs = reqs(model.cfg.vocab_size)
    jax_eng, eng = _jax(jm, jp, **kw), _port(model, **kw)
    assert _run(eng, reqs) == _run(jax_eng, reqs)
    assert _counters(eng) == _counters(jax_eng)
    m = eng.metrics()
    if stream == "compacting":
        assert m["compactions"] >= 1
    if stream == "chunked":
        assert m["prefill_chunks_dispatched"] > len(reqs)
    if stream == "prefix":
        assert m["prefix_hit_rate"] >= 5 / 6


def test_capacity_dropping_engine_matches_jax_engine(models, monkeypatch):
    """At capacity factor 1.0 the prefills drop picks (counted through the
    port's ``_dispatch_group``), and the decode's groups of one token never
    do: tokens and counters still the JAX engine's."""
    jm, jp, model = _with(models, capacity_factor=1.0)
    reqs = _drop_reqs(model.cfg.vocab_size)
    dropped = {"prefill": 0, "decode": 0}
    dispatch = moe._dispatch_group

    def counting(xt, top_e, top_p, E, k, capacity):
        out = dispatch(xt, top_e, top_p, E, k, capacity)
        which = "decode" if xt.shape[1] == 1 else "prefill"
        dropped[which] += int((~out[1][3]).sum())
        return out

    monkeypatch.setattr(moe, "_dispatch_group", counting)
    eng = _port(model, **DROP_KW)
    got = _run(eng, reqs)
    assert dropped["prefill"] > 0 and dropped["decode"] == 0
    jax_eng = _jax(jm, jp, **DROP_KW)
    assert got == _run(jax_eng, reqs)
    assert _counters(eng) == _counters(jax_eng)


def test_chunked_equals_monolithic_and_hit_equals_cold_without_drops(models):
    """At the smoke capacity nothing drops, so the grouping of a call does
    not change a token: chunked prefill gives the monolithic engine's
    tokens and a prefix hit the cold prefill's, inside the port."""
    model = models[2]
    reqs = _chunked_reqs(model.cfg.vocab_size)
    mono = _run(_port(model, **CHUNKED_KW), reqs)
    assert _run(_port(model, **CHUNKED_KW, prefill_chunk=16), reqs) == mono
    reqs = _prefix_reqs(model.cfg.vocab_size)
    hot = _port(model, **PREFIX_KW, prefix_cache=True)
    assert _run(hot, reqs) == _run(_port(model, **PREFIX_KW), reqs)
    assert hot.metrics()["prefix_hit_rate"] >= 5 / 6
