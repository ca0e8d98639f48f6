"""The port's prefix-cache hit path against the JAX package's.

Three levels, each on the same inputs in both packages:

* pool and tree — the port's ``LogStructuredKVPool`` reference counts,
  ``FrameLog`` sharing and ``PrefixCache`` driven through the operations
  of ``tests/test_prefix_cache.py`` (incref until the last decref, death
  estimate raised to the max, counts carried by compaction, random
  traffic, longest prefix with the copy-on-write cap, LRU and capacity,
  eviction under pool pressure): every observation must equal the JAX
  package's, and the JAX tests' own assertions hold for the port;
* model — ``gqa_prefill_cont`` and ``prefill_with_prefix`` against the JAX
  functions at f32 (2e-5), and the port's hit rows against its own whole
  prefill's rows, bit for bit;
* engine — the shared-prefix streams of ``tests/test_prefix_cache.py``: the
  port's hit engine gives the JAX hit engine's tokens and counters, and its
  own cold engine's tokens.

Both engines run with ``pool_dtype`` float32 on the same float32 parameters
(the JAX engine on its plain path, the port's with ``device="cpu"``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.logstructure import Placement as JaxPlacement
from repro.models import Model as JaxModel
from repro.models import attention as jatt
from repro.models import transformer as jtfm
from repro.serving import LogStructuredKVPool as JaxPool
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import PrefixCache as JaxPrefixCache
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.logstructure import Placement
from repro_torch.models import Model
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.serving import (LogStructuredKVPool, PagedServingEngine,
                                 PrefixCache)

TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp",
            "prefill_tokens_saved", "prefix_hit_rate", "frames_shared")

JAX_SIDE = dict(Pool=JaxPool, Placement=JaxPlacement, Cache=JaxPrefixCache)
PORT_SIDE = dict(Pool=LogStructuredKVPool, Placement=Placement,
                 Cache=PrefixCache)


# ------------------------------------------------------------ pool and tree

def _alloc(side, pool, owner, n, death):
    return pool.alloc_blocks(np.full(n, owner),
                             side["Placement"](est_death=np.full(n, death)))


def _case_incref_until_last_decref(side):
    pool = side["Pool"](8, 4, policy="mdc", compact_trigger=1,
                        compact_batch=2, streams=2)
    pages = _alloc(side, pool, 7, 3, 50.0)
    pool.incref_pages(pages, 90.0)          # a second sequence shares them
    seen = [pool.block_ref[pages].tolist()]
    pool.free_pages(pages)                  # first reference drops
    assert (pool.block_owner[pages] >= 0).all(), "freed while referenced"
    assert pool.stats.blocks_died == 0 and pool.stats.ref_drops == 3
    seen.append(pool.block_ref[pages].tolist())
    pool.free_pages(pages)                  # last reference drops
    assert (pool.block_owner[pages] == -1).all()
    assert pool.stats.blocks_died == 3 and pool.stats.frames_shared == 3
    pool.check_invariants()
    return seen, pool


def _case_death_estimate_raised_to_max(side):
    pool = side["Pool"](8, 4, policy="mdc", compact_trigger=1,
                        compact_batch=2, streams=2)
    pages = _alloc(side, pool, 1, 2, 50.0)
    pool.incref_pages(pages, 200.0)         # longer-lived referencer
    assert (pool.block_death[pages] == 200.0).all()
    pool.incref_pages(pages, 120.0)         # a shorter one must NOT lower it
    assert (pool.block_death[pages] == 200.0).all()
    seg = int(pages[0]) // pool.S
    assert pool.core.seg_up2sum[seg] == pytest.approx(
        200.0 * pool.core.seg_live[seg])
    seen = [pool.block_death.tolist(), pool.core.seg_up2sum.tolist()]
    for _ in range(3):
        pool.free_pages(pages)
    pool.check_invariants()
    return seen, pool


def _case_compaction_carries_refcounts(side):
    pool = side["Pool"](8, 4, policy="mdc", compact_trigger=0,
                        compact_batch=4, streams=1)
    held = {}  # shadow: page -> refcount (remapped by the plan callback)

    def execute(plan):
        remap = dict(zip(plan.src_pages.tolist(), plan.dst_pages.tolist()))
        for p in list(held):
            if p in remap:
                held[remap[p]] = held.pop(p)

    pool.on_compaction = execute
    short = []
    for i in range(8):
        short.append(int(_alloc(side, pool, 100 + i, 1, 5.0)[0]))
        p = int(_alloc(side, pool, 200 + i, 1, 1e6)[0])
        pool.incref_pages(np.asarray([p]), 1e6)   # shared with a 2nd seq
        held[p] = 2
    pool.free_pages(np.asarray(short))
    plan = pool.compact()
    assert plan is not None and len(plan) > 0
    pool.check_invariants()
    pages = np.asarray(list(held))
    assert (pool.block_ref[pages] == [held[int(p)] for p in pages]).all()
    seen = [plan.src_pages.tolist(), plan.dst_pages.tolist(),
            pool.block_ref.tolist()]
    pool.free_pages(pages)
    assert (pool.block_owner[pages] >= 0).all()
    pool.free_pages(pages)
    assert (pool.block_owner[pages] == -1).all()
    pool.check_invariants()
    return seen, pool


def _case_random_traffic(side, seed):
    """test_pool_refcount_invariants_random_traffic's traffic, against a
    shadow model: a referenced page is never freed or re-allocated, and its
    owner and count match the shadow after every plan's remap."""
    rng = np.random.default_rng(seed)
    pool = side["Pool"](10, 4, policy="mdc", compact_trigger=2,
                        compact_batch=3, streams=2)
    refs: dict[int, int] = {}
    seqs: dict[int, list[int]] = {}
    deaths = 0
    seen = []

    def execute(plan):
        assert set(plan.src_pages.tolist()) <= set(refs), \
            "compaction moved a dead page"
        remap = dict(zip(plan.src_pages.tolist(), plan.dst_pages.tolist()))
        moved = {remap[p]: refs.pop(p) for p in list(refs) if p in remap}
        refs.update(moved)
        for pages in seqs.values():
            pages[:] = [remap.get(p, p) for p in pages]

    pool.on_compaction = execute
    sid = 0
    for _ in range(250):
        op = rng.random()
        if op < 0.45 or not seqs:                      # new sequence
            if pool.free_blocks() < 8:
                continue
            n = int(rng.integers(1, 4))
            pages = pool.alloc_blocks(
                np.full(n, sid), side["Placement"](
                    est_death=rng.integers(1, 100, n).astype(float)))
            for p in pages:
                assert int(p) not in refs, "re-allocated a referenced page"
                refs[int(p)] = 1
            seqs[sid] = pages.tolist()
            sid += 1
        elif op < 0.65:                                # share another's pages
            donor = rng.choice(list(seqs))
            take = [p for p in seqs[donor]
                    if refs[p] < 4][:int(rng.integers(1, 3))]
            if not take:
                continue
            pool.incref_pages(np.asarray(take), float(rng.integers(50, 200)))
            for p in take:
                refs[p] += 1
            seqs[sid] = take
            sid += 1
        elif op < 0.9:                                 # a sequence finishes
            pages = seqs.pop(rng.choice(list(seqs)))
            pool.free_pages(np.asarray(pages))
            for p in pages:
                refs[p] -= 1
                if refs[p] == 0:
                    del refs[p]
                    deaths += 1
        else:                                          # forced compaction
            pool.compact()
        pool.check_invariants()
        if refs:
            pages = np.asarray(list(refs))
            assert (pool.block_owner[pages] >= 0).all()
            assert (pool.block_ref[pages] == list(refs.values())).all()
        assert int((pool.block_owner >= 0).sum()) == len(refs) \
            == int(pool.core.seg_live.sum())
        assert pool.stats.deaths == deaths
        seen.append((pool.block_ref.tolist(), pool.block_owner.tolist()))
    for k in list(seqs):
        pool.free_pages(np.asarray(seqs.pop(k)))
    pool.check_invariants()
    return seen, pool


def _mini_pool(side):
    return side["Pool"](8, 4, policy="mdc", compact_trigger=1,
                        compact_batch=2, streams=2)


def _case_longest_prefix_and_cow_boundary(side):
    pool = _mini_pool(side)
    cache = side["Cache"](pool, page_T=4)
    toks = np.arange(1, 11)  # 10 tokens = 2 full pages + partial
    pages = _alloc(side, pool, 0, 3, 50.0)
    assert cache.insert(toks, pages[:2], 50.0) == 2  # the partial page never
    assert cache.n_pages == 2                        # enters
    assert (pool.block_ref[pages[:2]] == 2).all()
    assert pool.block_ref[pages[2]] == 1
    seen = [cache.lookup(toks), cache.lookup(np.r_[toks[:4], [99] * 4]),
            cache.lookup(np.asarray([99] * 8))]
    assert seen == [pages[:2].tolist(), [pages[0]], []]
    assert cache.hit_rate() == pytest.approx(2 / 3)
    # a referenced leaf pins its unreferenced parent
    pool.free_pages(pages[:1])
    assert cache.evictable() == 0
    pool.free_pages(pages[1:2])
    assert cache.evictable() == 2
    cache.check_invariants()
    return seen + [cache.pages()], pool


def _case_lru_eviction_and_capacity(side):
    pool = _mini_pool(side)
    cache = side["Cache"](pool, page_T=4, capacity_pages=2)
    entries = []
    for owner, base in enumerate((0, 100, 200)):
        toks = np.arange(base, base + 4)
        page = _alloc(side, pool, owner, 1, 50.0)
        cache.insert(toks, page, 50.0)
        pool.free_pages(page)  # the owner finishes; the tree keeps it alive
        entries.append((toks, int(page[0])))
    assert cache.n_pages == 2 and cache.evictions == 1
    assert cache.lookup(np.r_[entries[0][0], [7]]) == []   # LRU evicted
    assert pool.block_owner[entries[0][1]] == -1
    assert cache.lookup(entries[1][0]) == []  # a one-page prompt never splices
    hit = cache.lookup(np.r_[entries[1][0], [7]])
    assert len(hit) == 1
    pool.incref_pages(np.asarray(hit), 60.0)   # an active sequence uses it
    cache.evict(10)
    assert pool.block_owner[hit[0]] >= 0       # referenced: never evicted
    assert cache.lookup(np.r_[entries[1][0], [7]]) == hit
    cache.check_invariants()
    return [hit, cache.pages(), cache.evictions], pool


def _case_pressure_evicts_unreferenced_prefixes(side):
    pool = side["Pool"](4, 2, policy="mdc", compact_trigger=0,
                        compact_batch=2, streams=1)
    pool.on_compaction = lambda plan: None
    cache = side["Cache"](pool, page_T=4)
    for base in range(0, 24, 4):  # fill the whole pool with cached prefixes
        page = _alloc(side, pool, base, 1, 50.0)
        cache.insert(np.arange(base, base + 4), page, 50.0)
        pool.free_pages(page)
    assert pool.free_blocks() <= 2
    pages = _alloc(side, pool, 99, 4, 70.0)  # would OOM without the hook
    assert len(pages) == 4 and cache.evictions >= 2
    cache.check_invariants()
    pool.check_invariants()
    return [pages.tolist(), cache.pages(), cache.evictions], pool


CASES = {
    "incref_until_last_decref": _case_incref_until_last_decref,
    "death_estimate_raised_to_max": _case_death_estimate_raised_to_max,
    "compaction_carries_refcounts": _case_compaction_carries_refcounts,
    **{f"random_traffic_seed{s}": (lambda side, s=s: _case_random_traffic(
        side, s)) for s in (0, 1, 2, 3)},
    "longest_prefix_and_cow_boundary": _case_longest_prefix_and_cow_boundary,
    "lru_eviction_and_capacity": _case_lru_eviction_and_capacity,
    "pressure_evicts_unreferenced_prefixes":
        _case_pressure_evicts_unreferenced_prefixes,
}


@pytest.mark.parametrize("case", list(CASES))
def test_pool_and_tree_match_jax(case):
    """Each case asserts the JAX test's own properties on both packages, and
    the port's observations and counters must equal the JAX package's."""
    want, jpool = CASES[case](JAX_SIDE)
    got, pool = CASES[case](PORT_SIDE)
    assert got == want
    for f in dataclasses.fields(pool.stats):
        assert getattr(pool.stats, f.name) == getattr(jpool.stats, f.name), \
            f.name


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _prefix_kv(rng, L, P, Kh, hd):
    return (rng.standard_normal((L, 1, P, Kh, hd)).astype(np.float32),
            rng.standard_normal((L, 1, P, Kh, hd)).astype(np.float32))


@pytest.mark.parametrize("kernel", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("P,S,kv_len", [(16, 8, 32), (16, 24, 32),
                                        (24, 13, None), (8, 32, 32)])
def test_gqa_prefill_cont_matches_jax(models, kernel, P, S, kv_len):
    """One layer's continuation attention: the tail padded (S < kv_len - P)
    or cut (S > kv_len - P) to the key extent, or at its own length."""
    jm, jp, model = models
    cfg = model.cfg
    rng = np.random.default_rng(P + S)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    kp, vp = _prefix_kv(rng, 1, P, cfg.n_kv_heads, cfg.hd)
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want, (jk, jv) = jatt.gqa_prefill_cont(jnp.asarray(x), jlp, jm.cfg,
                                           jnp.asarray(kp[0]),
                                           jnp.asarray(vp[0]), kv_len=kv_len)
    lp = tfm.layer(model.params["blocks"], 0)["attn"]
    got, (k, v) = att.gqa_prefill_cont(torch.from_numpy(x), lp, cfg,
                                       torch.from_numpy(kp[0]),
                                       torch.from_numpy(vp[0]), kv_len=kv_len,
                                       kernel=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def _cold_prefill(params, cfg, prompt, bucket):
    toks = np.zeros(bucket, np.int64)
    toks[:len(prompt)] = prompt
    return tfm.prefill(params, torch.from_numpy(toks)[None], cfg, bucket,
                       cache_dtype=torch.float32, true_len=len(prompt))


def test_prefill_with_prefix_matches_jax_and_the_cold_rows(models):
    """A 40-token prompt with a 24-token cached prefix (the engine's page_T
    8 geometry): the tail's logits and K/V against the JAX function at f32,
    and against the port's own whole prefill of the prompt, bit for bit —
    the flash kernel's query offset makes the tail rows the cold rows."""
    jm, jp, model = models
    cfg, params = model.cfg, model.params
    prompt = np.random.default_rng(5).integers(1, cfg.vocab_size, 40)
    P, tail, bucket = 24, 16, 64
    cold_logits, cache = _cold_prefill(params, cfg, prompt, bucket)
    k_pre, v_pre = cache["k"][:, :, :P], cache["v"][:, :, :P]
    toks = np.zeros(tail, np.int64)
    toks[:len(prompt) - P] = prompt[P:]
    logits, ks, vs = tfm.prefill_with_prefix(
        params, torch.from_numpy(toks)[None], cfg, k_pre, v_pre, tail,
        true_len=len(prompt) - P, kv_len=bucket, cache_dtype=torch.float32)
    jlogits, jks, jvs = jtfm.prefill_with_prefix(
        jp, jnp.asarray(toks, jnp.int32)[None], jm.cfg,
        jnp.asarray(k_pre.numpy()), jnp.asarray(v_pre.numpy()), tail,
        true_len=len(prompt) - P, kv_len=bucket, cache_dtype=jnp.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), **TOL)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
    assert torch.equal(logits, cold_logits)
    n = len(prompt) - P
    assert torch.equal(ks[:, :, :n], cache["k"][:, :, P:P + n])
    assert torch.equal(vs[:, :, :n], cache["v"][:, :, P:P + n])


# ------------------------------------------------------------------ engine

ENGINE_KW = dict(blocks_per_slab=2, page_T=8, max_batch=3, max_seq=96,
                 policy="mdc", streams=1, compact_trigger=2, compact_batch=3)


def _engines(models, **kw):
    jm, jp, model = models
    jax_eng = JaxEngine(jm, params=jp, use_pallas=False,
                        pool_dtype=jnp.float32, **ENGINE_KW, **kw)
    eng = PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                             **ENGINE_KW, **kw)
    return jax_eng, eng


def _requests(vocab, n_req=6, sys_len=24, seed=1):
    """test_prefix_cache.py::_shared_stream: N users × one system prompt +
    unique tails."""
    rng = np.random.default_rng(seed)
    sys_prompt = np.random.default_rng(42).integers(1, vocab, size=sys_len)
    return [(np.concatenate([sys_prompt,
                             rng.integers(1, vocab, size=int(rng.integers(3, 14)))]),
             int(rng.integers(4, 12))) for _ in range(n_req)]


def _check_refcounts(eng):
    """Each page's reference count is the number of block-table rows that
    hold it plus one if the tree caches it."""
    want = np.zeros_like(eng.pool.block_ref)
    for i in range(eng.max_batch):
        if eng.slot_active(i):
            np.add.at(want, eng.slot_pages(i).astype(np.int64), 1)
    if eng.prefix_cache is not None and eng.prefix_cache.pages():
        np.add.at(want, np.asarray(eng.prefix_cache.pages(), np.int64), 1)
    assert (want == eng.pool.block_ref).all()


def _run(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    for _ in range(10_000):
        eng.step()
        if isinstance(eng, PagedServingEngine):
            _check_refcounts(eng)
        if not eng.has_work():
            break
    eng.pool.check_invariants()
    if eng.prefix_cache is not None:
        eng.prefix_cache.check_invariants()
    return [eng.finished[r] for r in rids]


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS}


def test_prefix_hit_engine_matches_jax_and_cold(models):
    """test_prefix_hit_decode_bit_identical_to_cold's stream: the port's hit
    engine gives the JAX hit engine's tokens and counters, and its own cold
    engine's tokens, under compaction."""
    jm, _, _ = models
    reqs = _requests(jm.cfg.vocab_size)
    jax_hot, hot = _engines(models, n_slabs=8, prefix_cache=True)
    _, cold = _engines(models, n_slabs=8)
    want = _run(jax_hot, reqs)
    got = _run(hot, reqs)
    assert got == want
    assert got == _run(cold, reqs)
    assert _counters(hot) == _counters(jax_hot)
    m = hot.metrics()
    assert m["prefix_hit_rate"] >= 5 / 6
    assert m["prefill_tokens_saved"] >= m["prefill_tokens_computed"]
    assert m["frames_shared"] > 0 and m["compactions"] >= 1


def test_shared_pages_survive_donor_finish_and_compaction(models):
    """test_shared_pages_survive_donor_finish_and_compaction's stream: the
    donor drains alone, a forced compaction moves the cached pages, and the
    followers still hit with the cold tokens and the JAX engine's."""
    jm, _, _ = models
    reqs = _requests(jm.cfg.vocab_size)
    _, cold = _engines(models, n_slabs=8)
    want = _run(cold, reqs)
    results = []
    for eng in _engines(models, n_slabs=10, prefix_cache=True):
        rids = [eng.submit(*reqs[0])]
        eng.run_to_completion()
        assert eng.prefix_cache.n_pages >= 3
        eng.pool.compact()             # pages may move; the tree remaps
        eng.prefix_cache.check_invariants()
        rids += [eng.submit(p, n) for p, n in reqs[1:]]
        eng.run_to_completion()
        assert [eng.finished[r] for r in rids] == want
        assert eng.metrics()["prefix_hit_rate"] == pytest.approx(5 / 6)
        results.append(_counters(eng))
    assert results[0] == results[1]


def test_prefix_cache_is_off_by_default(models):
    _, _, model = models
    eng = PagedServingEngine(model, n_slabs=8, blocks_per_slab=2, page_T=8,
                             max_batch=2, max_seq=64, device="cpu")
    assert eng.prefix_cache is None
    assert "prefix_hit_rate" not in eng.metrics()
