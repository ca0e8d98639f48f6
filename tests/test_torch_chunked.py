"""The port's chunked prefill, fused with decode in one dispatch, against the
JAX package's.

The contracts of ``tests/test_chunked_prefill.py``, each on the same inputs
in both packages:

* ``normalize_prefill_chunk`` rounds a budget up to whole pages as the JAX
  one does;
* model — ``gqa_prefill_chunk`` and ``prefill_chunk`` against the JAX
  functions at f32 (2e-5), a chunk's end past the key extent included,
  and the chunk rows against the port's own monolithic prefill's, bit for
  bit (each chunk attends the whole prompt's key extent);
* engine — on the serialized and the concurrent mixed streams the chunked
  engine gives the monolithic port engine's tokens and the oracle's, and
  the JAX chunked engine's tokens and pool counters; a prefix hit starts a
  chunk mid-grid; an in-flight prefill can be preempted and resumes with
  the uninterrupted tokens; an admission OOM after the prefix incref gives
  every reference back; ``admit_every_dispatch`` is the dial of the event
  horizon's clamp under stop-token decode.  Under pool pressure the chunked
  engine preempts as the JAX one does, and where the JAX engine's resumes
  preempt peers and never drain (ROADMAP §3) the port's tokens are held to
  the oracle.

Both engines run with ``pool_dtype`` float32 on the same float32 parameters
(the JAX engine on its plain path, the port's with ``device="cpu"``).  The
JAX engine runs are shared through module-scoped fixtures: each compiles
its own executables and costs seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import attention as jatt
from repro.models import transformer as jtfm
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving.scheduler import \
    normalize_prefill_chunk as jax_normalize_prefill_chunk
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.serving import PagedServingEngine
from repro_torch.serving.scheduler import normalize_prefill_chunk

TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp",
            "dispatches", "preemptions", "resumes", "recomputed_tokens",
            "prefill_chunks_dispatched")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's operations are tiny: one intra-op thread runs them
    faster than many, and keeps test files that run side by side in
    parallel workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _kw(prefill_chunk, n_slabs=8, max_batch=3, **kw):
    """test_chunked_prefill.py::_engine's geometry."""
    return dict(n_slabs=n_slabs, blocks_per_slab=4, page_T=8,
                max_batch=max_batch, max_seq=96, policy="mdc",
                compact_trigger=1, compact_batch=2,
                prefill_chunk=prefill_chunk, **kw)


def _port(models, **kw):
    return PagedServingEngine(models[2], pool_dtype=torch.float32,
                              device="cpu", **kw)


def _jax(models, **kw):
    jm, jp, _ = models
    return JaxEngine(jm, params=jp, use_pallas=False, pool_dtype=jnp.float32,
                     **kw)


def _mixed_reqs(vocab, n=8, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 60))),
             int(rng.integers(4, 25))) for _ in range(n)]


def _drain(eng):
    for _ in range(10_000):
        eng.step()
        if not eng.has_work():
            return
    raise AssertionError("engine did not drain")


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS if k in m}


def _oracle(models, prompt, n):
    _, _, model = models
    return tfm.greedy_decode(model.params, prompt, model.cfg, n,
                             cache_dtype=torch.float32)


def _serialized(eng, reqs):
    """One request at a time, each drained before the next is submitted."""
    out = []
    for p, n in reqs:
        rid = eng.submit(p, n)
        _drain(eng)
        out.append(eng.finished[rid])
    eng.pool.check_invariants()
    return out


def _concurrent(eng, reqs):
    rids = [eng.submit(p, n) for p, n in reqs]
    _drain(eng)
    eng.pool.check_invariants()
    return [eng.finished[r] for r in rids]


STREAMS = {"serialized": (dict(n_slabs=6, max_batch=1), 6, _serialized),
           "concurrent": (dict(n_slabs=6), 10, _concurrent)}


@pytest.fixture(scope="module")
def jax_streams(models):
    """Each mixed stream through the JAX chunked engine at C = 16: tokens
    and counters."""
    jm = models[0]
    out = {}
    for name, (kw, n, run) in STREAMS.items():
        eng = _jax(models, **_kw(16, **kw))
        out[name] = (run(eng, _mixed_reqs(jm.cfg.vocab_size, n=n)),
                     _counters(eng))
    return out


def test_normalize_prefill_chunk_matches_jax():
    for page_T in (1, 6, 8, 12, 16):
        for chunk in range(-2, 41):
            assert normalize_prefill_chunk(chunk, page_T) == \
                jax_normalize_prefill_chunk(chunk, page_T)
    assert normalize_prefill_chunk(10, 8) == 16
    assert normalize_prefill_chunk(16, 6) == 18


# ------------------------------------------------------------------- model

def _extent(rng, L, kv_len, Kh, hd):
    return (rng.standard_normal((L, 1, kv_len, Kh, hd)).astype(np.float32),
            rng.standard_normal((L, 1, kv_len, Kh, hd)).astype(np.float32))


@pytest.mark.parametrize("kernel", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("pos0,S,kv_len", [(16, 16, 32), (24, 16, 32),
                                           (40, 8, 64)])
def test_gqa_prefill_chunk_matches_jax(models, kernel, pos0, S, kv_len):
    """One layer's chunk attention over a random key extent (stale rows
    past the chunk included); at (24, 16, 32) the chunk's end passes the
    extent and its pad rows are cut.  The port writes the
    chunk's K/V into the extent's rows in place."""
    jm, jp, model = models
    cfg = model.cfg
    rng = np.random.default_rng(pos0 + S + kv_len)
    x = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    ke, ve = _extent(rng, 1, kv_len, cfg.n_kv_heads, cfg.hd)
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    want, (jk, jv) = jatt.gqa_prefill_chunk(
        jnp.asarray(x), jlp, jm.cfg, jnp.asarray(ke[0]), jnp.asarray(ve[0]),
        pos0)
    lp = tfm.layer(model.params["blocks"], 0)["attn"]
    k_ext = torch.from_numpy(ke[0].copy())
    v_ext = torch.from_numpy(ve[0].copy())
    got, (k, v) = att.gqa_prefill_chunk(torch.from_numpy(x), lp, cfg, k_ext,
                                        v_ext, pos0, kernel=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    n = min(S, kv_len - pos0)
    assert torch.equal(k_ext[:, pos0:pos0 + n], k[:, :n])
    assert torch.equal(v_ext[:, pos0:pos0 + n], v[:, :n])
    assert np.array_equal(k_ext[:, :pos0].numpy(), ke[0][:, :pos0])


def test_gqa_prefill_chunk_refuses_a_start_outside_the_extent(models):
    _, _, model = models
    cfg = model.cfg
    lp = tfm.layer(model.params["blocks"], 0)["attn"]
    ext = torch.zeros(1, 16, cfg.n_kv_heads, cfg.hd)
    with pytest.raises(ValueError, match="outside the key extent"):
        att.gqa_prefill_chunk(torch.zeros(1, 8, cfg.d_model), lp, cfg, ext,
                              ext.clone(), 16)


def test_prefill_chunk_matches_jax_and_the_monolithic_rows(models):
    """A 44-token prompt (bucket 64) in chunks of 16 at 0, 16 and 32, each
    over an extent whose rows from the chunk on are random (stale pool
    content): logits and chunk K/V against the JAX function, and the chunk
    rows and the final logits bit for bit the port's monolithic prefill's.
    A non-final chunk computes no logits."""
    jm, jp, model = models
    cfg, params = model.cfg, model.params
    plen, C, bucket = 44, 16, 64
    prompt = np.random.default_rng(5).integers(1, cfg.vocab_size, plen)
    toks = np.zeros(bucket, np.int64)
    toks[:plen] = prompt
    mono_logits, cache = tfm.prefill(params, torch.from_numpy(toks)[None],
                                     cfg, bucket, cache_dtype=torch.float32,
                                     true_len=plen)
    rng = np.random.default_rng(6)
    for pos0 in range(0, plen, C):
        ke, ve = _extent(rng, cfg.n_layers, bucket, cfg.n_kv_heads, cfg.hd)
        ke[:, :, :pos0] = cache["k"][:, :, :pos0].numpy()
        ve[:, :, :pos0] = cache["v"][:, :, :pos0].numpy()
        chunk = np.zeros(C, np.int64)
        seg = prompt[pos0:pos0 + C]
        chunk[:len(seg)] = seg
        last = pos0 + C >= plen
        last_idx = plen - 1 - pos0 if last else None
        logits, ks, vs = tfm.prefill_chunk(
            params, torch.from_numpy(chunk)[None], cfg,
            torch.from_numpy(ke.copy()), torch.from_numpy(ve.copy()), pos0,
            last_idx)
        jlogits, jks, jvs = jtfm.prefill_chunk(
            jp, jnp.asarray(chunk, jnp.int32)[None], jm.cfg, jnp.asarray(ke),
            jnp.asarray(ve), pos0, last_idx or 0)
        np.testing.assert_allclose(ks.numpy(), np.asarray(jks), **TOL)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
        n = len(seg)
        assert torch.equal(ks[:, :, :n], cache["k"][:, :, pos0:pos0 + n])
        assert torch.equal(vs[:, :, :n], cache["v"][:, :, pos0:pos0 + n])
        if last:
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL)
            assert torch.equal(logits, mono_logits)
        else:
            assert logits is None


# ------------------------------------------------------------------ engine

@pytest.mark.parametrize("stream", list(STREAMS))
def test_chunked_engine_matches_monolithic_jax_and_oracle(models, jax_streams,
                                                          stream):
    """test_chunked_matches_monolithic_{serialized,concurrent}'s streams:
    for every chunk size the port's tokens are its monolithic engine's and
    the oracle's; at C = 16 they and the pool counters are the JAX chunked
    engine's.  Serialized, the pool also sees the monolithic engine's
    events (equal counters but the dispatch counts).  The concurrent stream
    compacts under chunked prefill and releases every page at drain."""
    jm = models[0]
    kw, n, run = STREAMS[stream]
    reqs = _mixed_reqs(jm.cfg.vocab_size, n=n)
    mono = _port(models, **_kw(0, **kw))
    want = run(mono, reqs)
    assert want == [_oracle(models, p, m) for p, m in reqs]
    for chunk in (8, 16, 32):
        eng = _port(models, **_kw(chunk, **kw))
        assert run(eng, reqs) == want, f"tokens diverged at C={chunk}"
        m = eng.metrics()
        assert m["free_blocks"] == 6 * 4
        assert m["prefill_chunks_dispatched"] == sum(
            -(-len(p) // chunk) for p, _ in reqs)
        if stream == "serialized":
            drop = ("dispatches", "prefill_chunks_dispatched")
            mm = {k: v for k, v in _counters(eng).items() if k not in drop}
            assert mm == {k: v for k, v in _counters(mono).items()
                          if k not in drop}
        if chunk == 16:
            jtoks, jcount = jax_streams[stream]
            assert jtoks == want
            assert _counters(eng) == jcount
    if stream == "concurrent":
        assert m["compactions"] >= 1


def test_prefix_hit_starts_chunk_mid_grid(models):
    """test_prefix_hit_starts_chunk_mid_grid's stream: a cached 5-page
    prefix (40 tokens) starts the first chunk at 40, not a multiple of
    C = 16; the hit engine gives the cold engine's tokens and the JAX hit
    engine's tokens and counters, and saves prefill work."""
    jm = models[0]
    vocab = jm.cfg.vocab_size
    sysp = np.random.default_rng(42).integers(1, vocab, size=40)
    rng = np.random.default_rng(7)
    reqs = [(np.concatenate([sysp, rng.integers(1, vocab,
                                                size=int(rng.integers(5, 14)))]),
             int(rng.integers(6, 12))) for _ in range(4)]
    kw = _kw(16, n_slabs=12)
    cold = _concurrent(_port(models, **kw), reqs)
    hot_eng = _port(models, prefix_cache=True, **kw)
    jax_eng = _jax(models, prefix_cache=True, **kw)
    hot = _concurrent(hot_eng, reqs)
    assert hot == cold == _concurrent(jax_eng, reqs)
    hot_eng.prefix_cache.check_invariants()
    assert _counters(hot_eng) == _counters(jax_eng)
    assert hot_eng._prefill_tokens_saved > 0, "scenario must actually hit"
    assert hot_eng._prefill_tokens_saved == jax_eng._prefill_tokens_saved


def test_preempt_in_flight_prefill_resumes_with_its_tokens(models):
    """test_preempt_in_flight_prefill_resumes_bit_identical's stream: the
    prefilling slot is preempted after its first chunk, before it emitted
    a token; its pages release through the usual path, and the restart (a
    resume, as it came off the resume queue) finishes with the
    uninterrupted tokens."""
    jm = models[0]
    prompt = (np.arange(2, 60) * 7) % jm.cfg.vocab_size
    want = _oracle(models, prompt, 10)
    eng = _port(models, preemption=True, **_kw(16, n_slabs=10))
    rid = eng.submit(prompt, 10)
    eng.step()                       # first chunk dispatched
    assert eng._pf is not None and eng._pf["pos"] < eng._pf["plen"]
    i = eng._pf["slot"]
    assert eng._out[i] is None       # no token emitted yet
    eng._preempt(i)
    assert eng._pf is None and not eng._prefilling.any()
    eng.pool.check_invariants()
    assert eng.has_work()            # the request is on the resume queue
    _drain(eng)
    eng.pool.check_invariants()
    assert eng.finished[rid] == want
    assert eng.preemptions == 1 and eng.resumes == 1
    assert eng.metrics()["free_blocks"] == eng.pool.n_slabs * eng.pool.S


def test_preempt_a_resumed_prefill_mid_flight(models):
    """A request preempted mid-decode resumes through a chunked prefill,
    which is preempted again before its final chunk: the carried tokens
    survive both, and the second resume finishes with the oracle's."""
    jm = models[0]
    prompt = (np.arange(3, 50) * 5) % jm.cfg.vocab_size
    want = _oracle(models, prompt, 12)
    eng = _port(models, preemption=True, max_decode_chunk=2,
                **_kw(16, n_slabs=10))
    rid = eng.submit(prompt, 12)
    while eng._pf is not None or not eng._out_n.any():
        eng.step()
    eng.step()
    i = int(np.flatnonzero(eng.rid == rid)[0])
    assert 1 < eng._out_n[i] < 12
    eng._preempt(i)
    eng.step()                       # the resume's first chunk
    assert eng._pf is not None and eng._pf["resume"]
    eng._preempt(eng._pf["slot"])
    _drain(eng)
    eng.pool.check_invariants()
    assert eng.finished[rid] == want
    assert eng.preemptions == eng.resumes == 2


def test_admission_oom_returns_prefix_refs(models):
    """test_admission_oom_returns_prefix_refs: if the tail alloc OOMs
    after the prefix incref, the chunked start gives the shared references
    back and the engine keeps serving."""
    jm = models[0]
    sysp = np.random.default_rng(9).integers(1, jm.cfg.vocab_size, size=24)
    eng = _port(models, prefix_cache=True, **_kw(16, n_slabs=12))
    rid0 = eng.submit(np.concatenate([sysp, [3, 5]]), 4)  # seeds the tree
    _drain(eng)
    assert rid0 in eng.finished
    ref_before = eng.pool.block_ref.copy()
    orig = eng.pool.alloc_blocks

    def boom(*a, **k):
        raise RuntimeError("KV pool out of slabs (forced)")

    eng.pool.alloc_blocks = boom
    eng.submit(np.concatenate([sysp, [7, 11]]), 4)
    with pytest.raises(RuntimeError, match="forced"):
        eng.step()
    eng.pool.alloc_blocks = orig
    np.testing.assert_array_equal(eng.pool.block_ref, ref_before)
    assert not (eng.rid >= 0).any() and eng._pf is None
    eng.pool.check_invariants()
    rid2 = eng.submit(np.concatenate([sysp, [13, 17]]), 4)
    _drain(eng)
    assert rid2 in eng.finished


def test_event_horizon_clamps_only_with_admit_every_dispatch(models):
    """test_event_horizon_shrinks_while_work_waits_under_stop: with a
    request waiting under stop-token decode the horizon clamps to one
    token, and returns to its full length with ``admit_every_dispatch``
    off or nothing waiting; without a stop token it never clamps."""
    jm = models[0]
    vocab = jm.cfg.vocab_size
    eng = _port(models, stop_token=70, **_kw(0, n_slabs=4, max_batch=2))
    eng.submit(np.arange(1, 9) % vocab, 40)
    eng.step()                               # slot 0 decoding
    eng.submit((np.arange(1, 60) * 3) % vocab, 30)
    eng._admit()
    assert eng.queue and eng._pf is None     # pool-blocked: queued
    i = int(np.flatnonzero(eng.rid >= 0)[0])
    eng.lens[i] = int(eng.npages[i]) * eng.page_T - 5
    active = eng._decoding()
    assert eng._event_horizon(active) == 1   # clamped: the exit must be seen
    eng.admit_every_dispatch = False
    assert eng._event_horizon(active) == 5   # full horizon
    eng.admit_every_dispatch = True
    eng.queue.clear()
    assert eng._event_horizon(active) == 5   # nothing waiting: no clamp

    eng2 = _port(models, **_kw(16, n_slabs=4, max_batch=2))
    eng2.submit(np.arange(1, 9) % vocab, 40)
    while eng2._pf is not None or not (eng2.rid >= 0).any():
        eng2.step()
    eng2.submit((np.arange(1, 60) * 3) % vocab, 30)
    eng2._admit()
    assert eng2.queue and eng2._pf is None
    j = int(np.flatnonzero(eng2.rid >= 0)[0])
    eng2.lens[j] = int(eng2.npages[j]) * eng2.page_T - 6
    assert eng2._event_horizon(eng2._decoding()) == 6


def test_admit_every_dispatch_off_keeps_the_tokens(models):
    """With a stop token the stream emits and ``admit_every_dispatch`` off,
    dispatches keep the horizon's length while work waits: fewer
    dispatches, the oracle's tokens either way."""
    jm, _, model = models
    reqs = _mixed_reqs(jm.cfg.vocab_size, n=5, seed=4)
    full = _oracle(models, *reqs[0])
    stop = full[len(full) // 2]
    want = [tfm.greedy_decode(model.params, p, model.cfg, n, stop_token=stop,
                              cache_dtype=torch.float32) for p, n in reqs]
    dispatches = {}
    for flag in (True, False):
        eng = _port(models, stop_token=stop, admit_every_dispatch=flag,
                    **_kw(16, n_slabs=8, max_batch=2))
        assert _concurrent(eng, reqs) == want
        dispatches[flag] = eng.dispatches
    assert dispatches[False] < dispatches[True]


# ------------------------------------------------------ pressure, preemption

def _pressure_reqs(vocab):
    rng = np.random.default_rng(0)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 40))),
             int(rng.integers(4, 30))) for _ in range(8)]


def _pressure_kw(n_slabs):
    """test_preemption.py::_engine's geometry, chunked at 16."""
    return dict(n_slabs=n_slabs, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", compact_trigger=1, compact_batch=2,
                max_decode_chunk=32, preemption=True, prefill_chunk=16)


def test_chunked_pressure_preemption_matches_jax_and_oracle(models):
    """test_pressure_preemption_matches_big_pool's stream, chunked: through
    8 slabs both engines preempt once, with equal tokens and counters, and
    the tokens are the oracle's."""
    jm = models[0]
    reqs = _pressure_reqs(jm.cfg.vocab_size)
    want = [_oracle(models, p, n) for p, n in reqs]
    engs = _port(models, **_pressure_kw(8)), _jax(models, **_pressure_kw(8))
    assert [_concurrent(e, reqs) for e in engs] == [want, want]
    assert _counters(engs[0]) == _counters(engs[1])
    assert engs[0].preemptions >= 1
    assert engs[0].resumes == engs[0].preemptions


def test_chunked_resumes_wait_where_the_jax_engine_thrashes(models):
    """The same stream through 6 slabs: the JAX engine's resumes preempt
    peers and it does not drain in 10,000 steps (ROADMAP §3), so the
    port's tokens are held to the oracle.  Its resumes wait for capacity,
    and every preemption is resumed."""
    jm = models[0]
    reqs = _pressure_reqs(jm.cfg.vocab_size)
    eng = _port(models, **_pressure_kw(6))
    assert _concurrent(eng, reqs) == [_oracle(models, p, n) for p, n in reqs]
    assert eng.preemptions >= 2 and eng.resumes == eng.preemptions
    assert eng.metrics()["free_blocks"] == 6 * 2
