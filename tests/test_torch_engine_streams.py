"""The JAX engine streams of ``tests/test_serving.py`` and
``tests/test_streams.py`` that the other port tests do not run, on the
port's engine against the JAX engine.

Each stream runs through both engines with ``pool_dtype`` float32 on the
same float32 parameters (the JAX engine on its plain path, the port's with
``device="cpu"``): the finished tokens and the pool counters must be equal,
and the JAX test's own assertions hold for the port.
``test_stop_token_chunked_equals_singlestep`` fails on the reference
engine, so its twin holds the port's one-token and eight-token dispatches
to each other and to the oracle instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.serving import PagedServingEngine

COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp",
            "dispatches", "free_blocks", "streams", "stream_writes",
            "stream_moves")


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


def _engines(models, **kw):
    """(JAX engine, port engine) on one configuration."""
    jm, jp, model = models
    return (JaxEngine(jm, params=jp, use_pallas=False,
                      pool_dtype=jnp.float32, **kw),
            PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                               **kw))


def _oracle(models, prompt, n, stop_token=None):
    _, _, model = models
    return tfm.greedy_decode(model.params, prompt, model.cfg, n,
                             stop_token=stop_token, cache_dtype=torch.float32)


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS}


def _run(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    eng.run_to_completion()
    eng.pool.check_invariants()
    assert not eng.has_work()
    return [eng.finished[r] for r in rids]


def _both(models, requests, **kw):
    """Tokens of the port's engine, after holding them and its counters to
    the JAX engine's; returns (tokens, port engine)."""
    jax_eng, eng = _engines(models, **kw)
    want = _run(jax_eng, requests)
    got = _run(eng, requests)
    assert got == want
    assert _counters(eng) == _counters(jax_eng)
    return got, eng


@pytest.mark.parametrize("policy", ["mdc", "greedy", "age", "cost_benefit"])
def test_engine_policies_all_correct(models, policy):
    """test_serving.py::test_engine_policies_all_correct, with the fourth
    policy too: every cleaning policy gives the oracle's tokens."""
    jm = models[0]
    prompt = (np.arange(2, 16) * 3) % jm.cfg.vocab_size
    got, _ = _both(models, [(prompt, 6)], n_slabs=10, blocks_per_slab=2,
                   page_T=8, max_batch=2, max_seq=48, policy=policy,
                   compact_trigger=2, compact_batch=2)
    assert got == [_oracle(models, prompt, 6)]


@pytest.mark.parametrize("prefill_chunk", [0, 16])
def test_non_pow2_page_size(models, prefill_chunk):
    """test_serving.py::test_non_pow2_page_size: prefill bucketing does not
    assume a power-of-two page_T (12); chunked, the budget rounds up to
    two pages (24) and the extent to whole pages past the bucket."""
    jm = models[0]
    prompt = (np.arange(2, 16) * 3) % jm.cfg.vocab_size
    got, eng = _both(models, [(prompt, 6)], n_slabs=10, blocks_per_slab=2,
                     page_T=12, max_batch=2, max_seq=96, policy="mdc",
                     compact_trigger=2, compact_batch=2,
                     prefill_chunk=prefill_chunk)
    assert got == [_oracle(models, prompt, 6)]
    assert eng.prefill_chunk == (24 if prefill_chunk else 0)


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_single_token_request_reported_by_step(models, prefill_chunk):
    """test_serving.py::test_single_token_request_reported_by_step: a
    request that its prefill token completes (max_new_tokens 1) is
    reported by the step that ran its (last chunk of) prefill."""
    results = []
    for eng in _engines(models, n_slabs=8, blocks_per_slab=2, page_T=8,
                        max_batch=2, max_seq=64, policy="mdc",
                        prefill_chunk=prefill_chunk):
        rid = eng.submit(np.arange(1, 6), 1)
        assert eng.step() == [rid]
        assert len(eng.finished[rid]) == 1
        assert not eng.has_work()
        eng.pool.check_invariants()
        results.append((eng.finished[rid], _counters(eng)))
    assert results[0] == results[1]
    assert results[1][0] == _oracle(models, np.arange(1, 6), 1)


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_stop_token_on_prefill_token_finishes_at_admission(models,
                                                           prefill_chunk):
    """test_serving.py::test_stop_token_on_prefill_token_finishes_at_
    admission: when the prefill's first token is the stop token, the
    request completes in the step that ran its prefill, and that step
    reports it."""
    prompt = np.arange(1, 6)
    first = _oracle(models, prompt, 1)[0]
    results = []
    for eng in _engines(models, n_slabs=8, blocks_per_slab=2, page_T=8,
                        max_batch=2, max_seq=64, policy="mdc",
                        stop_token=first, prefill_chunk=prefill_chunk):
        rid = eng.submit(prompt, 10)
        assert eng.step() == [rid]
        assert eng.finished[rid] == [first]
        assert not eng.has_work()
        eng.pool.check_invariants()
        results.append(_counters(eng))
    assert results[0] == results[1]


def test_admission_reserve_is_in_slab_units(models):
    """test_serving.py::test_admission_reserve_is_in_slab_units: the
    compaction reserve is compact_trigger slabs, so B waits until A's death
    frees blocks; a request of need + reserve == pool admits once the pool
    is idle (the reserve is waived), with neither OOM nor starvation."""
    results = []
    for eng in _engines(models, n_slabs=5, blocks_per_slab=4, page_T=8,
                        max_batch=2, max_seq=96, policy="mdc",
                        compact_trigger=2, compact_batch=2,
                        max_decode_chunk=2):
        assert eng.pool.admission_reserve() == 2 * 4
        ra = eng.submit(np.arange(1, 49), 16)   # needs 8 of the 20 blocks
        rb = eng.submit(np.arange(1, 9), 56)    # needs 8 more
        eng.step()
        assert eng.rid[0] == ra and rb not in eng.rid
        assert len(eng.queue) == 1
        while eng.queue:
            assert rb not in eng.rid
            eng.step()
        eng.run_to_completion()
        assert len(eng.finished[ra]) == 16 and len(eng.finished[rb]) == 56
        eng.pool.check_invariants()
        rc = eng.submit(np.arange(1, 9), 88)    # needs 12 = 20 - reserve
        eng.run_to_completion()
        assert len(eng.finished[rc]) == 88
        eng.pool.check_invariants()
        results.append(([eng.finished[r] for r in (ra, rb, rc)],
                        _counters(eng)))
    assert results[0] == results[1]


def test_engine_continuous_batching_many_requests(models):
    """test_serving.py::test_engine_continuous_batching_many_requests: a
    mixed-length stream finishes every request with its token count and
    releases every page."""
    rng = np.random.default_rng(0)
    lens, news = [5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5]
    reqs = [(rng.integers(1, 100, size=n), m) for n, m in zip(lens, news)]
    got, eng = _both(models, reqs, n_slabs=14, blocks_per_slab=2, page_T=8,
                     max_batch=3, max_seq=96, policy="mdc",
                     compact_trigger=2, compact_batch=3)
    assert [len(t) for t in got] == news
    m = eng.metrics()
    assert m["blocks_written"] > 0
    assert m["free_blocks"] == eng.pool.n_slabs * eng.pool.S


def test_engine_tokens_bit_identical_across_streams(models):
    """test_streams.py::test_engine_tokens_bit_identical_across_streams:
    four death streams with survivor demotion change page ids, never a
    decoded token; every write is counted in one stream."""
    jm = models[0]
    prompt = (np.arange(2, 25) * 3) % jm.cfg.vocab_size
    outs = []
    for streams in (1, 4):
        got, eng = _both(models, [(prompt, 10)], n_slabs=12,
                         blocks_per_slab=2, page_T=8, max_batch=2,
                         max_seq=64, policy="mdc", compact_trigger=2,
                         compact_batch=3, streams=streams)
        m = eng.metrics()
        assert m["streams"] == streams
        assert sum(m["stream_writes"]) == m["blocks_written"]
        outs.append(got)
    assert outs[0] == outs[1] == [_oracle(models, prompt, 10)]


def test_stop_token_multi_token_dispatch_equals_singlestep_and_oracle(models):
    """test_serving.py::test_stop_token_chunked_equals_singlestep's stream
    (a JAX test that fails on the reference engine): with stop token 509,
    dispatches of eight tokens truncate exactly where one-token dispatches
    do, and each request ends where the oracle's stop-aware decode ends."""
    jm, _, model = models
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(1, jm.cfg.vocab_size, size=n), m)
            for n, m in zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]
    results = []
    for chunk in (1, 8):
        eng = PagedServingEngine(model, n_slabs=14, blocks_per_slab=2,
                                 page_T=8, max_batch=3, max_seq=96,
                                 policy="mdc", compact_trigger=2,
                                 compact_batch=3, max_decode_chunk=chunk,
                                 stop_token=509, pool_dtype=torch.float32,
                                 device="cpu")
        results.append(_run(eng, reqs))
    want = [_oracle(models, p, n, stop_token=509) for p, n in reqs]
    assert results[0] == results[1] == want
