"""The port's preemption with resume, and its load shedding, against the JAX
package's engine.

The streams are those of ``tests/test_preemption.py`` (and the shedding
test of ``tests/test_crash_recovery.py``).  On each, the port's engine must
give the JAX engine's finished tokens and its ``preemptions`` /
``resumes`` counts.  The two reference tests that fail on the JAX engine
(``test_repeated_preemption_still_bit_identical`` and
``test_pressure_preemption_with_stop_tokens``) hold the port against the
dense ``greedy_decode`` oracle instead.

Both engines run with ``pool_dtype`` float32 on the same float32 parameters
(the JAX engine on its plain path, the port's with ``device="cpu"``), and
the oracle decodes with a float32 cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Model as JaxModel
from repro.models import transformer as jtfm
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.serving import AdmissionShed, PagedServingEngine


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _kw(n_slabs, max_batch=3, chunk=4, **kw):
    """test_preemption.py::_engine's geometry."""
    return dict(n_slabs=n_slabs, blocks_per_slab=2, page_T=8,
                max_batch=max_batch, max_seq=96, policy="mdc",
                compact_trigger=1, compact_batch=2, max_decode_chunk=chunk,
                preemption=True, **kw)


def _engines(models, **kw):
    jm, jp, model = models
    return (JaxEngine(jm, params=jp, use_pallas=False,
                      pool_dtype=jnp.float32, **kw),
            PagedServingEngine(model, pool_dtype=torch.float32,
                               device="cpu", **kw))


def _oracle(models, prompt, n, stop_token=None):
    """The port's dense greedy decode, and the JAX one: they must agree."""
    jm, jp, model = models
    got = tfm.greedy_decode(model.params, prompt, model.cfg, n,
                            stop_token=stop_token, cache_dtype=torch.float32)
    assert got == jtfm.greedy_decode(jp, prompt, jm.cfg, n,
                                     stop_token=stop_token,
                                     cache_dtype=jnp.float32)
    return got


def _mixed_reqs(vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 40))),
             int(rng.integers(4, 30))) for _ in range(n)]


def _drain(eng, check=False):
    for _ in range(10_000):
        eng.step()
        if check:
            eng.pool.check_invariants()
        if not eng.has_work():
            return
    raise AssertionError("engine did not drain")


def _counts(eng):
    return eng.preemptions, eng.resumes


def test_preempt_compact_resume_matches_jax(models):
    """test_preempt_compact_resume_bit_identical's stream: preempt mid-decode,
    force a compaction while the sequence is off the pool, resume; the
    invariants hold at every step and the tokens are the oracle's."""
    jm, _, _ = models
    prompt = np.arange(1, 21) % jm.cfg.vocab_size
    want = _oracle(models, prompt, 12)
    for eng in _engines(models, **_kw(14)):
        rid = eng.submit(prompt, 12)
        eng.step()
        i = int(np.flatnonzero(eng.rid == rid)[0])
        assert 1 <= eng._out_n[i] < 12, "must preempt mid-decode"
        eng._preempt(i)
        eng.pool.check_invariants()
        assert not eng.slot_active(i) and eng.has_work()
        eng.pool.compact()             # clean while the sequence is evicted
        eng.pool.check_invariants()
        _drain(eng, check=True)
        assert eng.finished[rid] == want
        assert _counts(eng) == (1, 1)
        assert eng.metrics()["free_blocks"] == eng.pool.n_slabs * eng.pool.S


def test_pressure_preemption_matches_jax_and_big_pool(models):
    """test_pressure_preemption_matches_big_pool's stream: a tiny pool
    preempts and serves the same tokens as the JAX engine's tiny pool and
    as a pool large enough never to stall, with the JAX engine's counts."""
    jm, _, _ = models
    reqs = _mixed_reqs(jm.cfg.vocab_size)
    runs = []
    for n_slabs in (8, 40):
        for eng in _engines(models, **_kw(n_slabs, chunk=32)):
            rids = [eng.submit(p, n) for p, n in reqs]
            _drain(eng)
            eng.pool.check_invariants()
            m = eng.metrics()
            runs.append(([eng.finished[r] for r in rids], _counts(eng),
                         m["recomputed_tokens"], m["free_blocks"]))
    (jsmall, small, jbig, big) = runs
    assert small == jsmall and big == jbig
    assert small[0] == big[0]
    assert [len(t) for t in small[0]] == [n for _, n in reqs]
    assert big[1] == (0, 0), "the big pool must not need preemption"
    assert small[1][0] >= 1 and small[1][0] == small[1][1]
    assert small[2] > 0 and small[3] == 8 * 2


def test_resume_splices_surviving_prefix_pages_matches_jax(models):
    """test_resume_splices_surviving_prefix_pages's stream: the tree's
    references keep the shared prefix alive through the preempting
    sequence's decref, and the resume's continuation prefill splices those
    pages back."""
    jm, _, _ = models
    sysp = np.random.default_rng(42).integers(1, jm.cfg.vocab_size, size=24)

    def run(eng, preempt_after):
        eng.submit(np.concatenate([sysp, [5, 9]]), 6)  # donor seeds the tree
        eng.run_to_completion()
        rid = eng.submit(np.concatenate([sysp, [7, 11, 13]]), 14)
        saved0 = eng._prefill_tokens_saved
        for _ in range(preempt_after):
            eng.step()
        if preempt_after:
            eng._preempt(int(np.flatnonzero(eng.rid == rid)[0]))
        eng.run_to_completion()
        eng.pool.check_invariants()
        eng.prefix_cache.check_invariants()
        return (eng.finished[rid], eng._prefill_tokens_saved - saved0,
                _counts(eng))

    kw = _kw(12, max_batch=2, chunk=2, prefix_cache=True)
    runs = [[run(eng, k) for eng in _engines(models, **kw)] for k in (0, 3)]
    (jcold, cold), (jpre, pre) = runs
    assert cold == jcold and pre == jpre
    assert pre[0] == cold[0]               # equal tokens through preemption
    assert pre[1] > cold[1], "the resume must splice the surviving prefix"
    assert pre[2] == (1, 1)


def test_repeated_preemption_matches_oracle(models):
    """test_repeated_preemption_still_bit_identical's stream (a JAX test that
    fails on the reference engine): a sequence preempted three times still
    finishes with the oracle's tokens."""
    jm, _, model = models
    prompt = (np.arange(3, 30) * 5) % jm.cfg.vocab_size
    want = _oracle(models, prompt, 14)
    eng = PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                             **_kw(14, chunk=2))
    rid = eng.submit(prompt, 14)
    preempted = 0
    for step in range(10_000):
        eng.step()
        slots = np.flatnonzero(eng.rid == rid)
        if step % 2 == 1 and slots.size and preempted < 3:
            eng._preempt(int(slots[0]))
            preempted += 1
            eng.pool.check_invariants()
        if not eng.has_work():
            break
    assert preempted >= 2 and eng.resumes == preempted
    assert eng.finished[rid] == want


@pytest.mark.parametrize("stop", ["reference", "emitted"])
def test_pressure_preemption_with_stop_tokens_matches_oracle(models, stop):
    """test_pressure_preemption_with_stop_tokens's stream (a JAX test that
    fails on the reference engine): stop tokens and preemption together,
    with the reference's stop token 70 (which the stream never emits at
    float32 parameters) and with one the stream's oracle outputs do emit,
    so that early exits happen.  Every request ends as the oracle's
    stop-aware decode does, in the tiny pool and in the big one.  The EWMA
    predicts a few tokens per request, admission over-commits the tiny
    pool, and a resume that preempted a peer to restart would thrash
    forever (the JAX engine does, ROADMAP §3): the port's resumes wait."""
    jm, _, model = models
    reqs = _mixed_reqs(jm.cfg.vocab_size, seed=1)

    def oracle(prompt, n, stop_token=None):
        # the port's oracle alone: the other tests hold it to the JAX one,
        # whose eager decode of these 16 streams would take minutes
        return tfm.greedy_decode(model.params, prompt, model.cfg, n,
                                 stop_token=stop_token,
                                 cache_dtype=torch.float32)

    full = [oracle(p, n) for p, n in reqs]
    stop = 70 if stop == "reference" else full[0][len(full[0]) // 2]
    want = [oracle(p, n, stop_token=stop) for p, n in reqs]
    early = any(w[-1] == stop and len(w) < n for w, (_, n) in zip(want, reqs))
    assert early == (stop != 70)
    for n_slabs in (8, 40):
        eng = PagedServingEngine(model, pool_dtype=torch.float32,
                                 device="cpu",
                                 **_kw(n_slabs, chunk=32, stop_token=stop))
        rids = [eng.submit(p, n) for p, n in reqs]
        _drain(eng)
        eng.pool.check_invariants()
        assert [eng.finished[r] for r in rids] == want
        if n_slabs == 8:
            assert eng.preemptions >= 1 and eng.resumes == eng.preemptions


def test_load_shedding_retry_after_matches_jax(models):
    """test_crash_recovery.py::test_load_shedding_retry_after's stream: once
    admission stalls and the queue is at the shed depth, submit() raises
    AdmissionShed with a positive retry-after hint; after the backlog
    drains the same request is accepted, and every token equals the JAX
    engine's."""
    jm, _, _ = models
    from repro.serving import AdmissionShed as JaxAdmissionShed
    results = []
    for eng in _engines(models, n_slabs=3, blocks_per_slab=2, page_T=8,
                        max_batch=2, max_seq=48, policy="mdc",
                        compact_trigger=1, compact_batch=2, stop_token=97,
                        shed_queue_depth=2):
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.submit(rng.integers(1, jm.cfg.vocab_size, 20), 6)
        for _ in range(3):
            eng.step()          # stalls admission: pages exhausted, queue deep
        assert eng._admit_stalled and len(eng.queue) >= 2
        prompt = rng.integers(1, jm.cfg.vocab_size, 20)
        with pytest.raises((AdmissionShed, JaxAdmissionShed)) as ei:
            eng.submit(prompt, 6)
        assert ei.value.retry_after_s > 0
        assert eng.shed_count == 1 and eng.metrics()["shed_count"] == 1
        _drain(eng)
        rid = eng.submit(prompt, 6)   # backlog gone: accepted now
        _drain(eng)
        results.append(eng.finished)
        assert rid in eng.finished
    assert results[0] == results[1]
