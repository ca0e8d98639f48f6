"""The port's paged serving engine against the JAX engine.

Both engines run with ``pool_dtype`` float32 on the same float32 parameters
(the JAX engine on its plain path, ``use_pallas=False``; the port's with
``device="cpu"``, which runs every kernel's plain version) over the request
streams of ``tests/test_serving.py``.  The finished tokens must be equal, and
so must the pool traffic (blocks written, blocks moved, compactions, Wamp):
the host-side placement and cleaning are the same algorithm in both
packages, so equal tokens imply equal events.
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
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.serving import PagedServingEngine

COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp")


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
    jm, jp, model = models
    jax_eng = JaxEngine(jm, params=jp, use_pallas=False,
                        pool_dtype=jnp.float32, **kw)
    eng = PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                             **kw)
    return jax_eng, eng


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in COUNTERS}


def _run(eng, requests, force_every=0):
    """Submit, run to completion (forcing ``pool.compact()`` after every
    ``force_every``-th step when set), return the finished token lists."""
    rids = [eng.submit(p, n) for p, n in requests]
    for step in range(10_000):
        eng.step()
        if force_every and step % force_every == force_every - 1:
            eng.pool.compact()
        eng.pool.check_invariants()
        if not eng.has_work():
            break
    return [eng.finished[r] for r in rids]


def test_paged_engine_matches_jax_engine_and_dense_decode(models):
    """test_serving.py::test_paged_engine_matches_dense_decode's stream."""
    jm, jp, _ = models
    prompt = np.arange(1, 21) % jm.cfg.vocab_size
    kw = dict(n_slabs=12, blocks_per_slab=2, page_T=8, max_batch=2,
              max_seq=64, policy="mdc", compact_trigger=2, compact_batch=3)
    jax_eng, eng = _engines(models, **kw)
    want = _run(jax_eng, [(prompt, 12)])
    got = _run(eng, [(prompt, 12)])
    assert got == want
    assert got[0] == jtfm.greedy_decode(jp, prompt, jm.cfg, 12,
                                        cache_dtype=jnp.float32)
    assert _counters(eng) == _counters(jax_eng)
    assert eng.metrics()["free_blocks"] == eng.pool.n_slabs * eng.pool.S


def test_forced_compaction_plan_execution_matches_jax(models):
    """test_serving.py::test_engine_compaction_plan_execution_consistent's
    stream: one open stream and a ``pool.compact()`` forced every third
    step, so the move + remap path runs many times."""
    jm, _, _ = models
    prompt = (np.arange(3, 30) * 5) % jm.cfg.vocab_size
    rng = np.random.default_rng(1)
    requests = [(prompt, 10)] + [(rng.integers(1, 100, size=n), m)
                                 for n, m in [(5, 8), (11, 6), (3, 12)]]
    kw = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3, max_seq=96,
              policy="mdc", streams=1, compact_trigger=2, compact_batch=3)
    jax_eng, eng = _engines(models, **kw)
    want = _run(jax_eng, requests, force_every=3)
    got = _run(eng, requests, force_every=3)
    assert got == want
    assert [len(t) for t in got] == [10, 8, 6, 12]
    assert _counters(eng) == _counters(jax_eng)
    assert eng.metrics()["compactions"] >= 2


def _slot_kv(eng):
    """Each live slot's K/V read through its block-table row."""
    return {int(eng.rid[i]): (eng.k_pools[:, eng.slot_pages(i)].clone(),
                              eng.v_pools[:, eng.slot_pages(i)].clone())
            for i in range(eng.max_batch) if eng.slot_active(i)}


def test_compaction_keeps_block_tables_consistent(models):
    """After every step of a forced-compaction run: each live slot reads the
    same K/V through its remapped block table as before the move, held pages
    are owned by their slot's request, the rest of the row parks on the
    trash page, and the device block table mirrors the host's.  The stream's
    plans place survivors into pages the same plan frees (a destination that
    is another move's source), so the move's read-before-write is held."""
    jm, _, model = models
    eng = PagedServingEngine(model, n_slabs=7, blocks_per_slab=2, page_T=8,
                             max_batch=3, max_seq=96, streams=1,
                             compact_trigger=2, compact_batch=3,
                             max_decode_chunk=8, pool_dtype=torch.float32,
                             device="cpu")
    rng = np.random.default_rng(1)
    for n, m in [(27, 10), (5, 8), (11, 6), (3, 12)]:
        eng.submit(rng.integers(1, 100, size=n), m)
    moved = overlapping = 0
    staged0 = ops.move_plans["staged"]
    for _ in range(10_000):
        eng.step()
        before = _slot_kv(eng)
        plan = eng.pool.compact()
        if plan is not None and len(plan):
            moved += 1
            overlapping += bool(np.isin(plan.dst_pages, plan.src_pages).any())
            gone = np.setdiff1d(plan.src_pages, plan.dst_pages)
            assert not np.isin(gone, eng.bt[eng.bt != eng.trash_page]).any()
        after = _slot_kv(eng)
        assert before.keys() == after.keys()
        for rid, (k, v) in before.items():
            assert torch.equal(k, after[rid][0]) and torch.equal(v, after[rid][1])
        for i in range(eng.max_batch):
            if eng.slot_active(i):
                pages = eng.slot_pages(i)
                assert (eng.bt[i, len(pages):] == eng.trash_page).all()
                assert (eng.pool.block_owner[pages] == eng.rid[i]).all()
        eng._sync_device()
        assert (eng._bt_dev.numpy() == eng.bt).all()
        if not eng.has_work():
            break
    assert moved >= 1
    assert overlapping >= 1
    assert ops.move_plans["staged"] - staged0 == overlapping


@pytest.mark.parametrize("chunk", [1, 8])
def test_multistep_stream_matches_jax(models, chunk):
    """test_serving.py::test_multistep_decode_equals_singlestep's stream at
    one and at eight tokens per dispatch."""
    rng = np.random.default_rng(3)
    requests = [(rng.integers(1, 512, size=n), m)
                for n, m in zip([5, 17, 9, 24, 3, 12], [6, 10, 4, 8, 12, 5])]
    kw = dict(n_slabs=14, blocks_per_slab=2, page_T=8, max_batch=3,
              max_seq=96, policy="mdc", compact_trigger=2, compact_batch=3,
              max_decode_chunk=chunk)
    jax_eng, eng = _engines(models, **kw)
    want = _run(jax_eng, requests)
    got = _run(eng, requests)
    assert got == want
    assert [len(t) for t in got] == [6, 10, 4, 8, 12, 5]
    assert _counters(eng) == _counters(jax_eng)
    assert eng.metrics()["dispatches"] == jax_eng.metrics()["dispatches"]


def test_stop_token_early_exit_matches_dense_and_jax(models):
    """test_serving.py::test_stop_token_early_exit_matches_dense's stream:
    the request truncates at (and including) the first stop token, exactly
    like ``tfm.greedy_decode(stop_token=...)``, and frees its pages."""
    jm, jp, _ = models
    prompt = np.arange(1, 21) % jm.cfg.vocab_size
    full = jtfm.greedy_decode(jp, prompt, jm.cfg, 12, cache_dtype=jnp.float32)
    stop = full[5]
    want = jtfm.greedy_decode(jp, prompt, jm.cfg, 12, stop_token=stop,
                              cache_dtype=jnp.float32)
    assert want == full[:full.index(stop) + 1] and len(want) < len(full)
    kw = dict(n_slabs=12, blocks_per_slab=2, page_T=8, max_batch=2,
              max_seq=64, policy="mdc", compact_trigger=2, compact_batch=3,
              stop_token=stop)
    jax_eng, eng = _engines(models, **kw)
    assert _run(eng, [(prompt, 12)]) == [want]
    assert _run(jax_eng, [(prompt, 12)]) == [want]
    assert _counters(eng) == _counters(jax_eng)
    assert eng.metrics()["free_blocks"] == eng.pool.n_slabs * eng.pool.S


def test_engine_entry_points_refuse_a_missing_card(models, monkeypatch):
    """``device=None`` means the CUDA card: without one the entry points
    raise instead of quietly running on the CPU."""
    _, _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedServingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config("qwen3-1.7b").smoke())


def test_engine_refuses_params_on_another_device(models):
    _, _, model = models
    with pytest.raises(ValueError, match="params live on"):
        PagedServingEngine(model, device="meta")


def test_request_longer_than_max_seq_is_refused(models):
    _, _, model = models
    eng = PagedServingEngine(model, n_slabs=4, blocks_per_slab=2, page_T=8,
                             max_batch=1, max_seq=32, device="cpu")
    eng.submit(np.arange(1, 30), 8)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.step()
