"""The port's asynchronous, budgeted compaction against the JAX package's.

The contracts of ``tests/test_async_compaction.py``, each on the same inputs
in both packages:

* pool — ``plan_compaction`` / ``commit_plan`` give the JAX pool's sub-plans
  (sources, destinations, owners, the victims each commit releases), page
  owners, reference counts, free counts and counters at every step of a
  plan/commit interleaving, and end where one monolithic synchronous cycle
  would; fenced slabs are invisible to allocation and victim selection;
  allocation pressure drains the pipeline; the invariants catch a fenced
  slab on the free list; ``clean_budget`` is the JAX dial.  The JAX file's
  hypothesis property is an explicit grid here, so that it runs without
  hypothesis;
* engine — on ``_run_engine``'s stream the async port engine gives the JAX
  async engine's tokens and pool counters and the port's own synchronous
  tokens, and a plan stays in flight across a step while the audit passes.

The port's own paths, which the JAX file does not run, are held to the
port's synchronous engine and to the plain greedy decode: async with
chunked prefill (the prefilling slot's chunk span is a hot page), with the
prefix cache (a hazard commit, and a moved page that dies and is handed out
again inside the window), and with preemption (the pipeline drains before
anyone is preempted).

Not here: the kill between a move and its commit (it needs the journal,
which comes with crash safety) and the mesh stream (tensor-parallel
serving).  Both engines run with ``pool_dtype`` float32 on the same float32
parameters (the JAX engine on its plain path, the port's with
``device="cpu"``, where the moves run inline).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.logstructure import FENCED as JAX_FENCED
from repro.models import Model as JaxModel
from repro.serving import LogStructuredKVPool as JaxPool
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving.kvcache import CompactionPlan as JaxPlan
from repro.serving.scheduler import DEFAULT_CLEAN_BUDGET as JAX_DEFAULT_BUDGET
from repro.serving.scheduler import clean_budget as jax_clean_budget
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.logstructure import FENCED, Placement
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.serving import (CompactionPlan, LogStructuredKVPool,
                                 PagedServingEngine)
from repro_torch.serving.scheduler import DEFAULT_CLEAN_BUDGET, clean_budget

COUNTERS = ("blocks_written", "blocks_moved", "compactions", "wamp",
            "dispatches", "compaction_debt_moves", "fenced_slabs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's operations are tiny: one intra-op thread runs them
    faster than many, and keeps test files that run side by side in
    parallel workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ pool two-phase

def _mk_pools(n_slabs=10):
    """test_async_compaction.py::_mk_pool on both sides: (JAX, port)."""
    kw = dict(policy="mdc", compact_trigger=0, compact_batch=4, streams=1)
    return JaxPool(n_slabs, 4, **kw), LogStructuredKVPool(n_slabs, 4, **kw)


def _alloc(pool, owner, death):
    if isinstance(pool, LogStructuredKVPool):
        return int(pool.alloc_blocks(np.array([owner]), Placement(
            est_death=np.array([death], np.float64)))[0])
    return pool.alloc_block(owner, est_death=death)


def _checkerboard(pool):
    """Interleave two lifetime classes and kill one: the victim driver."""
    short, long_ = [], []
    for i in range(12):
        short.append(_alloc(pool, 100 + i, 5.0))
        long_.append(_alloc(pool, 500 + i, 1e6))
    pool.free_pages(np.asarray(short))
    return long_


def _remap_held(held, plan):
    """What the engine does at commit: rewrite one external holder."""
    lut = {int(s): int(d) for s, d in zip(plan.src_pages, plan.dst_pages)}
    return [lut.get(p, p) for p in held]


def _plan(plan):
    return (plan.src_pages.tolist(), plan.dst_pages.tolist(),
            plan.owners.tolist(),
            None if plan.commit_segs is None else plan.commit_segs.tolist())


def _state(pool):
    st = pool.stats
    return dict(
        owner=pool.block_owner.tolist(), ref=pool.block_ref.tolist(),
        death=pool.block_death.tolist(), seg_state=pool.core.seg_state.tolist(),
        free=pool.core.free_count(), frames=pool.core.free_frames(),
        fenced=pool.core.fenced_count(), debt=pool.deferred_moves(),
        projected=pool.projected_free_slabs(), remap=pool._remap.tolist(),
        stats=(st.user_writes, st.gc_moves, st.deaths, st.cleanings,
               st.cleaned_segments, st.sum_E_cleaned, st.gc_planned,
               st.gc_committed))


def _run_split_committed(pool, budget, allocs_between, trace):
    """One checkerboarded pool cleaned through plan/commit at ``budget``,
    with ``allocs_between`` fresh allocations between commits; every plan
    and the state at every commit go to ``trace``.  Returns (held pages
    after all remaps, extra alloc pages)."""
    held = _checkerboard(pool)
    plans = pool.plan_compaction(budget)
    assert plans, "checkerboard must yield a plan"
    assert pool.deferred_moves() == sum(len(p) for p in plans)
    trace.append([_plan(p) for p in plans])
    extra = []
    while pool.pending_plans:          # commit in plan order
        plan = pool.pending_plans.pop(0)
        pool.check_invariants()        # mid-window: LUT + fencing coherent
        for _ in range(allocs_between):
            extra.append(_alloc(pool, 900 + len(extra), 50.0))
        trace.append(_state(pool))
        held = _remap_held(held, plan)
        pool.commit_plan(plan)
    assert pool.deferred_moves() == 0
    trace.append(_state(pool))
    return held, extra


def _split_against_jax_and_monolithic(budget, allocs_between):
    traces = []
    for pool in _mk_pools():
        traces.append([])
        held, extra = _run_split_committed(pool, budget, allocs_between,
                                           traces[-1])
    assert traces[0] == traces[1]
    # the port's sub-plans end where one monolithic synchronous cycle does
    mono = _mk_pools()[1]
    held_m = _remap_held(_checkerboard(mono), mono.compact())
    for i in range(len(extra)):
        _alloc(mono, 900 + i, 50.0)
    assert mono.stats.blocks_moved == pool.stats.blocks_moved
    assert mono.stats.wamp() == pool.stats.wamp()
    assert mono.core.free_frames() == pool.core.free_frames()
    assert mono.core.free_count() == pool.core.free_count()
    for p, h in ((mono, held_m), (pool, held)):
        arr = p.resolve(np.asarray(h, np.int64))
        assert (p.block_owner[arr] >= 500).all(), "live set corrupted"
        assert (p.block_ref[arr] == 1).all()
        p.check_invariants()


@pytest.mark.parametrize("budget,allocs_between", [(0, 0), (2, 0), (3, 2),
                                                   (1, 1)])
def test_plan_commit_matches_jax_and_monolithic(budget, allocs_between):
    """test_plan_commit_matches_monolithic's cases: the JAX pool's sub-plans
    and state at every commit, and one monolithic cycle's end state."""
    _split_against_jax_and_monolithic(budget, allocs_between)


@pytest.mark.parametrize("budget,allocs_between",
                         list(itertools.product(range(7), range(3))))
def test_plan_commit_interleaving_grid(budget, allocs_between):
    """test_plan_commit_interleaving_property's whole domain (budget 0-6,
    0-2 allocations between commits), as a grid."""
    _split_against_jax_and_monolithic(budget, allocs_between)


def test_fenced_invisible_to_alloc_and_victims():
    """Mid-window, fenced victim slabs are not allocatable and not
    re-victimizable; projected free space counts them; the JAX pool fences
    the same slabs and hands out the same fresh pages."""
    seen = []
    for pool, fenced_state in zip(_mk_pools(), (JAX_FENCED, FENCED)):
        _checkerboard(pool)
        plans = pool.plan_compaction(2)
        fenced = np.flatnonzero(pool.core.seg_state == fenced_state)
        assert len(fenced) > 0 and plans
        assert pool.core.fenced_count() == len(fenced)
        assert not np.isin(np.asarray(pool.core.free_list, np.int64),
                           fenced).any()
        assert not np.isin(pool.select_victims(), fenced).any()
        assert (pool.projected_free_slabs()
                == pool.core.free_count() + len(fenced))
        fresh = [_alloc(pool, 7, 10.0) for _ in range(4)]
        assert not np.isin(np.asarray(fresh, np.int64) // pool.S,
                           fenced).any()
        while pool.pending_plans:
            pool.commit_plan(pool.pending_plans.pop(0))
        assert pool.core.fenced_count() == 0
        seen.append((fenced.tolist(), fresh, [_plan(p) for p in plans],
                     _state(pool)))
    assert seen[0] == seen[1]


def test_alloc_pressure_drains_pipeline():
    """The capacity fallback: when allocation runs out of room mid-window,
    the pool's first lever is ``on_drain``; both pools drain and then hand
    out the same pages."""
    seen = []
    for pool in _mk_pools(8):
        held = [_checkerboard(pool)]
        drains = []

        def drain(pool=pool, held=held, drains=drains):
            drains.append(pool.deferred_moves())
            while pool.pending_plans:
                plan = pool.pending_plans.pop(0)
                held[0] = _remap_held(held[0], plan)
                pool.commit_plan(plan)

        pool.on_drain = drain
        pool.plan_compaction(2)
        assert pool.deferred_moves() > 0
        fresh = [_alloc(pool, 800 + i, 50.0) for i in range(12)]
        assert len(set(fresh)) == 12 and drains
        assert pool.deferred_moves() == 0 and pool.core.fenced_count() == 0
        arr = pool.resolve(np.asarray(held[0], np.int64))
        assert (pool.block_owner[arr] >= 500).all()
        pool.check_invariants()
        seen.append((fresh, drains, held[0], _state(pool)))
    assert seen[0] == seen[1]


def test_fenced_planning_keeps_the_victims_that_fit():
    """Fenced planning pays for survivors out of the current free room (the
    victims come back only at commit): in a pool with one free slab, only
    the best-ranked victims whose survivors fit are fenced, as in the JAX
    pool."""
    seen = []
    for pool, fenced_state in zip(_mk_pools(7), (JAX_FENCED, FENCED)):
        _checkerboard(pool)
        room = pool.core.free_frames()
        victims = pool.select_victims()
        plans = pool.plan_compaction(0)
        fenced = np.flatnonzero(pool.core.seg_state == fenced_state)
        assert 0 < len(fenced) < len(victims)
        assert sum(len(p) for p in plans) <= room
        pool.check_invariants()
        seen.append((fenced.tolist(), [_plan(p) for p in plans], _state(pool)))
    assert seen[0] == seen[1]


def test_pool_invariants_catch_fenced_on_free_list():
    """A fenced slab leaking onto the free list trips the core's check."""
    pool = _mk_pools()[1]
    _checkerboard(pool)
    pool.plan_compaction(0)
    fenced = np.flatnonzero(pool.core.seg_state == FENCED)
    assert len(fenced) > 0
    pool.check_invariants()
    pool.core.free_list.append(int(fenced[0]))
    with pytest.raises(AssertionError):
        pool.check_invariants()


def test_pool_invariants_catch_a_stale_lut():
    """A pending-LUT entry left behind by a commit trips the pool's check."""
    pool = _mk_pools()[1]
    _checkerboard(pool)
    for plan in pool.plan_compaction(0):
        pool.commit_plan(plan)
    pool.check_invariants()
    pool._remap[0] = 1
    with pytest.raises(AssertionError, match="pending LUT"):
        pool.check_invariants()


def test_clean_budget_matches_jax():
    """The scheduler dial on a grid, and its default."""
    assert DEFAULT_CLEAN_BUDGET == JAX_DEFAULT_BUDGET
    for base, free, trig, S, q in itertools.product(
            (0, 1, 8), range(6), range(4), (2, 4, 16), (0, 3, 12)):
        kw = dict(free_slabs=free, trigger=trig, blocks_per_slab=S,
                  queue_depth=q)
        assert clean_budget(base, **kw) == jax_clean_budget(base, **kw)
    kw = dict(trigger=2, blocks_per_slab=4)
    assert clean_budget(8, free_slabs=2, **kw) > 8
    assert clean_budget(8, free_slabs=0, **kw) > clean_budget(8, free_slabs=2,
                                                              **kw)


@pytest.mark.parametrize("budget", [0, 1, 3, 8])
def test_plan_split_matches_jax(budget):
    """``CompactionPlan.split``: each victim's release rides with its last
    move's sub-plan, as in the JAX plan."""
    rng = np.random.default_rng(budget)
    segs = np.repeat(rng.permutation(9)[:5], rng.integers(1, 5, 5))
    n = len(segs)
    src, dst = rng.permutation(100)[:n], rng.permutation(100)[:n] + 100
    owners = rng.integers(0, 10, n)
    ours = CompactionPlan(src, dst, owners).split(budget, segs)
    theirs = JaxPlan(src, dst, owners).split(budget, segs)
    assert [_plan(p) for p in ours] == [_plan(p) for p in theirs]
    assert sorted(s for p in ours for s in p.commit_segs) == sorted(set(segs))


# ------------------------------------------------------------ engine e2e

@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


def _reqs(vocab, seed=1):
    """test_async_compaction.py::_reqs."""
    rng = np.random.default_rng(seed)
    lens = [5, 17, 9, 24, 3, 12, 20, 7, 15, 11]
    news = [16, 20, 14, 18, 22, 15, 19, 21, 13, 17]
    return [(rng.integers(1, vocab, size=n), m) for n, m in zip(lens, news)]


# test_async_compaction.py::_run_engine's geometry: a tiny pool and an eager
# trigger, so that cleaning fires again and again mid-run
ENGINE_KW = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
                 max_seq=96, policy="mdc", compact_trigger=2,
                 compact_batch=2, audit_every=3)
ASYNC = dict(async_compaction=True, clean_budget=4)


def _port(models, **kw):
    return PagedServingEngine(models[2], pool_dtype=torch.float32,
                              device="cpu", **kw)


def _drain(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    for _ in range(10_000):
        eng.step()
        if not eng.has_work():
            break
    else:
        raise AssertionError("engine did not drain")
    eng.audit()
    m = eng.metrics()
    counters = {k: m[k] for k in COUNTERS}
    counters.update(gc_planned=eng.pool.stats.gc_planned,
                    gc_committed=eng.pool.stats.gc_committed)
    return [eng.finished[r] for r in rids], counters


def _oracle(models, requests):
    model = models[2]
    return [tfm.greedy_decode(model.params, p, model.cfg, n,
                              cache_dtype=torch.float32)
            for p, n in requests]


@pytest.fixture(scope="module")
def engine_runs(models):
    """_run_engine's stream through the JAX and the port engine, sync and
    async: {(package, mode): (tokens, counters)}."""
    jm, jp, _ = models
    reqs = _reqs(jm.cfg.vocab_size)
    runs = {}
    for mode, kw in (("sync", {}), ("async", ASYNC)):
        runs["jax", mode] = _drain(
            JaxEngine(jm, params=jp, use_pallas=False, pool_dtype=jnp.float32,
                      **ENGINE_KW, **kw), reqs)
        runs["port", mode] = _drain(_port(models, **ENGINE_KW, **kw), reqs)
    return runs


def test_engine_async_matches_jax_async(engine_runs):
    """The port's async engine gives the JAX async engine's tokens and pool
    counters, planned and committed moves included."""
    assert engine_runs["port", "async"] == engine_runs["jax", "async"]


def test_engine_async_bit_identical_to_sync(engine_runs):
    """Tokens do not change when cleaning goes asynchronous, and every
    planned move commits."""
    tokens, c = engine_runs["port", "async"]
    assert tokens == engine_runs["port", "sync"][0]
    assert engine_runs["port", "sync"] == engine_runs["jax", "sync"]
    assert c["gc_planned"] == c["gc_committed"] > 0
    assert c["compaction_debt_moves"] == 0 and c["fenced_slabs"] == 0


def test_engine_phase_stream_matches_jax(models):
    """``chip_smoke.py``'s engine-phase stream (32 requests of 256-1,024
    prompt tokens, 30 slabs of 16 pages of 16 tokens, 8 slots) at the smoke
    widths, async at the default clean budget: the JAX async engine's tokens
    and counters.  Its Wamp is not the synchronous run's here (5 cleanings
    and 140 moves; ``scripts/rehearse_schedule.py engine 30`` gives 4 and
    104): fenced planning keeps only victims whose survivors fit the free
    room, and the projected trigger plans at other states — in both
    packages alike."""
    jm, jp, _ = models
    rng = np.random.default_rng(0)
    plens, news = rng.integers(256, 1025, 32), rng.integers(32, 129, 32)
    reqs = [(rng.integers(1, 151936, p) % jm.cfg.vocab_size, int(n))
            for p, n in zip(plens, news)]
    kw = dict(n_slabs=30, blocks_per_slab=16, page_T=16, max_batch=8,
              max_seq=2048, streams=1, compact_trigger=2, compact_batch=4,
              max_decode_chunk=32, async_compaction=True)
    got = _drain(_port(models, **kw), reqs)
    want = _drain(JaxEngine(jm, params=jp, use_pallas=False,
                            pool_dtype=jnp.float32, **kw), reqs)
    assert got == want
    c = got[1]
    assert (c["compactions"], c["blocks_moved"], c["gc_planned"]) == (5, 140, 140)


def test_engine_metrics_and_audit_track_debt(models):
    """A plan stays in flight across a step boundary at some point, and the
    audit passes inside those windows (audit_every=1)."""
    eng = _port(models, **{**ENGINE_KW, "audit_every": 1}, **ASYNC)
    for p, n in _reqs(models[0].cfg.vocab_size):
        eng.submit(p, n)
    saw_window = False
    while eng.has_work():
        eng.step()
        saw_window = saw_window or bool(eng._inflight_plans)
    assert saw_window, "no plan ever stayed in flight across a step"
    m = eng.metrics()
    assert m["compaction_debt_moves"] == 0 and m["fenced_slabs"] == 0
    assert m["gc_planned"] == m["gc_committed"] > 0
    assert m["inflight_boundaries"] > 0


def test_a_block_that_dies_before_its_move_is_not_moved(models):
    """A block whose last reference drops after planning is not moved when
    its sub-plan is issued: its destination may have been handed out again
    and written (here: a sentinel), and the move must not overwrite it.
    The other moves copy their sources."""
    eng = _port(models, n_slabs=10, blocks_per_slab=4, page_T=8,
                max_batch=3, max_seq=96, policy="mdc", streams=1,
                compact_trigger=0, compact_batch=4, **ASYNC)
    pool = eng.pool
    _checkerboard(pool)
    for i in range(pool.n_slabs * pool.S):    # every page tells its id
        eng.k_pools[:, i] = i
    plans = pool.plan_compaction(2)
    assert len(plans) >= 2
    victim = plans[-1]
    src, dst = int(victim.src_pages[0]), int(victim.dst_pages[0])
    pool.free_pages(np.array([src]))          # a stale id: dies at dst
    assert pool.block_ref[dst] == 0
    eng.k_pools[:, dst] = -1.0                # the page's next owner writes
    assert len(eng._live_moves(victim)) == len(victim) - 1
    while pool.pending_plans:
        plan = pool.pending_plans.pop(0)
        eng._issue(plan)
        eng._commit_plan(plan)
    assert (eng.k_pools[:, dst] == -1.0).all()
    for plan in plans:
        for s_, d_ in zip(plan.src_pages, plan.dst_pages):
            if d_ != dst:
                assert (eng.k_pools[:, d_] == s_).all()
    pool.check_invariants()


def test_audit_catches_a_leaked_reference(models):
    """The audit's refcount cross-check has teeth: one extra reference on a
    held page trips it."""
    eng = _port(models, **ENGINE_KW, **ASYNC)
    for p, n in _reqs(models[0].cfg.vocab_size)[:3]:
        eng.submit(p, n)
    eng.step()
    eng.audit()
    page = int(eng.pool.resolve(eng.slot_pages(0)[:1].astype(np.int64))[0])
    eng.pool.block_ref[page] += 1
    with pytest.raises(AssertionError, match="refcount mismatch"):
        eng.audit()


# -------------------------------------------- the port's own async paths

def _mixed_reqs(vocab, n, seed, lo, hi, new_hi):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(lo, hi))),
             int(rng.integers(4, new_hi))) for _ in range(n)]


def _against_sync_and_oracle(models, requests, **kw):
    """The async port engine on ``requests``: its tokens against the sync
    port engine's and the plain decode's.  Returns the async engine."""
    eng = _port(models, **kw, **ASYNC)
    got, c = _drain(eng, requests)
    want, _ = _drain(_port(models, **kw), requests)
    assert got == want == _oracle(models, requests)
    assert c["gc_planned"] == c["gc_committed"] + c["compaction_debt_moves"]
    # moves still in flight when the engine runs out of work commit at the
    # next steps, as in the JAX engine
    for _ in range(3):
        eng.step()
    eng.audit()
    m = eng.metrics()
    assert m["gc_planned"] == m["gc_committed"] > 0
    assert m["compaction_debt_moves"] == 0 and m["fenced_slabs"] == 0
    return eng


def test_async_with_chunked_prefill(models):
    """test_chunked_prefill.py's concurrent mixed stream, chunked at 16
    tokens through 7 slabs of 4 pages: moves stay in flight across fused
    dispatches, and while a prefill is in flight its slot's pages from the
    chunk position on are hot (the chunk writes them)."""
    reqs = _mixed_reqs(models[0].cfg.vocab_size, 10, 3, 4, 60, 25)
    kw = dict(n_slabs=7, blocks_per_slab=4, page_T=8, max_batch=3,
              max_seq=96, policy="mdc", compact_trigger=1, compact_batch=2,
              prefill_chunk=16, audit_every=1)
    eng = _port(models, **kw, **ASYNC)
    hot_checks = 0
    hot_pages = eng._hot_pages

    def checked():
        hot = hot_pages()
        if eng._pf is not None:
            i, T = eng._pf["slot"], eng.page_T
            span = eng.bt[i, eng._pf["pos"] // T:eng.npages[i]]
            assert np.isin(span, hot).all()
            nonlocal hot_checks
            hot_checks += 1
        return hot

    eng._hot_pages = checked
    for p, n in reqs:
        eng.submit(p, n)
    eng.run_to_completion()
    assert eng.metrics()["inflight_boundaries"] > 0
    assert hot_checks > 0
    _against_sync_and_oracle(models, reqs, **kw)


PREFIX_KW = dict(blocks_per_slab=2, page_T=8, max_batch=3, max_seq=96,
                 policy="mdc", streams=1, compact_trigger=2, compact_batch=3,
                 prefix_cache=True, audit_every=1)


def _shared_stream(vocab, n_req, n_sys, seed, sys_len):
    """Users over ``n_sys`` system prompts, each with its own tail."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=sys_len) for _ in range(n_sys)]
    return [(np.concatenate([prompts[int(rng.integers(n_sys))],
                             rng.integers(1, vocab, size=int(rng.integers(3, 14)))]),
             int(rng.integers(2, 12))) for _ in range(n_req)]


def test_async_with_prefix_cache_hazard_commit(models):
    """test_prefix_cache.py's shared stream (10 users, one 24-token system
    prompt) through 8 slabs: admission counts fenced slabs and resolves the
    matched ids, and a sub-plan whose source the next dispatch writes
    commits at once."""
    vocab = models[0].cfg.vocab_size
    rng = np.random.default_rng(1)
    sys_prompt = np.random.default_rng(42).integers(1, vocab, size=24)
    reqs = [(np.concatenate([sys_prompt, rng.integers(
        1, vocab, size=int(rng.integers(3, 14)))]), int(rng.integers(4, 12)))
        for _ in range(10)]
    eng = _against_sync_and_oracle(models, reqs, n_slabs=8, **PREFIX_KW)
    m = eng.metrics()
    assert m["hazard_commits"] >= 1 and m["prefix_hit_rate"] >= 0.9


def test_async_with_prefix_eviction_reuses_a_moved_page(models):
    """Three system prompts through a 6-page prefix cache and 8 slabs: the
    cache evicts a page whose move is in flight, and the same admission
    hands the page out again before the move commits (on the card the main
    stream then waits for the move).  Tokens and counters are also the JAX
    async engine's."""
    jm, jp, _ = models
    reqs = _shared_stream(jm.cfg.vocab_size, 12, 3, 1, 16)
    kw = dict(n_slabs=8, prefix_cache_pages=6, **PREFIX_KW)
    eng = _port(models, **kw, **ASYNC)
    dead, reused = set(), []
    on_dead, alloc = eng.pool.on_dead_destination, eng.pool.alloc_blocks

    def note_dead(pages):
        for plan in eng._inflight_plans:
            dead.update(int(p) for p in plan.dst_pages if p in pages)
        on_dead(pages)

    def note_alloc(ids, placement):
        pages = alloc(ids, placement)
        if eng._inflight_plans:
            reused.extend(dead.intersection(pages.tolist()))
        else:
            dead.clear()
        return pages

    eng.pool.on_dead_destination = note_dead
    eng.pool.alloc_blocks = note_alloc
    got = _drain(eng, reqs)
    assert reused, "no moved page was handed out again inside a window"
    assert eng.dead_destination_waits >= 1
    jax_kw = {k: v for k, v in kw.items() if k != "audit_every"}
    want = _drain(JaxEngine(jm, params=jp, use_pallas=False,
                            pool_dtype=jnp.float32, **jax_kw, **ASYNC), reqs)
    assert got == want
    _against_sync_and_oracle(models, reqs, **kw)


def test_async_with_preemption_drains_first(models):
    """A mixed stream (test_preemption.py's shape, 10 requests) through 5
    slabs of 4 pages with preemption on: admission needs a preemption while
    moves are still planned, and the pipeline drains (every move committed)
    before anyone is preempted; the tokens are the sync engine's and the
    oracle's."""
    reqs = _mixed_reqs(models[0].cfg.vocab_size, 10, 2, 4, 40, 30)
    kw = dict(n_slabs=5, blocks_per_slab=4, page_T=8, max_batch=3,
              max_seq=96, policy="mdc", compact_trigger=1, compact_batch=2,
              max_decode_chunk=32, preemption=True, audit_every=1)
    eng = _port(models, **kw, **ASYNC)
    preempt, preempt_for = eng._preempt, eng._preempt_for
    debts, indebted = [], []

    def checked(i):
        debts.append(eng.pool.deferred_moves() + len(eng.pool.pending_plans))
        preempt(i)

    def entered(deficit, **k):
        debt, n = eng.pool.deferred_moves(), eng.preemptions
        freed = preempt_for(deficit, **k)
        indebted.append(debt > 0 and eng.preemptions > n)
        return freed

    eng._preempt, eng._preempt_for = checked, entered
    for p, n in reqs:
        eng.submit(p, n)
    eng.run_to_completion()
    assert any(indebted), "no preemption was asked for with moves planned"
    assert debts and not any(debts), "preempted with moves uncommitted"
    _against_sync_and_oracle(models, reqs, **kw)
