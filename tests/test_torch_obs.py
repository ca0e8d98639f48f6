"""The port's observability against the JAX package's, on the same inputs.

The contracts of ``tests/test_obs.py``, each held to the original:

* ``Tracer`` — the same calls on two deterministic clocks export the same
  Chrome-trace document (spans, counters, async spans, the ring's drops);
  its argument coercion also takes 0-d and small tensors;
* ``MetricsLogger`` — the same samples write the same JSON lines;
* ``DeathCalibration`` — the same batches give the same ``report()`` and
  ``format_report()``, misroutes and unrouted frames included;
* the core's hooks — the port's ``FrameLog`` and the JAX one, put through
  the same place / kill / evacuate sequence with a tracer and a calibration
  attached, emit the same segment events and give the same report, and the
  snapshot store's ``tracer=`` gives the JAX store's ``ByteLog`` events;
* the engine — test_obs's stream at f32 on both engines (preemption,
  ``metrics_every=2``, ``phase_log``, calibration): equal tokens,
  ``metrics()``, calibration report, metric rows (apart from their clock),
  ``phase_report`` keys and dispatch counts, and request- and segment-lane
  events.  Timestamps may differ: the two engines read the clock a
  different number of times.  A chunked, an async-compaction and a
  journaled stream show the ``req.prefill_chunk`` events, the pump's
  ``compaction`` phase and the ``journal`` phase; an engine without
  observability gives the instrumented tokens and counters and carries no
  tracer; a recovered engine's tracer receives its journal core's events.

Both engines run with ``pool_dtype`` float32 on the same float32
parameters (the JAX engine on its plain path, the port's on the CPU).
"""

import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.logstructure import FrameLog as JaxFrameLog
from repro.core.logstructure import Placement as JaxPlacement
from repro.models import Model as JaxModel
from repro.obs import DeathCalibration as JaxCalibration
from repro.obs import MetricsLogger as JaxMetricsLogger
from repro.obs import Tracer as JaxTracer
from repro.serving import PagedServingEngine as JaxEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.logstructure import FrameLog, Placement
from repro_torch.models import Model
from repro_torch.obs import DeathCalibration, MetricsLogger, Tracer
from repro_torch.serving import PagedServingEngine, recover_engine
from repro_torch.serving import engine as engine_mod
from repro.checkpoint.logstore import \
    LogStructuredCheckpointStore as JaxStore
from repro_torch.checkpoint.logstore import LogStructuredCheckpointStore
from test_obs import Tick, _check_chrome_trace
from test_torch_journal import _store_run


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke model's operations are tiny: one intra-op thread runs them
    faster than many, and keeps test files that run side by side in
    parallel workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ tracer

def _drive_tracer(tr, arr, half):
    """test_obs.py's span / counter / async-span sequence, with array
    arguments (numpy on the JAX side, tensors on the port's)."""
    with tr.span("step", cat="engine", dispatch=0):
        with tr.span("admit"):
            tr.instant("queued", reqs=3, arr=arr, e=half)
        with tr.span("dispatch"):
            pass
    tr.counter("pool", free_blocks=7, queue_depth=2)
    tr.async_begin("req", 0, tid=1, cat="request", prompt_len=11)
    tr.async_instant("req.admit", 0, tid=1, cat="request")
    tr.async_end("req", 0, tid=1, cat="request", tokens=4)
    tr.instant("seg.open", tid=2, cat="segment", seg=5)


def test_tracer_exports_the_jax_document(tmp_path):
    want = JaxTracer(capacity=64, clock=Tick())
    got = Tracer(capacity=64, clock=Tick())
    _drive_tracer(want, np.arange(3), np.float64(0.5))
    _drive_tracer(got, torch.arange(3), torch.tensor(0.5, dtype=torch.float64))
    doc = got.export(tmp_path / "t.json")
    assert doc == want.export()
    _check_chrome_trace(doc)
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    args = next(e for e in doc["traceEvents"] if e["name"] == "queued")["args"]
    assert args == {"reqs": 3, "arr": [0, 1, 2], "e": 0.5}


@pytest.mark.parametrize("cap,n", [(1, 5), (4, 10), (16, 16), (50, 200)])
def test_tracer_ring_drops_as_the_jax_ring(cap, n):
    want, got = JaxTracer(capacity=cap, clock=Tick()), Tracer(capacity=cap,
                                                            clock=Tick())
    for tr in (want, got):
        for i in range(n):
            tr.instant(f"e{i}", i=i)
    assert (len(got), got.dropped) == (len(want), want.dropped)
    assert got.export() == want.export()


# ----------------------------------------------------------- metrics logger

def test_metrics_logger_writes_the_jax_rows(tmp_path):
    rows = [{"a": 10, "xs": [1, 2], "name": "mdc", "flag": True, "w": 0.25},
            {"a": 25, "xs": [2, 5, 1], "name": "mdc", "flag": False,
             "w": 0.5},
            {"a": 26, "xs": [2], "name": "greedy", "flag": True, "w": 0.0}]
    want, got = io.StringIO(), io.StringIO()
    jl, pl = JaxMetricsLogger(want, clock=Tick()), MetricsLogger(got,
                                                               clock=Tick())
    for r in rows:
        assert pl.sample(r) == jl.sample(r)
    assert got.getvalue() == want.getvalue()
    assert pl.samples == jl.samples == 3
    path = tmp_path / "m.jsonl"
    owned = MetricsLogger(path, clock=Tick())
    owned.sample(rows[0])
    owned.close()
    assert path.read_text() == want.getvalue().splitlines(True)[0]


# -------------------------------------------------------------- calibration

def _calibration_batches(seed):
    """Random death batches over 3 streams: some unrouted (NaN estimates or
    an unknown stream), lifetimes over several log2 bins, cuts that move."""
    rng = np.random.default_rng(seed)
    out, now = [], 10.0
    for _ in range(6):
        n = int(rng.integers(1, 12))
        est = rng.uniform(0, 200, n)
        est[rng.random(n) < 0.15] = np.nan
        streams = rng.integers(-1, 3, n)
        wtime = now - rng.uniform(0, 300, n)
        bounds = np.sort(rng.uniform(now, now + 400, 2))
        out.append((streams, est, now, wtime, bounds))
        now += float(rng.uniform(1, 50))
    return out


CALIBRATION_CASES = {
    # test_obs.py::test_calibration_counts_and_histogram
    "counts": (dict(n_streams=2, hist_bins=6),
               [([0, 0, 0, 0, 0], [10.0, 10, 10, 10, 10], 10.0,
                 [10.0, 9, 8, 7, 6], [100.0])]),
    # test_obs.py::test_calibration_misroute_and_unrouted
    "misroute": (dict(n_streams=2),
                 [([0, 1, 0], [12.0, 12.0, np.nan], 10.0, [8.0, 8.0, 8.0],
                   [20.0])]),
    "no_wtime": (dict(n_streams=2), [([0, 1], [3.0, 4.0], 5.0, None, None)]),
    "random0": (dict(n_streams=3), _calibration_batches(0)),
    "random1": (dict(n_streams=3, hist_bins=8), _calibration_batches(1)),
}


@pytest.mark.parametrize("case", sorted(CALIBRATION_CASES))
def test_calibration_gives_the_jax_report(case):
    kw, batches = CALIBRATION_CASES[case]
    want, got = JaxCalibration(**kw), DeathCalibration(**kw)
    for streams, est, actual, wtime, bounds in batches:
        for cal in (want, got):
            cal.record(streams, est, actual, wtime=wtime, bounds=bounds)
    assert got.report() == want.report()
    assert got.format_report() == want.format_report()
    assert got.misroute_rate() == want.misroute_rate()
    json.dumps(got.report())


# --------------------------------------------- the core's hooks (FrameLog)

def _framelog_events(cls, placement, tracer_cls, cal_cls):
    """One place / tick / kill / evacuate / re-place sequence over two
    streams with a tracer and a calibration attached; returns the exported
    events and the calibration report."""
    log = cls(6, 4, n_streams=2)
    tr = tracer_cls(capacity=1024, clock=Tick())
    cal = cal_cls(n_streams=2)
    log.tracer = tr
    log.enable_calibration(cal)
    rng = np.random.default_rng(5)
    frames = log.place(np.arange(14), placement(
        est_death=rng.uniform(5, 60, 14).round(1)))
    log.tick(3)
    dead = frames[[0, 2, 3, 5, 8, 9, 12]]
    log.kill_slots(dead // 4, dead % 4, tick=True)
    victims = log.select_victims("mdc", 2)
    res = log.evacuate(victims)
    # survivors carry no estimate: their deaths are unrouted
    moved = log.place(res.items, placement(up2=res.up2_slot, kind="gc"))
    log.tick(2)
    rest = np.setdiff1d(frames, dead)
    alive = np.concatenate([rest[np.isin(rest // 4, victims, invert=True)][:3],
                            moved[:2]])
    log.kill_slots(alive // 4, alive % 4, tick=True)
    log.check_invariants()
    return tr.events(), cal.report()


def test_framelog_hooks_emit_the_jax_events():
    want = _framelog_events(JaxFrameLog, JaxPlacement, JaxTracer,
                            JaxCalibration)
    got = _framelog_events(FrameLog, Placement, Tracer, DeathCalibration)
    assert got == want
    names = {e["name"] for e in got[0]}
    assert {"seg.open", "seg.seal", "seg.evacuate", "seg.clean"} <= names
    assert {e["tid"] for e in got[0]} == {2}
    assert got[1]["deaths"] > 0 and got[1]["unrouted"] > 0


def test_checkpoint_store_traces_as_the_jax_store(tmp_path):
    """The snapshot store's ``tracer=`` reaches its ``ByteLog`` core: the
    same save / drop / clean sequence emits the JAX store's segment events
    (files opened, sealed, evacuated and cleaned)."""
    events = {}
    for name, cls, tracer_cls in (("jax", JaxStore, JaxTracer),
                                  ("port", LogStructuredCheckpointStore, Tracer)):
        tr = tracer_cls(capacity=4096, clock=Tick())
        _store_run(functools.partial(cls, tracer=tr), tmp_path / name)
        events[name] = tr.events()
    assert events["port"] == events["jax"]
    assert {"seg.open", "seg.seal", "seg.evacuate", "seg.clean"} <= {
        e["name"] for e in events["port"]}


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX f32 params, port model on the CPU), one PRNGKey."""
    jm = JaxModel(jax_get_config("qwen3-1.7b").smoke())
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    model = Model(get_config("qwen3-1.7b").smoke(),
                  params_from_jax(jax.tree.map(np.asarray, jp)))
    return jm, jp, model


# test_obs.py::test_engine_obs_end_to_end's engine and stream
OBS_KW = dict(n_slabs=8, blocks_per_slab=4, page_T=8, max_batch=3, max_seq=96,
              policy="mdc", compact_trigger=2, compact_batch=3, preemption=True)
# test_async_compaction.py's engine (a tiny pool that cleans repeatedly)
SMALL_KW = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
                max_seq=96, policy="mdc", compact_trigger=2, compact_batch=2)


def _obs_requests(vocab, seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 30))),
             int(rng.integers(4, 12))) for _ in range(n)]


def _small_requests(vocab):
    """test_async_compaction.py::_reqs."""
    rng = np.random.default_rng(1)
    lens = [5, 17, 9, 24, 3, 12, 20, 7, 15, 11]
    news = [16, 20, 14, 18, 22, 15, 19, 21, 13, 17]
    return [(rng.integers(1, vocab, size=n), m) for n, m in zip(lens, news)]


def _mixed_requests(vocab, n=8, seed=3):
    """test_chunked_prefill.py::_mixed_reqs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(4, 60))),
             int(rng.integers(4, 25))) for _ in range(n)]


def _engine(models, side, **kw):
    jm, jp, model = models
    if side == "jax":
        return JaxEngine(jm, params=jp, use_pallas=False,
                         pool_dtype=jnp.float32, **kw)
    return PagedServingEngine(model, pool_dtype=torch.float32, device="cpu",
                              **kw)


def _drain(eng, requests):
    rids = [eng.submit(p, n) for p, n in requests]
    while eng.has_work():
        eng.step()
    eng.pool.check_invariants()
    return [eng.finished[r] for r in rids]


def _lanes(tracer):
    """The request-lane (1) and segment-lane (2) events without their
    timestamps, in order."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in tracer.events() if e["tid"] in (1, 2)]


def _instrumented(models, side, requests, tmp_path, **kw):
    clock = Tick()
    tracer = (JaxTracer if side == "jax" else Tracer)(capacity=1 << 16,
                                                      clock=clock)
    mpath = tmp_path / f"metrics_{side}.jsonl"
    eng = _engine(models, side, clock=clock, tracer=tracer, calibration=True,
                  metrics_every=2, metrics_sink=mpath, phase_log=True, **kw)
    tokens = _drain(eng, requests)
    eng._metrics_logger.close()
    rows = [json.loads(line) for line in mpath.read_text().splitlines()]
    return eng, tracer, tokens, rows


def _phase_shape(eng):
    pr = eng.phase_report()
    return (sorted(pr), sorted(pr["phase_mean_ms"]),
            sorted(pr["phase_share_p99_tail"]), pr["dispatches"])


def test_engine_observability_matches_jax_engine(models, tmp_path):
    """test_obs.py's instrumented stream on both engines."""
    reqs = _obs_requests(models[0].cfg.vocab_size)
    runs = {side: _instrumented(models, side, reqs, tmp_path, **OBS_KW)
            for side in ("jax", "port")}
    (jeng, jtr, jtok, jrows), (eng, tr, tok, rows) = runs["jax"], runs["port"]
    assert tok == jtok
    assert eng.metrics() == jeng.metrics()
    assert eng.calibration.report() == jeng.calibration.report()
    assert eng.calibration.report()["deaths"] > 0
    assert len(rows) == len(jrows) >= 2
    assert [{k: v for k, v in r.items() if k != "t"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "t"} for r in jrows]
    assert _phase_shape(eng) == _phase_shape(jeng)
    assert eng.phase_report()["dispatches"] == eng.metrics()["dispatches"] > 0
    assert _lanes(tr) == _lanes(jtr)
    doc = tr.export(tmp_path / "trace.json")
    _check_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"step", "dispatch", "host_sync", "pool", "req", "req.admit",
            "seg.open", "seg.seal"} <= names
    # one clock: admission stamps and metric rows on the fake timebase
    assert eng.clock is tr.clock
    assert all(t >= 1000.0 for t in eng.admit_wall.values())
    assert sorted(eng.admit_wall) == sorted(jeng.admit_wall)
    for row in eng.dispatch_phases:
        assert sum(v for k, v in row.items() if k != "total") \
            <= row["total"] + 1e-9


STREAMS = {
    # a prefill chunk per fused dispatch (test_chunked_prefill.py's engine)
    "chunked": (dict(n_slabs=6, blocks_per_slab=4, page_T=8, max_batch=3,
                     max_seq=96, compact_trigger=1, compact_batch=2,
                     prefill_chunk=16), _mixed_requests, "req.prefill_chunk",
                "dispatch"),
    # the pump moves and commits sub-plans at the start of each step
    "async": (dict(SMALL_KW, async_compaction=True, clean_budget=4),
              _small_requests, "seg.evacuate", "compaction"),
    # a record per state transition, synchronous cleaning inside admission
    "journal": (dict(SMALL_KW, snapshot_every=4), _small_requests,
                "seg.evacuate", "journal"),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_engine_streams_trace_as_the_jax_engine(models, stream, tmp_path):
    kw, requests, event, phase = STREAMS[stream]
    reqs = requests(models[0].cfg.vocab_size)
    runs = {}
    for side in ("jax", "port"):
        extra = ({"journal_dir": str(tmp_path / f"j_{side}")}
                 if stream == "journal" else {})
        eng, tr, tok, rows = _instrumented(models, side, reqs, tmp_path,
                                           **kw, **extra)
        m = eng.metrics()
        runs[side] = (tok, {k: m[k] for k in ("blocks_written", "blocks_moved",
                                               "compactions", "wamp",
                                               "dispatches")},
                      eng.calibration.report(), _phase_shape(eng), _lanes(tr))
        if side == "port":
            names = {e["name"] for e in tr.events()}
            phases = eng.phase_report()["phase_mean_ms"]
            assert event in names and phase in phases, (names, phases)
            _check_chrome_trace(tr.export())
    assert runs["port"] == runs["jax"]
    assert runs["port"][1]["compactions"] >= 1


def test_engine_without_observability_is_inert(models):
    """test_obs.py::test_engine_obs_disabled_is_inert_and_identical in the
    port: no tracer or calibration state, and the instrumented run's tokens
    and counters."""
    reqs = _small_requests(models[0].cfg.vocab_size)

    def run(**obs):
        eng = _engine(models, "port", **SMALL_KW, **obs)
        return _drain(eng, reqs), eng

    plain_toks, plain = run()
    assert plain.tracer is None and plain.calibration is None
    assert plain.pool.core.tracer is None and plain.pool.core.slot_est is None
    assert plain._metrics_logger is None and not plain.dispatch_phases
    obs_toks, obs = run(tracer=Tracer(capacity=1 << 14, clock=Tick()),
                        calibration=True, phase_log=True)
    assert obs_toks == plain_toks, "observability changed decoded tokens"
    m, pm = obs.metrics(), plain.metrics()
    assert m.pop("misroute_rate") >= 0.0
    assert m == pm
    assert pm["compactions"] >= 1
    assert plain.phase_report() == {
        "dispatches": 0, "p50_ms": 0.0, "p99_ms": 0.0, "phase_mean_ms": {},
        "phase_share_p99_tail": {}, "compaction_share_p99": 0.0,
        "compaction_share_total": 0.0}


def test_recovered_engine_traces_its_journal_core(models, tmp_path,
                                                  monkeypatch):
    """``recover_engine(..., tracer=)`` reaches the rebuilt engine, its
    pool's core and its journal's core: with small journal segments the
    recovered session rotates and cleans journal segments, whose ids lie
    past the pool's slabs, and their events reach the tracer."""
    monkeypatch.setattr(engine_mod, "JournalLog",
                        functools.partial(engine_mod.JournalLog,
                                          seg_bytes=256))
    reqs = _small_requests(models[0].cfg.vocab_size)
    kw = dict(SMALL_KW, pool_dtype=torch.float32, device="cpu",
              snapshot_every=3)
    eng = PagedServingEngine(models[2], journal_dir=tmp_path / "j", **kw)
    for p, n in reqs:
        eng.submit(p, n)
    for _ in range(4):      # the kill: two sequences live
        eng.step()
    eng.journal.close()
    first = eng.journal.core.next_sid
    tracer = Tracer(capacity=1 << 16, clock=Tick())
    reng, rep = recover_engine(models[2], tmp_path / "j", tracer=tracer, **kw)
    assert reng.tracer is tracer and reng.pool.core.tracer is tracer
    assert reng.journal.core.tracer is tracer
    reng.run_to_completion()
    reng.audit()
    assert rep["sequences_resumed"] > 0
    nseg = reng.pool.core.nseg
    opened = {e["args"]["seg"] for e in tracer.events()
              if e["name"] == "seg.open"}
    journal_sids = set(range(max(first, nseg), reng.journal.core.next_sid))
    assert journal_sids and journal_sids <= opened
    cleaned = {e["args"]["seg"] for e in tracer.events()
               if e["name"] == "seg.evacuate"}
    assert cleaned & journal_sids
