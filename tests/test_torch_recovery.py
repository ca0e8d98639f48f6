"""The port's crash-safe serving against the JAX package's.

The contracts of ``tests/test_crash_recovery.py`` (and the kill between a
move and its commit of ``tests/test_async_compaction.py``), each on the
same streams in both packages:

* the journal is passive and is the JAX engine's: on streams where the two
  schedules agree, the port's journal files and snapshot store are the JAX
  engine's byte for byte, and its tokens are the JAX engine's;
* a kill at *every* record boundary (snapshots off, and every 2
  dispatches) recovers to the unkilled run's tokens for every request whose
  submission survived, the audit passes, and a second recovery from the
  same cut gives the same ``metrics()``.  A cut is the journal directory
  cloned the moment its record was appended: with snapshots on, truncating
  the final directory would keep the snapshots and journal segments of
  later records;
* a second kill in the middle of the first recovery's re-decode;
* ``load_session`` and ``recover_engine`` read the JAX engine's journal;
* the five fault-injection twins: each injector fires on the same calls in
  both engines (equal per-op call counts), a transient dispatch is retried
  from unchanged device mirrors, a hard fault propagates, a bounded retry
  escalates, a prefill fault unwinds the admission, a journal fault is
  retried and its journal recovers;
* a kill while an async sub-plan is moved and not committed;
* a few cuts each on the chunked, prefix-hit and preempting streams, held
  to the port's unkilled run and to the plain greedy decode (the port's
  resumes wait where the JAX engine's preempt a peer).

Both engines run with ``pool_dtype`` float32 on the same float32
parameters (the JAX engine on its plain path, the port's with
``device="cpu"``), as the JAX file runs them.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.fault import FailureInjector as JaxInjector
from repro.distributed.fault import SimulatedFailure as JaxFailure
from repro.distributed.fault import TransientFault as JaxTransient
from repro.models import Model as JaxModel
from repro.serving import PagedServingEngine as JaxEngine
from repro.serving import recovery as jrec
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.logstructure import JournalLog
from repro_torch.distributed.fault import (FailureInjector, SimulatedFailure,
                                           TransientFault)
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.serving import PagedServingEngine, recover_engine
from repro_torch.serving import recovery


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size operations run faster on one intra-op thread, and test
    files side by side in parallel workers do not oversubscribe the CPU."""
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


def _ekw(**kw):
    """test_crash_recovery.py::_ekw's geometry."""
    base = dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=2,
                max_seq=96, policy="mdc", compact_trigger=2,
                compact_batch=2, stop_token=97, preemption=True)
    base.update(kw)
    return base


def _reqs(vocab, n=3, seed=11):
    """test_crash_recovery.py::_reqs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(5, 20))),
             int(rng.integers(4, 7))) for _ in range(n)]


def _port(models, **kw):
    return PagedServingEngine(models[2], pool_dtype=torch.float32,
                              device="cpu", **kw)


def _jax(models, **kw):
    jm, jp, _ = models
    return JaxEngine(jm, params=jp, use_pallas=False, pool_dtype=jnp.float32,
                     **kw)


def _recover(models, jdir, **kw):
    return recover_engine(models[2], jdir, pool_dtype=torch.float32,
                          device="cpu", **kw)


def _drain(eng, cap=10_000):
    for _ in range(cap):
        eng.step()
        if not eng.has_work():
            return
    raise AssertionError("engine did not drain")


def _serve(eng, reqs):
    rids = [eng.submit(p, n) for p, n in reqs]
    assert rids == list(range(len(reqs)))
    _drain(eng)
    return {r: eng.finished[r] for r in rids}


def _capture(eng, root):
    """Clone the journal directory the moment each record is appended: the
    disk state of a kill at that record boundary.  Returns the list the
    clones go to, as (seq, record, directory)."""
    cuts = []
    append = eng.journal.append

    def hooked(payload):
        seq = append(payload)
        d = Path(root) / f"cut{seq:05d}"
        shutil.copytree(eng.journal.root, d)
        cuts.append((seq, json.loads(payload), d))
        return seq

    eng.journal.append = hooked
    return cuts


def _tree(root):
    """Every file under a journal directory, by relative path."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(Path(root).rglob("*")) if p.is_file()}


def _clean_metrics(eng):
    m = eng.metrics()
    m.get("recovery", {}).pop("recovery_wall_s", None)
    return m


def _oracle(models, reqs, stop_token=None):
    _, _, model = models
    return {r: tfm.greedy_decode(model.params, p, model.cfg, n,
                                 stop_token=stop_token,
                                 cache_dtype=torch.float32)
            for r, (p, n) in enumerate(reqs)}


def _check_cuts(models, tmp_path, cuts, want, kw, pick=lambda k: True):
    """Recover from every picked cut and drain: each request whose ``sub``
    survived the cut ends with ``want``'s tokens; the audit passes."""
    subs, checked = 0, 0
    for k, (seq, rec, d) in enumerate(cuts):
        subs += rec["t"] == "sub"
        if not pick(k):
            continue
        work = tmp_path / f"work{seq:05d}"
        shutil.copytree(d, work)
        reng, rep = _recover(models, work, **kw)
        assert rep["journal_torn_bytes"] == 0
        _drain(reng)
        reng.audit()
        got = {r: reng.finished.get(r) for r in range(subs)}
        assert got == {r: want[r] for r in range(subs)}, \
            f"kill at record {seq} ({rec['t']}) lost bit-identity"
        checked += 1
    return checked


# -------------------------------------------------- the journal is JAX's

JOURNAL_STREAMS = {
    "ekw_11": (dict(), dict(seed=11), 0),
    "ekw_29_snap": (dict(), dict(seed=29), 2),
    "async": (dict(n_slabs=7, max_batch=3, stop_token=None, preemption=False,
                   async_compaction=True, clean_budget=4), dict(n=6, seed=5), 3),
    "chunked_prefix": (dict(n_slabs=10, max_batch=3, stop_token=None,
                            preemption=False, prefill_chunk=16,
                            prefix_cache=True), "shared", 2),
}


def _stream_reqs(vocab, spec):
    if spec == "shared":
        rng = np.random.default_rng(1)
        sys_prompt = np.random.default_rng(42).integers(1, vocab, size=24)
        return [(np.concatenate([sys_prompt, rng.integers(
            1, vocab, size=int(rng.integers(3, 14)))]),
            int(rng.integers(4, 12))) for _ in range(6)]
    return _reqs(vocab, **spec)


@pytest.mark.parametrize("stream", list(JOURNAL_STREAMS))
def test_journal_is_the_jax_engines(models, tmp_path, stream):
    """Journal files and snapshot store byte for byte the JAX engine's, the
    tokens and the journal metrics the same."""
    extra, spec, snap = JOURNAL_STREAMS[stream]
    kw = _ekw(**extra)
    reqs = _stream_reqs(models[0].cfg.vocab_size, spec)
    jeng = _jax(models, journal_dir=tmp_path / "jax", snapshot_every=snap,
                **kw)
    peng = _port(models, journal_dir=tmp_path / "port", snapshot_every=snap,
                 **kw)
    assert _serve(peng, reqs) == _serve(jeng, reqs)
    peng.audit()
    keys = ("journal_records", "journal_bytes", "journal_wamp", "wamp",
            "compactions", "dispatches")
    pm, jm_ = peng.metrics(), jeng.metrics()
    assert {k: pm[k] for k in keys} == {k: jm_[k] for k in keys}
    assert pm["journal_wamp"] == 0.0
    assert peng.session_state() == jeng.session_state()
    peng.journal.close()
    jeng.journal.close()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    # the one segment file keeps the records compacted behind a snapshot
    kinds = {r["t"] for _, r in JournalLog(tmp_path / "port").iter_records()}
    assert {"sub", "adm", "first", "emit", "fin", "rel"} <= kinds
    if snap:
        assert peng._snap_id == jeng._snap_id >= 1 and "snap" in kinds
    if extra.get("async_compaction"):
        assert {"mv", "mvc"} <= kinds


# ------------------------------------------------ a kill at every boundary

@pytest.mark.parametrize("snapshot_every", [0, 2], ids=["replay", "snap2"])
def test_kill_at_every_record_boundary(models, tmp_path, snapshot_every):
    """The tentpole contract, at every record boundary of a full session:
    a recovery drains to the unkilled run's tokens (the JAX engine's) for
    every request whose submission survived; a second recovery from the
    middle cut reproduces the whole ``metrics()``."""
    kw = _ekw()
    reqs = _reqs(models[0].cfg.vocab_size)
    want = _serve(_jax(models, **kw), reqs)
    eng = _port(models, journal_dir=tmp_path / "j",
                snapshot_every=snapshot_every, **kw)
    cuts = _capture(eng, tmp_path)
    assert _serve(eng, reqs) == want          # the journal is passive
    eng.audit()
    assert len(cuts) >= 8
    if snapshot_every:
        assert sum(r["t"] == "snap" for _, r, _ in cuts) >= 2
    else:
        # with one segment and no snapshot, a clone is the final journal
        # truncated at the boundary (test_crash_recovery.py::_truncate_to)
        final = next((tmp_path / "j").glob("journal_*.log"))
        data = final.read_bytes()
        for _, _, d in cuts:
            cut = (d / final.name).read_bytes()
            assert data[:len(cut)] == cut
    assert _check_cuts(models, tmp_path, cuts, want, kw) == len(cuts)

    seq, _, d = cuts[len(cuts) // 2]
    runs = []
    for i in range(2):
        work = tmp_path / f"again{i}"
        shutil.copytree(d, work)
        reng, _ = _recover(models, work, **kw)
        _drain(reng)
        reng.audit()
        runs.append((_clean_metrics(reng), reng.finished))
    assert runs[0] == runs[1]
    assert runs[0][0]["recovery"]["records_replayed"] >= 1 or snapshot_every


@pytest.mark.parametrize("chunk", [32, 2])
def test_double_kill_mid_replay(models, tmp_path, chunk):
    """A second kill while the first recovery still re-decodes must not lose
    the gap between re-decoded and journaled tokens (the _jskip span).  At
    the JAX file's 32-token dispatches the first recovered step may already
    catch up; at 2 it is mid-replay for sure."""
    kw = _ekw(max_decode_chunk=chunk)
    reqs = _reqs(models[0].cfg.vocab_size, n=3, seed=29)
    if chunk == 2:                  # spans longer than a recovered step
        reqs = [(p, n + 8) for p, n in reqs]
    want = _serve(_port(models, **kw), reqs)
    assert want == _serve(_jax(models, **kw), reqs)
    jd = tmp_path / "j"
    eng = _port(models, journal_dir=jd, **kw)
    for p, n in reqs:
        eng.submit(p, n)
    for _ in range(4):
        eng.step()
    while chunk == 2 and eng.has_work() and not (eng._out_n >= 6).any():
        eng.step()
    eng = None                      # kill 1
    eng, rep = _recover(models, jd, **kw)
    assert rep["sequences_resumed"] >= 1
    eng.step()                      # mid-replay
    if chunk == 2:
        assert (eng._jskip > eng._out_n).any(), "not mid-replay"
    eng = None                      # kill 2
    eng, _ = _recover(models, jd, **kw)
    _drain(eng)
    eng.audit()
    assert {r: eng.finished[r] for r in range(len(reqs))} == want


def test_recovery_reads_the_jax_engines_journal(models, tmp_path):
    """A journal (with snapshots) the JAX engine wrote: the port's
    load_session gives the JAX one's state and report at a few cuts, and
    the port's engine recovers from it to the unkilled tokens."""
    kw = _ekw()
    reqs = _reqs(models[0].cfg.vocab_size, n=3, seed=29)
    jeng = _jax(models, journal_dir=tmp_path / "j", snapshot_every=2, **kw)
    cuts = _capture(jeng, tmp_path)
    want = _serve(jeng, reqs)
    picked = [k for k in range(len(cuts)) if k % 5 == 4]
    for k in picked:
        _, _, d = cuts[k]
        assert (recovery.load_session(d, stop_token=97)
                == jrec.load_session(d, stop_token=97))
    assert _check_cuts(models, tmp_path, cuts, want, kw,
                       pick=lambda k: k in picked) == len(picked)


# --------------------------------------------------------- fault injection

def _twins(models, cfg, reqs, kw, expect=None, journal=None):
    """The same injector configuration through both engines (each with its
    own journal under ``journal``, if given): the outcome (tokens, or the
    exception class), the retries and unwinds, and the injector's per-op
    call counts must agree."""
    out = []
    for make, inj in ((_jax, JaxInjector(**cfg)), (_port, FailureInjector(**cfg))):
        jkw = {} if journal is None else {
            "journal_dir": Path(journal) / make.__name__}
        eng = make(models, injector=inj, **jkw, **kw)
        try:
            res = _serve(eng, reqs)
        except (JaxTransient, TransientFault) as e:
            res = ("transient", str(e))
        except (JaxFailure, SimulatedFailure) as e:
            res = ("hard", str(e))
        out.append((res, eng.fault_retries_done, eng.fault_unwinds,
                    dict(inj.op_counts)))
        if not isinstance(res, tuple):
            eng.audit()
    assert out[1] == out[0]
    if expect is not None:
        assert out[1][0][0] == expect
    return out[1]


def test_transient_dispatch_fault_retried(models):
    """A dispatch retried from unchanged device mirrors: the port writes
    K/V in place, so the fault must fire before the dispatch starts."""
    reqs = _reqs(models[0].cfg.vocab_size, seed=3)
    kw = _ekw(fault_retries=2, fault_backoff_s=0.0)
    want = _serve(_port(models, **_ekw()), reqs)
    res, retries, _, counts = _twins(
        models, dict(transient_at=(("dispatch", 2), ("dispatch", 5))), reqs,
        kw)
    assert res == want and retries == 2 and counts["dispatch"] >= 6


def test_hard_fault_propagates(models):
    reqs = _reqs(models[0].cfg.vocab_size)
    _twins(models, dict(fail_at=(("dispatch", 1),)), reqs, _ekw(),
           expect="hard")


def test_exhausted_retries_escalate(models):
    """Three transients in a row on one op exceed fault_retries=1."""
    reqs = _reqs(models[0].cfg.vocab_size)
    _twins(models, dict(transient_at=(("host_sync", 1), ("host_sync", 2),
                                      ("host_sync", 3))), reqs,
           _ekw(fault_retries=1), expect="transient")


def test_prefill_fault_unwinds_admission(models):
    """A transient at the prefill unwinds the partial start (the audit and
    the free count show no page leaked); the request is served later."""
    reqs = _reqs(models[0].cfg.vocab_size, seed=7)
    want = _serve(_port(models, **_ekw()), reqs)
    res, _, unwinds, _ = _twins(
        models, dict(transient_at=(("prefill", 0), ("prefill", 2))), reqs,
        _ekw(fault_retries=0))
    assert res == want and unwinds == 2
    eng = _port(models, injector=FailureInjector(
        transient_at=(("prefill", 0),)), fault_retries=0, **_ekw())
    _serve(eng, reqs)
    assert eng.metrics()["free_blocks"] == eng.pool.n_slabs * eng.pool.S
    assert eng.metrics()["fault_unwinds"] == 1


def test_journal_fault_retried_and_recoverable(models, tmp_path):
    """A transient journal append (and one compaction move) is retried; the
    retried journal is the JAX engine's byte for byte and complete: a
    recovery from it replays every finish."""
    reqs = _reqs(models[0].cfg.vocab_size, seed=13)
    kw = _ekw(fault_retries=2, fault_backoff_s=0.0)
    got, retries, _, counts = _twins(
        models, dict(transient_at=(("journal", 1), ("compaction", 0))), reqs,
        kw, journal=tmp_path)
    assert retries == 1 + (counts.get("compaction", 0) > 0)
    assert _tree(tmp_path / "_port") == _tree(tmp_path / "_jax")
    reng, rep = _recover(models, tmp_path / "_port", **_ekw())
    assert {r: reng.finished[r] for r in got} == got
    assert rep["sequences_resumed"] == rep["requests_requeued"] == 0


# ------------------------------------------ kill inside the async window

def test_kill_between_move_and_commit_recovers(models, tmp_path):
    """test_async_compaction.py::test_kill_between_move_and_commit_recovers:
    kill with a sub-plan moved ("mv" journaled) and not committed (no
    "mvc"); replay rebuilds placement from scratch, so every request still
    drains to the synchronous engine's tokens."""
    kw = dict(n_slabs=7, blocks_per_slab=2, page_T=8, max_batch=3,
              max_seq=96, policy="mdc", compact_trigger=2, compact_batch=2)
    # test_async_compaction.py::_reqs
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(1, models[0].cfg.vocab_size, size=n), m)
            for n, m in zip([5, 17, 9, 24, 3, 12, 20, 7, 15, 11],
                            [16, 20, 14, 18, 22, 15, 19, 21, 13, 17])]
    want = _serve(_port(models, **kw), reqs)
    assert want == _serve(_jax(models, **kw), reqs)
    jd = tmp_path / "journal"
    eng = _port(models, journal_dir=jd, async_compaction=True,
                clean_budget=4, **kw)
    assert [eng.submit(p, n) for p, n in reqs] == list(want)
    while eng.has_work() and not eng._inflight_plans:
        eng.step()
    assert eng._inflight_plans, "never caught the mv→mvc crash window"
    recs = [r for _, r in eng.journal.iter_records()]
    last_mv = max(i for i, r in enumerate(recs) if r["t"] == "mv")
    assert not any(r["t"] == "mvc" and r["src"] == recs[last_mv]["src"]
                   for r in recs[last_mv:])
    eng = None                                     # the kill
    reng, rep = _recover(models, jd, async_compaction=True, clean_budget=4,
                         **kw)
    assert rep["sequences_resumed"] >= 1
    _drain(reng)
    assert {r: reng.finished.get(r) for r in want} == want
    reng.audit()


# --------------------------------------------- the port's other streams

def _mixed_reqs(vocab, n=8, seed=0, lo=4, hi=40, new=(4, 30)):
    """test_preemption.py::_mixed_reqs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, vocab, size=int(rng.integers(lo, hi))),
             int(rng.integers(*new))) for _ in range(n)]


OTHER_STREAMS = {
    # chunked prefill (test_chunked_prefill.py's geometry)
    "chunked": (dict(n_slabs=8, blocks_per_slab=4, page_T=8, max_batch=3,
                     max_seq=96, policy="mdc", compact_trigger=1,
                     compact_batch=2, prefill_chunk=16),
                dict(n=6, seed=3, hi=60, new=(4, 12)), None),
    # prefix hits: one system prompt shared by every request
    "prefix": (dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=3,
                    max_seq=96, policy="mdc", compact_trigger=2,
                    compact_batch=2, prefix_cache=True), "shared", None),
    # preemption under pressure (test_preemption.py's mixed stream)
    "preempting": (dict(n_slabs=8, blocks_per_slab=2, page_T=8, max_batch=3,
                        max_seq=96, policy="mdc", compact_trigger=1,
                        compact_batch=2, max_decode_chunk=32,
                        preemption=True), dict(n=6, seed=0), None),
}


@pytest.mark.parametrize("stream", list(OTHER_STREAMS))
def test_cuts_on_the_ports_other_paths(models, tmp_path, stream):
    """Six cuts spread over each stream's journal: recovered tokens equal
    the port's unkilled run's and the plain greedy decode's.  Where a JAX
    resume would preempt a peer, the port's waits (ROADMAP §3), so the
    oracle is the reference here."""
    kw, spec, stop = OTHER_STREAMS[stream]
    vocab = models[0].cfg.vocab_size
    reqs = (_stream_reqs(vocab, spec) if spec == "shared"
            else _mixed_reqs(vocab, **spec))
    eng = _port(models, journal_dir=tmp_path / "j", snapshot_every=3, **kw)
    cuts = _capture(eng, tmp_path)
    want = _serve(eng, reqs)
    eng.audit()
    assert want == _oracle(models, reqs, stop)
    m = eng.metrics()
    if stream == "chunked":
        assert m["prefill_chunks_dispatched"] > len(reqs)
    if stream == "prefix":
        assert m["prefill_tokens_saved"] > 0
    if stream == "preempting":
        assert m["preemptions"] >= 1
    step = max(len(cuts) // 6, 1)
    assert _check_cuts(models, tmp_path, cuts, want, kw,
                       pick=lambda k: k % step == step - 1) >= 5
