"""The port's crash-safety building blocks against the JAX package's.

Each runs on the same inputs in both packages:

* ``JournalLog`` / ``ByteLog`` — the same appends (rotating segments),
  ``compact`` behind a cut and reopen give byte-equal files, the same seqs,
  the same ``StoreStats``, and each package reads the other's directory.
  A torn tail is cut at every byte offset of the last record (an explicit
  grid: the JAX file's hypothesis property only skips here);
* the byte-mode victim keys (``key_mdc_bytes``, ``select_victims_bytes``);
* ``LogStructuredCheckpointStore`` — a fixed save / ``drop_step`` / ``gc``
  sequence gives equal ``StoreStats``, equal restored leaves, clean
  ``check_invariants`` and byte-equal segment files, and reopens in the
  other package;
* ``FailureInjector`` — the same firing sequence (which calls raise, and
  what), and ``backoff_delay``;
* ``replay`` / ``load_session`` — on seeded record streams (whose
  synthesiser never emits past a stop token, unlike the JAX file's
  ``_synth_records``), a snapshot cut anywhere commutes with replay, and
  both packages give the same state and report.
"""

import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from repro.checkpoint.logstore import \
    LogStructuredCheckpointStore as JaxStore
from repro.core import policies as jpol
from repro.core.logstructure import ByteLog as JaxByteLog
from repro.core.logstructure import JournalLog as JaxJournal
from repro.distributed.fault import FailureInjector as JaxInjector
from repro.distributed.fault import SimulatedFailure as JaxFailure
from repro.distributed.fault import TransientFault as JaxTransient
from repro.distributed.fault import backoff_delay as jax_backoff
from repro.serving import recovery as jrec
from repro_torch.checkpoint import LogStructuredCheckpointStore
from repro_torch.core import policies
from repro_torch.core.logstructure import ByteLog, JournalLog, StoreStats
from repro_torch.distributed.fault import (FailureInjector, SimulatedFailure,
                                           TransientFault, backoff_delay)
from repro_torch.serving import recovery

_HDR = struct.Struct("<IIQ")   # [u32 len][u32 crc32][u64 seq]


def _records(seed, n):
    rng = np.random.default_rng(seed)
    return [{"t": "x", "i": i, "d": rng.integers(0, 99, int(rng.integers(
        1, 40))).tolist()} for i in range(n)]


def _files(root):
    return {p.name: p.read_bytes()
            for p in sorted(Path(root).glob("journal_*.log"))}


def _journal_state(j):
    return (j.next_seq, j.torn_bytes, sorted(j._index.items()),
            dataclasses.asdict(j.core.stats), j.core.next_sid,
            j.core.seg_state[:j.core.next_sid].tolist(),
            j.core.seg_written[:j.core.next_sid].tolist(),
            j.core.seg_live_bytes[:j.core.next_sid].tolist())


# ------------------------------------------------------------- the journal

def test_store_stats_fields_are_the_jax_ones():
    """The session blob's ``pool_stats`` and a snapshot store's stats load
    in either package: same fields, same order."""
    from repro.core.logstructure import StoreStats as JaxStats
    assert ([f.name for f in dataclasses.fields(StoreStats)]
            == [f.name for f in dataclasses.fields(JaxStats)])


@pytest.mark.parametrize("seed,n,seg_bytes,cut", [
    (0, 12, 256 * 1024, 5), (1, 60, 600, 37), (2, 200, 900, 150),
    (3, 40, 300, 40)])
def test_journal_appends_compact_reopen_match_jax(tmp_path, seed, n,
                                                  seg_bytes, cut):
    """Same appends, a compact behind ``cut`` and a reopen: byte-equal
    segment files, equal seqs, index, stats and segment accounting; each
    package then reads the other's directory."""
    recs = _records(seed, n)
    logs = {}
    for name, cls in (("jax", JaxJournal), ("port", JournalLog)):
        j = cls(tmp_path / name, seg_bytes=seg_bytes)
        seqs = [j.append_record(r) for r in recs]
        assert seqs == list(range(n))
        deleted = j.compact(cut)
        logs[name] = (j, deleted)
    (jj, jd), (pj, pd) = logs["jax"], logs["port"]
    assert jd == pd
    assert _journal_state(pj) == _journal_state(jj)
    assert [r for _, r in pj.iter_records()] == recs[cut:]
    pj.check_tail()
    jj.close()
    pj.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    # a reopened journal holds every record its files still hold (the owner
    # compacts again behind its last snapshot marker): a suffix of the
    # appends, from the first file that compact kept
    reads = []
    for reader, writer in ((JournalLog, "jax"), (JaxJournal, "port")):
        j = reader(tmp_path / writer)
        reads.append([r for _, r in j.iter_records()])
        assert j.next_seq == n and j.torn_bytes == 0
        j.close()
    assert reads[0] == reads[1] == recs[n - len(reads[0]):]
    assert len(reads[0]) >= n - cut
    # reopened, both go on appending alike
    for name, cls in (("jax", JaxJournal), ("port", JournalLog)):
        j = cls(tmp_path / name, seg_bytes=seg_bytes)
        j.append_record({"t": "y"})
        logs[name] = j
    assert _journal_state(logs["port"]) == _journal_state(logs["jax"])
    for j in logs.values():
        j.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("n_rec,seed", [(1, 0), (5, 1), (12, 2)])
def test_torn_tail_at_every_byte_of_the_last_record(tmp_path, n_rec, seed):
    """Cut the live segment at every byte offset inside its last record:
    reopening keeps exactly the complete records before it, drops the torn
    bytes, stays appendable, and does so as the JAX journal does."""
    recs = _records(seed, n_rec)
    j = JournalLog(tmp_path / "w")
    for r in recs:
        j.append_record(r)
    j.close()
    f = next((tmp_path / "w").glob("journal_*.log"))
    whole = f.read_bytes()
    start = len(whole) - (_HDR.size + _HDR.unpack_from(
        whole, len(whole) - len(json.dumps(
            recs[-1], separators=(",", ":")).encode()) - _HDR.size)[0])
    for cut in range(start, len(whole)):
        got = {}
        for name, cls in (("jax", JaxJournal), ("port", JournalLog)):
            d = tmp_path / f"{name}{cut}"
            d.mkdir()
            (d / f.name).write_bytes(whole[:cut])
            jj = cls(d)
            got[name] = ([r for _, r in jj.iter_records()], jj.torn_bytes,
                         jj.next_seq)
            jj.check_tail()
            jj.append_record({"t": "y"})
            jj.close()
        assert got["port"] == got["jax"]
        assert got["port"] == (recs[:-1], cut - start, n_rec - 1)
        assert ((tmp_path / f"port{cut}" / f.name).read_bytes()
                == (tmp_path / f"jax{cut}" / f.name).read_bytes())


@pytest.mark.parametrize("policy", ["mdc", "greedy", "age"])
def test_byte_victims_match_jax(policy):
    """``select_victims_bytes`` (and ``key_mdc_bytes`` under it) on random
    byte-extent segments, through ``ByteLog.select_victims`` too."""
    rng = np.random.default_rng(7)
    n = 64
    written = rng.integers(1, 10_000, n)
    live = np.minimum(written, rng.integers(0, 10_000, n))
    live[::9] = written[::9]            # full: never a victim
    live[::11] = 0                      # empty: reclaimed first under mdc
    chunks = np.where(live > 0, rng.integers(1, 20, n), 0)
    up2 = rng.uniform(0, 500, n)
    seal = rng.uniform(0, 500, n)
    elig = rng.random(n) < 0.8
    kw = dict(live_bytes=live, written=written, n_chunks=chunks, up2=up2,
              seal_time=seal, u_now=600.0, eligible=elig)
    for k in (1, 5, 64):
        np.testing.assert_array_equal(
            policies.select_victims_bytes(policy, k, **kw),
            jpol.select_victims_bytes(policy, k, **kw))
    np.testing.assert_array_equal(
        policies.key_mdc_bytes(live, written - live, chunks, up2, 600.0),
        jpol.key_mdc_bytes(live, written - live, chunks, up2, 600.0))
    logs = []
    for cls in (JaxByteLog, ByteLog):
        log = cls()
        for i in range(n):
            s = log.alloc()
            log.append_bytes(s, int(written[i]), float(up2[i]))
            if live[i] < written[i]:
                log.kill_bytes(s, int(written[i] - live[i]), 0.0)
            log.seal(s)
        logs.append(log.select_victims(policy, 8))
    np.testing.assert_array_equal(logs[1], logs[0])


# ------------------------------------------------------- the snapshot store

def _leaves(rng, step):
    """Leaves that change at different rates: a frozen table, a slowly and
    a quickly changing one, and a per-step blob (the session's shape)."""
    frozen = np.arange(3000, dtype=np.int32)
    slow = np.full(2000, step // 3, np.int64)
    fast = rng.integers(0, 255, 5000).astype(np.uint8)
    blob = np.frombuffer(json.dumps({"step": step}).encode(), np.uint8)
    return {"frozen": frozen, "slow": slow, "fast": fast, "meta": blob}


def _store_run(cls, root):
    rng = np.random.default_rng(3)
    store = cls(root, seg_bytes=16 << 10, chunk_bytes=2 << 10)
    saved = {}
    for step in range(1, 13):
        if step == 12:      # an explicit clean; the save persists its state
            store.gc(2)
            store.check_invariants()
        leaves = _leaves(rng, step)
        saved[step] = leaves
        store.save(step, leaves, keep_last=3 if step < 9 else 0)
        if step == 10:
            store.drop_step(9)
        store.check_invariants()
    return store, saved


def test_checkpoint_store_matches_jax(tmp_path):
    """A fixed save / keep_last / drop_step / gc sequence: equal StoreStats,
    versions and segment accounting, byte-equal segment files and state,
    equal restored leaves; each package reopens the other's store."""
    jstore, saved = _store_run(JaxStore, tmp_path / "jax")
    store, _ = _store_run(LogStructuredCheckpointStore, tmp_path / "port")
    assert dataclasses.asdict(store.stats) == dataclasses.asdict(jstore.stats)
    assert store.stats.gc_bytes > 0 and store.stats.cleanings > 0
    assert store.stats.wamp() == jstore.stats.wamp()
    assert sorted(store.steps) == sorted(jstore.steps)
    for sub in ("segments", "manifests"):
        a = {p.name: p.read_bytes() for p in (tmp_path / "port" / sub).iterdir()}
        b = {p.name: p.read_bytes() for p in (tmp_path / "jax" / sub).iterdir()}
        assert a == b
    assert (json.loads((tmp_path / "port" / "store_state.json").read_text())
            == json.loads((tmp_path / "jax" / "store_state.json").read_text()))
    for step in store.steps:
        got, want = store.restore(step), jstore.restore(step)
        assert got.keys() == want.keys() == saved[step].keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], saved[step][k])
    for reader, writer in ((LogStructuredCheckpointStore, "jax"),
                           (JaxStore, "port")):
        s = reader(tmp_path / writer, seg_bytes=16 << 10,
                   chunk_bytes=2 << 10)
        s.check_invariants()
        assert dataclasses.asdict(s.stats) == dataclasses.asdict(store.stats)
        for step in s.steps:
            for k, v in s.restore(step).items():
                np.testing.assert_array_equal(v, saved[step][k])


# ------------------------------------------------------------ fault injection

def _fire(inj, calls, transient, hard):
    out = []
    for step, op in calls:
        try:
            inj.check(step, op=op)
            out.append(None)
        except transient as e:
            out.append(("transient", str(e), e.step, e.op))
        except hard as e:
            out.append(("hard", str(e), e.step, e.op))
    return out


@pytest.mark.parametrize("cfg", [
    dict(transient_at=(("dispatch", 2), ("journal", 0))),
    dict(fail_at=(("host_sync", 3),), transient_at=(("host_sync", 1),)),
    dict(transient_prob=0.3, seed=5),
    dict(transient_prob={"compaction": 0.5, "dispatch": 0.1},
         fail_prob={"prefill": 0.2}, seed=11),
    dict(fail_prob=0.05, transient_prob=0.2, ops=("dispatch", "journal"),
         seed=2),
    dict(fail_at_steps=(3, 7), fail_prob=0.1, seed=1),
], ids=["at", "hard_at", "prob", "per_op", "op_filter", "steps"])
def test_failure_injector_fires_as_jax(cfg):
    """The same configuration raises on the same calls, with the same
    class, message, step and op (per-op call counts, and the seeded rolls
    of the probability knobs)."""
    rng = np.random.default_rng(0)
    ops_ = ["dispatch", "prefill", "compaction", "host_sync", "journal"]
    calls = [(int(s), ops_[int(o)] if not cfg.get("fail_at_steps") else None)
             for s, o in zip(np.arange(300) // 5, rng.integers(0, 5, 300))]
    got = _fire(FailureInjector(**cfg), calls, TransientFault,
                SimulatedFailure)
    want = _fire(JaxInjector(**cfg), calls, JaxTransient, JaxFailure)
    assert got == want
    assert any(g is not None for g in got)


def test_backoff_delay_matches_jax():
    for attempt in range(6):
        for base in (0.0, 0.01, 0.25):
            for jitter in (0.0, 0.25):
                got = backoff_delay(attempt, base_s=base, jitter=jitter,
                                    rng=np.random.default_rng(attempt))
                want = jax_backoff(attempt, base_s=base, jitter=jitter,
                                   rng=np.random.default_rng(attempt))
                assert got == want
    assert backoff_delay(3, base_s=0.1, jitter=0.0) == pytest.approx(0.8)


# ------------------------------------------------------------------ replay

STOP = 9


def _synth(rng, n_req=5):
    """A record stream of the engine's shapes (submits, admissions, first
    tokens, emits, finishes).  A request finishes at its cap or on the stop
    token, and emits nothing after it, as the engine does."""
    recs, live, caps = [], {}, {}
    for rid in range(n_req):
        caps[rid] = int(rng.integers(2, 7))
        recs.append({"t": "sub", "rid": rid,
                     "p": rng.integers(1, 50, int(rng.integers(2, 6))).tolist(),
                     "n": caps[rid]})
    pending = list(range(n_req))

    def done(rid):
        out = live[rid]
        return len(out) >= caps[rid] or out[-1] == STOP

    while pending or live:
        if pending and (not live or rng.random() < 0.4):
            rid = pending.pop(0)
            recs.append({"t": "adm", "rid": rid, "slot": 0, "res": 0,
                         "shr": 0, "pg": []})
            live[rid] = [int(rng.integers(1, 12))]
            recs.append({"t": "first", "rid": rid, "tok": live[rid][0]})
        else:
            rids = [r for r in live if not done(r)]
            ks = []
            for rid in rids:
                k = []
                for _ in range(int(rng.integers(1, 3))):
                    if len(live[rid]) + len(k) >= caps[rid] or (
                            k and k[-1] == STOP):
                        break
                    k.append(int(rng.integers(1, 12)))
                live[rid].extend(k)
                ks.append(k)
            if rids:
                recs.append({"t": "emit", "r": rids, "k": ks})
        for rid in [r for r in live if done(r)]:
            recs.append({"t": "fin", "rid": rid})
            del live[rid]
    return recs


def _as_meta(state):
    """A replay() result as the session snapshot replay consumes."""
    def entry(rid, e):
        return {"rid": rid, "prompt": e["prompt"], "max_new": e["max_new"],
                "out": e["out"]}
    return {"live": [entry(r, e) for r, e in state["pending"] if e["prio"]],
            "resume": [],
            "queue": [entry(r, e) for r, e in state["pending"]
                      if not e["prio"]],
            "finished": {str(k): v for k, v in state["finished"].items()},
            "next_rid": state["next_rid"]}


def _canon(state):
    return (dict(state["finished"]), dict(state["pending"]),
            state["next_rid"])


@pytest.mark.parametrize("seed", range(8))
def test_replay_matches_jax_and_snapshot_cuts_commute(seed):
    """replay(snapshot(prefix), tail) == replay(None, prefix + tail) at every
    cut, and the port's replay gives the JAX one's state at every cut."""
    recs = _synth(np.random.default_rng(seed))
    full = recovery.replay(None, recs, stop_token=STOP)
    assert full == jrec.replay(None, recs, stop_token=STOP)
    assert not full["pending"] and len(full["finished"]) == 5
    for k in range(len(recs) + 1):
        head = recovery.replay(None, recs[:k], stop_token=STOP)
        assert head == jrec.replay(None, recs[:k], stop_token=STOP)
        stitched = recovery.replay(_as_meta(head), recs[k:], stop_token=STOP)
        assert _canon(stitched) == _canon(full)
        assert stitched == jrec.replay(_as_meta(head), recs[k:],
                                       stop_token=STOP)


def test_load_session_matches_jax(tmp_path):
    """A journal with a snapshot marker (through the port's snapshot store)
    and a record tail: both packages' load_session give the same state and
    report, from either package's journal files."""
    recs = _synth(np.random.default_rng(4), n_req=6)
    k = len(recs) // 2
    head = recovery.replay(None, recs[:k], stop_token=STOP)
    meta = _as_meta(head)
    meta.update(predictor={"kind": "ewma", "value": 3.5, "n_obs": 2},
                counters={"dispatches": 7}, pool_stats=None, u_now=4.0)
    blob = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    for name, cls in (("port", JournalLog), ("jax", JaxJournal)):
        j = cls(tmp_path / name)
        for r in recs[:k]:
            j.append_record(r)
        store = (recovery._snap_store if name == "port"
                 else jrec._snap_store)(tmp_path / name)
        store.save(1, {"meta": blob}, keep_last=2)
        seq = j.append_record({"t": "snap", "id": 1})
        j.compact(seq)
        for r in recs[k:]:
            j.append_record(r)
        j.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for d in ("port", "jax"):
        got = recovery.load_session(tmp_path / d, stop_token=STOP)
        want = jrec.load_session(tmp_path / d, stop_token=STOP)
        assert got == want
        state, rep = got
        assert rep == {"snapshot_id": 1, "records_replayed": len(recs) - k,
                       "journal_torn_bytes": 0}
        assert _canon(state) == _canon(recovery.replay(None, recs,
                                                       stop_token=STOP))
        assert state["predictor"]["value"] == 3.5
