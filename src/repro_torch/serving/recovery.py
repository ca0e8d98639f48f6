"""Crash recovery for the serving engine: snapshot + bounded journal replay.

A copy of ``repro.serving.recovery`` whose :func:`recover_engine` builds
the port's engine.  The recovery contract: after a kill at *any* journal
record boundary, a warm restart reproduces the unkilled run's output tokens
bit for bit (at ``pool_dtype`` float32, and at bf16 on the card, whose
decode batch is always ``max_batch`` rows through batch-invariant kernels).
The journal records only *request-level* state transitions (submits,
admissions, emitted tokens, finishes), never device tensors: greedy decode
is per-sequence deterministic over the paged pool (attention reads only a
sequence's own pages; batch composition and compaction change Wamp, not
tokens), so a live sequence's K/V is cheaper to *recompute* than to
persist.  Recovery therefore:

1. opens the journal (torn tail truncated), finds the last ``snap`` marker,
   and restores that snapshot's session blob from the manifest store;
2. replays the surviving records (bounded by the snapshot cadence) to
   rebuild the request table: finished outputs, emitted-so-far buffers,
   admission priority, the rid cursor, predictor and Wamp counters;
3. hands every live sequence to the engine's *resume* path: the prompt
   re-prefills as at its original admission (same token bucket, same
   kernel) and decode re-derives the already-emitted span: every op
   repeats the original arithmetic.

Replay is a pure function of snapshot + records and survives repeated
crashes: emits are keyed by rid and append in seq order, and a resumed
sequence's re-decoded span is never re-journaled (the engine's ``_jskip``
ledger), so a second crash replays the concatenation.  The records and the
session blob are the JAX engine's, so either package recovers the other's
journal.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np

from ..checkpoint.logstore import LogStructuredCheckpointStore
from ..core.logstructure import JournalLog, StoreStats

# engine-side counters mirrored through the session snapshot
_COUNTERS = (
    ("preemptions", "preemptions"), ("resumes", "resumes"),
    ("recomputed_tokens", "recomputed_tokens"),
    ("dispatches", "dispatches"), ("shed_count", "shed_count"),
    ("prefill_chunks_dispatched", "prefill_chunks_dispatched"),
    ("prefill_tokens_total", "_prefill_tokens_total"),
    ("prefill_tokens_saved", "_prefill_tokens_saved"),
)


def _snap_store(root) -> LogStructuredCheckpointStore:
    """The session-snapshot manifest store, nested under the journal root
    (``snap/`` doesn't match the ``journal_*.log`` glob)."""
    return LogStructuredCheckpointStore(Path(root) / "snap",
                                        seg_bytes=1 << 20,
                                        chunk_bytes=64 << 10)


def snapshot(engine) -> int:
    """Checkpoint the engine's session state and truncate the journal.

    Ordering is the crash-safety invariant: the manifest store's ``save``
    completes (durably, synchronously) *before* the ``snap`` marker is
    journaled, so a journaled marker always references a restorable
    snapshot; only then are the superseded records compacted away (E = 1
    reclamation — journal truncation moves nothing)."""
    state = engine.session_state()
    blob = np.frombuffer(json.dumps(state).encode("utf-8"), np.uint8)
    sid = engine._snap_id + 1
    if engine._snap_store is None:
        engine._snap_store = _snap_store(engine.journal.root)
    # the session blob is the recovery input; the raw slot/refcount views
    # ride along for offline forensics (they are rebuilt, not restored)
    engine._snap_store.save(sid, {
        "meta": blob,
        "bt": engine.bt.copy(),
        "rid": engine.rid.copy(),
        "npages": engine.npages.copy(),
        "block_ref": np.asarray(engine.pool.block_ref).copy(),
    }, keep_last=2)
    engine._snap_id = sid
    seq = engine._jrec({"t": "snap", "id": sid})
    if seq is not None:
        engine.journal.compact(seq)
    return sid


def replay(meta: dict | None, records: list[dict],
           stop_token: int | None = None) -> dict:
    """Pure replay: (snapshot blob, post-snapshot records) -> session state.

    Only ``sub``/``adm``/``first``/``emit``/``fin`` drive the rebuild; the
    allocation/move/release records are audit trail (physical placement is
    re-derived by re-prefilling, the page contents died with device HBM).
    Requests whose completing ``emit`` survived but whose ``fin`` was lost
    to the crash are finalized by the completeness rule: the output hit its
    cap or ends with the stop token.
    """
    reqs: dict[int, dict] = {}
    finished: dict[int, list[int]] = {}
    next_rid = 0
    predictor: dict = {}
    counters: dict = {}
    pool_stats = None
    u_now = 0.0
    if meta is not None:
        for e in meta["live"] + meta["resume"]:
            reqs[int(e["rid"])] = {"prompt": e["prompt"],
                                   "max_new": int(e["max_new"]),
                                   "out": list(e["out"]), "prio": True}
        for e in meta["queue"]:
            reqs[int(e["rid"])] = {"prompt": e["prompt"],
                                   "max_new": int(e["max_new"]),
                                   "out": list(e["out"]), "prio": False}
        finished = {int(k): list(v) for k, v in meta["finished"].items()}
        next_rid = int(meta["next_rid"])
        predictor = dict(meta.get("predictor") or {})
        counters = dict(meta.get("counters") or {})
        pool_stats = meta.get("pool_stats")
        u_now = float(meta.get("u_now", 0.0))
    for r in records:
        t = r["t"]
        if t == "sub":
            reqs[int(r["rid"])] = {"prompt": r["p"], "max_new": int(r["n"]),
                                   "out": [], "prio": False}
            next_rid = max(next_rid, int(r["rid"]) + 1)
        elif t == "adm":
            e = reqs.get(int(r["rid"]))
            if e is not None:  # it ran: recovery resumes it before the queue
                e["prio"] = True
        elif t == "first":
            e = reqs.get(int(r["rid"]))
            if e is not None and not e["out"]:
                e["out"].append(int(r["tok"]))
        elif t == "emit":
            for rid, toks in zip(r["r"], r["k"]):
                e = reqs.get(int(rid))
                if e is not None:
                    e["out"].extend(int(t_) for t_ in toks)
        elif t == "fin":
            e = reqs.pop(int(r["rid"]), None)
            if e is not None:
                finished[int(r["rid"])] = e["out"]
        # snap / al / mv / rel / pre / rec: forensic only
    for rid in [rid for rid, e in reqs.items()
                if len(e["out"]) >= e["max_new"]
                or (stop_token is not None and e["out"]
                    and e["out"][-1] == stop_token)]:
        finished[rid] = reqs.pop(rid)["out"]
    pending = ([(rid, e) for rid, e in reqs.items() if e["prio"]]
               + [(rid, e) for rid, e in reqs.items() if not e["prio"]])
    return {"finished": finished, "pending": pending, "next_rid": next_rid,
            "predictor": predictor, "counters": counters,
            "pool_stats": pool_stats, "u_now": u_now}


def load_session(journal_dir, *, stop_token: int | None = None):
    """Open (and torn-tail-truncate) the journal, restore the last
    journaled snapshot, and replay the surviving records.  Returns
    ``(state, report)``; the journal is closed again (the recovering engine
    reopens it for append)."""
    j = JournalLog(journal_dir)
    recs = list(j.iter_records())
    torn_bytes = j.torn_bytes
    j.close()
    snap_seq, snap_id = -1, 0
    for seq, r in recs:
        if r.get("t") == "snap":
            snap_seq, snap_id = seq, int(r["id"])
    meta = None
    if snap_id:
        leaves = _snap_store(journal_dir).restore(snap_id)
        meta = json.loads(np.asarray(leaves["meta"], np.uint8)
                          .tobytes().decode("utf-8"))
    tail = [r for seq, r in recs if seq > snap_seq]
    state = replay(meta, tail, stop_token)
    state["snap_id"] = snap_id
    report = {"snapshot_id": snap_id, "records_replayed": len(tail),
              "journal_torn_bytes": torn_bytes}
    return state, report


def _apply_session(eng, state: dict) -> dict:
    """Install a replayed session into a freshly constructed engine: the
    request-level state is restored exactly; every live sequence enters the
    *resume* queue (prompt re-prefilled, emitted span re-decoded
    bit-identically), never-admitted requests re-enter the submit queue in
    order."""
    from .engine import Request  # local: engine imports this module lazily

    eng.finished = {int(k): list(v) for k, v in state["finished"].items()}
    eng._next_rid = int(state["next_rid"])
    pred = state.get("predictor") or {}
    if (pred.get("kind") == eng.length_predictor.name
            and hasattr(eng.length_predictor, "value")
            and pred.get("value") is not None):
        eng.length_predictor.value = float(pred["value"])
        eng.length_predictor.n_obs = int(pred.get("n_obs", 0))
    c = state.get("counters") or {}
    for key, attr in _COUNTERS:
        if key in c:
            setattr(eng, attr, int(c[key]))
    if state.get("pool_stats"):
        # cumulative Wamp accounting continues across the restart; the
        # physical pool itself restarts empty (pages re-fill on re-prefill)
        eng.pool.core.stats = StoreStats(**state["pool_stats"])
        eng.pool.core.u_now = float(state.get("u_now", 0.0))
    eng._snap_id = int(state.get("snap_id", 0))

    resumed = requeued = tokens_replayed = 0
    for rid, e in state["pending"]:
        prompt = np.asarray(e["prompt"], np.int32)
        if e["out"]:
            out = np.empty(int(e["max_new"]), np.int32)
            out[:len(e["out"])] = e["out"]
            eng._resume.append(Request(int(rid), prompt, int(e["max_new"]),
                                       out=out, out_n=len(e["out"])))
            tokens_replayed += len(prompt) + len(e["out"]) - 1
            resumed += 1
        elif e["prio"]:
            # admitted but crashed before its first token: restart is a
            # plain resume-queue re-prefill of the whole prompt
            eng._resume.append(Request(int(rid), prompt, int(e["max_new"])))
            tokens_replayed += len(prompt)
            resumed += 1
        else:
            eng.queue.append(Request(int(rid), prompt, int(e["max_new"])))
            requeued += 1
    return {"sequences_resumed": resumed, "requests_requeued": requeued,
            "tokens_replayed": tokens_replayed}


def recover_engine(model, journal_dir, **engine_kw):
    """Warm-restart a killed serving session: rebuild the port's engine from
    the journal and return ``(engine, report)``.  ``engine_kw`` must match
    the dead engine's configuration (it is the serving config, not state),
    ``device`` included (the card unless ``device="cpu"``);
    ``journal_dir`` is reopened for append, so the recovered session keeps
    journaling, and can itself be killed and recovered again.  The
    observability arguments pass through as well: ``tracer=`` reaches the
    rebuilt engine, its pool's core and its journal's core."""
    t0 = time.perf_counter()
    state, report = load_session(journal_dir,
                                 stop_token=engine_kw.get("stop_token"))
    from .engine import PagedServingEngine
    eng = PagedServingEngine(model, journal_dir=journal_dir, **engine_kw)
    report.update(_apply_session(eng, state))
    report["recovery_wall_s"] = time.perf_counter() - t0
    eng.recovery = report
    eng._jrec({"t": "rec", "resumed": report["sequences_resumed"],
               "requeued": report["requests_requeued"]})
    return eng, report
