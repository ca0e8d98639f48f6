"""Log-structured checkpoint store with MDC garbage collection.

A copy of ``repro.checkpoint.logstore`` for numpy leaves, which the serving
engine's session snapshots use (``serving.recovery``); its training-side
user, the checkpoint manager, is not ported yet.

The paper's *variable-size page* case (§4.4): a "page" is one chunk of one
leaf, a "segment" is one append-only segment file on disk.  Saves are
incremental: only chunks whose content changed are appended; unchanged
chunks are re-referenced.  Old chunk versions die in place when the last
retained step referencing them is dropped, so segment files checkerboard,
and GC evacuates live chunks ordered by the paper's variable-size
declining-cost key

    -dCost/du ∝ ((B-A)/A)^2 · 1/(C·(u_now - u_p2))        (§5.1.3)

with the clock ticking once per chunk death, u_p2 carry-forward per §5.2.2
(supersede: new = old + 0.5·(now-old); GC move: inherit the segment mean;
first write: coldest of the batch), and GC survivors sorted by u_p2 before
re-packing (§5.3).

All segment accounting lives in the shared byte-accounted core
(:class:`repro_torch.core.logstructure.ByteLog`); this module owns what is
checkpoint-shaped: segment *files*, chunk versions and their step pins,
manifests, and restore.  Wamp is *bytes moved / bytes written*.  The files
and ``store_state.json`` are the JAX store's, so either package opens the
other's store.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib

import numpy as np

from ..core.logstructure import USED, ByteLog, Placement, StoreStats

__all__ = ["LogStructuredCheckpointStore", "ChunkVersion", "StoreStats"]

_FIRST_WRITE_COLD = 0.0

@dataclasses.dataclass
class ChunkVersion:
    key: str            # "<leaf path>#<chunk idx>"
    seg: int            # segment id
    offset: int
    size: int
    sha: str
    up2: float
    pins: set = dataclasses.field(default_factory=set)  # steps referencing


class _SegView:
    """Read-through view of one segment: core accounting + its file path."""

    __slots__ = ("_core", "sid", "path")

    def __init__(self, core: ByteLog, sid: int, path: pathlib.Path):
        self._core = core
        self.sid = sid
        self.path = path

    @property
    def written(self) -> int:          # B
        return int(self._core.seg_written[self.sid])

    @property
    def live_bytes(self) -> int:       # B - A
        return int(self._core.seg_live_bytes[self.sid])

    @property
    def live_chunks(self) -> int:      # C
        return int(self._core.seg_live[self.sid])

    @property
    def up2(self) -> float:
        return float(self._core.seg_up2[self.sid])

    @property
    def up2_sum(self) -> float:
        return float(self._core.seg_up2sum[self.sid])

    @property
    def sealed(self) -> bool:
        return bool(self._core.seg_state[self.sid] == USED)


class LogStructuredCheckpointStore:
    """Append-only segment files + MDC cleaning.  Not thread-safe; the
    CheckpointManager serializes access."""

    def __init__(self, root: str | pathlib.Path, *, seg_bytes: int = 8 << 20,
                 chunk_bytes: int = 1 << 20, policy: str = "mdc",
                 gc_dead_frac: float = 0.35, gc_batch: int = 4,
                 streams: int = 4, tracer=None):
        self.root = pathlib.Path(root)
        (self.root / "segments").mkdir(parents=True, exist_ok=True)
        (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        self.seg_bytes = seg_bytes
        self.chunk_bytes = chunk_bytes
        self.policy = policy
        self.gc_dead_frac = gc_dead_frac
        self.gc_batch = gc_batch
        self.streams = max(1, int(streams))

        self.core = ByteLog(n_streams=self.streams)
        # segment-lifecycle events (seg.open/seal/evacuate/clean) flow to
        # the optional obs tracer, like every other core frontend
        self.core.tracer = tracer
        self.segments: dict[int, _SegView] = {}
        self.versions: dict[str, list[ChunkVersion]] = {}  # key -> versions
        self.steps: dict[int, dict] = {}  # step -> manifest dict
        self._load_state()

    @property
    def stats(self) -> StoreStats:
        return self.core.stats

    @property
    def u_now(self) -> float:
        return self.core.u_now

    # ----------------------------------------------------------- persistence
    def _state_path(self) -> pathlib.Path:
        return self.root / "store_state.json"

    def _save_state(self) -> None:
        state = {
            "u_now": self.core.u_now,
            "next_sid": self.core.next_sid,
            "open_sids": [int(x) for x in self.core.streams.open],
            "segments": {
                str(s.sid): dict(written=s.written, live_bytes=s.live_bytes,
                                 live_chunks=s.live_chunks, up2=s.up2,
                                 up2_sum=s.up2_sum, sealed=s.sealed,
                                 stream=int(self.core.seg_stream[s.sid]))
                for s in self.segments.values()},
            "versions": {
                key: [dict(seg=v.seg, offset=v.offset, size=v.size, sha=v.sha,
                           up2=v.up2, pins=sorted(v.pins)) for v in vs]
                for key, vs in self.versions.items()},
            "steps": {str(k): v for k, v in self.steps.items()},
            "stats": dataclasses.asdict(self.core.stats),
        }
        tmp = self._state_path().with_suffix(".tmp")
        tmp.write_text(json.dumps(state))
        tmp.replace(self._state_path())  # atomic: a torn save never corrupts

    def _load_state(self) -> None:
        p = self._state_path()
        if not p.exists():
            return
        state = json.loads(p.read_text())
        self.core.u_now = state["u_now"]
        for sid_s, d in state["segments"].items():
            sid = int(sid_s)
            self.core.restore_segment(sid, **d)
            self.segments[sid] = _SegView(self.core, sid, self._seg_path(sid))
            self._truncate_torn_tail(self.segments[sid])
        # a store reopened with fewer streams can leave unsealed segments
        # that no stream claims — seal them so GC can reclaim their space
        claimed = {int(x) for x in self.core.streams.open if int(x) >= 0}
        for sid, seg in self.segments.items():
            if not seg.sealed and sid not in claimed:
                self.core.seal(sid)
        self.core.next_sid = max(self.core.next_sid, state["next_sid"])
        for key, vs in state["versions"].items():
            self.versions[key] = [
                ChunkVersion(key, v["seg"], v["offset"], v["size"], v["sha"],
                             v["up2"], set(v["pins"])) for v in vs]
        self.steps = {int(k): v for k, v in state["steps"].items()}
        self.core.stats = StoreStats(**state["stats"])

    def _seg_path(self, sid: int) -> pathlib.Path:
        return self.root / "segments" / f"seg_{sid:06d}.bin"

    @staticmethod
    def _truncate_torn_tail(seg: _SegView) -> None:
        """Drop bytes appended after the last committed store state.

        store_state.json is written atomically *after* segment appends, so a
        crash mid-save can leave a segment file longer than its recorded
        ``written`` — those tail bytes are referenced by no chunk version and
        are safely truncated.  A *shorter* file means referenced data is
        gone: that is real corruption, refuse to open."""
        if not seg.path.exists():
            if seg.written == 0:
                return
            raise RuntimeError(
                f"checkpoint segment {seg.path.name} missing "
                f"({seg.written} bytes recorded)")
        size = seg.path.stat().st_size
        if size > seg.written:
            with seg.path.open("r+b") as f:
                f.truncate(seg.written)
        elif size < seg.written:
            raise RuntimeError(
                f"checkpoint segment {seg.path.name} truncated below "
                f"committed state ({size} < {seg.written} bytes)")

    # -------------------------------------------------------------- segments
    def _open_segment(self, stream: int = 0) -> _SegView:
        sid, fresh = self.core.open_stream(stream)
        if fresh:
            seg = _SegView(self.core, sid, self._seg_path(sid))
            seg.path.write_bytes(b"")
            self.segments[sid] = seg
        return self.segments[sid]

    def _seal(self, sid: int) -> None:
        self.core.seal(sid)

    def _append(self, data: bytes, p: Placement) -> tuple[int, int]:
        """Route and append one chunk payload; returns (segment id, offset).

        The :class:`Placement` hint carries the exact u_p2 tag and the
        predicted invalidation time; routing (which of the k death-stream
        segment files receives the chunk) happens in the shared core."""
        stream = int(self.core.route(p, 1)[0])
        seg = self._open_segment(stream)
        if seg.written + len(data) > self.seg_bytes and seg.written > 0:
            self._seal(seg.sid)
            seg = self._open_segment(stream)
        with seg.path.open("ab") as f:
            off = f.tell()
            f.write(data)
        self.core.append_bytes(seg.sid, len(data), p)
        if seg.written >= self.seg_bytes:
            self._seal(seg.sid)
        return seg.sid, off

    # ------------------------------------------------------------------ save
    def save(self, step: int, leaves: dict[str, np.ndarray],
             keep_last: int = 0) -> dict:
        """Incremental save.  ``leaves``: flat {path: host ndarray}.  Returns
        the manifest.  ``keep_last``>0 drops older steps (their chunk pins)."""
        manifest = {"step": step, "leaves": {}}
        # Phase 1 — diff against the latest versions.  The §5.2.2 first-write
        # u_p2 (coldest of the batch) is only known once the whole batch has
        # been scanned, so new chunks are collected here and appended in
        # phase 2 with their *exact* tag — no placeholder-then-retag.
        pending: list[tuple[str, bytes, str, float | None]] = []
        for path, arr in leaves.items():
            arr = np.ascontiguousarray(arr)
            raw = arr.tobytes()
            chunks = []
            n = max(1, -(-len(raw) // self.chunk_bytes))
            for ci in range(n):
                data = raw[ci * self.chunk_bytes:(ci + 1) * self.chunk_bytes]
                key = f"{path}#{ci}"
                sha = hashlib.sha1(data).hexdigest()
                vs = self.versions.get(key)
                latest = vs[-1] if vs else None
                if latest is not None and latest.sha == sha:
                    latest.pins.add(step)       # unchanged: re-reference
                    chunks.append(key)
                    continue
                if latest is not None:
                    # §5.2.2 non-first write: supersede event updates u_p2
                    up2 = latest.up2 + 0.5 * (self.u_now - latest.up2)
                    self._unpin_from_latest(latest, step)
                else:
                    up2 = None                   # first write: assign below
                pending.append((key, data, sha, up2))
                chunks.append(key)
            manifest["leaves"][path] = {
                "dtype": str(arr.dtype), "shape": list(arr.shape),
                "chunks": chunks}

        # Phase 2 — append with exact tags.  est_death is one mean supersede
        # interval ahead of now (§5.2.2's estimator); first writes carry the
        # batch-coldest tag, which routes them to the cold streams where
        # never-changing leaves (frozen params) belong.
        known = [u for _, _, _, u in pending if u is not None]
        cold = min(known) if known else _FIRST_WRITE_COLD
        for key, data, sha, up2 in pending:
            tag = cold if up2 is None else up2
            sid, off = self._append(data, Placement(
                up2=tag, est_death=2.0 * self.u_now - tag))
            self.versions.setdefault(key, []).append(
                ChunkVersion(key, sid, off, len(data), sha, tag, {step}))

        self.steps[step] = manifest
        json_path = self.root / "manifests" / f"step_{step:09d}.json"
        json_path.write_text(json.dumps(manifest))

        if keep_last > 0:
            for old in sorted(self.steps)[:-keep_last]:
                self.drop_step(old)
        self.maybe_gc()
        self._save_state()
        return manifest

    def _unpin_from_latest(self, v: ChunkVersion, new_step: int) -> None:
        """The new save supersedes v *for this step onward*; v stays alive
        while older retained steps pin it."""
        if not v.pins:
            self._kill(v)

    def drop_step(self, step: int) -> None:
        if step not in self.steps:
            return
        man = self.steps.pop(step)
        for path, meta in man["leaves"].items():
            for key in meta["chunks"]:
                for v in self.versions.get(key, []):
                    if step in v.pins:
                        v.pins.discard(step)
                        if not v.pins:
                            self._kill(v)
        (self.root / "manifests" / f"step_{step:09d}.json").unlink(
            missing_ok=True)

    def _kill(self, v: ChunkVersion) -> None:
        """A chunk version died: tick the clock, checkerboard its segment."""
        if v.seg not in self.segments:
            return
        self.core.kill_bytes(v.seg, v.size, v.up2)
        self.versions[v.key].remove(v)
        if not self.versions[v.key]:
            del self.versions[v.key]
        sid = v.seg
        if self.core.seg_state[sid] == USED and self.core.seg_live[sid] == 0:
            self._delete_segment(sid)

    def _delete_segment(self, sid: int) -> None:
        self.segments[sid].path.unlink(missing_ok=True)
        self.core.release(np.array([sid]))
        self.core.streams.clear_seg(sid)
        del self.segments[sid]

    # -------------------------------------------------------------------- gc
    def dead_frac(self) -> float:
        total = int(self.core.seg_written.sum())
        live = int(self.core.seg_live_bytes.sum())
        return (total - live) / max(total, 1)

    def maybe_gc(self) -> int:
        cleaned = 0
        while self.dead_frac() > self.gc_dead_frac:
            n = self.gc()
            if n == 0:
                break
            cleaned += n
        return cleaned

    def select_victims(self, k: int) -> list[int]:
        return [int(s) for s in self.core.select_victims(self.policy, k)]

    def gc(self, k: int | None = None) -> int:
        """Evacuate up to k victim segments; returns segments cleaned."""
        victims = self.select_victims(k or self.gc_batch)
        if not victims:
            return 0
        movers: list[tuple[ChunkVersion, bytes, float, int]] = []
        for sid in victims:
            seg = self.segments[sid]
            data = seg.path.read_bytes()
            up2 = seg.up2
            src = int(self.core.seg_stream[sid])
            for vs in self.versions.values():
                for v in vs:
                    if v.seg == sid:
                        # §5.2.2 GC write: u_p2 from the containing segment
                        movers.append((v, data[v.offset:v.offset + v.size],
                                       up2, src))
        # §5.3: sort survivors by u_p2 (hottest together)
        movers.sort(key=lambda t: -t[2])
        # SepBIT survivor inference: each mover re-enters one stream colder
        # than the one that wrote it (pre-stream segments route by est_death)
        demoted = self.core.demote_streams(
            np.array([m[3] for m in movers], dtype=np.int64),
            np.array([2.0 * self.u_now - m[2] for m in movers]))
        # one clean cycle: core accounts E / moved bytes and frees the victims
        self.core.evacuate_accounting(np.asarray(victims))
        for sid in victims:
            self._delete_segment(sid)  # release is idempotent on FREE segs
        for (v, data, up2, _), stream in zip(movers, demoted):
            v.up2 = up2
            sid, off = self._append(data, Placement(
                up2=up2, stream=int(stream), kind="gc"))
            v.seg, v.offset = sid, off
        return len(victims)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        return max(self.steps) if self.steps else None

    def restore(self, step: int | None = None) -> dict[str, np.ndarray]:
        if step is None:
            step = self.latest_step()
        if step is None or step not in self.steps:
            raise FileNotFoundError(f"no checkpoint for step {step}")
        man = self.steps[step]
        out = {}
        for path, meta in man["leaves"].items():
            parts = []
            for key in meta["chunks"]:
                v = self._version_for(key, step)
                with self.segments[v.seg].path.open("rb") as f:
                    f.seek(v.offset)
                    parts.append(f.read(v.size))
            raw = b"".join(parts)
            out[path] = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])
                                      ).reshape(meta["shape"]).copy()
        return out

    def _version_for(self, key: str, step: int) -> ChunkVersion:
        for v in self.versions.get(key, []):
            if step in v.pins:
                return v
        raise KeyError(f"chunk {key} has no live version for step {step}")

    # ------------------------------------------------------------ invariants
    def check_invariants(self) -> None:
        live_b = {sid: 0 for sid in self.segments}
        live_c = {sid: 0 for sid in self.segments}
        for vs in self.versions.values():
            for v in vs:
                assert v.pins, f"unpinned version survived: {v.key}"
                assert v.seg in self.segments, f"dangling segment {v.seg}"
                live_b[v.seg] += v.size
                live_c[v.seg] += 1
        for sid, seg in self.segments.items():
            assert seg.live_bytes == live_b[sid], (sid, seg.live_bytes, live_b[sid])
            assert seg.live_chunks == live_c[sid]
            assert seg.path.stat().st_size == seg.written
        for step, man in self.steps.items():
            for meta in man["leaves"].values():
                for key in meta["chunks"]:
                    self._version_for(key, step)
