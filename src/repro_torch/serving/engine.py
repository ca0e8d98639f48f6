"""Paged serving engine: continuous batching over the log-structured KV pool.

The port of the main path of ``repro.serving.engine.PagedServingEngine``.
The engine owns the tensor pool (per-layer K/V page arrays) and executes on
the device the two data paths the host-side pool manager plans:

  * decode      — up to ``max_decode_chunk`` tokens for every active slot per
                  dispatch; each token writes its K/V in place at
                  ``(page, off)`` and attends through the block tables with
                  the ``paged_attention`` kernel;
  * compaction  — the paper's cleaning: move the live pages of MDC victims
                  to their new pages with the ``segment_move`` kernel (K and
                  V of every layer in one launch), and remap the block
                  tables;

plus the bucketed monolithic prefill, whose attention is the
``flash_attention`` kernel, and the scatter of the prompt's K/V into pages.

Chunked prefill (``prefill_chunk=C``) co-schedules prefill with decode: a
prompt prefills ``C`` tokens per dispatch instead of one monolithic
prefill at admission, so the decoding slots never wait a whole prompt.  A
*fused* dispatch gathers the prefilling slot's key extent from the pool
(padded to the whole prompt's bucket), runs one chunk through the flash
kernel with a query offset at the chunk's position, scatters the chunk's
K/V into its pages, runs the usual decode loop for the other slots, and
reads the decode tokens and the chunk's first token in one host sync.
One prefill is in flight at a time; its slot stays out of the decode
batch until its final chunk lands.

Two scheduling features ride on the pool's reference counts:

  * prefix cache (``prefix_cache=True``) — full prompt pages enter a radix
    tree (:class:`PrefixCache`); a later prompt with the same prefix
    splices those pages into its block table and prefills only its tail,
    attending the cached prefix K/V through the flash kernel with a query
    offset.  Rows of the tail see the same key extent as a cold prefill of
    the whole prompt, so a hit reproduces the cold prefill's arithmetic;
  * preemption (``preemption=True``) — admission reserves the *predicted*
    output length instead of the worst case, and when the pool cannot
    cover admission or growth, running sequences are preempted (their
    page references dropped) and requeued; a resume re-prefills the
    prompt and re-decodes the emitted span, which reproduces the lost K/V.
    A resume waits for capacity and never preempts a peer: two sequences
    restarting each other would discard each other's progress forever.

Asynchronous, budgeted compaction (``async_compaction=True``) takes the
cleaning out of the dispatch path.  Where the pool's reserve needs upkeep,
the alloc path *fences* the victims a synchronous cycle would pick and
places their survivors (host accounting only), and queues the moves as
sub-plans of at most ``clean_budget`` blocks.  A pump at the start of
every ``step()`` commits the sub-plans moved by the previous step (remaps
the block tables and the prefix tree, releases the victims) and moves the
next ones, up to the scheduler's deficit-weighted budget; the decode of
the same step reads the sources through the not-yet-remapped tables.  On
the card the moves run on a side CUDA stream of their own, ordered against
the main stream only by events (no host sync):

  1. before a move is issued, the side stream waits for the main stream,
     whose earlier work wrote the source pages;
  2. a commit makes the tables point at the destinations, so the main
     stream waits for the move's event before anything it reads next;
  3. a sub-plan whose source the upcoming dispatch writes (a slot's
     current page) commits at once, and the main stream waits for its move
     before the decode writes the destination;
  4. when a moved block dies inside the window (its last reference
     dropped, as by a prefix-cache eviction in admission), its destination
     can be handed out again: the main stream then waits for every move in
     flight before its next write.  A block that dies before its move is
     issued is not moved at all;
  5. a staged move's buffer is allocated while the side stream is current,
     so the caching allocator ties it to that stream;
  6. a drain from the alloc path (capacity needed now) commits the moves in
     flight and moves the rest on the main stream, as synchronous cleaning
     does.

On the CPU the moves run inline, with the same host logic.  On the card
each move marks both pools as used by the side stream
(``Tensor.record_stream``), so a pool freed while a move is still in flight
(the engine dropped mid-window, as by a kill) keeps its memory until the
move is done, instead of handing it to the next allocation on the main
stream.

Crash safety (``journal_dir=...``): the engine appends one small durable
record per request-level state transition to a :class:`JournalLog` (a
byte-accounted log-structured store): submissions, admissions, first and
emitted tokens, finishes, page allocations and releases, compaction moves
and their commits, preemptions and snapshot markers, in the JAX engine's
encoding and order.  ``snapshot_every=k`` checkpoints the request-level
session every k dispatches into a log-structured snapshot store and
truncates the journal behind it.  ``serving.recovery.recover_engine``
rebuilds a killed session from snapshot + replay: every live sequence
re-prefills its prompt and re-decodes its emitted span, which reproduces
its K/V and its tokens.  A :class:`FailureInjector` (``injector=...``)
raises faults at the engine's named operations: a transient fault is
retried up to ``fault_retries`` times, always *before* the operation
starts (the port updates K/V and moves pages in place, so a retry is only
sound from unchanged state), and one at a prefill unwinds the admission.

Observability (``obs``) is opt-in: ``tracer=`` records the request
lifecycles (lane 1), the per-dispatch phase spans (lane 0) and, through the
pool's core and the journal's, the segment lifecycle (lane 2);
``phase_log=True`` keeps each dispatch's wall split into its phases (admit,
alloc, upload, dispatch, host_sync, compaction, journal: :meth:`phase_report`);
``calibration=True`` compares each block's death estimate with its death;
``metrics_every=k`` samples :meth:`metrics` to ``metrics_sink`` every k
dispatches.  Every timestamp comes from one clock (``clock=``, default
``time.perf_counter``), the host's: ``dispatch`` is the time the host takes
to enqueue the dispatch's work and ``host_sync`` the wait for the card's
tokens.  Disabled, each costs one ``is None`` check, and enabled, none
changes a token or a counter, nor reads the card.

Block tables, sequence lengths and last tokens live on the device between
dispatches and are uploaded only when a host event dirtied them.  The host
intervenes only at pre-computed *events* (the next page-boundary crossing,
a completion, an admission), so each dispatch decodes
``n = min(tokens-to-next-event, max_decode_chunk)`` tokens with one host
sync.  Where the JAX engine runs a jitted ``lax.fori_loop`` over donated
pools, the port runs a Python loop of one-token steps on device tensors and
updates the pools in place.

Batch slots are fixed (``max_batch``); inactive slots point at a reserved
trash page and are masked out.  Per-slot bookkeeping is numpy arrays
(``rid``, ``lens``, ``to_gen``, ``npages``, ``tokens``, ``_prefilling``)
plus the ``bt`` block-table matrix.  Supported family: dense (GQA attention).

Tensor-parallel serving (``mesh=``, a ``"model"`` ``DeviceMesh`` from
``launch.mesh.make_serving_mesh``) runs one engine per rank, one process
each, on the same requests.  The host planner is the same on every rank and
runs the same, so every rank holds the same block tables over global page
ids; each rank keeps its own slice of the kv heads: pools
``(L, pages + 1, T, Kh/n, hd)`` and ``wq`` / ``wk`` / ``wv`` cut on their
head axis (:func:`shard_serving_params`), every other parameter whole.  A
rank given a whole model slices it and the caller's model keeps the whole
projections (a rank that builds several engines from one model); a rank
given :func:`shard_model`'s result holds only its own heads.
Attention runs on the local heads (``ops.paged_attention_sharded``,
``ops.flash_attention_sharded``) and ``ops.gather_heads`` joins the ranks'
heads before the replicated ``wo``, so every later contraction runs in full
and in the same order on every rank: the tokens are those of the one-device
engine, and every rank reads the same ones.  Compaction moves each rank's
own pools by the common plan.  When the mesh does not divide the kv heads,
the pools and parameters replicate (``_pool_sharded`` false) and each rank
runs the unsharded path.  Only rank 0 writes the journal and snapshots; the
other ranks keep its accounting (``JournalLog.mirror``), so ``metrics()`` is
the same on every rank.  ``audit()`` also all-gathers a hash of each rank's
block tables, lengths and tokens and fails unless they agree.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.logstructure import FENCED, JournalLog, Placement
from ..device import resolve_device
from ..distributed.fault import TransientFault, backoff_delay
from ..distributed.sharding import (HEAD_SHARDED_PARAMS, KV_POOL_AXES,
                                    resolve_spec, shard, spec_shards)
from ..kernels import ops
from ..models import attention as att
from ..models import transformer as tfm
from ..models.layers import rmsnorm
from ..models.model import Model
from ..obs import DeathCalibration, MetricsLogger
from .kvcache import LogStructuredKVPool
from .prefix_cache import PrefixCache
from .scheduler import (DEFAULT_CLEAN_BUDGET, AdmissionShed,
                        choose_preempt_victims, clean_budget,
                        make_length_predictor, normalize_prefill_chunk,
                        retry_after_estimate)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    # resume state (preempted requests only): the tokens already emitted
    # and how many; a restart re-decodes them from the prompt into this
    # buffer.
    out: np.ndarray | None = None
    out_n: int = 0


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def shard_serving_params(params: dict, mesh, coords=None) -> dict:
    """Tensor-parallel placement of the serving parameters (the JAX
    engine's ``_serving_param_shardings``): where the mesh divides the kv
    heads, ``wq`` / ``wk`` / ``wv`` keep this rank's slice of their head
    axis, as ``SERVING_RULES`` resolve it on ``mesh``; everything else,
    ``wo`` included, stays whole (and where the kv heads do not divide,
    everything does, as the pools replicate).  A replicated ``wo`` after
    the all-gather of the per-head context keeps every cross-head
    contraction whole on every rank, in the one-device engine's order.
    ``coords`` default to this process's place on the mesh."""
    wk = params["blocks"]["attn"]["wk"]
    if not resolve_spec(tuple(wk.shape), HEAD_SHARDED_PARAMS["wk"], mesh):
        return params

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else shard(v, HEAD_SHARDED_PARAMS[k], mesh, coords)
                if k in HEAD_SHARDED_PARAMS else v
                for k, v in tree.items()}
    return walk(params)


def shard_model(model: Model, mesh) -> Model:
    """This rank's model on ``mesh``: ``model``'s parameters through
    :func:`shard_serving_params`, the unsliced ones shared with ``model``.
    Once the caller drops ``model``, the rank holds only its own heads of
    ``wq`` / ``wk`` / ``wv``; an engine on ``mesh`` takes the result as
    the rank's own (a whole model it slices itself, and the whole
    projections stay with the caller's model)."""
    return Model(model.cfg, shard_serving_params(model.params, mesh))


def _from_lead(obj, mesh):
    """``obj`` as rank 0 of ``mesh`` holds it, on every rank."""
    group = mesh.get_group("model")
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


class PagedServingEngine:
    """Continuous-batching engine on the log-structured KV pool.

    Constructor arguments are those of the JAX engine for the features the
    port carries; ``params`` defaults to the model's own, and ``device``
    (default: the CUDA card, raising without one) is where the pools and
    device state live — it must be the parameters' device."""

    def __init__(self, model, *, n_slabs: int = 16, blocks_per_slab: int = 8,
                 page_T: int = 16, max_batch: int = 4, max_seq: int = 512,
                 policy: str = "mdc", params=None, compact_trigger: int = 2,
                 compact_batch: int = 4, streams: int | None = None,
                 demote_survivors: bool = False, max_decode_chunk: int = 32,
                 pool_dtype=torch.bfloat16, stop_token: int | None = None,
                 predictor: str = "ewma", prefix_cache: bool = False,
                 prefix_cache_pages: int = 0, preemption: bool = False,
                 shed_queue_depth: int = 0, prefill_chunk: int = 0,
                 admit_every_dispatch: bool = True,
                 async_compaction: bool = False, clean_budget: int = 0,
                 audit_every: int = 0, journal_dir=None,
                 snapshot_every: int = 0, injector=None,
                 fault_retries: int = 2, fault_backoff_s: float = 0.0,
                 journal_fsync: bool = False, clock=None, tracer=None,
                 metrics_every: int = 0, metrics_sink=None,
                 calibration: bool = False, phase_log: bool = False,
                 device=None, mesh=None):
        cfg = model.cfg
        if cfg.family != "dense":
            raise ValueError(f"the port serves the dense family, not {cfg.family!r}")
        self.model, self.cfg = model, cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else model.params
        if self.params["embed"].device != self.device:
            raise ValueError(f"params live on {self.params['embed'].device}, "
                             f"the engine on {self.device}")
        self.page_T = page_T
        self.max_batch = max_batch
        self.max_pages_per_seq = (max_seq + page_T - 1) // page_T
        self.max_decode_chunk = max_decode_chunk
        self.pool_dtype = pool_dtype
        # prefill_chunk > 0: prompts prefill that many tokens (whole pages)
        # per fused dispatch; 0 keeps the monolithic prefill at admission.
        # admit_every_dispatch: with work waiting under stop-token decode,
        # dispatches shrink to one token so a slot's exit is seen (and
        # admission re-run) at the next token
        self.prefill_chunk = normalize_prefill_chunk(prefill_chunk, page_T)
        self.admit_every_dispatch = admit_every_dispatch

        self.pool = LogStructuredKVPool(
            n_slabs, blocks_per_slab, policy=policy, streams=streams,
            demote_survivors=demote_survivors,
            compact_trigger=compact_trigger, compact_batch=compact_batch)
        self.streams = self.pool.n_open
        # synchronous plan execution: tensor move + block-table remap happen
        # before any compaction-freed page id can be re-allocated
        self.pool.on_compaction = self._execute_plan
        # async, budgeted compaction: planned → in flight → committed.  The
        # synchronous callback above stays the fallback under real pressure
        # (the pool drains the pipeline through on_drain first)
        self.async_compaction = bool(async_compaction)
        self.clean_budget = (int(clean_budget) if clean_budget > 0
                             else DEFAULT_CLEAN_BUDGET)
        self._inflight_plans: list = []   # moved, remap pending
        self._move_events: dict = {}      # id(plan) -> its move's CUDA event
        # the side stream of the moves (on the card) and a hook run on it
        # just before each move there
        self._side = None
        self.before_side_move = None
        self.hazard_commits = 0      # sub-plans committed at once (hazard 3)
        self.drains = 0              # pipeline drains from the alloc path
        self.dead_destination_waits = 0   # hazard 4 occurrences
        self.inflight_boundaries = 0      # steps that ended with a move in flight
        self.sub_plans = 0                # async sub-plans committed
        if self.async_compaction:
            self.pool.on_drain = self._drain_compaction
            # alloc-path trigger crossings fence-plan at this grain
            self.pool.plan_budget = self.clean_budget
            self.pool.on_dead_destination = self._on_dead_destination
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(self.device)
        # audit() every that many dispatches (0: never)
        self.audit_every = audit_every
        # shared-prefix KV reuse: full-page prompt prefixes keyed in a radix
        # tree over the pool's physical pages (refcounted)
        self.prefix_cache = (
            PrefixCache(self.pool, page_T, capacity_pages=prefix_cache_pages)
            if (prefix_cache or prefix_cache_pages) else None)
        self._prefill_tokens_total = 0   # prompt tokens submitted to prefill
        self._prefill_tokens_saved = 0   # of those, served from the cache
        n_pages = n_slabs * blocks_per_slab
        self.trash_page = n_pages  # reserved scratch page for inactive slots

        L, Kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        shape = (L, n_pages + 1, page_T, Kh, hd)
        # tensor parallelism: the pools shard their kv heads where the mesh
        # divides them, else every rank holds them whole
        self.mesh = mesh
        self.rank = 0
        if mesh is not None:
            if tuple(mesh.mesh_dim_names or ()) != ("model",):
                raise ValueError("serving mesh needs one axis named 'model'; "
                                 "use launch.mesh.make_serving_mesh")
            self.rank = mesh.get_local_rank("model")
            spec = resolve_spec(shape, KV_POOL_AXES, mesh)
        self._pool_sharded = mesh is not None and any(
            p is not None for p in spec)
        # the mesh the model and kernels see: None where nothing shards
        self._tp = mesh if self._pool_sharded else None
        if self._pool_sharded:
            local = Kh // spec_shards(spec, mesh)
            held = self.params["blocks"]["attn"]["wk"].shape[2]
            if held == Kh:          # whole heads: keep this rank's slice
                self.params = shard_serving_params(self.params, mesh)
            elif held != local:     # else they are this rank's (shard_model)
                raise ValueError(f"wk holds {held} kv heads: want all {Kh} "
                                 f"or this rank's {local}")
            shape = (L, n_pages + 1, page_T, local, hd)
        self.k_pools = torch.zeros(shape, dtype=pool_dtype, device=self.device)
        self.v_pools = torch.zeros(shape, dtype=pool_dtype, device=self.device)

        # --- host slot state: flat numpy arrays, one row per batch slot ---
        B, P = max_batch, self.max_pages_per_seq
        self.rid = np.full(B, -1, np.int64)       # owning request (-1 free)
        self.lens = np.zeros(B, np.int32)         # current sequence length
        self.to_gen = np.zeros(B, np.int32)       # tokens left to emit
        self.npages = np.zeros(B, np.int32)       # allocated pages per slot
        self.tokens = np.zeros(B, np.int32)       # last emitted token
        self.bt = np.full((B, P), self.trash_page, np.int32)
        self._out = [None] * B                    # per-slot output buffers
        self._out_n = np.zeros(B, np.int32)
        self._prompt: list[np.ndarray | None] = [None] * B
        # a resumed slot re-decodes its already-emitted span; _jskip[i] is
        # how many output tokens were delivered before it was preempted
        self._jskip = np.zeros(B, np.int32)
        # chunked prefill: the slot whose prompt is still prefilling (out of
        # the decode batch), and the one in-flight prefill's progress
        self._prefilling = np.zeros(B, bool)
        self._pf: dict | None = None
        self.prefill_chunks_dispatched = 0

        # --- device mirrors, uploaded only when an event dirties them ------
        self._bt_dev = self._put(self.bt)
        self._lens_dev = self._put(self.lens)
        self._tok_dev = self._put(self.tokens)
        self._act_dev = self._put(self._decoding())
        self._bt_dirty = False
        self._state_dirty = False

        self.queue: collections.deque[Request] = collections.deque()
        self.finished: dict[int, list[int]] = {}
        self._admit_done: list[int] = []  # finished during admission
        # stop_token: requests finish when they emit it, so output length —
        # and every page's est_death — is a *prediction* of the length
        # predictor instead of the exact max_new_tokens
        self.stop_token = stop_token
        self.length_predictor = make_length_predictor(predictor)
        # preemption: when admission stalls and compaction + prefix-cache
        # eviction cannot cover the page deficit, victims are preempted and
        # requeued on _resume, which admission serves first
        self.preemption = preemption
        self._resume: collections.deque[Request] = collections.deque()
        self.preemptions = 0
        self.resumes = 0
        self.recomputed_tokens = 0  # tokens recomputed (prefill + re-decode)
        # shed_queue_depth > 0: when admission has stalled past preemption
        # and the queue is this deep, submit() raises AdmissionShed with a
        # retry-after hint instead of growing head-of-line latency
        self.shed_queue_depth = shed_queue_depth
        self.shed_count = 0
        self._admit_stalled = False
        self._tpot_ewma = 0.05        # s/token (host clock), seeds the hint
        self.dispatches = 0
        self._next_rid = 0
        # --- crash safety: the session journal, snapshots, fault injection.
        # Under a mesh rank 0 writes the journal and the other ranks keep a
        # copy of its accounting that writes nothing
        self.journal = None
        if journal_dir:
            if self.rank == 0:
                self.journal = JournalLog(journal_dir, fsync=journal_fsync)
            if mesh is not None:
                mirror = _from_lead(self.journal.mirror() if self.rank == 0
                                    else None, mesh)
                if self.rank:
                    self.journal = mirror
        self.snapshot_every = snapshot_every
        self.injector = injector
        self.fault_retries = fault_retries
        self.fault_backoff_s = fault_backoff_s
        self.fault_retries_done = 0   # transient faults cleared by retry
        self.fault_unwinds = 0        # admissions unwound by a fault
        self.recovery: dict | None = None   # set by recovery.recover_engine
        self._snap_id = 0
        self._snap_store = None       # the snapshot store, opened lazily
        # --- observability (obs) ------------------------------------------
        # one monotonic, pluggable clock for every engine timestamp:
        # admit_wall, dispatch timing, trace spans and metric rows
        self.clock = clock if clock is not None else time.perf_counter
        # rid -> clock at first admission (the queue wait of TTFT)
        self.admit_wall: dict[int, float] = {}
        self.tracer = tracer
        if tracer is not None:
            self.pool.attach_tracer(tracer)
            if self.journal is not None:
                self.journal.core.tracer = tracer
        self.calibration = (DeathCalibration(n_streams=self.streams)
                            if calibration else None)
        if self.calibration is not None:
            self.pool.enable_calibration(self.calibration)
        self.metrics_every = int(metrics_every)
        self._metrics_logger = (
            MetricsLogger(metrics_sink, clock=self.clock)
            if self.metrics_every and metrics_sink is not None else None)
        # per-dispatch phase splits, kept with phase_log=True or a tracer
        # (bounded: old dispatches roll off)
        self.phase_log = bool(phase_log)
        self.dispatch_phases: collections.deque = collections.deque(
            maxlen=100_000)
        self._phase_acc: dict | None = None

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ----------------------------------------------- crash safety plumbing
    def _jrec(self, rec: dict) -> int | None:
        """Append one record to the session journal (no-op when off).  An
        append goes through the retry path like a device op: a transient
        fault is retried, a hard one ends the engine (better than serving
        unjournaled state)."""
        if self.journal is None:
            return None
        ph = self._phase_acc
        if ph is None:
            return self._with_retries(
                "journal", lambda: self.journal.append_record(rec))
        t = self.clock()
        try:
            return self._with_retries(
                "journal", lambda: self.journal.append_record(rec))
        finally:
            ph["journal"] = ph.get("journal", 0.0) + self.clock() - t

    def _with_retries(self, op: str, fn):
        """Run ``fn`` with fault injection keyed by ``op`` and bounded
        retry with backoff for :class:`TransientFault`.  The injector fires
        *before* ``fn`` starts, so a failed attempt has written nothing (no
        K/V, no page, no device mirror) and the retry starts from the same
        state."""
        for attempt in range(self.fault_retries + 1):
            try:
                if self.injector is not None:
                    self.injector.check(self.dispatches, op=op)
                return fn()
            except TransientFault:
                if attempt == self.fault_retries:
                    raise
                self.fault_retries_done += 1
                delay = backoff_delay(attempt, base_s=self.fault_backoff_s)
                if delay > 0.0:
                    time.sleep(delay)
        raise AssertionError("unreachable")

    def _timed_retries(self, op: str, fn):
        """:meth:`_with_retries` plus phase attribution: with a phase
        accumulator active, ``op``'s wall time lands in the current
        dispatch's split (and a trace span when a tracer is attached)."""
        ph, tr = self._phase_acc, self.tracer
        if ph is None:
            return self._with_retries(op, fn)
        t = self.clock()
        if tr is not None:
            tr.begin(op, cat="engine")
        try:
            return self._with_retries(op, fn)
        finally:
            if tr is not None:
                tr.end(op)
            ph[op] = ph.get(op, 0.0) + self.clock() - t

    # ------------------------------------------------------------- requests
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if (self.shed_queue_depth and self._admit_stalled
                and len(self.queue) >= self.shed_queue_depth):
            # overload: admission stalled past preemption AND the queue is
            # at depth — shed with a retry-after derived from the waiting
            # work at the measured decode rate
            waiting = sum(
                self._predict_remaining(r.max_new_tokens, r.out_n)
                + len(self._eff_prompt(r))
                for q in (self._resume, self.queue) for r in q)
            self.shed_count += 1
            raise AdmissionShed(retry_after_estimate(waiting,
                                                     self._tpot_ewma))
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        if self.tracer is not None:
            self.tracer.async_begin("req", rid, tid=1, cat="request",
                                    prompt_len=len(prompt),
                                    max_new=int(max_new_tokens))
        self._jrec({"t": "sub", "rid": rid,
                    "p": [int(t) for t in np.asarray(prompt)],
                    "n": int(max_new_tokens)})
        return rid

    def slot_active(self, i: int) -> bool:
        return self.rid[i] >= 0

    def _decoding(self) -> np.ndarray:
        """Slots in the decode batch: active and not prefilling."""
        return (self.rid >= 0) & ~self._prefilling

    def slot_pages(self, i: int) -> np.ndarray:
        """Physical pages held by slot i (a view of the block-table row)."""
        return self.bt[i, :self.npages[i]]

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self._resume)
                or bool((self.rid >= 0).any()))

    def _prefill_bucket(self, plen: int, n_pages: int) -> tuple[int, int]:
        """(padded prompt length, prefill cache length).

        The prompt bucket is a power of two (as in the JAX engine, so both
        run the same prefill shapes); the cache length is the smallest
        multiple of ``page_T`` covering both it and the power-of-two page
        bucket."""
        T = self.page_T
        tok_bucket = max(_pow2(plen), _pow2(T))
        max_len = max(_pow2(n_pages) * T, -(-tok_bucket // T) * T)
        return tok_bucket, max_len

    def _eff_prompt(self, req: Request) -> np.ndarray:
        """The token positions a (re)start must hold K/V for: the prompt,
        plus — for a preempted request — the emitted tokens already
        *consumed* by decode (all but the last).  Used for admission sizing
        only: the restart prefills just the prompt and re-decodes the
        emitted span (see ``_start``)."""
        if req.out is None or req.out_n <= 1:
            return req.prompt
        return np.concatenate([req.prompt,
                               req.out[:req.out_n - 1].astype(np.int32)])

    def _predict_remaining(self, max_new: int, emitted: int) -> int:
        """Tokens a request is *predicted* to still emit: exact without stop
        tokens, else the length predictor's estimate in [1, tokens-left]."""
        cap = max(max_new - emitted, 1)
        if self.stop_token is None:
            return cap
        pred = self.length_predictor.predict(max_new)
        return int(np.clip(pred - emitted, 1, cap))

    def _pages_needed(self, req: Request) -> int:
        """Pages admission reserves for a request (prompt + consumed resume
        tokens + remaining output), gross of any cached prefix.  Optimistic
        — the predicted output length instead of ``max_new_tokens`` — only
        with preemption on, which turns an under-prediction into pressure
        the scheduler relieves instead of an OOM."""
        plen_eff = len(self._eff_prompt(req))
        rem = (self._predict_remaining(req.max_new_tokens, req.out_n)
               if self.preemption else max(req.max_new_tokens - req.out_n, 1))
        return (plen_eff + rem + self.page_T - 1) // self.page_T

    def _evictable(self) -> int:
        return self.prefix_cache.evictable() if self.prefix_cache else 0

    def _gate_avail(self, hit_pages: list[int]) -> int:
        """Blocks the admission gate may count: free blocks, fenced victim
        slabs (the alloc path drains the async pipeline when frames run
        short), plus cached prefixes reclaimable on demand (the pool's
        pressure hook evicts them before OOM) — minus the matched pages only
        the tree still references, which the request is about to splice,
        not reclaim.  Cached ids may be stale across a pending remap, so
        they resolve first."""
        pool = self.pool
        overlap = (int((pool.block_ref[pool.resolve(
            np.asarray(hit_pages, np.int64))] == 1).sum()) if hit_pages else 0)
        return (pool.free_blocks() + pool.core.fenced_count() * pool.S
                + max(self._evictable() - overlap, 0))

    def _admit(self) -> None:
        started: list[int] = []
        self._admit_stalled = False
        for i in np.flatnonzero(self.rid < 0):
            if self._pf is not None:
                # chunked mode admits one prefill at a time; admission runs
                # every step(), so the next waits at most the chunk cadence
                break
            # preempted requests resume first: they were admitted once and
            # already carry emitted tokens the caller is waiting on
            q = self._resume if self._resume else self.queue
            if not q:
                break
            req = q[0]
            worst = (len(req.prompt) + req.max_new_tokens + self.page_T - 1
                     ) // self.page_T
            if worst > self.max_pages_per_seq:
                raise ValueError("request exceeds max_seq")
            need = self._pages_needed(req)
            hit_pages: list[int] = []
            if self.prefix_cache is not None:
                # a cached prefix is spliced, not allocated: the need is net
                # of the match (on the prompt, which is what _start prefills)
                hit_pages = self.prefix_cache.match(req.prompt)
                need -= len(hit_pages)
            # the compaction reserve is compact_trigger *slabs*, waived when
            # nothing is active so a request sized to the pool can run alone
            reserve = (self.pool.admission_reserve()
                       if (self.rid >= 0).any() else 0)
            avail = self.pool.free_blocks()
            if avail < need + reserve and self.prefix_cache is not None:
                avail = self._gate_avail(hit_pages)
            if (avail < need + reserve and self.preemption
                    and q is not self._resume):
                # a resume waits for capacity instead: preempting a peer to
                # restart one would let two sequences evict each other
                # forever, each restart discarding the other's progress
                self._preempt_for(need + reserve - avail, keep=started)
                avail = self._gate_avail(hit_pages)  # re-measured gate
            if avail < need + reserve:
                # wait for deaths / compaction; the stall arms load shedding
                self._admit_stalled = True
                break
            q.popleft()
            try:
                self._start(int(i), req, from_resume=q is self._resume)
            except TransientFault:
                # transactional admission: _start gave back the page
                # references it took; the request goes back to the head of
                # its queue and is retried at the next step()
                self.fault_unwinds += 1
                q.appendleft(req)
                break
            started.append(int(i))

    def _preempt_for(self, deficit: int, *, keep=(),
                     min_active: int = 0) -> int:
        """Free at least ``deficit`` blocks by preempting running sequences,
        cheapest declining-cost first (``policies.key_preempt``).  Returns
        the blocks actually freed.

        Progress is *measured* (free blocks + evictable cache pages), not
        estimated from the victims' refcounts: a page freed into a still
        OPEN slab is neither appendable nor compactable until its slab
        drains.  ``keep``: slots never picked (admitted in this pass).
        ``min_active``: stop before the active count drops below it (the
        growth path keeps the last sequence running, or it would preempt a
        sequence to fund its own growth, forever)."""
        pool = self.pool

        def avail() -> int:
            return (pool.free_blocks() + pool.core.fenced_count() * pool.S
                    + self._evictable())

        # committing the async pipeline frees fenced slabs without evicting
        # anyone: always cheaper than preemption, so it goes first
        if pool.on_drain is not None and pool.deferred_moves():
            pool.on_drain()
        start = avail()
        keep = set(int(k) for k in keep)
        while avail() - start < deficit:
            cand = np.array([c for c in np.flatnonzero(self.rid >= 0)
                             if int(c) not in keep], dtype=np.int64)
            if len(cand) == 0 or int((self.rid >= 0).sum()) <= min_active:
                break
            # pages whose *last* reference a preemption drops (shared prefix
            # pages survive in the tree or with other referencers)
            freeable = np.array(
                [int((pool.block_ref[pool.resolve(
                    self.bt[j, :self.npages[j]].astype(np.int64))] == 1).sum())
                 for j in cand])
            remaining = np.array(
                [self._predict_remaining(int(self._out_n[j] + self.to_gen[j]),
                                         int(self._out_n[j])) for j in cand])
            v = choose_preempt_victims(1, recompute=self.lens[cand],
                                       freeable=freeable, remaining=remaining)
            if len(v) == 0:
                break  # no preemptible sequence frees any page
            self._preempt(int(cand[v[0]]))
        return max(avail() - start, 0)

    def _start(self, i: int, req: Request, from_resume: bool = False) -> None:
        # A resume restarts a preempted sequence from scratch: the original
        # prompt goes through the prefill a fresh admission runs, and decode
        # re-derives the emitted span (re-prefilling the consumed tokens
        # instead would compute their K/V with prefill arithmetic where the
        # original used decode arithmetic: close, not bit-equal).
        resume = req.out is not None and req.out_n > 0
        prompt = req.prompt
        plen = len(prompt)
        T = self.page_T
        n_pages = (plen + T - 1) // T
        # §5.3 placement estimator: blocks die when their sequence finishes
        # ⇒ expected death clock = now + blocks that will die then (a
        # re-decoded span counts: those writes happen again)
        est = (self.pool.u_now + plen + max(req.out_n - 1, 0)
               + self._predict_remaining(req.max_new_tokens, req.out_n))

        # shared-prefix lookup: splice cached full pages (CoW-capped: at
        # least one prompt token is always prefilled)
        n_shared = 0
        if self.prefix_cache is not None:
            hit = self.prefix_cache.lookup(prompt)
            n_shared = len(hit)
            if n_shared:
                shared = np.asarray(hit, np.int64)
                # one reference per referencing sequence; the death estimate
                # becomes the max over referencers
                self.pool.incref_pages(shared, est)
                # park the shared ids in the block table *before* the tail
                # alloc: a compaction fired by it remaps this row too
                self.bt[i, :] = self.trash_page
                self.bt[i, :n_shared] = shared
                self.npages[i] = n_shared

        # any compaction fires (and remaps held pages via the callback)
        # before these page ids are handed out.  If the pool still OOMs,
        # the prefix references just taken are given back.
        try:
            pages_new = self.pool.alloc_blocks(
                np.full(n_pages - n_shared, req.rid, dtype=np.int64),
                Placement(est_death=est))
        except Exception:
            if n_shared:
                self.pool.free_pages(self.bt[i, :n_shared].astype(np.int64))
                self.bt[i, :] = self.trash_page
                self.npages[i] = 0
                self._bt_dirty = True
            raise
        if n_shared == 0:
            self.bt[i, :] = self.trash_page
        self.bt[i, n_shared:n_pages] = pages_new
        self.npages[i] = n_pages

        # the prefill's fault point, before any device write: unwinding is
        # host bookkeeping only (drop every reference this admission took;
        # shared prefix pages survive for their other holders)
        if self.injector is not None:
            try:
                self.injector.check(self.dispatches, op="prefill")
            except BaseException:
                self.pool.free_pages(self.bt[i, :n_pages].astype(np.int64))
                self.bt[i, :] = self.trash_page
                self.npages[i] = 0
                self._bt_dirty = True
                raise

        self.admit_wall.setdefault(req.rid, self.clock())
        if self.tracer is not None:
            self.tracer.async_instant(
                "req.resume" if from_resume else "req.admit",
                req.rid, tid=1, cat="request")
        if from_resume:
            self.resumes += 1
        if resume:  # prompt re-prefilled + consumed output tokens re-decoded
            self.recomputed_tokens += plen + req.out_n - 1
        self._prefill_tokens_total += plen
        self._prefill_tokens_saved += n_shared * T
        # admission record: replay resumes the request before fresh queue
        # entries; slot and pages are forensic (placement is rebuilt)
        self._jrec({"t": "adm", "rid": req.rid, "slot": int(i),
                    "res": int(resume), "shr": int(n_shared),
                    "pg": [int(p) for p in pages_new]})
        if self.prefill_chunk:
            # step() feeds the prompt one chunk per fused dispatch
            self._start_chunked(i, req, n_pages, n_shared, est)
            return

        # bucketed prefill (of the uncached tail on a hit), then scatter the
        # whole bucket's pages; pages beyond the allocation land in the
        # trash page
        if n_shared:
            logits, ks, vs, max_len = self._prefill_cont(i, prompt, n_shared,
                                                         n_pages)
        else:
            tok_bucket, max_len = self._prefill_bucket(plen, n_pages)
            toks = np.zeros(tok_bucket, np.int64)
            toks[:plen] = prompt
            logits, cache = tfm.prefill(self.params, self._put(toks)[None],
                                        self.cfg, max_len,
                                        cache_dtype=self.pool_dtype,
                                        true_len=plen, mesh=self._tp)
            ks, vs = cache["k"], cache["v"]
        first_tok = int(torch.argmax(logits[0]))
        L, _, _, Kh, hd = ks.shape
        nb = max_len // T
        pages_pad = np.full(nb, self.trash_page, np.int64)
        pages_pad[:len(pages_new)] = pages_new
        pages_dev = self._put(pages_pad)
        self.k_pools[:, pages_dev] = ks[:, 0].reshape(L, nb, T, Kh, hd)
        self.v_pools[:, pages_dev] = vs[:, 0].reshape(L, nb, T, Kh, hd)

        self._own(i, req)
        self._bt_dirty = True
        if self._graduate(i, prompt, est, first_tok, resume,
                          req.max_new_tokens):
            self._admit_done.append(req.rid)

    def _own(self, i: int, req: Request) -> None:
        """Slot ``i`` takes ``req``: its id, prompt, and the tokens a
        resumed request carries."""
        self.rid[i] = req.rid
        self._prompt[i] = req.prompt
        self._out[i] = req.out
        self._out_n[i] = req.out_n

    def _graduate(self, i: int, prompt: np.ndarray, est: float,
                  first_tok: int, resume: bool, max_new: int) -> bool:
        """Slot ``i``'s prompt is prefilled and ``first_tok`` is its first
        output token: register the prompt's full pages for sharing and
        start decoding.  Returns True when that token already completes the
        request (cap reached, or a fresh start's stop token), which is then
        finished."""
        T, plen = self.page_T, len(prompt)
        # keys already cached keep their page, so a recomputed boundary
        # page stays private to this sequence
        if self.prefix_cache is not None and plen // T:
            self.prefix_cache.insert(prompt, self.bt[i, :plen // T].copy(),
                                     est)
        self.lens[i] = plen
        self.tokens[i] = first_tok
        self.to_gen[i] = max_new - 1
        if resume:
            # keep the carried buffer: decode re-emits the same tokens, and
            # a preemption mid-replay still knows the whole span (_jskip)
            self._jskip[i] = self._out_n[i]
        else:
            self._out[i] = np.empty(max_new, np.int32)
            self._jskip[i] = 0
        self._out[i][0] = first_tok
        self._out_n[i] = 1
        if not resume:
            # journaled before any finish this token causes; a resume's
            # first token was journaled by its original start
            self._jrec({"t": "first", "rid": int(self.rid[i]),
                        "tok": int(first_tok)})
        self._state_dirty = True
        if self.to_gen[i] <= 0 or (not resume and self.stop_token is not None
                                   and first_tok == self.stop_token):
            self._finish(i)
            return True
        return False

    def _prefill_cont(self, i: int, prompt: np.ndarray, n_shared: int,
                      n_pages: int):
        """Prefix-hit prefill: gather the cached prefix K/V of slot ``i``'s
        first ``n_shared`` pages from the pool and run the tail-only
        continuation prefill.  The key extent is the bucket a cold prefill
        of the whole prompt attends over, which is what makes the tail rows
        reproduce the cold prefill's.  Returns (logits, K tail, V tail,
        the tail cache length)."""
        T = self.page_T
        plen, P = len(prompt), n_shared * T
        tlen = plen - P
        tok_bucket, max_len = self._prefill_bucket(tlen, n_pages - n_shared)
        toks = np.zeros(tok_bucket, np.int64)
        toks[:tlen] = prompt[P:]
        pages = self._put(self.bt[i, :n_shared].astype(np.int64))  # post-remap
        L, _, _, Kh, hd = self.k_pools.shape
        k_pre = self.k_pools[:, pages].reshape(L, 1, P, Kh, hd)
        v_pre = self.v_pools[:, pages].reshape(L, 1, P, Kh, hd)
        kv_len = self._prefill_bucket(plen, n_pages)[0]
        logits, ks, vs = tfm.prefill_with_prefix(
            self.params, self._put(toks)[None], self.cfg, k_pre, v_pre,
            max_len, true_len=tlen, kv_len=kv_len,
            cache_dtype=self.pool_dtype, mesh=self._tp)
        return logits, ks, vs, max_len

    def _start_chunked(self, i: int, req: Request, n_pages: int,
                       n_shared: int, est: float) -> None:
        """Park slot ``i`` in the prefilling state: its pages are allocated
        (and a cached prefix spliced) as for a monolithic start, and
        ``step()`` feeds one ``prefill_chunk``-token chunk per fused
        dispatch until :meth:`_pf_complete` moves it into decode.  The slot
        owns its request, pages and prompt from the first chunk, so a
        preemption mid-prefill releases it like a decoding slot."""
        T = self.page_T
        plen = len(req.prompt)
        self._own(i, req)
        self._jskip[i] = 0           # parked: _out_n is the known span
        self.tokens[i] = 0
        self.to_gen[i] = req.max_new_tokens - req.out_n
        # lens tracks prefill progress on the host; the slot is out of the
        # decode batch, so the device never reads it
        self.lens[i] = n_shared * T
        self._prefilling[i] = True
        # kv_len, the whole prompt's token bucket, is the key extent every
        # chunk attends: the extent a monolithic prefill attends
        self._pf = dict(slot=i, prompt=req.prompt, plen=plen,
                        pos=n_shared * T,
                        kv_len=self._prefill_bucket(plen, n_pages)[0],
                        est=est, resume=req.out is not None and req.out_n > 0,
                        max_new=req.max_new_tokens)
        self._bt_dirty = self._state_dirty = True

    def _prefill_chunk(self, pf: dict) -> torch.Tensor | None:
        """One chunk of the in-flight prefill on the device: gather the
        slot's key extent (its block-table row padded with the trash page
        to the prompt's bucket) once for all layers, run the chunk at
        ``pf["pos"]``, scatter its K/V into the chunk's allocated pages.
        The gather reads the pool before the chunk's own scatter, so the
        chunk attends its K/V unrounded, as a monolithic prefill does.
        Returns the first output token (a (1,) device tensor) on the final
        chunk, else None."""
        C, T = self.prefill_chunk, self.page_T
        i, pos, plen, kv_len = pf["slot"], pf["pos"], pf["plen"], pf["kv_len"]
        nb = -(-kv_len // T)
        ext = np.full(nb, self.trash_page, np.int64)
        m = min(nb, self.max_pages_per_seq)
        ext[:m] = self.bt[i, :m]
        # the chunk's own pages; a final chunk's pages past the allocation
        # hold only pad rows and are not written
        p0 = pos // T
        n_own = int(np.clip(self.npages[i] - p0, 0, C // T))
        toks = np.zeros(C, np.int64)
        seg = pf["prompt"][pos:pos + C]
        toks[:len(seg)] = seg
        # one upload: extent pages, the chunk's pages, its tokens
        host = np.concatenate([ext, self.bt[i, p0:p0 + n_own], toks])
        dev = self._put(host)
        ext_dev, own_dev, tok_dev = dev[:nb], dev[nb:nb + n_own], dev[nb + n_own:]
        L, _, _, Kh, hd = self.k_pools.shape
        ext_k = self.k_pools[:, ext_dev].reshape(L, 1, nb * T, Kh, hd)
        ext_v = self.v_pools[:, ext_dev].reshape(L, 1, nb * T, Kh, hd)
        is_last = pos + C >= plen
        logits, ks, vs = tfm.prefill_chunk(
            self.params, tok_dev[None], self.cfg, ext_k[:, :, :kv_len],
            ext_v[:, :, :kv_len], pos, plen - 1 - pos if is_last else None,
            mesh=self._tp)
        rows = n_own * T
        self.k_pools[:, own_dev] = ks[:, 0, :rows].reshape(
            L, n_own, T, Kh, hd).to(self.pool_dtype)
        self.v_pools[:, own_dev] = vs[:, 0, :rows].reshape(
            L, n_own, T, Kh, hd).to(self.pool_dtype)
        if not is_last:
            return None
        return torch.argmax(logits[0]).to(torch.int32).reshape(1)

    def _pf_complete(self, first_tok: int) -> int | None:
        """The final chunk landed: move the prefilling slot into the decode
        batch.  Returns the request id if the prefill token already
        completed the request, else None.  The prefix-cache insert waits
        until now: an in-flight prefill's later pages hold stale K/V that
        no other request may splice."""
        pf, self._pf = self._pf, None
        i = pf["slot"]
        self._prefilling[i] = False
        rid = int(self.rid[i])
        done = self._graduate(i, pf["prompt"], pf["est"], first_tok,
                              pf["resume"], pf["max_new"])
        return rid if done else None

    def _release_slot(self, i: int) -> None:
        """Free slot i's pages (one decref each — shared prefix pages
        survive for their other referencers) and reset its state; an
        in-flight prefill of the slot is abandoned."""
        if self._pf is not None and self._pf["slot"] == i:
            self._pf = None
        self._prefilling[i] = False
        self._jrec({"t": "rel", "rid": int(self.rid[i]),
                    "pg": [int(p) for p in self.slot_pages(i)]})
        self.pool.free_pages(self.slot_pages(i).astype(np.int64))
        self.bt[i, :] = self.trash_page
        self.rid[i] = -1
        self.lens[i] = self.to_gen[i] = self.npages[i] = 0
        self.tokens[i] = 0
        self._out[i] = None
        self._out_n[i] = 0
        self._jskip[i] = 0
        self._prompt[i] = None
        self._bt_dirty = self._state_dirty = True

    def _finish(self, i: int) -> None:
        rid = int(self.rid[i])
        self.finished[rid] = self._out[i][:self._out_n[i]].tolist()
        self.length_predictor.observe(int(self._out_n[i]))
        if self.tracer is not None:
            self.tracer.async_end("req", rid, tid=1, cat="request",
                                  tokens=int(self._out_n[i]))
        self._jrec({"t": "fin", "rid": rid})
        self._release_slot(i)

    def _preempt(self, i: int) -> None:
        """Evict a running sequence under pressure: drop its page references
        and requeue it with its emitted tokens on the resume queue, which
        ``_admit`` serves first; the resume re-prefills the prompt and
        re-decodes the emitted span."""
        self.preemptions += 1
        if self.tracer is not None:
            self.tracer.async_instant("req.preempt", int(self.rid[i]),
                                      tid=1, cat="request")
        self._jrec({"t": "pre", "rid": int(self.rid[i])})
        # a slot preempted mid-replay (out_n < _jskip) still knows the whole
        # emitted span: the carried buffer holds it past out_n
        self._resume.append(Request(
            int(self.rid[i]), self._prompt[i],
            int(self._out_n[i] + self.to_gen[i]),   # original max_new_tokens
            out=self._out[i],
            out_n=int(max(self._out_n[i], self._jskip[i]))))
        self._release_slot(i)

    # ---------------------------------------------------------------- step
    def _sync_device(self) -> None:
        """Upload host state that an event dirtied since the last dispatch."""
        if self._bt_dirty:
            self._bt_dev = self._put(self.bt)
            self._bt_dirty = False
        if self._state_dirty:
            self._lens_dev = self._put(self.lens)
            self._tok_dev = self._put(self.tokens)
            self._act_dev = self._put(self._decoding())
            self._state_dirty = False

    def _event_horizon(self, active: np.ndarray) -> int:
        """Tokens until the earliest host event: a slot crossing into an
        unallocated page (from ``seq_len % page_T``) or finishing.  With
        stop-token decode and work waiting, a slot's exit is invisible to
        the horizon, so with ``admit_every_dispatch`` dispatches shrink to
        one token (every exit is seen — and admission re-run — at the next
        token); without it they keep the horizon's length."""
        if active.any():
            room = self.npages * self.page_T - self.lens
            until = np.minimum(room, self.to_gen)[active]
            n = min(int(until.min()), self.max_decode_chunk)
        else:
            n = 1
        if (self.admit_every_dispatch and self.stop_token is not None
                and (self.queue or self._resume)):
            n = 1
        return max(n, 1)

    def _one_token(self, seq_lens, tokens, active):
        """Decode one token for every slot: write each active slot's new
        K/V at ``(page, off)`` of its current length, attend over
        ``seq_len + 1`` tokens, return the argmax (frozen for inactive
        slots, whose writes go to the trash page)."""
        params, cfg, T = self.params, self.cfg, self.page_T
        B = tokens.shape[0]
        x = tfm._embed(params, tokens[:, None])              # (B, 1, d)
        # a slot frozen at exactly npages*T would index one past its table:
        # clamp, then route every inactive slot to the trash page
        col = torch.clamp(seq_lens // T, max=self.max_pages_per_seq - 1)
        page = self._bt_dev[torch.arange(B, device=self.device), col.long()]
        page = torch.where(active, page, self.trash_page).long()
        off = (seq_lens % T).long()
        pos = seq_lens[:, None]
        attend = seq_lens + 1  # lengths read by attention: the new token too
        for i in range(cfg.n_layers):
            lp = tfm.layer(params["blocks"], i)
            kp, vp = self.k_pools[i], self.v_pools[i]
            q, k, v = att._project_qkv(rmsnorm(x, lp["ln1"]), lp["attn"], cfg,
                                       pos)
            kp[page, off] = k[:, 0].to(kp.dtype)
            vp[page, off] = v[:, 0].to(vp.dtype)
            o = ops.paged_attention(q[:, 0], kp, vp, self._bt_dev, attend,
                                    mesh=self._tp)
            if self._tp is not None:   # every rank's heads before wo
                o = ops.gather_heads(o, self._tp)
            x = x + torch.einsum("bhe,hed->bd", o.to(x.dtype),
                                 lp["attn"]["wo"])[:, None]
            x = x + tfm._block_mlp(rmsnorm(x, lp["ln2"]), lp["mlp"], cfg)
        logits = tfm._unembed(params, x, cfg)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.where(active, nxt, tokens)

    def _decode(self, n: int) -> torch.Tensor:
        """``n`` one-token steps on the device state; returns the emitted
        tokens (n, B).  A slot that emits the stop token freezes for the
        rest of the dispatch (its length, token and K/V writes)."""
        seq_lens, tokens = self._lens_dev, self._tok_dev
        active = self._act_dev
        out = torch.empty((n, self.max_batch), dtype=torch.int32,
                          device=self.device)
        for t in range(n):
            tokens = self._one_token(seq_lens, tokens, active)
            out[t] = tokens
            seq_lens = seq_lens + active.to(torch.int32)
            if self.stop_token is not None:
                active = active & (tokens != self.stop_token)
        self._lens_dev, self._tok_dev = seq_lens, tokens
        return out

    def step(self) -> list[int]:
        """Admit, then decode up to ``max_decode_chunk`` tokens for every
        decoding slot in one dispatch — fused with one chunk of the
        in-flight prefill in chunked mode.  With async compaction the pump
        runs first.  Returns finished request ids.

        With a tracer attached or ``phase_log=True``, each dispatch's wall
        is split into attributed phases (admit, alloc, upload, dispatch,
        host_sync, plus compaction and journal time wherever they fire).
        Disabled (the default), the whole apparatus is one ``None`` check."""
        tr = self.tracer
        ph = {} if (self.phase_log or tr is not None) else None
        self._phase_acc = ph
        t_step = self.clock()
        if tr is not None:
            tr.begin("step", cat="engine", dispatch=self.dispatches)
        try:
            return self._step_impl(ph, tr)
        finally:
            self._phase_acc = None
            if tr is not None:
                tr.counter("pool", free_blocks=self.pool.free_blocks(),
                           queue_depth=len(self.queue) + len(self._resume),
                           active_slots=int((self.rid >= 0).sum()))
                tr.end("step")
            if ph is not None and ph.pop("dispatched", False):
                ph["total"] = self.clock() - t_step
                self.dispatch_phases.append(ph)
            if (self._metrics_logger is not None
                    and self.dispatches % self.metrics_every == 0):
                self._sample_metrics()

    def _step_impl(self, ph, tr) -> list[int]:
        if self.async_compaction:
            self._pump_compaction()
        if ph is None:
            self._admit()
        else:
            t_a = self.clock()
            if tr is not None:
                tr.begin("admit", cat="engine")
            self._admit()
            if tr is not None:
                tr.end("admit")
            ph["admit"] = self.clock() - t_a
        done, self._admit_done = self._admit_done, []
        active = self._decoding()
        if not active.any() and self._pf is None:
            return done
        self.dispatches += 1
        t0 = self.clock()
        if ph is not None:
            ph["dispatched"] = True

        # pages for the incoming tokens must exist before the dispatch writes
        # them; one batched alloc covers every slot at a page boundary
        # (compaction, if it fires, remaps held pages first).  With
        # preemption, an under-predicted lifetime can push growth past the
        # admission reserve: preemption is the backstop before an OOM — but
        # never of the last active sequence
        growing = np.flatnonzero(active & (self.lens >= self.npages * self.page_T))
        if growing.size and self.preemption:
            avail = self.pool.free_blocks() + self._evictable()
            if avail < growing.size:
                self._preempt_for(growing.size - avail, min_active=1)
                active = self._decoding()   # the prefill may be evicted too
                growing = np.flatnonzero(
                    active & (self.lens >= self.npages * self.page_T))
                if not active.any() and self._pf is None:
                    return done
        if growing.size:
            t_al = self.clock() if ph is not None else 0.0
            rem = np.array([self._predict_remaining(
                int(self._out_n[j] + self.to_gen[j]), int(self._out_n[j]))
                for j in growing])
            pages = self.pool.alloc_blocks(
                self.rid[growing],
                Placement(est_death=self.pool.u_now
                          + (self.lens[growing] + rem).astype(np.float64)))
            self.bt[growing, self.npages[growing]] = pages
            self.npages[growing] += 1
            self._bt_dirty = True
            self._jrec({"t": "al", "r": self.rid[growing].tolist(),
                        "pg": pages.tolist()})
            if ph is not None:
                ph["alloc"] = self.clock() - t_al

        n = self._event_horizon(active)
        if ph is None:
            self._sync_device()
        else:
            t_up = self.clock()
            if tr is not None:
                tr.begin("upload", cat="engine")
            self._sync_device()
            if tr is not None:
                tr.end("upload")
            ph["upload"] = self.clock() - t_up
        pf = self._pf
        act = np.flatnonzero(active)

        def dispatch():
            # the chunk's gather reads the pool before the decode writes it;
            # the two touch disjoint pages (the prefilling slot decodes
            # nothing)
            first = self._prefill_chunk(pf) if pf is not None else None
            reads = [self._decode(n).reshape(-1)] if act.size else []
            if first is not None:
                reads.append(first)
            return reads, first

        reads, first = self._timed_retries("dispatch", dispatch)
        # the one host sync: decode tokens and the chunk's first token
        host = self._timed_retries(
            "host_sync",
            lambda: torch.cat(reads).cpu().numpy() if reads else None)
        if pf is not None:
            pf["pos"] += self.prefill_chunk
            self.lens[pf["slot"]] = min(pf["pos"], pf["plen"])
            self.prefill_chunks_dispatched += 1
            if tr is not None:
                tr.async_instant("req.prefill_chunk", int(self.rid[pf["slot"]]),
                                 tid=1, cat="request", pos=int(pf["pos"]))

        # with stop tokens a slot may have stopped mid-dispatch: it emitted
        # tokens up to and including its first stop token
        emitted = np.full(self.max_batch, n, np.int32)
        stopped = np.zeros(self.max_batch, bool)
        if act.size:
            toks = host[:n * self.max_batch].reshape(n, self.max_batch)
            if self.stop_token is not None:
                hit = toks[:, act] == self.stop_token      # (n, |act|)
                has = hit.any(axis=0)
                emitted[act[has]] = hit.argmax(axis=0)[has] + 1
                stopped[act[has]] = True
        for i in act:
            e = int(emitted[i])
            w = self._out_n[i]
            self._out[i][w:w + e] = toks[:e, i]
            self._out_n[i] += e
            self.lens[i] += e            # matches the device: seq_lens froze
            self.to_gen[i] -= e          # with the active mask at the stop
            self.tokens[i] = int(toks[e - 1, i])
        # the emitted tokens are journaled before any finish below (replay
        # must never see a finish whose tokens were lost).  A resumed slot's
        # re-decoded span (indices < _jskip) was journaled by its original
        # run and is sliced off: replay appends emits blindly
        if act.size:
            spans = []
            for i in act:
                e = int(emitted[i])
                b = int(self._out_n[i]) - e
                s = max(b, int(self._jskip[i]))
                spans.append([int(t) for t in self._out[i][s:b + e]])
            if any(spans):
                self._jrec({"t": "emit", "r": [int(self.rid[i]) for i in act],
                            "k": spans})
        for i in act:
            if stopped[i] or self.to_gen[i] <= 0:
                done.append(int(self.rid[i]))
                self._finish(int(i))
        if first is not None:
            fin = self._pf_complete(int(host[-1]))
            if fin is not None:
                done.append(fin)
        tot = int(emitted[act].sum())
        if tot > 0:   # decode-rate EWMA feeds the shed retry-after hint
            dt = self.clock() - t0
            self._tpot_ewma = 0.8 * self._tpot_ewma + 0.2 * (dt / tot)
        if (self.journal is not None and self.snapshot_every
                and self.dispatches % self.snapshot_every == 0):
            self.snapshot()
        if self.audit_every and self.dispatches % self.audit_every == 0:
            self.audit()
        return done

    def run_to_completion(self, max_steps: int = 100_000) -> dict:
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
        return self.finished

    # ----------------------------------------------------------- compaction
    @contextlib.contextmanager
    def _compaction_phase(self, moves: int):
        """Attribute a compaction span to the current dispatch's phase split
        (accumulated: several plans or pumps can fire per dispatch)."""
        ph, tr = self._phase_acc, self.tracer
        t_c = self.clock() if ph is not None else 0.0
        if tr is not None:
            tr.begin("compaction", cat="engine", moves=moves)
        try:
            yield
        finally:
            if tr is not None:
                tr.end("compaction")
            if ph is not None:
                ph["compaction"] = (ph.get("compaction", 0.0)
                                    + self.clock() - t_c)

    def _move_plan(self, plan, *, live: bool = False) -> None:
        """Compaction data path: pool[:, dst] = pool[:, src] for K and V.

        ``ops.segment_move`` moves both pools in one launch, or, when a
        survivor is placed into a page that the same plan frees (src/dst
        overlap), gathers every source into a buffer before it scatters, so
        each destination receives the old content.  The ``mv`` record is
        the plan as planned (the JAX engine's record); with ``live`` (an
        async sub-plan) only its blocks still alive move (``_live_moves``).
        The pool's accounting already placed the survivors, so the move
        cannot be abandoned: a transient fault retries it, before it
        starts."""
        self._jrec({"t": "mv", "src": plan.src_pages.tolist(),
                    "dst": plan.dst_pages.tolist()})
        if live:
            plan = self._live_moves(plan)
        src = np.asarray(plan.src_pages, np.int64)
        dst = np.asarray(plan.dst_pages, np.int64)
        if ((src < 0) | (src >= self.trash_page)).any() or \
                ((dst < 0) | (dst >= self.trash_page)).any():
            raise AssertionError("compaction plan outside the pool's pages")
        self._with_retries("compaction", lambda: ops.segment_move(
            (self.k_pools, self.v_pools), src, dst))

    def _apply_remap(self, plan) -> None:
        """Remap block tables: one vectorized page-id lookup over the
        matrix.  Every reference holder remaps with the same LUT: all slot
        rows (shared pages appear in several) and the prefix-cache tree."""
        lut = np.arange(self.trash_page + 1, dtype=np.int32)
        lut[plan.src_pages] = plan.dst_pages
        self.bt = lut[self.bt]
        if self.prefix_cache is not None:
            self.prefix_cache.remap(lut)
        self._bt_dirty = True

    def _execute_plan(self, plan) -> None:
        """``pool.on_compaction``: move + remap, run to completion before
        the pool hands out any plan-freed page id."""
        if len(plan) == 0:
            return
        with self._compaction_phase(len(plan)):
            self._move_plan(plan)
            self._apply_remap(plan)

    # --- async pipeline: planned → in flight → committed -----------------
    def _main_wait(self, event) -> None:
        """Order the main stream's later work after ``event`` (on the
        device: no host sync)."""
        torch.cuda.current_stream(self.device).wait_event(event)

    def _live_moves(self, plan):
        """The moves of a planned sub-plan whose block is still alive: a
        block whose owner died after planning is not moved, since its
        destination page may have been handed out again.  A block's newest
        location is its destination resolved through the pending LUT (a
        later plan may move it on)."""
        pool = self.pool
        keep = pool.block_owner[pool.resolve(plan.dst_pages)] == plan.owners
        if keep.all():
            return plan
        return dataclasses.replace(plan, src_pages=plan.src_pages[keep],
                                   dst_pages=plan.dst_pages[keep],
                                   owners=plan.owners[keep])

    def _issue(self, plan) -> None:
        """Move one sub-plan.  On the card it goes to the side stream after
        everything the main stream has queued (whose writes it reads), and
        records the event its commit waits on; a staged plan's buffer is
        allocated there, tied to that stream.  Both pools are marked as used
        by the side stream: the caching allocator then keeps their memory
        from any other stream until the move is done, also when the engine
        is dropped with the move in flight.  On the CPU it moves inline."""
        if self._side is None:
            self._move_plan(plan, live=True)
            return
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        self.k_pools.record_stream(self._side)
        self.v_pools.record_stream(self._side)
        with torch.cuda.stream(self._side):
            if self.before_side_move is not None:
                self.before_side_move()
            self._move_plan(plan, live=True)
            event = torch.cuda.Event()
            event.record()
        self._move_events[id(plan)] = event

    def _commit_plan(self, plan) -> None:
        """Commit one moved sub-plan: the main stream waits for its move
        (the remapped tables point at the destinations), every holder is
        remapped, and its fenced victims are released."""
        event = self._move_events.pop(id(plan), None)
        if event is not None:
            self._main_wait(event)
        if len(plan):
            self._apply_remap(plan)
            # forensic: a kill between "mv" and "mvc" recovers by replay,
            # which rebuilds placement from scratch
            self._jrec({"t": "mvc", "src": plan.src_pages.tolist(),
                        "dst": plan.dst_pages.tolist()})
        self.pool.commit_plan(plan)
        self.sub_plans += 1

    def _commit_inflight(self) -> None:
        """Commit every sub-plan in flight, in plan order."""
        while self._inflight_plans:
            self._commit_plan(self._inflight_plans.pop(0))

    def _hot_pages(self) -> np.ndarray:
        """Pages the upcoming dispatch may write: each live slot's pages
        from its current length on (decode appends K/V there), a prefilling
        slot's from its chunk position on.  A planned move whose source is
        among them cannot stay uncommitted across the dispatch: the write
        would land on the source after the move copied it."""
        hot = []
        for i in np.flatnonzero(self.rid >= 0):
            lo = int(self.lens[i]) // self.page_T
            if self._pf is not None and self._pf["slot"] == i:
                lo = min(lo, int(self._pf["pos"]) // self.page_T)
            hot.append(self.bt[i, lo:self.npages[i]].astype(np.int64))
        return (np.concatenate(hot) if hot
                else np.empty(0, dtype=np.int64))

    def _pump_compaction(self) -> None:
        """The per-step pump, run before admission.

        1. **commit** — the sub-plans moved last step are committed, in plan
           order (the pending LUT and chained moves compose only so).
        2. **issue** — pending sub-plans are moved up to the scheduler's
           deficit-weighted clean budget, beside this step's dispatch.  A
           sub-plan whose source the dispatch writes commits at once, and
           the main stream waits for its move (hazard 3).

        The pump does not plan: victims become worth cleaning in the middle
        of admission, sealed by the writes that drain the reserve, so the
        alloc path plans them (``pool._compact_until``), at the state
        synchronous cleaning would have used."""
        pool = self.pool
        if self._inflight_plans:
            self.inflight_boundaries += 1
        if not (self._inflight_plans or pool.pending_plans):
            return
        with self._compaction_phase(0):
            self._commit_inflight()
            if not pool.pending_plans:
                return
            # the deficit is judged on projected free slabs: reclamation in
            # flight is demand already served
            budget = clean_budget(
                self.clean_budget, free_slabs=pool.projected_free_slabs(),
                trigger=pool.compact_trigger, blocks_per_slab=pool.S,
                queue_depth=len(self.queue) + len(self._resume))
            hot = self._hot_pages()
            moved = 0
            while pool.pending_plans and moved < budget:
                plan = pool.pending_plans.pop(0)
                self._issue(plan)
                moved += len(plan)
                if len(plan) and np.isin(plan.src_pages, hot).any():
                    self.hazard_commits += 1
                    self._commit_inflight()
                    self._commit_plan(plan)
                    # the commits remapped the tables: a chained later
                    # sub-plan (its source an earlier one's destination)
                    # must see it
                    hot = self._hot_pages()
                else:
                    self._inflight_plans.append(plan)

    def _drain_compaction(self) -> None:
        """The pool's ``on_drain``: commit the whole pipeline now, in order
        — the moves in flight need only their commit; the sub-plans not yet
        moved are moved on the main stream and committed, as synchronous
        cleaning does.  Called from the alloc path when capacity is needed
        at once."""
        if not (self._inflight_plans or self.pool.pending_plans):
            return
        self.drains += 1
        with self._compaction_phase(0):
            self._commit_inflight()
            while self.pool.pending_plans:
                plan = self.pool.pending_plans.pop(0)
                self._move_plan(plan, live=True)
                self._commit_plan(plan)

    def _on_dead_destination(self, pages: np.ndarray) -> None:
        """The pool's ``on_dead_destination``: a free killed the
        destinations ``pages`` of uncommitted moves, so their pages can be
        handed out again.  If a move in flight writes one, the main stream
        waits for every move in flight before its next write (hazard 4)."""
        if not any(np.isin(p.dst_pages, pages).any()
                   for p in self._inflight_plans):
            return
        self.dead_destination_waits += 1
        for plan in self._inflight_plans:
            event = self._move_events.get(id(plan))
            if event is not None:
                self._main_wait(event)

    # ------------------------------------------------------------ integrity
    def audit(self) -> None:
        """Cross-check every reference holder against the pool's refcounts:
        each page's count is the number of block-table rows holding it plus
        one if the prefix tree caches it (no leak, no double free), read
        through the pending-move LUT across an async window; then the
        fenced cross-checks, each slot's length and output ledgers and,
        when journaling, that the journal's tail is whole and durable."""
        pool = self.pool
        pool.check_invariants()
        if self.prefix_cache is not None:
            self.prefix_cache.check_invariants()
        expected = np.zeros_like(pool.block_ref)
        for i in range(self.max_batch):
            if self.rid[i] >= 0:
                np.add.at(expected,
                          pool.resolve(self.slot_pages(i).astype(np.int64)), 1)
        if self.prefix_cache is not None:
            tree = self.prefix_cache.pages()
            if tree:
                np.add.at(expected, pool.resolve(np.asarray(tree, np.int64)),
                          1)
        assert (expected == pool.block_ref).all(), \
            f"refcount mismatch at pages {np.flatnonzero(expected != pool.block_ref)}"
        self._audit_fenced()
        for i in range(self.max_batch):
            if self.rid[i] >= 0 and not self._prefilling[i]:
                # lens counts the prompt and the consumed outputs (all
                # emitted but the last, the next decode input)
                assert self.lens[i] == (len(self._prompt[i])
                                        + self._out_n[i] - 1), \
                    f"slot {i}: lens ledger broken"
                assert self.to_gen[i] == len(self._out[i]) - self._out_n[i], \
                    f"slot {i}: to_gen ledger broken"
        if self.journal is not None:
            self.journal.check_tail()
        if self.mesh is not None:
            self._check_agreement()

    def _check_agreement(self) -> None:
        """Every rank of the mesh holds the same block tables, lengths,
        slots and tokens: an all-gathered hash of them, equal or raise."""
        h = hashlib.blake2b(digest_size=8)
        for a in (self.bt, self.lens, self.tokens, self.rid, self.npages,
                  self._out_n, self._prefilling):
            h.update(np.ascontiguousarray(a).tobytes())
        for out, n in zip(self._out, self._out_n):
            if out is not None:
                h.update(out[:n].tobytes())
        mine = torch.tensor([int.from_bytes(h.digest(), "little",
                                            signed=True)],
                            dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(mine) for _ in range(self.mesh.size())]
        dist.all_gather(parts, mine, group=self.mesh.get_group("model"))
        got = [int(p) for p in parts]
        assert len(set(got)) == 1, \
            f"ranks disagree on block tables or tokens: hashes {got}"

    def _audit_fenced(self) -> None:
        """A FENCED slab is a victim whose moves are planned or in flight:
        it must be invisible to allocation (never on the free list),
        unreachable from any holder (no resolved table or tree page lands
        in one), and the home of every uncommitted plan's sources (the
        destinations are survivor placements, never in a fenced slab)."""
        pool, core = self.pool, self.pool.core
        fenced = np.flatnonzero(core.seg_state == FENCED)
        plans = list(pool.pending_plans) + list(self._inflight_plans)
        if len(fenced) == 0 and not plans:
            assert pool.deferred_moves() == 0, "move debt with no plans"
            return
        assert not np.isin(np.asarray(core.free_list, np.int64),
                           fenced).any(), "fenced slab on the free list"
        S = pool.S
        for i in range(self.max_batch):
            if self.rid[i] >= 0:
                held = pool.resolve(self.slot_pages(i).astype(np.int64))
                assert not np.isin(held // S, fenced).any(), \
                    f"slot {i} holds a page in a fenced slab"
        if self.prefix_cache is not None and self.prefix_cache.n_pages:
            tree = pool.resolve(np.asarray(self.prefix_cache.pages(),
                                           np.int64))
            assert not np.isin(tree // S, fenced).any(), \
                "prefix tree holds a page in a fenced slab"
        for plan in plans:
            if len(plan) == 0:
                continue
            assert np.isin(plan.src_pages // S, fenced).all(), \
                "uncommitted plan source outside fenced slabs"
            assert not np.isin(plan.dst_pages // S, fenced).any(), \
                "uncommitted plan destination inside a fenced slab"

    # ------------------------------------------------------- crash safety
    def session_state(self) -> dict:
        """JSON-able view of the *request-level* session, the JAX engine's
        schema: what recovery restores.  Device state (K/V pages) is absent:
        a live sequence re-prefills its prompt and re-decodes its emitted
        span on the resume path instead."""
        def entry(rid, prompt, max_new, out, out_n):
            return {"rid": int(rid), "prompt": [int(t) for t in prompt],
                    "max_new": int(max_new),
                    "out": ([int(t) for t in out[:out_n]]
                            if out is not None else [])}

        # a slot mid-replay (out_n < _jskip) knows more tokens than it has
        # re-decoded: the snapshot keeps the whole journaled span, since the
        # emit records after it cover only indices >= _jskip
        live = sorted(
            (entry(self.rid[i], self._prompt[i],
                   int(self._out_n[i]) + int(self.to_gen[i]),
                   self._out[i],
                   int(max(self._out_n[i], self._jskip[i])))
             for i in np.flatnonzero(self.rid >= 0)),
            key=lambda e: e["rid"])
        return {
            "live": live,
            "resume": [entry(r.rid, r.prompt, r.max_new_tokens, r.out,
                             r.out_n) for r in self._resume],
            "queue": [entry(r.rid, r.prompt, r.max_new_tokens, r.out,
                            r.out_n) for r in self.queue],
            "finished": {str(k): v for k, v in self.finished.items()},
            "next_rid": self._next_rid,
            "predictor": {
                "kind": self.length_predictor.name,
                "value": getattr(self.length_predictor, "value", None),
                "n_obs": int(getattr(self.length_predictor, "n_obs", 0))},
            "counters": {
                "preemptions": self.preemptions, "resumes": self.resumes,
                "recomputed_tokens": self.recomputed_tokens,
                "dispatches": self.dispatches,
                "shed_count": self.shed_count,
                "prefill_chunks_dispatched": self.prefill_chunks_dispatched,
                "prefill_tokens_total": self._prefill_tokens_total,
                "prefill_tokens_saved": self._prefill_tokens_saved},
            "pool_stats": dataclasses.asdict(self.pool.stats),
            "u_now": float(self.pool.u_now),
            "prefix_tree": (self.prefix_cache.tree_state()
                            if self.prefix_cache is not None else []),
        }

    def snapshot(self) -> int:
        """Checkpoint the session through the snapshot store and truncate
        the journal behind it (recovery = snapshot + bounded replay)."""
        from . import recovery  # deferred: recovery imports this module
        return recovery.snapshot(self)

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        st = self.pool.stats
        m = {
            "blocks_written": st.blocks_written,
            "blocks_moved": st.blocks_moved,
            "wamp": st.wamp(),
            "mean_E_compacted": st.mean_E(),
            "compactions": st.compactions,
            "streams": self.streams,
            "stream_writes": list(st.stream_writes),
            "stream_moves": list(st.stream_moves),
            "per_stream_wamp": st.per_stream_wamp(),
            "free_blocks": self.pool.free_blocks(),
            # async-cleaning debt: moves planned but not committed, and the
            # slabs they will hand back (0 when synchronous)
            "compaction_debt_moves": self.pool.deferred_moves(),
            "fenced_slabs": self.pool.core.fenced_count(),
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "recomputed_tokens": self.recomputed_tokens,
            "dispatches": self.dispatches,
        }
        if self.shed_queue_depth:
            m["shed_count"] = self.shed_count
        if self.injector is not None:
            m["fault_retries"] = self.fault_retries_done
            m["fault_unwinds"] = self.fault_unwinds
        if self.journal is not None:
            js = self.journal.core.stats
            m["journal_records"] = self.journal.next_seq
            m["journal_bytes"] = js.user_bytes
            m["journal_wamp"] = js.wamp()   # stays 0: truncation moves nothing
        if self.recovery is not None:
            m["recovery"] = dict(self.recovery)
        if self.prefill_chunk:
            m["prefill_chunks_dispatched"] = self.prefill_chunks_dispatched
        if self.async_compaction:
            m.update(gc_planned=st.gc_planned, gc_committed=st.gc_committed,
                     sub_plans=self.sub_plans,
                     hazard_commits=self.hazard_commits, drains=self.drains,
                     dead_destination_waits=self.dead_destination_waits,
                     inflight_boundaries=self.inflight_boundaries)
        if self.prefix_cache is not None:
            total = self._prefill_tokens_total
            saved = self._prefill_tokens_saved
            m.update(
                prefix_hit_rate=self.prefix_cache.hit_rate(),
                prefill_tokens=total,
                prefill_tokens_saved=saved,
                prefill_tokens_computed=total - saved,
                prefix_cache_pages=self.prefix_cache.n_pages,
                prefix_evictions=self.prefix_cache.evictions,
                frames_shared=st.frames_shared,
            )
        if self.calibration is not None:
            m["misroute_rate"] = self.calibration.misroute_rate()
        return m

    def _sample_metrics(self) -> None:
        """One metrics-logger row: the cumulative :meth:`metrics` dict plus
        point-in-time gauges (JSONL sink, ``metrics_every`` cadence)."""
        m = self.metrics()
        m.pop("recovery", None)   # nested dict, not a time series
        m["u_now"] = float(self.pool.u_now)
        m["queue_depth"] = len(self.queue) + len(self._resume)
        m["active_slots"] = int((self.rid >= 0).sum())
        self._metrics_logger.sample(m)

    def phase_report(self) -> dict:
        """Aggregate the per-dispatch phase splits (``phase_log=True`` or a
        tracer attached): per-phase means, the dispatch wall's p50/p99, and
        compaction's share of the p99 tail.

        Phases can nest (a compaction fires inside the admit or alloc path
        when allocation trips the pool's trigger), so per-phase tail shares
        may overlap and sum past 1.0: each is the fraction of the tail's
        wall during which that phase ran, not a partition."""
        rows = list(self.dispatch_phases)
        if not rows:
            # zeroed but full-key: readers index these fields without checks
            return {"dispatches": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                    "phase_mean_ms": {}, "phase_share_p99_tail": {},
                    "compaction_share_p99": 0.0,
                    "compaction_share_total": 0.0}
        tot = np.array([r["total"] for r in rows])
        p50, p99 = np.quantile(tot, [0.5, 0.99])
        tail = [r for r in rows if r["total"] >= p99]
        tail_tot = sum(r["total"] for r in tail)
        keys = sorted({k for r in rows for k in r} - {"total"})
        return {
            "dispatches": len(rows),
            "p50_ms": float(p50) * 1e3,
            "p99_ms": float(p99) * 1e3,
            "phase_mean_ms": {
                k: float(np.mean([r.get(k, 0.0) for r in rows])) * 1e3
                for k in keys},
            "phase_share_p99_tail": {
                k: (sum(r.get(k, 0.0) for r in tail) / tail_tot
                    if tail_tot else 0.0)
                for k in keys},
            "compaction_share_p99": (
                sum(r.get("compaction", 0.0) for r in tail) / tail_tot
                if tail_tot else 0.0),
            "compaction_share_total": float(
                sum(r.get("compaction", 0.0) for r in rows) / tot.sum())
            if tot.sum() else 0.0,
        }
