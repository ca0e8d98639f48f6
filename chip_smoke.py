#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:

1. device  — the card's name and power limit (``nvidia-smi``); CUDA present.
2. build   — compile the five CUDA kernels from ``src/repro_torch/kernels/
             csrc`` (one ``nvcc`` per source, started together).
3. kernels — each kernel against its plain PyTorch version on the card, at
             the main path's full-width shapes (qwen3-1.7b: Kh=8, G=2,
             D=128, page_T=16; paged attention also at a long context of
             32 sequences of up to 4,096 tokens, bf16, with the share of
             its bound it reaches; at both shapes also with q's dtype apart
             from the pools' (f32 q over bf16 pools, bf16 over f32), and the
             same-dtype outputs bitwise the earlier kernel's, by sha256),
             with the tolerances of the JAX package's
             kernel tests (f32 2e-5, bf16 2e-2, exact for the copies) and,
             for a mixed pair, a bar from where it rounds
             (``_torch_checks.paged_bar``);
             kernel, plain and library times (median of CUDA-event timings,
             L2 flushed before each launch; a kernel and its yardstick timed
             in alternation) beside the least time the card could take.  Flash attention runs at the engine's prefill
             buckets (S 256, 512, 1024) in bf16 on its tensor-core route and
             at S 1024 in f32 on its CUDA-core route, each line naming the
             route; the compaction move runs a disjoint plan (one launch) and
             an overlapping one (gather and scatter) beside the PyTorch
             expression ``p[:, dst] = p[:, src]``.  Flash attention also runs
             at the prefix-hit shape (512 query rows after a 512-token cached
             prefix, over 1,024 keys) on both routes, and at a chunked
             prefill's last chunk (256 rows at offset 768) in bf16: against
             its plain version, and bit for bit the same rows of the
             ``q_offset = 0`` call over all 1,024 rows, beside
             ``scaled_dot_product_attention`` with the same (lower-right
             causal) mask.  Paged attention and flash also run at the
             moe phase's heads (Qwen3-30B-A3B: G 8 over Kh 4; H 32 / Kh 4
             at S 1,024), and flash at the families phase's Zamba2-7B heads
             (H 32 / Kh 32, D 112, launched at D on the tensor-core route:
             TMA zero-fills the tile's columns past 112, nothing is
             padded), at Nemotron-4-340B's heads (H 96 / Kh 8, D 192, S
             1,024) in bf16 (tensor cores, 64-row kv tiles) and f32 (CUDA
             cores), and at the
             encdec phase's shapes: Whisper-medium's encoder (B 2, H 16 /
             Kh 16, D 64, 1,500 x 1,500 frames) and cross attention (384
             rows over 1,500 frame keys), both non-causal (SDPA without a
             mask), and InternVL2-76B's heads (H 64 / Kh 8, S 1,024).
4. engine  — the paged serving engine on the full-width qwen3-1.7b (28
             layers, random bf16 weights from a seed) serving 32 requests,
             with the pool sized so that MDC compaction fires under pressure.
             The kernels' launch counters are zeroed just before and read
             just after; each of the engine's three (paged attention, the
             compaction move, flash attention on its tensor-core route) must
             have grown.  It reports how many compaction plans were staged
             (a destination that is another move's source), and the median
             and largest wall of a dispatch (CUDA events around each
             ``step()``).
5. tokens  — one request at float32 through the engine (the kernels) and
             through the plain ``greedy_decode``: the tokens must be equal,
             or the first mismatch must sit on a near-tie (top-2 logit
             margin below 1e-3).
6. victims — the device route of cleaning-victim selection (the MDC key
             through the ``mdc_priority`` kernel, then top-k) at the paper's
             51,200 segments of 512 pages and at 2**24 segments (a 32 TiB
             store of 2 MiB segments), clean batch 64.  The launch counter
             is zeroed just before the route is driven and read just after.
             Per shape: the kernel against its plain version (the same
             -1 / +inf pattern, finite keys within rtol 1e-6), the victims
             equal as a set to the plain route's on the card, and their keys
             equal as a multiset (rtol 1e-5) to the f64 host selection's;
             kernel, plain and key + top-k times beside the bound.  It and
             the phases below run after the tokens phase, so that the engine
             phase runs in the same process history as before they existed.
7. prefix  — 16 requests sharing one 512-token system prompt (tails of
             64-256 tokens, 32-64 new tokens) through the full-width engine
             twice, cold and then with the prefix cache: hit rate,
             prefill tokens saved, shared frames, flash launches with a query
             offset, pool and tree invariants; wall and prefill stream times
             (CUDA events around each admission's prefill); the share of requests
             whose bf16 tokens equal the cold run's (reported: a 256-row GEMM
             need not round like the rows of a 1,024-row one).  Then 4 such
             requests at f32 (TF32 off), hit against cold: equal tokens, or a
             first mismatch on a near-tie of the plain decode.
8. preemption — the engine phase's first 16 requests, with preemption on,
             through a pool small enough to preempt (chosen by rehearsing the
             host schedule on the CPU: ``scripts/rehearse_schedule.py``) and
             one with room to spare: ``preemptions`` >= 1, ``resumes`` equal
             to it, and every request's tokens equal to the big pool's.
9. chunked — the engine phase's 32 requests with chunked prefill (256
             tokens, 16 pages, per fused dispatch: a prompt of 256-1,024
             tokens makes 1-4 chunks at offsets 0, 256, 512, 768) through
             the same pool: every request's token count, one chunk per
             ceil(prompt / 256), >= 1 compaction, pool invariants, all three
             engine kernels launched and flash launches with a query offset;
             wall, tokens/s, dispatches, launches and the median and largest
             dispatch wall beside the engine phase's monolithic run, and
             the share of requests whose bf16 tokens equal it (reported).
             Then 4 requests of 300-1,000 tokens at f32 (TF32 off), chunked:
             equal to the plain decode, or a first mismatch on a near-tie.
10. async  — the engine phase's 32 requests and pool with asynchronous,
             budgeted compaction (the default clean budget; the moves on a
             side CUDA stream) and ``audit()`` after every dispatch: every
             request's token count, bf16 tokens equal to the engine phase's
             (synchronous) run in every request, the host-determined counters
             (compactions, blocks moved, Wamp, moves planned and committed,
             sub-plans, step boundaries crossed with a move in flight, hazard
             commits, drains, direct and staged plans) equal to the CPU
             rehearsal's (``scripts/rehearse_schedule.py async 30``), no debt
             and no fenced slab left, and ``segment_move`` launched on the
             side stream; wall, tokens/s, dispatches and the median and
             largest dispatch wall beside the engine phase's run, and Wamp
             beside it.  Then the f32 leg's 4 long requests (16-128 new tokens,
             f32 weights and pool, TF32 off) through a pool small enough to
             compact (``rehearse_schedule.py async-f32 8``), async and sync:
             equal tokens, and equal to the plain decode or parting from it
             on a near-tie.
11. recovery — crash safety.  A kill inside the async window: the
             engine phase's 32 requests through the async phase's
             configuration with the session journal on and a snapshot every
             ``RECOVERY_SNAPSHOT_EVERY`` dispatches, each side-stream move
             held back ~50 ms, the engine dropped with a move in flight and
             recovered in the same process (``recover_engine(...,
             device="cuda")`` from the snapshot and the records after it,
             ``audit()`` passing): bf16 tokens equal to the engine phase's
             in 32 of 32; by the kill the journal holds an ``mv`` record
             and its Wamp is 0.  Then the f32
             leg (the async phase's f32 requests and pool, TF32 off), killed
             at its middle record boundary: tokens equal to the unkilled
             run's, and to the plain decode or parting from it on a
             near-tie.  Host counters (the kill's dispatch, the records
             journaled by then and the ``mv`` records among them, the
             snapshot recovered from, records replayed, sequences resumed,
             requests requeued, tokens replayed) equal
             ``scripts/rehearse_schedule.py recovery 30``'s.
             Reported per cut: ``load_session`` ms and the time to recover
             (from ``recover_engine`` until every resumed sequence has
             re-derived its journaled span).
12. serve  — observability and the serving CLI, in three legs.  (a) The
             engine phase's 32 requests and pool with a tracer, the phase
             split, death calibration and a metrics row every
             ``SERVE_METRICS_EVERY`` dispatches (files under
             ``build/serve/``): bf16 tokens equal to the engine phase's in 32
             of 32, its compactions, blocks moved and Wamp, a Chrome trace
             that passes the schema check of ``tests/test_obs.py`` with the
             engine's event names, ``phase_report()`` counting every
             dispatch, >= 2 metric rows, deaths calibrated, and all three
             engine kernels launched; reported: wall beside the engine
             phase's (the cost of observability, host noise included),
             events and drops, the dispatch wall's p50 / p99 and mean per
             phase, compaction's share of the p99 tail, the misroute rate.
             (b) The same requests through ``launch.serve._open_loop`` at
             ``SERVE_ARRIVAL_RATE`` requests/s (Poisson, seed 0) on a fresh
             engine: every request's token count, pool invariants, flash and
             paged attention launched; reported: TTFT, queue wait and TPOT
             p50 / p99, tokens/s, compactions and the phase split.  (c) The
             CLI, ``launch.serve.main()``, at its default smoke width on the
             card with tracing, the phase log, metrics and calibration: both
             policies ran, every row has tokens, the trace files exist.
13. mixed  — the parameters' dtype apart from the pool's.  (a) Full width:
             the seeded qwen3-1.7b weights at f32 over a bf16 pool and at
             bf16 over an f32 pool (the JAX ``examples/serve_paged.py``
             mix), 4 requests of 300-1,000 tokens each through the engine
             phase's pool, held against the plain greedy decode on the card
             (dense cache in the pool's dtype): tokens equal, or parting on
             a near-tie (top-2 margin < 1e-3 for f32 logits, at most one
             bf16 step for bf16 ones).  (b) Smoke width: f32 parameters
             over the default bf16 pool through ``launch.serve.serve_run``
             on the card and on the CPU (one weight draw): equal rows
             (tokens digest, Wamp, compactions, dispatches, blocks); bf16
             parameters over an f32 pool: every request's token count and
             the CPU's counters, the tokens held to the plain decode as in
             (a) and their share equal to the CPU's reported.
14. sim    — the port's cleaning simulator at the paper's store
             (``configs.paper_store.PAPER``: 51,200 segments of 512 pages,
             26.2 M pages, F 0.8) under 80:20 hot/cold updates and MDC,
             half a store's worth of updates (the first half warm-up; the
             length is the cut, not the store).  At every
             cleaning cycle ``_torch_checks.DeviceVictimCheck`` uploads
             the store's live counts, u_p2 means and eligibility, runs
             ``mdc_priority`` on the card and picks 64 with
             ``policies.torch_select_victims``; the host's f64 pick decides,
             and every device pick outside it must be a near-tie (host key
             within 1e-5 of the host's 64th).  Asserted: >= 1 launch per
             cycle, the store's invariants at the end.  Reported: cycles,
             launches, the kernel's median ms under this traffic, the share
             of cycles with identical sets, host seconds, Wamp and mean E at
             clean beside ``analysis.min_wamp_hotcold(0.8, 0.8, 0.2)``.
15. tp     — tensor-parallel serving on ``torch.distributed``, two ranks
             of ``gloo`` sharing the one card (one process each, spawned by
             ``launch.mesh.spawn_ranks``).  (a) At qwen3-1.7b's heads, each
             rank on 4 of the 8 kv heads: ``paged_attention_sharded`` at
             the kernels phase's shape (B 8, P 64, bf16) and
             ``flash_attention_sharded`` at S 1,024 and at the prefix-hit
             shape (512 rows at offset 512), each bit for bit the
             unsharded kernel's slice of the same heads, its
             ``gather_heads`` the whole unsharded output, and within the
             kernels phase's bars of the plain version on the local heads;
             timed on rank 0 while rank 1 waits, beside the bound and (flash)
             ``scaled_dot_product_attention`` on the local heads.  (b) The
             engine phase's first ``TP_REQUESTS`` requests through a pool of
             ``TP_SLABS`` slabs (it compacts: ``scripts/rehearse_schedule.py
             tp``) at full width, bf16, each rank's model cut to its heads
             (``shard_model``), with ``audit()`` (and the ranks' agreement
             check) every ``TP_AUDIT_EVERY`` dispatches, beside the unsharded
             engine on the same stream with the same audits: the ranks'
             tokens equal, every request finished, the host counters the
             unsharded run's, the tokens equal to it or parting on a
             near-tie of the plain decode (``first_mismatches``), pools
             sharded to 4 kv heads; reported: wall, each rank's launches of
             the two wrappers, and what each process holds on the card once
             its engine is built (``memory_allocated``, weight and pool
             bytes).
             (c) One ``nccl`` rank in this process (world size 1): tokens
             and counters bitwise the unsharded run's.
16. moe    — the MoE family at full width: Qwen3-30B-A3B (48 layers, d
             2,048, 32 q over 4 kv heads, 128 experts of d_ff 768, top-8,
             capacity factor 1.25), random bf16 weights (the router f32)
             drawn on the card from the seed, in a process of its own
             (spawned like the tp ranks; it first asserts that the card has
             room for the weights, the pool and ``MOE_HEADROOM``).  The tp
             phase's 8 requests and 12-slab pool through the engine: the
             host counters of ``scripts/rehearse_schedule.py moe 12`` (4
             compactions), all three engine kernels launched (paged
             attention at G 8, flash at H 32 / Kh 4 on the ``wgmma``
             route).  Each request through the plain path on the card at
             the engine's prompt bucket (so the MoE groups and drops as the
             engine's does), up to its first ``MOE_PLAIN_TOKENS`` tokens:
             they equal the engine's, or the first mismatch sits on a logit
             near-tie (``near_tie_bar``) of the plain path.  Layer 0 of a 1,024-token bucket through the
             port's moe functions: the capacity-dropped picks, and
             ``moe_ffn`` at the prefill and decode shapes called twice,
             bitwise equal.  Reported: the parameter counts, wall and
             dispatch times, peak memory.  (The decode step's device split
             is ``scripts/profile_engine.py --arch qwen3-moe-30b-a3b``.)
16b. yi    — yi-34b at full width (60 layers, d 7,168, 56 q over 8 kv
             heads: G 7, which only the paged kernel's second instance
             family takes), random bf16 weights drawn on the card from the
             seed, in a process of its own (it first asserts room for the
             68.8 GB of weights, the pool and ``YI_HEADROOM``).  Four
             requests of 256-512 tokens, 16 new each, through the engine:
             the host counters of ``scripts/rehearse_schedule.py yi 8``,
             paged attention launched (every launch at G 7), flash on its
             ``wgmma`` route; reported, its wall and dispatch times.  Then
             the same stream again, its tokens equal to the first's, each
             of its paged calls held to the plain version in all f32 on the
             same pools, tables and lengths (``YI_PAGED_BAR``), and the
             kernel run again on three planted faults per call, each caught
             by that bar in at least ``YI_FAULT_CAUGHT`` of the calls
             (``paged_calls_held``).  Each request through the plain path on the
             card, its prefill through the engine's flash kernel: reported,
             not asserted, whether its tokens equal the engine's, and the
             plain path's own first token with the chunked attention's
             prefill (a random 60-layer stack carries rounding to O(1):
             ``scripts/family_sensitivity.py yi-34b``).  Then the same
             weights cut to ``YI_F32_LAYERS`` in f32, through the engine
             over an f32 pool: its counters the rehearsal's, its tokens
             equal to the f32 plain path's or parting on a near-tie (top-2
             margin < 1e-3).
17. train  — the training side at full width: qwen3-1.7b uncut (28
             layers, d 2,048, vocab 151,936, ~2.03 B params), random bf16
             weights from the seed, through ``launch.train.train`` (the JAX
             trainer's AdamW and schedule, ``SyntheticLMStream`` at B 2 x S
             1,024, remat as the config says) in a process of its own with
             deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG``).  It
             first asserts room for two checkpoints on the temp dir's disk
             and for a host snapshot.  A clean run of 6 steps, then a
             faulty one that checkpoints every 4 steps into the MDC store
             (``keep_last=1``) and loses its node at step 5: one restart,
             resumed from step 4, and its last two losses within 2e-4
             (rtol and atol, ``tests/test_checkpoint.py``'s) of the clean
             run's; reported: the largest difference and whether it is
             bitwise.  Then the smoke config at f32 for 8 steps on the
             card and on the CPU (TF32 off): losses within 1e-4 relative.
             Reported: step ms (median after the first), tokens/s, the
             share of the bf16 dense peak, peak ``max_memory_allocated``,
             each save's host-snapshot and background-write seconds, the
             restore's seconds, the stragglers, and the store's byte-Wamp
             and segments cleaned.  No kernel of the port is on the
             training path (training attention is the plain chunked
             attention under autograd, as the JAX package's is XLA): the
             counters, zeroed before it, must read 0 after.
18. families — the MLA-MoE, hybrid and SSM families at full width, in a
             process of its own, each model freed before the next is drawn.
             (a) Each uncut from random bf16 weights (DeepSeek-V2-Lite 16.2
             B parameters, 2.66 B active; Zamba2-7B 6.75 B; Mamba2-1.3B 1.45
             B), its parameter counts beside the JAX package's: two
             1,024-token prompts as one batch and one of 1,000 (not a
             multiple of the SSD chunk of 128) through the contiguous-cache
             ``prefill`` (bf16 cache) and 32 ``decode_step``s fed the true
             next tokens.  Asserted: finite logits; the hybrid's prefill
             launching flash once per group (13) on the route its D 112
             pads to, one of those launches within the bf16 bar (rtol 2e-2)
             of the plain attention on its own inputs; no flash launch off
             the hybrid (the bar's absolute part is 2e-2 of max
             |v|, the scale of the rounding of P·V: ``flash_check``).
             Reported: the prefill's last row
             against ``forward``'s over the prompt, each decode step's top-1
             against ``forward`` over prompt and fed tokens, the forward's
             dropped MoE picks, draw seconds, peak
             ``max_memory_allocated``, prefill ms and decode ms per token
             step (CUDA events; the decode is host-bound).  (b) Each at
             full width in f32, cut to ``FAMILY_F32_LAYERS`` (the depth at
             which rounding is not carried past the logits' margins; DeepSeek
             at the capacity that drops nothing), one 1,000-token prompt and
             32 decode steps: the prefill's last row within the JAX test's
             bar (atol 0.08, rtol 0.05) of ``forward``'s, top-1 agreement of
             decode with ``forward`` >= 0.85 for the SSM and the hybrid
             (``tests/test_models.py``'s bar; reported for MLA-MoE), the
             hybrid's flash launches on the CUDA-core route within 2e-5 of
             the plain attention; reported: ``forward``'s own move under a
             1e-7 relative perturbation of its embeddings.  (c) At smoke
             width, f32, each family's logits (forward, prefill, 4 decode
             steps) on the card within 1e-4 of the CPU's max-abs.
19. encdec — the encoder-decoder family and the VLM stub, in a process of
             their own, each model freed before the next is drawn.  (a)
             Whisper-medium uncut (24 encoder + 24 decoder layers, d 1,024,
             vocab 51,865, 1.01 B parameters, equal to the JAX package's),
             random bf16 weights and 1,500 frame embeddings from the seed:
             ``prefill`` of 2 x 384 tokens (whisper decodes at most 448),
             then 32 ``decode_step``s fed the true next tokens.  Asserted:
             finite logits; 72 flash launches per prefill, all on the
             tensor-core route at D 64 — 24 causal (the decoder's self
             attention), 24 non-causal 1,500 x 1,500 (the encoder), 24
             non-causal 384 x 1,500 (the cross attention) — one of each
             within its bar of the plain version on its own inputs.  Then
             ``Model.loss`` forward and backward at full width with frames
             (B 1 x 384): finite, its peak memory reported.  (b) Whisper in
             f32 at ``ENCDEC_F32_LAYERS``: the prefill's last row within the
             JAX test's bar of ``forward``'s, decode's top-1 agreement with
             ``forward`` >= 0.85, 72 flash launches on the CUDA-core route
             within their bars.  (c) InternVL2-76B cut to ``VLM_LAYERS`` of
             its 80 layers (the uncut ~141 GB of bf16 weights do not fit;
             the uncut config's parameter count equals the JAX package's):
             ``forward`` with 256 patches (logits (1, 256 + 256, V),
             finite), then the text-only ``prefill`` of 2 x 1,024 (the
             port's VLM prefill refuses patches: the reference's cache
             misplaces them) with one flash launch per layer at H 64 / Kh 8
             on the tensor-core route, one within its bar, and 16 decode
             steps.  (d) Both smoke configs at f32, card against CPU within
             1e-4.  Reported: draw seconds, peak memory, prefill ms and
             decode ms per token step, decode's and the prefill's agreement
             with ``forward`` in bf16.
             Each of the other last eleven phases zeroes the launch
             counters before it and reads them after, and fails unless its
             kernels launched.
20. dryrun — the dry-run's count (``launch.steps.build_cell`` under
             ``roofline.op_cost.OpCost``) held against the card, in this
             process: qwen3-1.7b at full width, bf16, TF32 off, in three
             cells — train (B 2 x S 1,024, AdamW: the train phase's step),
             prefill (B 2 x S 1,024 through ``ops.flash_attention``, one
             launch per layer) and one decode step (B 8 over a 1,024-token
             cache); and Zamba2-7B's prefill of B 2 x S 1,024 at full width,
             cut to ``DRYRUN_ZAMBA_LAYERS``, whose flash launches run at its
             head dim of 112.  Each cell is built on ``meta`` and on
             the card and run once under a counter on each: FLOPs by dtype,
             HBM bytes and kernel charges must be equal, and the flash
             charges equal the launches of the counted run; one flash call
             at Zamba2's heads charges the kernel alone and holds its
             count's peak (the output) to the card's on its own.  The card's
             ``max_memory_allocated`` above its level before the cell was
             built must lie within ``DRYRUN_PEAK_BAR`` of the count's peak of
             live bytes.  Reported: the step's median time without the
             counter (CUDA events, ``DRYRUN_REPS`` after a warm-up) beside
             ``roofline.report.term_seconds``' bound, the share of the
             bound it reaches and its model-FLOP share of the bf16 peak.
21. mesh   — training on the JAX package's data x model mesh
             (``launch.steps.make_train_fn(..., mesh=)``: each rank holds its
             shard of the params and moments under ``DEFAULT_RULES``; the
             dense family's step is the partitioned route, the JAX
             program's work per device: its heads, columns and vocabulary
             rows, the sequence-parallel residual, each layer's FSDP
             weights gathered for its forward and again for its backward),
             qwen3-1.7b at full width, bf16, TF32 off, deterministic
             kernels, AdamW (``MESH_OPT``), ``MESH_STEPS`` steps of B 2 x
             S 1,024.  (b) Two ``gloo`` ranks sharing the card on a (2, 1)
             mesh (a spawn), B 1 each, then (e) the same two ranks on a
             (1, 2) mesh, the whole batch each on half the model: losses
             within ``MESH_BARS`` / ``MESH_BARS_TP`` of (a)'s, params
             apart from (a)'s in at most the bars' share of elements and
             each within 2 lr plus one unit in the last place per step,
             (e)'s norms (held whole by both ranks, their gradients summed
             over "model") within their bar of that cap on average and
             bitwise equal on both ranks (the bars from
             ``scripts/rehearse_mesh.py``, each between sound readings and a
             planted fault's); reported: each rank's peak
             ``max_memory_allocated`` ((b)'s must lie below the
             replicated route's 28.36 GB; (e)'s stands beside the
             one-device 47.6 GB and (a)'s own), step ms and the host ms inside its
             all-gathers, reduce-scatters and all-reduces (the card
             synchronised around each).  (a) One ``nccl`` rank at world
             size 1, in this process: the one-device steps, then the same
             on a (1, 1) mesh, whose losses and params must be bitwise the
             one-device ones.  (c) Elastic, cut to ``MESH_ELASTIC_LAYERS``:
             the seed's params saved from the (2, 1) mesh (in (b)'s spawn),
             restored onto one rank (its (2, 1) slices bitwise the saving
             ranks' shards), then onto (2, 1) again (bitwise) and a step
             taken from fresh moments (finite loss), as
             ``tests/test_elastic.py`` does (in (b)'s spawn, once both
             ranks have saved).  (d) The (2,
             1) and (1, 2) meshes' train cells and the (2, 1) prefill cell
             (B 2 x 1,024, in (b)'s spawn), counted on ``meta`` at the
             mesh's sizes and on each rank on the card (a train cell is its
             leg's first step, the same step on the same arguments): FLOPs
             by dtype, HBM bytes, kernel charges and collective bytes
             equal, a train cell's reduce-scatters counted; the prefill's
             flash charges = its launches = 28 per rank; the peak within
             ``DRYRUN_PEAK_BAR`` of the count's.  (f) Qwen3-30B-A3B at full
             width cut to ``MESH_MOE_LAYERS``, the same two ranks on the
             (1, 2) mesh
             (each on half the experts, its router's logits gathered over
             "model"), against its one-device steps in this process: the
             losses and params within ``MESH_BARS_MOE``, the norms' copies
             bitwise equal; reported: each rank's peak beside one
             device's, step ms.  (g)-(i) likewise for DeepSeek-V2-Lite at
             4 of 27 layers (its latent rank, heads, experts and shared
             experts' columns over "model"), Mamba2-1.3B uncut (its SSM
             channels, heads and B / C columns) and Zamba2-7B at 7 of 81
             layers (one group of 6 and the tail layer), each within
             ``MESH_BARS_FAMILY`` of its own one-device steps
             (``MESH_FAMILY_LEGS``); then each one's first loss and
             gradient in f32 (the seed's params in f32, the first batch)
             against one device's, each rank's every leaf within
             ``MESH_GRAD_BARS`` of the one-device leaf's largest |value|
             (``MESH_GRAD_LEGS``: Zamba2 at 13 layers, two uses of its
             shared block and a tail; the bars from
             ``scripts/rehearse_mesh.py --grads``, between sound readings
             and faults planted in the partitioned blocks).

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))  # _torch_checks: checks shared with the tests

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.paper_store import PAPER  # noqa: E402
from repro_torch.core import analysis, policies  # noqa: E402
from repro_torch.core.simulator import Simulator  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.kernels import build, ops, ref, work  # noqa: E402
from repro_torch.distributed.sharding import (shard_spec,  # noqa: E402
                                              shard_view, tree_specs)
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_serving_mesh, spawn_ranks)
from repro_torch.launch.steps import (build_cell, make_train_fn,  # noqa: E402
                                      partitioned_grads, shard_batch)
from repro_torch.distributed.partition import Partition  # noqa: E402
from repro_torch.launch.train import TOKENS_AXES  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models.layers import flatten, rmsnorm, unflatten  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.op_cost import OpCost  # noqa: E402
from repro_torch.serving import PagedServingEngine, recover_engine  # noqa: E402
from repro_torch.serving import recovery  # noqa: E402
from repro_torch.serving.engine import shard_model  # noqa: E402
from repro_torch.serving.scheduler import DEFAULT_CLEAN_BUDGET  # noqa: E402
from _torch_checks import (PAGED_SHA256, DeviceVictimCheck,  # noqa: E402
                           check_paged_close, digest, paged_bar, paged_case)
from _torch_mesh import deterministic  # noqa: E402
from _torch_tp import local_heads  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SEED = 0

KERNELS = {
    "paged_attention": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:76"},
    "segment_compact": {
        "source": "src/repro_torch/kernels/csrc/segment_compact.cu",
        "replaces": "src/repro/kernels/segment_compact.py:33"},
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96"},
    "mdc_priority": {
        "source": "src/repro_torch/kernels/csrc/mdc_priority.cu",
        "replaces": "src/repro/kernels/mdc_priority.py:43"},
    # the compaction move of src/repro/serving/engine.py:307 _move_pages_fn,
    # whose TPU kernel is segment_compact
    "segment_move": {
        "source": "src/repro_torch/kernels/csrc/segment_move.cu",
        "replaces": "src/repro/kernels/segment_compact.py:33"},
    # the shard_map wrappers: each rank launches the kernel above on its own
    # kv heads (src/repro_torch/kernels/ops.py)
    "paged_attention_sharded": {
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:112"},
    "flash_attention_sharded": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:144"},
}
TP_KERNELS = ("paged_attention_sharded", "flash_attention_sharded")
# the engine's kernels: each must launch in the engine phase.  segment_compact
# is off the engine's path since the move is one fused kernel (its launches
# there are 0); mdc_priority's path is the victims phase.
ENGINE_KERNELS = ("paged_attention", "segment_move", "flash_attention")
FLASH_BUCKETS = (256, 512, 1024)  # the engine's prefill buckets
# the engine phase's pool and slots; the prefix and preemption phases keep
# them (the preemption phase sizes its own pools)
POOL = dict(n_slabs=30, blocks_per_slab=16, page_T=16, max_batch=8,
            max_seq=2048, streams=1, compact_trigger=2, compact_batch=4,
            max_decode_chunk=32)
PREFIX_LEN = 512             # the shared system prompt: 32 pages of 16
PREEMPT_SLABS = (24, 40)     # a pool that preempts, and one with room
PREFILL_CHUNK = 256          # the chunked phase's budget: 16 pages of 16
# the async phase's host-determined counters, rehearsed on the CPU with
# ``scripts/rehearse_schedule.py async 30`` (the engine phase's stream)
ASYNC_REHEARSED = dict(dispatches=141, compactions=5, blocks_moved=140,
                       gc_planned=140, gc_committed=140, sub_plans=19,
                       inflight_boundaries=19, hazard_commits=0, drains=0,
                       dead_destination_waits=2)
ASYNC_PLANS = {"direct": 19, "staged": 0}
# the async f32 leg: long_requests' prompts with these new tokens through a
# pool that compacts (``rehearse_schedule.py async-f32 8``: 1 compaction,
# 29 moves in 4 sub-plans, 4 step boundaries with a move in flight)
ASYNC_F32_NEW = (16, 64, 32, 128)
ASYNC_F32_SLABS = 8
# the recovery phase: the async-window kill's session takes a snapshot
# every this many dispatches (the kill comes after the first), and the
# phase's host-determined counters, rehearsed on the CPU with
# ``scripts/rehearse_schedule.py recovery 30``.  The engine phase's stream
# journaled to its end, and its three cuts, left the card to keep the
# script inside its time limit; the CPU tests recover at every record
# boundary (``tests/test_torch_recovery.py``)
RECOVERY_SNAPSHOT_EVERY = 36
RECOVERY_REHEARSED = {
    "async": dict(dispatch=49, records=200, mv_records=4, snapshot_id=1,
                  records_replayed=42, sequences_resumed=8,
                  requests_requeued=11, tokens_replayed=6317),
    "f32_records": 55,
    "f32": dict(records=55, snapshot_id=0, records_replayed=28,
                sequences_resumed=1, requests_requeued=1, tokens_replayed=529),
}
# the async-window kill: the first step boundary with a move in flight from
# this dispatch on
RECOVERY_ASYNC_FROM = 40
# the serve phase: a metrics row every this many dispatches (18 in the
# engine phase's 146), and the open loop's arrival rate, at or below what
# the closed loop sustained on every recorded run (32 requests in 14.8-29.6
# s: 1.08-2.16 requests/s), so the leg measures latency, not a queue that
# grows without bound
SERVE_METRICS_EVERY = 8
SERVE_ARRIVAL_RATE = 1.0
SERVE_EVENTS = {"step", "dispatch", "host_sync", "pool", "req", "req.admit",
                "seg.open", "seg.seal", "seg.evacuate"}
SERVE_CLI_ARGS = ["--requests", "8", "--policies", "mdc", "greedy",
                  "--arrival-rate", "4", "--phase-log", "--metrics-every", "2",
                  "--calibration"]
# paged attention's q dtype apart from the pools': (q, pools)
MIXED_PAIRS = ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32))
# the mixed phase's full-width legs: (leg, parameters' dtype, pool dtype)
MIXED_LEGS = (("f32_params_bf16_pool", torch.float32, torch.bfloat16),
              ("bf16_params_f32_pool", torch.bfloat16, torch.float32))
# the sim phase: the paper's store under 80:20 hot/cold updates, half a
# store's worth of them (~45 s of host) with the first half as warm-up
SIM_WORKLOAD = dict(update_frac=0.8, data_frac=0.2)
SIM_UPDATES = PAPER.nseg * PAPER.pages_per_seg // 2
SIM_WARMUP = 0.5
# the tp phase: two gloo ranks on the one card, the engine phase's first 8
# requests through a pool of 12 slabs (``scripts/rehearse_schedule.py tp
# 12``: 4 compactions, 114 moves, 34 dispatches), audit() every 8
TP_RANKS = 2
TP_REQUESTS = 8
TP_SLABS = 12
TP_AUDIT_EVERY = 8
TP_TIMEOUT_S = 300   # the ranks took ~45 s: a hung collective fails the run
COUNTERS = ("dispatches", "blocks_written", "blocks_moved", "compactions",
            "wamp")
# the moe phase: Qwen3-30B-A3B at full width in a process of its own (its
# 61.1 GB of weights and an earlier phase's tensors do not fit on one card
# together), on the tp phase's stream and pool.  The host plan depends only
# on the prompts' lengths: ``scripts/rehearse_schedule.py moe 12`` prints
# these counters
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_REHEARSED = dict(dispatches=34, blocks_written=295, blocks_moved=114,
                     compactions=4, wamp=114 / 295)
MOE_HEADROOM = 8e9   # bytes free beyond the weights and the pool
# the plain path's depth per request: it decodes one token at a time
# (~0.15-0.2 s a token), and 5 of the 8 requests part from the engine on a
# near-tie within their first 24 tokens on an NVIDIA H100 80GB HBM3
MOE_PLAIN_TOKENS = 24
MOE_TIMEOUT_S = 600
# the yi phase: yi-34b (56 q over 8 kv heads: G 7, which only the paged
# kernel's second instance family takes) at full width in a process of its
# own (its 68.8 GB of weights leave ~10 GB of the card): a short stream,
# its host counters from ``scripts/rehearse_schedule.py yi 8``
YI_ARCH = "yi-34b"
YI_REQUESTS = 4
YI_NEW = 16
YI_SLABS = 8
YI_REHEARSED = dict(dispatches=4, blocks_written=90, blocks_moved=0,
                    compactions=0, wamp=0.0)
YI_HEADROOM = 3e9
# each engine paged call against the plain version in all f32 (q and the
# pools read in f32, p unrounded): |kernel - plain| <= rel * |plain| + sum *
# sum_j p_j |v_j|.  The kernel rounds its f32 result to q's bf16 once (at
# most 2**-8 of it); the rest is the two f32 sums' orders, a small share
# of what they sum.  Each call is also run with three planted faults
# (``paged_faults``), each of which the bar must catch in at least
# ``YI_FAULT_CAUGHT`` of the calls
YI_PAGED_BAR = {"rel": 2 ** -7, "sum": 2 ** -12}
YI_FAULT_CAUGHT = 0.9
# the f32 leg's depth: a 1e-7 nudge of the f32 embeddings moves yi's random
# full-width logits by 0.0105 at 4 layers and 0.90 at 8, and a bf16 stack
# already parts from f32 at 4 (``scripts/family_sensitivity.py yi-34b``)
YI_F32_LAYERS = 2
YI_TIMEOUT_S = 600
TRAIN_ARCH = "qwen3-1.7b"
# train(): the JAX trainer's optimizer settings (its lr, warmup and AdamW
# are train()'s defaults), full width, 6 steps of B 2 x S 1024
TRAIN_RUN = dict(arch=TRAIN_ARCH, smoke=False, steps=6, global_batch=2,
                 seq_len=1024, verbose=False, seed=SEED)
# the store at full width: 4 MiB chunks in 64 MiB segments (~4,900 chunks
# and ~300 segments per 20 GB save; the JAX trainer's 64 KiB / 1 MiB would
# make ~312k chunks, each with the store's per-chunk host work)
TRAIN_FAULT = dict(save_every=4, fail_at=(5,), keep_last=1,
                   ckpt_chunk_bytes=4 << 20, ckpt_seg_bytes=64 << 20)
TRAIN_RESUME_TOL = 2e-4   # tests/test_checkpoint.py's rtol and atol
TRAIN_SMOKE_STEPS = 8
TRAIN_SMOKE_RTOL = 1e-4   # card against the CPU, f32, TF32 off
TRAIN_TIMEOUT_S = 600

# the families phase: DeepSeek-V2-Lite (MLA + MoE), Zamba2-7B (hybrid) and
# Mamba2-1.3B (SSM) uncut, random bf16 weights from the seed, one after
# another in a process of its own; the JAX package's parameter counts of
# the full configs (``repro.models.Model.n_params`` / ``n_active_params``)
FAMILY_ARCHS = {"deepseek-v2-lite-16b": (16210324992, 2663247360),
                "zamba2-7b": (6750539856, 6750539856),
                "mamba2-1.3b": (1446505472, 1446505472)}
ZAMBA_ARCH = "zamba2-7b"
# the kernels phase's flash lines at head dim 192 (its prefill's heads)
NEMOTRON_ARCH = "nemotron-4-340b"
FAMILY_PROMPTS = ((2, 1024), (1, 1000))   # (batch, prompt tokens)
FAMILY_DECODE = 32
FAMILY_AGREE = 0.85                       # tests/test_models.py:97
FAMILY_PREFILL_BAR = dict(atol=0.08, rtol=0.05)   # tests/test_models.py:77
FAMILY_SMOKE_TOL = 1e-4   # card against the CPU, f32, of the CPU's max-abs
FAMILY_TIMEOUT_S = 600
# The f32 leg, where decode is held to forward: full width, the layers of
# each family at which a 1e-7 relative perturbation of the f32 embeddings
# moves forward's logits by less than 0.02 (``scripts/family_sensitivity.py``
# on the card: 0.0128 at 8 DeepSeek layers, 0.0118 at 13 Zamba2 layers (two
# groups and a tail layer), 0.0037 at all 48 Mamba2 layers; 0.23 at 16
# DeepSeek layers, 0.14 / 2.08 at 25 / 81 Zamba2 layers).  Deeper, the
# random stack carries any rounding difference between two paths to O(1)
# in the logits, so neither bf16 nor f32 can show that decode computes
# forward's function there.  DeepSeek's leg takes the capacity that drops
# nothing (E / top_k), so its prefill, decode and forward route alike.
FAMILY_F32_LAYERS = {"deepseek-v2-lite-16b": 8, "zamba2-7b": 13,
                     "mamba2-1.3b": 48}
FAMILY_F32_PROMPT = (1, 1000)
FAMILY_PERTURB = 1e-7

# the encdec phase: Whisper-medium uncut (24 encoder + 24 decoder layers
# over 1,500 frames) and InternVL2-76B's dense backbone cut in depth (its 80
# layers' ~141 GB of bf16 weights do not fit on the card; 24 layers are
# ~45 GB), random bf16 weights from the seed, in a process of their own;
# the JAX package's parameter counts of the uncut configs
ENCDEC_ARCH = "whisper-medium"
VLM_ARCH = "internvl2-76b"
ENCDEC_N_PARAMS = {ENCDEC_ARCH: 1012313088, VLM_ARCH: 70562095104}
ENCDEC_PROMPT = (2, 384)   # (batch, prompt tokens); whisper decodes <= 448
ENCDEC_DECODE = 32
ENCDEC_LOSS = (1, 384)     # the full-width loss's batch (B 2 saves ~2x)
VLM_LAYERS = 24
VLM_PROMPT = (2, 1024)     # text only: the VLM's prefill refuses patches
VLM_DECODE = 16
VLM_FORWARD = (1, 256)     # text tokens after the 256 patches
ENCDEC_TIMEOUT_S = 600
# Whisper's f32 leg (decode held to forward): full width, the depth of both
# stacks at which a 1e-7 relative perturbation of the f32 embeddings and
# frames moves forward's logits by less than 0.02
# (``scripts/family_sensitivity.py whisper-medium`` on the card)
ENCDEC_F32_LAYERS = 2
ENCDEC_F32_PROMPT = (1, 384)
# the dryrun phase: qwen3-1.7b's three cells at full width, bf16
DRYRUN_ARCH = "qwen3-1.7b"
DRYRUN_CELLS = (ShapeConfig("train", 1024, 2, "train"),      # the train phase's
                ShapeConfig("prefill", 1024, 2, "prefill"),  # 28 flash launches
                ShapeConfig("decode", 1024, 8, "decode"))    # one step, 1,024 keys
# and a prefill at Zamba2-7B's full width, cut to 12 of 81 layers (two
# shared-attention launches at its head dim of 112)
DRYRUN_ZAMBA_ARCH, DRYRUN_ZAMBA_LAYERS = "zamba2-7b", 12
DRYRUN_REPS = 5   # timed steps per cell (median), after one warm-up
# measured peak (max_memory_allocated above the level before the cell is
# built) over the count's predicted peak of live bytes: 1.000104-1.000115
# on an NVIDIA H100 80GB HBM3 (the allocator rounds each block up to 512
# bytes)
DRYRUN_PEAK_BAR = (0.99, 1.01)


# the mesh phase: qwen3-1.7b trained on the JAX package's data x model mesh
MESH_ARCH = "qwen3-1.7b"
MESH_SHAPE = ShapeConfig("train", 1024, 2, "train")   # the train phase's
MESH_STEPS = 2
MESH_OPT = dict(lr=1e-4, weight_decay=0.1, clip_norm=1.0)   # build_cell's
MESH_PAIR = (2, 1)   # (data, model): two gloo ranks sharing the one card
MESH_TP = (1, 2)     # (e): the same two ranks as (data 1, model 2)
# what the legs' rank peaks stand beside: a (2, 1) rank's on the replicated
# route (the whole tree gathered per step), and the one-device step's (the
# train phase's), both measured on an NVIDIA H100 80GB HBM3, 700.00 W
MESH_PAIR_PEAK_REPLICATED_GB = 28.36
MESH_ONE_DEVICE_PEAK_GB = 47.6
MESH_ELASTIC_LAYERS = 4
MESH_CKPT = dict(seg_bytes=64 << 20, chunk_bytes=4 << 20)  # the train phase's
MESH_PREFILL = DRYRUN_CELLS[1]   # (d)'s prefill cell, B 2 x 1,024
MESH_TIMEOUT_S = 600
# (f): Qwen3-30B-A3B at full width on the (1, 2) mesh, cut to 4 of its 48
# layers.  Whole, its 30.5 B parameters with AdamW's f32 moments are ~366
# GB: no card holds (a)'s one-device steps; at 4 layers the tree is 3.11 B
# parameters (the 0.62 B of the vocabulary's two tables among them)
MESH_MOE_LAYERS = 4
# (f)-(i): the MoE, MLA-MoE, SSM and hybrid families on the (1, 2) mesh at
# full width, each beside its own one-device steps: (leg letter, arch, the
# layers it is cut to, None for uncut).  DeepSeek-V2-Lite at 4 of 27 layers
# (~2.75 B parameters, its capacity factor 1.25), Mamba2-1.3B uncut,
# Zamba2-7B at 7 of 81 (one group of 6 and one tail layer, ~1.0 B)
MESH_FAMILY_LEGS = {"moe": ("f", MOE_ARCH, MESH_MOE_LAYERS),
                    "mla": ("g", "deepseek-v2-lite-16b", 4),
                    "ssm": ("h", "mamba2-1.3b", None),
                    "hybrid": ("i", ZAMBA_ARCH, 7)}
# (b)'s and (e)'s bars against (a), set between sound readings and a
# planted fault's.  ``scripts/rehearse_mesh.py --fault`` (the same functions
# at smoke width, bf16, two CPU ranks, seeds 0-2, ``MESH_STEPS`` 2): (b)
# sound, losses 2.5e-5-4.4e-5 relative and 0.81-0.89% of the param elements
# apart; with the gradients' sum over "data" taken out, losses 1.0e-4-6.6e-4
# and 22.6-23.2% apart.  On the card (NVIDIA H100 80GB HBM3, 700.00 W, full
# width, 2 steps) the sound (b) read 2.4e-5 and 2.11%.  Each bar sits near
# the geometric mean of the largest sound reading and the least fault one:
# 1.5x from each for the losses, ~3.3x for the share.  The cap (2 lr plus
# one unit in the last place per step: each step's update rounds to the
# leaf's type) only bounds an update's size: sound 0.50-0.78 of it, the
# fault 0.99.
MESH_BARS = {"loss_rtol": 6.7e-5, "param_share_differ": 0.07}
# (e): sound, losses 3.1e-5-5.2e-5 and 1.25-1.38% apart, the leaves every
# "model" rank holds whole (the norms) 0.0027-0.0032 of their cap apart on
# average, the ranks' copies of them bitwise equal.  With the norms'
# gradients not summed over "model", the norms read 0.167-0.179 and the
# copies differ, while the losses (1.4e-5-3.1e-5) and the share
# (1.34-1.46%) stay within the sound range (AdamW's update hardly moves
# when a gradient halves): the norms' bar sits at the geometric mean (~7x
# from each), the copies must be equal, and the loss and share bars sit ~3x
# above the largest sound readings (the card's, 2 steps: 1.5e-5 and 4.18%).
MESH_BARS_TP = {"loss_rtol": 1.5e-4, "param_share_differ": 0.12,
                "model_whole_mean_over_cap": 0.023}
# (f), the MoE config on (1, 2), rehearsed the same way (smoke width at
# its capacity factor 1.25, where the capacity binds and a routing choice
# that flips on a near-tie moves a whole pick): sound, losses 7.5e-5-5.5e-4
# and 5.1-6.0% apart, the norms 0.030-0.042 of their cap on average; with
# the norms' sum over "model" taken out, the norms read 0.178-0.195 (the
# losses and the share as sound).  The norms' bar sits at the geometric
# mean of the largest sound reading and the least fault one, the loss and
# share bars ~3x above the largest sound readings.
MESH_BARS_MOE = {"loss_rtol": 1.7e-3, "param_share_differ": 0.18,
                 "model_whole_mean_over_cap": 0.086}
# (g)-(i), rehearsed at the phase's full width on the card
# (``scripts/rehearse_mesh.py --card --fault``, seed 0, NVIDIA H100 80GB
# HBM3, 700.00 W; the runs are deterministic: two calls read the same
# digits).  There the random bf16 stacks part at the first loss (MLA / SSM /
# hybrid: 1.06e-3 / 7.0e-4 / 5.7e-4 relative, where (e) reads ~1.5e-5):
# sound, losses 1.06e-3 / 1.19e-3 / 6.6e-4 and 50.6% / 58.7% / 52.5% of the
# elements apart, the leaves every "model" rank holds whole (the norms, and
# MLA's w_kr) 0.0626 / 0.264 / 0.200 of their cap on average; with their
# sum over "model" taken out, 0.0690 / 0.317 / 0.284 and the copies differ,
# the losses and shares as sound.  So the copies' equality is what
# separates that fault; each norms' bar sits at the geometric mean of the
# sound reading and the fault's, the loss bars 3x above the sound ones,
# the share bars at 0.75.  These bars are coarse (an element's AdamW step
# is ~lr whatever its gradient, so the cap bounds any run): a fault in
# the new blocks is told by the f32 first gradient (``MESH_GRAD_BARS``).  (At smoke width on the CPU, seeds 0-2: sound
# losses 2.8e-4-6.6e-4 / 2.1e-5-6.8e-5 / 1.1e-4-6.5e-4, shares 6.8-7.4% /
# 3.1-3.5% / 16.2-17.0%, norms 0.0103-0.0124 / 0.0066-0.0195 /
# 0.107-0.134; the fault's norms 0.0417-0.0457 / 0.146-0.161 / 0.216-0.219.)
MESH_BARS_FAMILY = {
    "moe": MESH_BARS_MOE,
    "mla": {"loss_rtol": 3.2e-3, "param_share_differ": 0.75,
            "model_whole_mean_over_cap": 0.0657},
    "ssm": {"loss_rtol": 3.6e-3, "param_share_differ": 0.75,
            "model_whole_mean_over_cap": 0.289},
    "hybrid": {"loss_rtol": 2.0e-3, "param_share_differ": 0.75,
               "model_whole_mean_over_cap": 0.238}}
# (g)-(i)'s f32 check: the first step's loss and gradient in f32, where
# rounding is ~2^-16 of bf16's and AdamW's sign does not hide a fault, on
# the (1, 2) mesh against one device, at the depth each is cut to here
# (Zamba2 at 13 of 81 layers: two groups of 6, so two uses of the shared
# block whose gradient autograd sums, and one tail layer)
MESH_GRAD_LEGS = {"mla": 4, "ssm": None, "hybrid": 13}
# Rehearsed (``scripts/rehearse_mesh.py --grads --fault``): sound, the first
# loss 2.4e-7 / 1.7e-7 / 2.6e-7 relative and the worst leaf 2.9e-3 / 3.5e-3
# / 1.3e-2 of its largest on the card at this depth (NVIDIA H100 80GB HBM3,
# 700.00 W, seed 0; at smoke width on the CPU, seeds 0-2: within 1.5e-7 and
# 8.4e-6 / 1.2e-5 / 1.2e-3); with a fault planted in the partitioned blocks
# (the norms' sum over "model" taken out, MLA's latent norm over the rank's
# slice alone or its k_nope / v unsummed, the SSM's B / C not gathered or
# its gated norm over the rank's channels alone, the shared block's first
# use dropped) the worst leaf reads 0.626-2.11 on the card (0.55-4.6 on the
# CPU), the forward faults' first loss 6.75e-4-4.8e-3.  Each bar sits at the
# geometric mean of the largest sound reading and the least fault one.
MESH_GRAD_BARS = {
    "mla": {"loss_rtol": 1.3e-5, "worst_over_leaf_max": 0.047},
    "ssm": {"loss_rtol": 2.6e-5, "worst_over_leaf_max": 0.050},
    "hybrid": {"loss_rtol": 2.2e-5, "worst_over_leaf_max": 0.090}}


def encdec_flash_shapes() -> dict:
    """The encdec phase's flash launches as ``check_flash_attention``
    keywords: Whisper-medium's encoder and cross attention (non-causal) and
    InternVL2-76B's heads at its text prefill (causal)."""
    w, vlm = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    (B, S), F = ENCDEC_PROMPT, w.n_frames
    heads = dict(H=w.n_heads, Kh=w.n_kv_heads, D=w.hd, B=B, causal=False)
    return {"whisper_encoder": dict(S=F, **heads),
            "whisper_cross": dict(S=S, Skv=F, **heads),
            "vlm": dict(S=VLM_PROMPT[1], H=vlm.n_heads, Kh=vlm.n_kv_heads,
                        D=vlm.hd)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median of CUDA-event timings of single calls, after warm-up.  Every
    timed call is preceded by a write of 256 MB, which flushes the 50 MB L2
    (the engine finds K/V and weights cold), and by a ~1 ms device-side
    spin, which keeps the device busy while the host enqueues the call, so
    the events time the device's work and not the host's launch gaps.  Given
    several functions (a kernel and its yardstick), their calls alternate
    rep by rep, so that drift of the card's state falls on all of them
    alike.  One synchronise at the end."""

    def __init__(self, reps: int = 20, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, *fns):
        """The median ms of the one function, or a list, one per function."""
        for fn in fns:
            for _ in range(self.warmup):
                fn()
        events = [[] for _ in fns]
        for _ in range(self.reps):
            for fn, evs in zip(fns, events):
                self.flush.zero_()
                torch.cuda._sleep(2_000_000)  # clock cycles, ~1 ms
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                evs.append((start, end))
        torch.cuda.synchronize()
        ms = [statistics.median(s.elapsed_time(e) for s, e in evs)
              for evs in events]
        return ms[0] if len(fns) == 1 else ms


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = card()
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def ptxas_report(log: str) -> dict:
    """Per entry function of one library, from ``nvcc -Xptxas -v``:
    registers, spill-store bytes and static shared memory (dynamic shared
    memory is set at launch and not listed)."""
    report = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        smem = re.search(r"(\d+) bytes smem", chunk)
        report[chunk.split("'", 1)[0]] = {
            "registers": int(re.search(r"Used (\d+) registers", chunk).group(1)),
            "spill_store_bytes": int(re.search(r"(\d+) bytes spill stores",
                                               chunk).group(1)),
            "smem_static_bytes": int(smem.group(1)) if smem else 0}
    if shutil.which("c++filt"):  # readable kernel names where binutils has them
        names = subprocess.run(["c++filt"], input="\n".join(report), text=True,
                               capture_output=True, check=True).stdout.splitlines()
        report = {n.replace("(anonymous namespace)::", "").split("(", 1)[0]
                  .removeprefix("void "): r for n, r in zip(names, report.values())}
    return report


def phase_build() -> None:
    t0 = time.perf_counter()
    info = build.build()
    for name in build.SIGNATURES:  # load every library: fails if one is bad
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": {n: round(i["seconds"], 2) for n, i in info.items()},
          "ptxas": {n: ptxas_report(i["log"]) for n, i in info.items()}})


def check_paged_attention(dtype, timer, B=8, P=64, q_dtype=None, Kh=8,
                          G=2, D=128) -> dict:
    """Decode attention at qwen3-1.7b's heads (Kh 8, G 2, D 128, 16-token
    pages; Qwen3-30B-A3B's are Kh 4, G 8, yi-34b's Kh 8, G 7 and
    Nemotron-4-340B's Kh 8, G 12, D 192) over B sequences of up to P pages
    each; a full table and a one-token sequence among them
    (``_torch_checks.paged_case``).
    ``dtype`` is the pools', ``q_dtype`` (default the same) q's and the
    output's; each pair is held to its own bar (``paged_bar``), and
    ``bar_share`` is the largest share of it used.  ``launches_per_call``
    counts the kernel's launches in one wrapper call (the design makes it
    1).  A same-dtype output at a shape ``PAGED_SHA256`` holds must be
    bitwise the one it holds."""
    q_dtype = q_dtype or dtype
    T = 16
    H = Kh * G
    q, k_pool, v_pool, bt, lens = paged_case(q_dtype, dtype, B, P, Kh, G, D, T,
                                             seed=SEED)
    n0 = ops.launches["paged_attention"]
    got = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    per_call = ops.launches["paged_attention"] - n0
    if per_call != 1:
        raise AssertionError(f"paged_attention: {per_call} launches per call")
    if got.dtype != q_dtype:
        raise AssertionError(f"paged_attention: output {got.dtype}, q {q_dtype}")
    want = ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)
    share = check_paged_close(got, want, paged_bar(q, k_pool, v_pool, bt,
                                                   lens, want))
    sha = {}
    if q_dtype == dtype and (B, P, Kh, G, D, T) in PAGED_SHA256:
        sha = {"sha256": digest(got), "sha256_parent": PAGED_SHA256[
            (B, P, Kh, G, D, T)][dtype == torch.float32]}
        sha["bitwise_parent"] = sha["sha256"] == sha["sha256_parent"]
        if not sha["bitwise_parent"]:
            raise AssertionError(f"paged_attention {dtype} B={B}: output is "
                                 f"not bitwise the earlier kernel's")
    n_tok = int(lens.sum())
    b_ms, b_by = report.kernel_bound_ms(work.paged_attention(
        B=B, H=H, Kh=Kh, D=D, tokens=n_tok,
        pages=int(((lens + T - 1) // T).sum()), q_dtype=q_dtype,
        kv_dtype=dtype))
    kernel_ms = timer(lambda: ops.paged_attention(q, k_pool, v_pool, bt, lens))
    return {"q_dtype": str(q_dtype), "max_abs_err": max_err(got, want),
            "bar_share": share, "launches_per_call": per_call, **sha,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.paged_attention_ref(q, k_pool, v_pool, bt, lens)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / kernel_ms,
            "shape": {"B": B, "Kh": Kh, "G": G, "D": D, "page_T": T, "P": P,
                      "tokens": n_tok}}


def check_flash_attention(dtype, S, timer, H=16, Kh=8, D=128, *, B=1,
                          Skv=None, causal=True) -> dict:
    """Prefill attention at qwen3-1.7b's heads (H 16, Kh 8, D 128;
    Qwen3-30B-A3B's are H 32, Kh 4; Zamba2-7B's H 32, Kh 32, D 112, which
    the wrapper zero-pads to a launch at 128; InternVL2-76B's H 64, Kh 8;
    Whisper-medium's H 16, Kh 16, D 64) of B sequences, S query rows over
    ``Skv`` keys (default S), causal (with Skv = S) or not (Whisper's
    encoder and cross attention), in the model's (B, S, H, D) layout; the
    launch must take the route that ``ops.flash_route`` names for (dtype,
    D).  The bound counts the work at D itself: the causal triangle, or
    every row against every key."""
    Skv = S if Skv is None else Skv
    if causal and Skv != S:
        raise ValueError("causal lines have Skv = S")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    route = ops.flash_route(dtype, D)
    before = ops.flash_routes[route]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if ops.flash_routes[route] != before + 1:
        raise AssertionError(f"flash_attention {dtype} S={S}: not on the "
                             f"{route} route")
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # yardstick: the library's fused attention on the same inputs in its
    # (B, H, S, D) layout, kv heads expanded beforehand so it runs its
    # multi-head path
    qh = q.transpose(1, 2).contiguous()
    k_h = k.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    v_h = v.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    b_ms, b_by = report.kernel_bound_ms(work.flash_attention(
        B=B, H=H, Kh=Kh, Sq=S, Skv=Skv, D=D, dtype=dtype, causal=causal))
    kernel_ms, library_ms = timer(
        lambda: ops.flash_attention(q, k, v, causal=causal),
        lambda: F.scaled_dot_product_attention(qh, k_h, v_h,
                                               is_causal=causal))
    return {"flash_route": route, "max_abs_err": max_err(got, want),
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal)),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "H": H, "Kh": Kh, "S": S, "D": D,
                      **({} if Skv == S else {"Skv": Skv}),
                      "launch_D": D,
                      "causal": causal}}


def check_flash_offset(dtype, timer, Sq=512, Skv=1024) -> dict:
    """The prefix-hit shape: Sq query rows at absolute positions q_offset +
    i (q_offset = Skv - Sq, a cached prefix) over Skv keys, causal.  Held to
    the plain version, and bit for bit to the same rows of the q_offset = 0
    call over all Skv rows.  Yardstick: ``scaled_dot_product_attention``
    with ``causal_lower_right``, which is this mask when q_offset = Skv -
    Sq."""
    from torch.nn.attention.bias import causal_lower_right
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Kh, D, off = 1, 16, 8, 128, Skv - Sq
    q_all = torch.randn(B, Skv, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(dtype)
    q = q_all[:, off:]
    route = ops.flash_route(dtype, D)
    before = ops.flash_offsets["nonzero"], ops.flash_routes[route]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    if (ops.flash_offsets["nonzero"], ops.flash_routes[route]) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"flash_attention q_offset {dtype}: not one "
                             f"offset launch on the {route} route")
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    whole = ops.flash_attention(q_all, k, v, causal=True)
    rows_equal = bool(torch.equal(got, whole[:, off:]))
    if not rows_equal:
        raise AssertionError(f"flash_attention q_offset {dtype}: rows differ "
                             f"from the q_offset = 0 call's")
    qh = q.transpose(1, 2).contiguous()
    k_h = k.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    v_h = v.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
    mask = causal_lower_right(Sq, Skv)
    b_ms, b_by = report.kernel_bound_ms(work.flash_attention(
        B=B, H=H, Kh=Kh, Sq=Sq, Skv=Skv, D=D, dtype=dtype, causal=True,
        q_offset=off))
    kernel_ms, library_ms = timer(
        lambda: ops.flash_attention(q, k, v, causal=True, q_offset=off),
        lambda: F.scaled_dot_product_attention(qh, k_h, v_h, attn_mask=mask))
    return {"flash_route": route, "q_offset": off,
            "max_abs_err": max_err(got, want), "rows_bitwise_equal": rows_equal,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, q_offset=off)),
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "H": H, "Kh": Kh, "Sq": Sq, "Skv": Skv, "D": D,
                      "causal": True}}


def check_segment_compact(dtype, E, timer) -> dict:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, n_pages, moves = 28, 481, 64  # the engine's flattened pool, one plan
    N, M = L * n_pages, L * moves
    if dtype == torch.int32:
        pool = torch.randint(0, 1 << 30, (N, E), generator=g, device="cuda",
                             dtype=torch.int32)
    else:
        pool = torch.randn(N, E, generator=g, device="cuda").to(dtype)
    src = torch.randint(0, N, (M,), generator=g, device="cuda", dtype=torch.int32)
    got = ops.segment_compact(pool, src)
    want = ref.segment_compact_ref(pool, src)
    if not torch.equal(got, want):
        raise AssertionError(f"segment_compact {dtype} E={E}: copy not exact")
    b_ms, b_by = report.kernel_bound_ms(work.segment_compact(M=M, E=E,
                                                             dtype=dtype))
    src_l = src.long()
    kernel_ms, library_ms = timer(lambda: ops.segment_compact(pool, src),
                                  lambda: torch.index_select(pool, 0, src_l))
    return {"max_abs_err": 0.0, "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.segment_compact_ref(pool, src)),
            "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"N": N, "M": M, "E": E}}


def check_segment_move(overlap: bool, timer) -> dict:
    """One compaction plan at the engine's shape: 64 moves in every one of
    28 layers of the K and V pools of 481 pages of E = 16,384 bf16 (one
    16-token page of 8 heads x 128).  With ``overlap`` half of the
    destinations are other moves' sources, so the wrapper stages it."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    L, n_pages, moves, E = 28, 481, 64, 16384
    k_pool, v_pool = (torch.randn(L, n_pages, E, generator=g, device="cuda")
                      .to(torch.bfloat16) for _ in range(2))
    perm = np.random.default_rng(SEED).permutation(n_pages)
    src, dst = perm[:moves], perm[moves:2 * moves].copy()
    if overlap:
        dst[:moves // 2] = np.roll(src, 1)[:moves // 2]
    want = (k_pool.clone(), v_pool.clone())
    ref.segment_move_ref(want, src, dst)
    n0, form = ops.launches["segment_move"], "staged" if overlap else "direct"
    before = ops.move_plans[form]
    ops.segment_move((k_pool, v_pool), src, dst)
    torch.cuda.synchronize()
    if ops.move_plans[form] != before + 1:
        raise AssertionError(f"segment_move: the plan was not moved {form}")
    if not (torch.equal(k_pool, want[0]) and torch.equal(v_pool, want[1])):
        raise AssertionError(f"segment_move {form}: move not exact")
    launches = ops.launches["segment_move"] - n0
    del want
    src_t, dst_t = (torch.from_numpy(a).cuda() for a in (src, dst))

    def expression():  # the PyTorch expression of the same move
        for p in (k_pool, v_pool):
            p[:, dst_t] = p[:, src_t]

    b_ms, b_by = report.kernel_bound_ms(work.segment_move(
        L=L, moves=moves, E=E, dtype=k_pool.dtype))
    kernel_ms, expression_ms = timer(
        lambda: ops.segment_move((k_pool, v_pool), src, dst), expression)
    return {"form": form, "launches_per_plan": launches, "max_abs_err": 0.0,
            "kernel_ms": kernel_ms,
            "plain_ms": timer(lambda: ref.segment_move_ref((k_pool, v_pool), src, dst)),
            "expression_ms": expression_ms, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"L": L, "n_pages": n_pages, "moves": moves, "E": E}}


def phase_kernels() -> dict:
    timer = Timer()
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        r = check_paged_attention(dtype, timer)
        emit({"phase": "kernel", "name": "paged_attention", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16:  # the main path runs bf16
            main["paged_attention"] = r
    # long context: 32 sequences of up to 4,096 tokens (~270 MB of K/V),
    # where bytes and not launch latency set the time
    r = check_paged_attention(torch.bfloat16, timer, B=32, P=256)
    emit({"phase": "kernel", "name": "paged_attention", "dtype": "torch.bfloat16", **r})
    # mixed: q (the parameters' dtype) apart from the pools', at both shapes
    for q_dtype, dtype in MIXED_PAIRS:
        for B, P in ((8, 64), (32, 256)):
            r = check_paged_attention(dtype, timer, B=B, P=P, q_dtype=q_dtype)
            emit({"phase": "kernel", "name": "paged_attention", "step": "mixed",
                  "dtype": str(dtype), **r})
    torch.cuda.empty_cache()
    for dtype, S in [(torch.bfloat16, S) for S in FLASH_BUCKETS] + [(torch.float32, 1024)]:
        r = check_flash_attention(dtype, S, timer)
        emit({"phase": "kernel", "name": "flash_attention", "dtype": str(dtype), **r})
        if S == max(FLASH_BUCKETS):
            main["flash_attention" if dtype == torch.bfloat16
                 else "flash_attention_f32"] = r
    for dtype in (torch.bfloat16, torch.float32):
        r = check_flash_offset(dtype, timer)
        emit({"phase": "kernel", "name": "flash_attention", "dtype": str(dtype), **r})
        if dtype == torch.float32:
            main["flash_attention_f32_hit"] = r
    # a chunked prefill's last chunk of a 1,024-token prompt
    r = check_flash_offset(torch.bfloat16, timer, Sq=PREFILL_CHUNK)
    emit({"phase": "kernel", "name": "flash_attention", "dtype": "torch.bfloat16", **r})
    # the moe phase's heads (Qwen3-30B-A3B: 32 q over 4 kv heads): paged
    # attention at G 8 and flash at H 32 / Kh 4, each beside its plain
    # version and bound, flash also beside the library
    moe = get_config(MOE_ARCH)
    Kh, G = moe.n_kv_heads, moe.n_heads // moe.n_kv_heads
    r = check_paged_attention(torch.bfloat16, timer, Kh=Kh, G=G)
    emit({"phase": "kernel", "name": "paged_attention", "model": MOE_ARCH,
          "dtype": "torch.bfloat16", **r})
    main["paged_attention_moe"] = r
    # yi-34b's heads (56 q over 8 kv: G 7), which the yi phase decodes,
    # and Nemotron-4-340B's (96 over 8 of D 192: G 12, two chunks of 6
    # heads): the kernel's second instance family
    for key, arch in (("yi", YI_ARCH), ("nemotron", NEMOTRON_ARCH)):
        c = get_config(arch)
        r = check_paged_attention(torch.bfloat16, timer, Kh=c.n_kv_heads,
                                  G=c.n_heads // c.n_kv_heads, D=c.hd)
        emit({"phase": "kernel", "name": "paged_attention", "model": arch,
              "dtype": "torch.bfloat16", **r})
        main[f"paged_attention_{key}"] = r
    r = check_flash_attention(torch.bfloat16, max(FLASH_BUCKETS), timer,
                              H=moe.n_heads, Kh=Kh)
    emit({"phase": "kernel", "name": "flash_attention", "model": MOE_ARCH,
          "dtype": "torch.bfloat16", **r})
    main["flash_attention_moe"] = r
    # the families phase's shared attention (Zamba2-7B: 32 q over 32 kv
    # heads of D 112, launched at D)
    zamba = get_config(ZAMBA_ARCH)
    r = check_flash_attention(torch.bfloat16, max(FLASH_BUCKETS), timer,
                              H=zamba.n_heads, Kh=zamba.n_kv_heads,
                              D=zamba.hd)
    emit({"phase": "kernel", "name": "flash_attention", "model": ZAMBA_ARCH,
          "dtype": "torch.bfloat16", **r})
    main["flash_attention_zamba2"] = r
    # Nemotron-4-340B's heads (96 q over 8 kv heads of D 192), whose
    # prefill the dry-run counts on the kernel, in bf16 and f32
    nemo = get_config(NEMOTRON_ARCH)
    for dtype, key in ((torch.bfloat16, "nemotron"),
                       (torch.float32, "nemotron_f32")):
        r = check_flash_attention(dtype, max(FLASH_BUCKETS), timer,
                                  H=nemo.n_heads, Kh=nemo.n_kv_heads,
                                  D=nemo.hd)
        emit({"phase": "kernel", "name": "flash_attention",
              "model": NEMOTRON_ARCH, "dtype": str(dtype), **r})
        main[f"flash_attention_{key}"] = r
    # the encdec phase's shapes: Whisper-medium's encoder (non-causal, 1,500
    # frames over 1,500) and cross attention (the prompt's 384 rows over
    # 1,500 frame keys), H 16 / Kh 16, D 64, B 2; InternVL2-76B's heads (H
    # 64 / Kh 8, D 128) at its S 1,024 text prefill
    for key, kw in encdec_flash_shapes().items():
        r = check_flash_attention(torch.bfloat16, timer=timer, **kw)
        emit({"phase": "kernel", "name": "flash_attention",
              "model": key, "dtype": "torch.bfloat16", **r})
        main[f"flash_attention_{key}"] = r
    for dtype, E in ((torch.bfloat16, 16384), (torch.int32, 16383)):
        r = check_segment_compact(dtype, E, timer)
        emit({"phase": "kernel", "name": "segment_compact", "dtype": str(dtype), **r})
        if dtype == torch.bfloat16:
            main["segment_compact"] = r
    torch.cuda.empty_cache()
    for overlap in (False, True):
        r = check_segment_move(overlap, timer)
        emit({"phase": "kernel", "name": "segment_move", "dtype": "torch.bfloat16", **r})
        if not overlap:  # the summary's time: one launch of the kernel
            main["segment_move"] = r
    del timer
    torch.cuda.empty_cache()
    return main


def check_victims(N: int, timer) -> dict:
    """The device route of victim selection over N segments of S = 512
    pages (bench_kernels.py's paper-scale row: live in [0, S), up2 ~ U(0,
    1e6), u_now = 2e6), k = 64 (the paper's clean batch)."""
    S, k, u_now = 512, 64, 2e6
    g = torch.Generator(device="cuda").manual_seed(SEED)
    live = torch.randint(0, S, (N,), generator=g, device="cuda").float()
    live[::1021] = S  # a few full segments, so all three key branches occur
    up2 = torch.rand(N, generator=g, device="cuda") * 1e6
    # victims among live in [1, S): no empty or full segment, a strict order
    live_v = torch.randint(1, S, (N,), generator=g, device="cuda").float()
    eligible = torch.ones(N, dtype=torch.bool, device="cuda")

    torch.cuda.synchronize()
    ops.reset_launches()
    ids, valid = ops.mdc_select_victims(live_v, up2, u_now, S=S, k=k)
    pkey = policies.torch_key_mdc(live_v, S, up2, u_now)
    pids, pvalid = policies.torch_select_victims(pkey, eligible, k,
                                                 live=live_v, S=S)
    torch.cuda.synchronize()
    launches = ops.launches["mdc_priority"]
    if launches == 0:
        raise AssertionError("the victim route never launched mdc_priority")

    got = ops.mdc_priority(live, up2, u_now, S=S)
    want = ref.mdc_priority_ref(live, up2, u_now, S)
    if not (torch.equal(got == -1, want == -1)
            and torch.equal(torch.isinf(got), torch.isinf(want))):
        raise AssertionError(f"mdc_priority N={N}: -1 / +inf pattern differs")
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=0)
    err = (got[fin] - want[fin]).abs()

    _, plain_ids = torch.topk(-ref.mdc_priority_ref(live_v, up2, u_now, S), k)
    want_set = set(plain_ids.tolist())
    if not (bool(valid.all()) and bool(pvalid.all())
            and set(ids.tolist()) == want_set == set(pids.tolist())):
        raise AssertionError(f"victims N={N}: kernel route != plain route")
    lv = live_v.cpu().numpy().astype(np.int64)
    u2 = up2.cpu().numpy().astype(np.float64)
    host = policies.select_victims("mdc", k, live=lv, S=S, up2=u2,
                                   seal_time=np.zeros(N), u_now=u_now,
                                   eligible=np.ones(N, bool))
    key64 = policies.key_mdc(live=lv, S=S, up2=u2, u_now=u_now)
    np.testing.assert_allclose(np.sort(key64[ids.cpu().numpy()]),
                               np.sort(key64[host]), rtol=1e-5)

    b_ms, b_by = report.kernel_bound_ms(work.mdc_priority(N=N))
    return {"N": N, "S": S, "k": k, "launches": launches,
            "keys": {"empty": int((want == -1).sum()),
                     "full": int(torch.isinf(want).sum()),
                     "finite": int(fin.sum())},
            "same_pattern": True, "equal_victims": True,
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / want[fin].abs()).max()),
            "kernel_ms": timer(lambda: ops.mdc_priority(live, up2, u_now, S=S)),
            "plain_ms": timer(lambda: ref.mdc_priority_ref(live, up2, u_now, S)),
            "select_ms": timer(lambda: ops.mdc_select_victims(
                live, up2, u_now, S=S, k=k)),
            "plain_select_ms": timer(lambda: torch.topk(
                -ref.mdc_priority_ref(live, up2, u_now, S), k)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


def phase_victims() -> tuple[dict, int]:
    """Both shapes; returns the paper-scale result (the kernels line's
    times) and the launches of the route summed over both."""
    timer = Timer()
    results = []
    for N in (51_200, 1 << 24):
        results.append(check_victims(N, timer))
        emit({"phase": "victims", **results[-1]})
    del timer
    torch.cuda.empty_cache()
    return results[0], sum(r["launches"] for r in results)


def long_requests(vocab: int, news=(16, 16, 16, 16)) -> list:
    """The f32 legs' 4 requests: prompts of 300-1,000 tokens (seed 2),
    ``news`` new tokens (16 each in the chunked phase)."""
    rng = np.random.default_rng(SEED + 2)
    return [(rng.integers(1, vocab, int(n)), int(m))
            for n, m in zip(rng.integers(300, 1001, 4), news)]


def yi_requests(vocab: int) -> list:
    """The yi phase's ``YI_REQUESTS`` requests: prompts of 256-512 tokens
    (seed 3), ``YI_NEW`` new tokens each."""
    rng = np.random.default_rng(SEED + 3)
    return [(rng.integers(1, vocab, int(n)), YI_NEW)
            for n in rng.integers(256, 513, YI_REQUESTS)]


def engine_requests(vocab: int) -> tuple[list, np.ndarray]:
    """The engine phase's 32 requests: prompts of 256-1024 tokens, 32-128
    new tokens (seed 0)."""
    rng = np.random.default_rng(SEED)
    plens = rng.integers(256, 1025, 32)
    news = rng.integers(32, 129, 32)
    return [rng.integers(1, vocab, p) for p in plens], news


def prefix_requests(vocab: int, n: int = 16) -> list:
    """n requests sharing one PREFIX_LEN-token system prompt, each with its
    own tail of 64-256 tokens and 32-64 new tokens (seed 0)."""
    rng = np.random.default_rng(SEED)
    system = rng.integers(1, vocab, PREFIX_LEN)
    tails, news = rng.integers(64, 257, n), rng.integers(32, 65, n)
    return [(np.concatenate([system, rng.integers(1, vocab, t)]), int(m))
            for t, m in zip(tails, news)]


def phase_engine(cfg) -> dict:
    """32 requests (prompts 256-1024 tokens, 32-128 new tokens) through a
    pool of 30 slabs x 16 pages x 16 tokens: 8 slots of such requests hold
    up to ~9k tokens, so a 7,680-token pool with one open stream fills,
    checkerboards and compacts under pressure (no forced compaction).
    Returns the run (``serve``), for the chunked phase to compare with."""
    model = Model(cfg, device="cuda", seed=SEED)
    prompts, news = engine_requests(cfg.vocab_size)
    run = serve(model, [(p, int(n)) for p, n in zip(prompts, news)])
    del model
    m, launches = run["metrics"], run["launches"]
    if m["compactions"] < 1:
        raise AssertionError("the pool never compacted under pressure")
    missing = [k for k in ENGINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    if run["flash_routes"]["wgmma"] == 0:
        raise AssertionError("the prefill's flash attention never took the "
                             "tensor-core route")
    emit({"phase": "engine", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(prompts), "prompt_tokens": int(sum(map(len, prompts))),
          **stream_summary(run), "compactions": m["compactions"],
          "blocks_written": m["blocks_written"],
          "blocks_moved": m["blocks_moved"], "wamp": m["wamp"],
          "flash_routes": run["flash_routes"],
          "staged_plans": run["move_plans"]["staged"],
          "direct_plans": run["move_plans"]["direct"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return run


def oracle_margins(params, prompt, cfg, n_new, cache_dtype=torch.float32,
                   tops=None):
    """The plain greedy decode again, recording each step's top-2 logit
    margin (how close the argmax was to a tie), and each step's top logit
    into ``tops`` where given."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    logits, cache = tfm.prefill(params, toks, cfg, len(prompt) + n_new + 1,
                                cache_dtype=cache_dtype, kernel=False)
    out, margins = [], []
    while True:
        top = torch.topk(logits[0].float(), 2).values
        margins.append(float(top[0] - top[1]))
        if tops is not None:
            tops.append(float(top[0]))
        out.append(int(torch.argmax(logits[0])))
        if len(out) == n_new:
            return out, margins
        logits, cache = tfm.decode_step(
            params, cache, torch.tensor([out[-1]], device=dev), cfg)


def phase_tokens(cfg) -> None:
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    rng = np.random.default_rng(SEED + 1)
    prompt, n_new = rng.integers(1, cfg.vocab_size, 128), 16
    eng = PagedServingEngine(model, n_slabs=4, blocks_per_slab=16, page_T=16,
                             max_batch=1, max_seq=256, pool_dtype=torch.float32,
                             device="cuda")
    rid = eng.submit(prompt, n_new)
    eng.run_to_completion()
    got = eng.finished[rid]
    want = tfm.greedy_decode(model.params, prompt, cfg, n_new,
                             cache_dtype=torch.float32)
    replay, margins = oracle_margins(model.params, prompt, cfg, n_new)
    if replay != want:
        raise AssertionError("the plain decode is not deterministic")
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    at = margins[first] if first is not None else None
    emit({"phase": "tokens", "dtype": "float32", "prompt_len": len(prompt),
          "new_tokens": n_new, "equal": got == want, "first_mismatch": first,
          "margin_at_mismatch": at, "min_margin": min(margins)})
    if first is not None and not at < 1e-3:
        raise AssertionError(f"engine tokens {got} != plain {want} at {first} "
                             f"(top-2 margin {at})")


def timed(fn, events: list):
    """``fn`` with each call bracketed by a pair of CUDA events, appended to
    ``events``."""
    def call(*args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        out = fn(*args, **kwargs)
        ev[1].record()
        events.append(ev)
        return out
    return call


def serve(model, requests, setup=None, **kw) -> dict:
    """One engine over ``requests`` on the card, launch counters zeroed just
    before and read just after.  Each admission's prefill and each
    ``step()`` that dispatched are bracketed by CUDA events: the stream's
    time from the first launch to the last, host gaps included (the eager
    engine is host-bound), so a dispatch's time is its wall and the largest
    is the longest any decoding slot waited for its next tokens.
    ``setup(engine)`` runs before the first submission."""
    eng = PagedServingEngine(model, **{**POOL, **kw}, device="cuda")
    # what this process holds on the card once the engine is built: its
    # weights and pools, and anything else still alive in it
    memory = {"memory_allocated": torch.cuda.memory_allocated(),
              "param_bytes": sum(t.numel() * t.element_size()
                                 for _, t in flatten(eng.params)),
              "pool_bytes": 2 * eng.k_pools.numel() * eng.k_pools.element_size()}
    if setup is not None:
        setup(eng)
    events, steps = [], []
    eng._start = timed(eng._start, events)
    step = timed(eng.step, steps)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n) for p, n in requests]
    dispatched = []
    for _ in range(100_000):
        before = eng.dispatches
        step()
        dispatched.append(eng.dispatches > before)
        if not eng.has_work():
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"launches": dict(ops.launches), "flash_routes": dict(ops.flash_routes),
              "flash_offsets": dict(ops.flash_offsets),
              "move_plans": dict(ops.move_plans),
              "stream_launches": {k: dict(v) for k, v in ops.stream_launches.items()},
              "side_stream": eng._side.cuda_stream if eng._side is not None else None}
    eng.pool.check_invariants()
    if eng.prefix_cache is not None:
        eng.prefix_cache.check_invariants()
    tokens = [eng.finished[r] for r in rids]
    for t, (_, n) in zip(tokens, requests):
        if len(t) != n:
            raise AssertionError(f"a request emitted {len(t)} tokens, want {n}")
    return {"tokens": tokens, "metrics": eng.metrics(), "wall_s": wall,
            "memory": memory,
            "prefill_stream_ms": sum(a.elapsed_time(b) for a, b in events),
            "prefills": len(events),
            "dispatch_ms": [a.elapsed_time(b) for (a, b), d in zip(steps, dispatched)
                            if d], **counts}


def stream_summary(run) -> dict:
    """Throughput and per-dispatch wall of one ``serve`` run."""
    gen = sum(len(t) for t in run["tokens"])
    return {"generated_tokens": gen, "wall_s": run["wall_s"],
            "tokens_per_s": gen / run["wall_s"],
            "dispatches": run["metrics"]["dispatches"],
            "dispatch_ms_median": statistics.median(run["dispatch_ms"]),
            "dispatch_ms_max": max(run["dispatch_ms"]),
            "launches": run["launches"]}


def phase_prefix(cfg) -> dict:
    """bf16 at full width, cold then hit, on the engine phase's pool; then
    the f32 leg (4 requests, f32 weights and pool) whose tokens are held."""
    reqs = prefix_requests(cfg.vocab_size)
    model = Model(cfg, device="cuda", seed=SEED)
    # cold, then hit (one pair: a second pair in turns, for the walls'
    # noise, gave its time to the encdec phase; the cold-against-hit
    # prefill times in turns are ``scripts/profile_engine.py``'s)
    runs = {name: [serve(model, reqs, prefix_cache=on)]
            for name, on in (("cold", False), ("hit", True))}
    del model
    torch.cuda.empty_cache()
    cold, hit = runs["cold"][-1], runs["hit"][-1]
    m = hit["metrics"]
    if m["prefix_hit_rate"] < 15 / 16 or m["prefill_tokens_saved"] <= 0 \
            or m["frames_shared"] <= 0:
        raise AssertionError(f"prefix cache: hit rate {m['prefix_hit_rate']}, "
                             f"saved {m['prefill_tokens_saved']}, shared "
                             f"{m['frames_shared']}")
    if hit["flash_offsets"]["nonzero"] == 0:
        raise AssertionError("no flash_attention launch with a query offset")
    missing = [k for k in ("flash_attention", "paged_attention")
               if hit["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the prefix path never launched {missing}")
    same = sum(a == b for a, b in zip(hit["tokens"], cold["tokens"]))

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = reqs[:4]
    f32 = {name: serve(model, small, prefix_cache=on,
                       pool_dtype=torch.float32)
           for name, on in (("cold", False), ("hit", True))}
    mismatches = []
    for (prompt, n), a, b in zip(small, f32["hit"]["tokens"],
                                 f32["cold"]["tokens"]):
        first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if first is None:
            continue
        _, margins = oracle_margins(model.params, prompt, cfg, n)
        mismatches.append({"first_mismatch": first,
                           "margin_at_mismatch": margins[first]})
        if not margins[first] < 1e-3:
            raise AssertionError(f"f32 prefix hit: tokens differ from cold at "
                                 f"{first} (plain top-2 margin {margins[first]})")
    if f32["hit"]["metrics"]["prefill_tokens_saved"] <= 0:
        raise AssertionError("f32 leg: no prefix hit")
    del model
    torch.cuda.empty_cache()

    def summary(rs):
        mm, r = rs[-1]["metrics"], rs[-1]
        return {"wall_s": [x["wall_s"] for x in rs],
                "prefill_stream_ms": [x["prefill_stream_ms"] for x in rs],
                "prefills": r["prefills"],
                "prefill_tokens_computed": mm.get("prefill_tokens_computed",
                                                  sum(len(p) for p, _ in reqs)),
                "compactions": mm["compactions"], "launches": r["launches"],
                "flash_offsets": r["flash_offsets"]}

    out = {"phase": "prefix", "model": cfg.name, "dtype": "bfloat16",
           "requests": len(reqs), "shared_prompt_tokens": PREFIX_LEN,
           "prompt_tokens": sum(len(p) for p, _ in reqs),
           "prefix_hit_rate": m["prefix_hit_rate"],
           "prefill_tokens_saved": m["prefill_tokens_saved"],
           "frames_shared": m["frames_shared"],
           "tokens_equal_share": same / len(reqs),
           "cold": summary(runs["cold"]), "hit": summary(runs["hit"]),
           "f32": {"requests": len(small),
                   "equal": f32["hit"]["tokens"] == f32["cold"]["tokens"],
                   "mismatches": mismatches,
                   "prefill_tokens_saved":
                       f32["hit"]["metrics"]["prefill_tokens_saved"]}}
    emit(out)
    return hit["launches"]


def phase_preemption(cfg) -> dict:
    """The engine phase's first 16 requests with preemption on, through a
    pool that forces preemption and one with room to spare: the resumed
    sequences must re-derive their tokens exactly (the decode batch is
    always max_batch rows, and every kernel of it is batch-invariant)."""
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts[:16], news[:16])]
    model = Model(cfg, device="cuda", seed=SEED)
    small, big = (serve(model, reqs, n_slabs=n, preemption=True)
                  for n in PREEMPT_SLABS)
    del model
    torch.cuda.empty_cache()
    ms, mb = small["metrics"], big["metrics"]
    if ms["preemptions"] < 1 or ms["resumes"] != ms["preemptions"]:
        raise AssertionError(f"small pool: {ms['preemptions']} preemptions, "
                             f"{ms['resumes']} resumes")
    if mb["preemptions"] != 0:
        raise AssertionError(f"big pool preempted {mb['preemptions']} times")
    missing = [k for k in ("flash_attention", "paged_attention")
               if small["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the preemption path never launched {missing}")
    diff = [i for i, (a, b) in enumerate(zip(small["tokens"], big["tokens"]))
            if a != b]
    emit({"phase": "preemption", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "pools_slabs": list(PREEMPT_SLABS),
          "preemptions": ms["preemptions"], "resumes": ms["resumes"],
          "recomputed_tokens": ms["recomputed_tokens"],
          "compactions": ms["compactions"], "tokens_equal": not diff,
          "differing_requests": diff, "wall_s": small["wall_s"],
          "big_pool_wall_s": big["wall_s"], "launches": small["launches"]})
    if diff:
        raise AssertionError(f"requests {diff}: tokens differ from the big "
                             f"pool's after preemption")
    return small["launches"]


def near_tie_bar(dtype, top: float) -> float:
    """The top-2 logit margin below which (or, in bf16, at which) the plain
    decode's argmax is a near-tie, for logits of ``dtype``: 1e-3 in f32;
    one bf16 step at the top logit in bf16 (2**(e - 7) for |top| in
    [2**e, 2**(e+1))), the least margin two bf16 logits can have and not be
    equal."""
    if dtype == torch.float32:
        return 1e-3
    return 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0


def first_mismatches(model, cfg, requests, runs,
                     cache_dtype=torch.float32) -> list:
    """Each request whose tokens in ``runs`` part from the plain decode (its
    dense cache in ``cache_dtype``): where, the plain decode's top-2 margin
    there, and whether that margin is a near-tie (``near_tie_bar`` of the
    parameters' dtype, which the logits take)."""
    out = []
    dtype = model.params["embed"].dtype
    for (prompt, n), got in zip(requests, runs):
        want = tfm.greedy_decode(model.params, prompt, cfg, n,
                                 cache_dtype=cache_dtype)
        first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                     None)
        if first is not None:
            tops = []
            _, margins = oracle_margins(model.params, prompt, cfg, n,
                                        cache_dtype, tops)
            bar = near_tie_bar(dtype, tops[first])
            out.append({"first_mismatch": first,
                        "margin_at_mismatch": margins[first],
                        "near_tie_bar": bar,
                        "near_tie": (margins[first] < bar
                                     if dtype == torch.float32
                                     else margins[first] <= bar)})
    return out


def phase_chunked(cfg, mono) -> tuple[dict, dict]:
    """The engine phase's 32 requests with chunked prefill (PREFILL_CHUNK
    tokens per fused dispatch) through the same pool, beside the engine
    phase's monolithic run ``mono`` (the process's first engine run, so
    its first dispatch also pays the first calls of every GEMM shape; a
    warm monolithic rerun gave its time to the encdec phase, and the
    chunk's device split is ``scripts/profile_engine.py``'s fused_chunk);
    then the f32 leg: 4 requests of 300 to 1,000 tokens (f32 weights and
    pool, TF32 off) whose chunked tokens must be the plain decode's, or
    part from it on a near-tie.  Returns the chunked run's launches."""
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    model = Model(cfg, device="cuda", seed=SEED)
    run = serve(model, reqs, prefill_chunk=PREFILL_CHUNK)
    del model
    torch.cuda.empty_cache()
    m = run["metrics"]
    chunks = sum(-(-len(p) // PREFILL_CHUNK) for p, _ in reqs)
    if m["prefill_chunks_dispatched"] != chunks:
        raise AssertionError(f"{m['prefill_chunks_dispatched']} chunks "
                             f"dispatched, want {chunks}")
    if m["compactions"] < 1:
        raise AssertionError("the chunked run never compacted")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"the chunked path never launched {missing}")
    if run["flash_offsets"]["nonzero"] == 0:
        raise AssertionError("no chunk ran flash_attention with a query offset")
    same = sum(a == b for a, b in zip(run["tokens"], mono["tokens"]))

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = long_requests(cfg.vocab_size)
    f32 = serve(model, small, prefill_chunk=PREFILL_CHUNK,
                pool_dtype=torch.float32)
    mismatches = first_mismatches(model, cfg, small, f32["tokens"])
    if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
        raise AssertionError(f"f32 chunked: tokens part from the plain decode "
                             f"off a near-tie: {mismatches}")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "chunked", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "prefill_chunk": PREFILL_CHUNK,
          "prefill_chunks_dispatched": m["prefill_chunks_dispatched"],
          "compactions": m["compactions"], "wamp": m["wamp"],
          "flash_offsets": run["flash_offsets"],
          "tokens_equal_share": same / len(reqs),
          "chunked": stream_summary(run),
          "monolithic": [stream_summary(mono)],
          "f32": {"requests": len(small),
                  "prompt_tokens": [len(p) for p, _ in small],
                  "chunks": f32["metrics"]["prefill_chunks_dispatched"],
                  "equal": not mismatches, "mismatches": mismatches}})
    return run["launches"]


def phase_async(cfg, mono) -> dict:
    """The engine phase's 32 requests and pool with async compaction at the
    default clean budget, ``audit()`` after every dispatch, beside the
    engine phase's synchronous run ``mono``; then the f32 leg, async
    against sync and the plain decode.  Every check is made before any fails, and the phase's
    line names each failure."""
    t0 = time.perf_counter()
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    model = Model(cfg, device="cuda", seed=SEED)
    run = serve(model, reqs, async_compaction=True, audit_every=1)
    del model
    torch.cuda.empty_cache()
    m, sync_m = run["metrics"], mono["metrics"]
    failures = []
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], mono["tokens"]))
            if a != b]
    if diff:
        failures.append(f"bf16 tokens differ from the synchronous run's in "
                        f"requests {diff}, first request {diff[0]}")
    counters = {k: m[k] for k in ASYNC_REHEARSED}
    if counters != ASYNC_REHEARSED or run["move_plans"] != ASYNC_PLANS:
        failures.append(f"counters {counters} {run['move_plans']} are not the "
                        f"rehearsal's {ASYNC_REHEARSED} {ASYNC_PLANS}")
    if not m["gc_planned"] == m["gc_committed"] > 0:
        failures.append(f"planned {m['gc_planned']} != committed "
                        f"{m['gc_committed']}, or no move")
    if m["compaction_debt_moves"] or m["fenced_slabs"]:
        failures.append(f"left {m['compaction_debt_moves']} moves and "
                        f"{m['fenced_slabs']} fenced slabs")
    if m["inflight_boundaries"] < 1:
        failures.append("no step boundary crossed with a move in flight")
    side = run["stream_launches"]["segment_move"].get(run["side_stream"], 0)
    if side < 1:
        failures.append("segment_move never launched on the side stream")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        failures.append(f"the async path never launched {missing}")

    # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
    bf = Model(cfg, device="cuda", seed=SEED).params
    model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
    del bf
    small = long_requests(cfg.vocab_size, ASYNC_F32_NEW)
    kw = dict(n_slabs=ASYNC_F32_SLABS, pool_dtype=torch.float32)
    f32 = serve(model, small, async_compaction=True, audit_every=1, **kw)
    f32_sync = serve(model, small, **kw)
    if f32["tokens"] != f32_sync["tokens"]:
        failures.append("f32 async tokens differ from the sync run's")
    if f32["metrics"]["gc_planned"] == 0:
        failures.append("the f32 leg's pool never compacted")
    mismatches = first_mismatches(model, cfg, small, f32["tokens"])
    if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
        failures.append(f"f32 async tokens part from the plain decode off a "
                        f"near-tie: {mismatches}")
    del model
    torch.cuda.empty_cache()
    emit({"phase": "async", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "clean_budget": DEFAULT_CLEAN_BUDGET,
          "tokens_equal": not diff, "differing_requests": diff,
          **{k: m[k] for k in ("compactions", "blocks_moved", "wamp",
                               "gc_planned", "gc_committed", "sub_plans",
                               "inflight_boundaries", "hazard_commits",
                               "drains", "dead_destination_waits",
                               "compaction_debt_moves", "fenced_slabs")},
          "direct_plans": run["move_plans"]["direct"],
          "staged_plans": run["move_plans"]["staged"],
          "move_launches": run["launches"]["segment_move"],
          "side_stream_move_launches": side,
          "sync_wamp": sync_m["wamp"], "sync_compactions": sync_m["compactions"],
          "wamp_equal": m["wamp"] == sync_m["wamp"],
          "wamp_within_half_percent":
              abs(m["wamp"] - sync_m["wamp"]) <= 0.005 * sync_m["wamp"],
          "async": stream_summary(run),
          "sync": [stream_summary(mono)],
          "f32": {"requests": len(small), "n_slabs": ASYNC_F32_SLABS,
                  "new_tokens": list(ASYNC_F32_NEW),
                  "gc_planned": f32["metrics"]["gc_planned"],
                  "sub_plans": f32["metrics"]["sub_plans"],
                  "inflight_boundaries": f32["metrics"]["inflight_boundaries"],
                  "equal_to_sync": f32["tokens"] == f32_sync["tokens"],
                  "equal_to_plain": not mismatches, "mismatches": mismatches},
          "phase_seconds": time.perf_counter() - t0, "failures": failures})
    if failures:
        raise AssertionError(f"async phase: {failures}")
    return run["launches"]


def capture(eng, root: Path, pick) -> dict:
    """Clone ``eng``'s journal directory into ``root / name`` the moment a
    record that ``pick`` names is appended: the disk state a kill at that
    record boundary leaves (the journal segments and the snapshot store as
    they were then).  Returns {name: (seq, submissions so far, directory)};
    its ``"kinds"`` entry counts the records of each type."""
    cuts, kinds = {}, {}
    cuts["kinds"] = kinds
    append = eng.journal.append

    def hooked(payload):
        seq = append(payload)
        rec = json.loads(payload)
        kinds[rec["t"]] = kinds.get(rec["t"], 0) + 1
        name = pick(eng, seq, rec)
        if name is not None:
            d = Path(root) / name
            shutil.copytree(eng.journal.root, d)
            cuts[name] = (seq, kinds.get("sub", 0), d)
        return seq

    eng.journal.append = hooked
    return cuts


def recover_drain(model, jdir, **kw) -> tuple[dict, dict]:
    """Recover a killed session from ``jdir`` and drain it.  Returns the
    finished tokens and a summary: the recovery report's counters, the
    ``load_session`` time, the time to recover (from ``recover_engine``
    until every resumed sequence has re-derived its journaled span), the
    drain's wall and the kernels' launches from ``recover_engine`` on."""
    sync = (torch.cuda.synchronize if torch.device(kw["device"]).type == "cuda"
            else (lambda: None))
    t = time.perf_counter()
    recovery.load_session(jdir, stop_token=kw.get("stop_token"))
    load_ms = (time.perf_counter() - t) * 1e3
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng, rep = recover_engine(model, jdir, **kw)
    spans = {r.rid: r.out_n for r in eng._resume}

    def caught_up():
        return all(rid in eng.finished or any(
            eng.rid[i] == rid and not eng._prefilling[i]
            and eng._out_n[i] >= span for i in range(eng.max_batch))
            for rid, span in spans.items())

    recovered_s = None
    for _ in range(100_000):
        if recovered_s is None and caught_up():
            sync()
            recovered_s = time.perf_counter() - t0
        if not eng.has_work():
            break
        eng.step()
    sync()
    wall = time.perf_counter() - t0
    eng.audit()
    finished = dict(eng.finished)
    summary = {k: rep[k] for k in ("snapshot_id", "records_replayed",
                                   "sequences_resumed", "requests_requeued",
                                   "tokens_replayed", "journal_torn_bytes")}
    summary.update(load_session_ms=load_ms, time_to_recover_s=recovered_s,
                   drain_s=wall, launches=dict(ops.launches),
                   journal_records_after=eng.metrics()["journal_records"])
    eng.journal.close()
    return finished, summary


# the counters a recovery's summary must share with the CPU rehearsal
RECOVERY_COUNTERS = ("snapshot_id", "records_replayed", "sequences_resumed",
                     "requests_requeued", "tokens_replayed")


def phase_recovery(cfg, mono) -> dict:
    """Crash safety on the card: a kill inside the async window and the
    f32 leg (see the module's docstring).  Every check is made before any
    fails, and the phase's line names each failure."""
    t0 = time.perf_counter()
    reh = RECOVERY_REHEARSED
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_recovery_"))
    failures, launches = [], {k: 0 for k in KERNELS}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    try:
        model = Model(cfg, device="cuda", seed=SEED)
        # a kill inside the async window, recovered in the same process from
        # its snapshot and the records after it
        akw = dict(POOL, async_compaction=True, audit_every=1, device="cuda",
                   snapshot_every=RECOVERY_SNAPSHOT_EVERY)
        eng = PagedServingEngine(model, journal_dir=root / "async", **akw)
        eng.before_side_move = lambda: torch.cuda._sleep(100_000_000)
        kinds = capture(eng, root / "cuts", lambda *a: None)["kinds"]
        for p, n in reqs:
            eng.submit(p, n)
        while eng.has_work() and not (eng.dispatches >= RECOVERY_ASYNC_FROM
                                      and eng._inflight_plans):
            eng.step()
        m = eng.metrics()
        kill = {"dispatch": eng.dispatches, "records": m["journal_records"],
                "mv_records": kinds.get("mv", 0), "record_kinds": kinds,
                "journal_bytes": m["journal_bytes"],
                "journal_wamp": m["journal_wamp"],
                "inflight_plans": len(eng._inflight_plans),
                "inflight_moves": sum(len(p) for p in eng._inflight_plans)}
        if not kill["inflight_moves"]:
            failures.append("async kill: no move in flight")
        if not kill["mv_records"]:
            failures.append("async kill: no mv record journaled")
        if kill["journal_wamp"] != 0.0:
            failures.append(f"async kill: journal Wamp "
                            f"{kill['journal_wamp']} != 0")
        eng = None                  # the kill, with the move still running
        gc.collect()
        got, asum = recover_drain(model, root / "async", **akw)
        add(asum["launches"])
        bad = [r for r in range(len(reqs)) if got.get(r) != mono["tokens"][r]]
        if bad:
            failures.append(f"async kill: tokens differ in requests {bad}")
        if {**{k: kill[k] for k in ("dispatch", "records", "mv_records")},
                **{k: asum[k] for k in RECOVERY_COUNTERS}} != reh["async"]:
            failures.append(f"async kill: {kill} {asum} is not the "
                            f"rehearsal's {reh['async']}")
        if not (asum["launches"]["flash_attention"]
                and asum["launches"]["paged_attention"]):
            failures.append("async kill: a recovery kernel never launched")
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # f32 leg: the tokens phase's weights at f32, an f32 pool, TF32 off
        bf = Model(cfg, device="cuda", seed=SEED).params
        model = Model(cfg, unflatten((p, t.float()) for p, t in flatten(bf)))
        del bf
        small = long_requests(cfg.vocab_size, ASYNC_F32_NEW)
        fkw = dict(n_slabs=ASYNC_F32_SLABS, pool_dtype=torch.float32)
        held = {}

        def setup32(eng):
            held["cuts"] = capture(
                eng, root / "f32cuts",
                lambda e, seq, rec: "middle" if seq == reh["f32_records"] // 2
                else None)

        run32 = serve(model, small, setup=setup32, journal_dir=root / "f32",
                      **fkw)
        add(run32["launches"])
        seq, n_sub, d = held["cuts"]["middle"]
        f32_records = run32["metrics"]["journal_records"]
        got, fsum = recover_drain(model, d, **{**POOL, **fkw}, device="cuda")
        add(fsum["launches"])
        fsum.update(seq=seq, submissions=n_sub)
        tokens32 = [got[r] for r in range(len(small))]
        if tokens32 != run32["tokens"]:
            failures.append("f32 leg: recovered tokens differ from the "
                            "unkilled run's")
        mismatches = first_mismatches(model, cfg, small, tokens32)
        if any(not x["margin_at_mismatch"] < 1e-3 for x in mismatches):
            failures.append(f"f32 leg: tokens part from the plain decode off "
                            f"a near-tie: {mismatches}")
        if ({"records": f32_records,
             **{k: fsum[k] for k in RECOVERY_COUNTERS}} != reh["f32"]):
            failures.append(f"f32 leg: {fsum} is not the rehearsal's "
                            f"{reh['f32']}")
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "recovery", "model": cfg.name, "dtype": "bfloat16",
          "requests": len(reqs), "snapshot_every": RECOVERY_SNAPSHOT_EVERY,
          "async_kill": {**kill, **asum},
          "f32": {"requests": len(small), "records": f32_records, **fsum,
                  "equal_to_unkilled": tokens32 == run32["tokens"],
                  "equal_to_plain": not mismatches, "mismatches": mismatches},
          "launches": launches, "phase_seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        raise AssertionError(f"recovery phase: {failures}")
    return launches


def check_chrome_trace(doc: dict) -> None:
    """The schema check of ``tests/test_obs.py::_check_chrome_trace``: the
    invariants Perfetto and chrome://tracing rely on."""
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    stacks: dict[tuple, list] = {}
    for ev in doc["traceEvents"]:
        assert ev["ph"] in "BEiCbne", ev
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert isinstance(ev["name"], str) and ev["name"]
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] in "bne":   # async events need an id to form a track
            assert "id" in ev, ev
        lane = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(lane, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks.get(lane), f"E without open B on {lane}: {ev}"
            assert stacks[lane].pop() == ev["name"], \
                f"span close out of order on {lane}: {ev}"
    assert all(not s for s in stacks.values()), f"unclosed spans: {stacks}"
    json.dumps(doc)   # exported document must round-trip as plain JSON


def phase_split(report: dict) -> dict:
    """The dispatch wall's percentiles and per-phase means (ms) of a
    ``phase_report()``, and compaction's share of the p99 tail."""
    return {k: report[k] for k in ("dispatches", "p50_ms", "p99_ms",
                                   "phase_mean_ms", "compaction_share_p99",
                                   "compaction_share_total")}


def phase_serve(cfg, mono, smi) -> dict:
    """Observability and the serving CLI on the card: the instrumented
    closed loop, the open loop and the CLI (see the module's docstring).
    Every check is made before any fails, and the phase's line names each
    failure."""
    t0 = time.perf_counter()
    out = ROOT / "build" / "serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    prompts, news = engine_requests(cfg.vocab_size)
    reqs = [(p, int(n)) for p, n in zip(prompts, news)]
    failures, launches = [], {k: 0 for k in KERNELS}

    def add(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    model = Model(cfg, device="cuda", seed=SEED)

    # a. the engine phase's run, instrumented
    tracer, held = Tracer(capacity=1 << 18), {}
    run = serve(model, reqs, setup=lambda eng: held.update(eng=eng),
                tracer=tracer, phase_log=True, calibration=True,
                metrics_every=SERVE_METRICS_EVERY,
                metrics_sink=out / "metrics.jsonl")
    add(run["launches"])
    eng = held.pop("eng")
    eng._metrics_logger.close()
    m, mm = run["metrics"], mono["metrics"]
    diff = [i for i, (a, b) in enumerate(zip(run["tokens"], mono["tokens"]))
            if a != b]
    if diff:
        failures.append(f"traced run: tokens differ from the engine phase's "
                        f"in requests {diff}")
    counters = ("compactions", "blocks_moved", "wamp")
    if {k: m[k] for k in counters} != {k: mm[k] for k in counters}:
        failures.append(f"traced run: {({k: m[k] for k in counters})} is not "
                        f"the engine phase's {({k: mm[k] for k in counters})}")
    doc = tracer.export(out / "trace.json")
    try:
        check_chrome_trace(doc)
    except AssertionError as e:
        failures.append(f"trace schema: {e}")
    names = {e["name"] for e in doc["traceEvents"]}
    if not SERVE_EVENTS <= names:
        failures.append(f"trace lacks {sorted(SERVE_EVENTS - names)}")
    pr = eng.phase_report()
    if pr["dispatches"] != m["dispatches"]:
        failures.append(f"phase_report counts {pr['dispatches']} dispatches, "
                        f"metrics() {m['dispatches']}")
    rows = (out / "metrics.jsonl").read_text().splitlines()
    if len(rows) < 2:
        failures.append(f"{len(rows)} metric rows")
    cal = eng.calibration.report()
    if cal["deaths"] <= 0:
        failures.append("no death calibrated")
    missing = [k for k in ENGINE_KERNELS if run["launches"][k] == 0]
    if missing:
        failures.append(f"traced run never launched {missing}")
    gen = sum(len(t) for t in run["tokens"])
    traced = {"tokens_equal": not diff, **{k: m[k] for k in counters},
              "wall_s": run["wall_s"], "tokens_per_s": gen / run["wall_s"],
              "engine_phase_wall_s": mono["wall_s"],
              "engine_phase_tokens_per_s": gen / mono["wall_s"],
              "wall_over_engine_phase": run["wall_s"] / mono["wall_s"],
              "events": len(tracer), "dropped_events": tracer.dropped,
              "event_counts": {n: sum(e["name"] == n for e in doc["traceEvents"])
                               for n in sorted(SERVE_EVENTS)},
              "phase_split": phase_split(pr),
              "misroute_rate": m["misroute_rate"],
              "calibrated_deaths": cal["deaths"], "unrouted": cal["unrouted"],
              "metric_rows": len(rows), "launches": run["launches"]}
    del eng, held
    gc.collect()
    torch.cuda.empty_cache()

    # b. the open loop at SERVE_ARRIVAL_RATE requests/s
    eng = PagedServingEngine(model, **POOL, phase_log=True, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t_ol = time.perf_counter()
    dispatches, lat = serve_cli._open_loop(eng, reqs, SERVE_ARRIVAL_RATE,
                                           np.random.default_rng(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_ol
    ol_launches = dict(ops.launches)
    add(ol_launches)
    eng.pool.check_invariants()
    got = [eng.finished.get(r, []) for r in range(len(reqs))]
    short = [r for r, (t, (_, n)) in enumerate(zip(got, reqs)) if len(t) != n]
    if short:
        failures.append(f"open loop: requests {short} did not finish with "
                        f"their token counts")
    if not (ol_launches["flash_attention"] and ol_launches["paged_attention"]):
        failures.append("open loop: an attention kernel never launched")
    om = eng.metrics()
    gen = sum(len(t) for t in got)
    open_loop = {**lat, "requests": len(reqs), "wall_s": wall,
                 "tokens_per_s": gen / wall, "driver_steps": dispatches,
                 "dispatches": om["dispatches"],
                 "compactions": om["compactions"], "wamp": om["wamp"],
                 "tokens_equal_share": sum(a == b for a, b in
                                           zip(got, mono["tokens"])) / len(reqs),
                 "phase_split": phase_split(eng.phase_report()),
                 "launches": ol_launches}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # c. the CLI at its default smoke width, in build/serve/ (its metrics
    # files land in the working directory)
    trace = out / "cli_trace.json"
    argv, cwd, text = sys.argv, os.getcwd(), io.StringIO()
    ops.reset_launches()
    sys.argv = ["repro_torch.launch.serve", *SERVE_CLI_ARGS, "--trace",
                str(trace)]
    os.chdir(out)
    try:
        with contextlib.redirect_stdout(text):
            cli_rows = serve_cli.main()
    finally:
        sys.argv = argv
        os.chdir(cwd)
    torch.cuda.synchronize()
    cli_launches = dict(ops.launches)
    add(cli_launches)
    (out / "cli.txt").write_text(text.getvalue())
    policies_ran = [r["policy"] for r in cli_rows]
    if policies_ran != ["mdc", "greedy"]:
        failures.append(f"CLI ran {policies_ran}")
    for r in cli_rows:
        if r["tokens"] <= 0:
            failures.append(f"CLI {r['policy']}: no tokens")
        if not (out / f"cli_trace.json.{r['policy']}").is_file():
            failures.append(f"CLI {r['policy']}: no trace file")
    cli = {r["policy"]: {k: r[k] for k in (
        "tokens", "tok_per_s", "dispatches", "wamp", "compactions",
        "ttft_p50_ms", "ttft_p99_ms", "queue_ms_p99", "tpot_p50_ms",
        "tpot_p99_ms")} for r in cli_rows}
    emit({"phase": "serve", "model": cfg.name, "dtype": "bfloat16",
          "card": smi, "traced": traced, "open_loop": open_loop,
          "cli": {"args": SERVE_CLI_ARGS, "rows": cli,
                  "launches": cli_launches},
          "launches": launches, "phase_seconds": time.perf_counter() - t0,
          "failures": failures})
    if failures:
        raise AssertionError(f"serve phase: {failures}")
    return launches


def smoke_requests(vocab: int, n: int = 12) -> list:
    """The mixed phase's requests: prompts of 4-36 tokens, 4-20 new tokens
    (seed 3), through serve_run's pool of 9 slabs of 4 pages of 8."""
    rng = np.random.default_rng(SEED + 3)
    return [(rng.integers(1, vocab, int(rng.integers(4, 37))),
             int(rng.integers(4, 21))) for _ in range(n)]


def run_engine(model, requests, device, **kw) -> dict:
    """One smoke-width engine over ``requests`` on ``device``: its tokens,
    counters and (on the card) the launches between its first submission
    and its drain."""
    eng = PagedServingEngine(model, n_slabs=9, blocks_per_slab=4, page_T=8,
                             max_batch=4, max_seq=128, device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
        ops.reset_launches()
    rids = [eng.submit(p, n) for p, n in requests]
    eng.run_to_completion()
    if device == "cuda":
        torch.cuda.synchronize()
    eng.pool.check_invariants()
    m = eng.metrics()
    return {"tokens": [eng.finished[r] for r in rids],
            "counters": {k: m[k] for k in ("dispatches", "blocks_written",
                                           "blocks_moved", "compactions",
                                           "wamp")},
            "launches": dict(ops.launches) if device == "cuda" else None}


def phase_mixed(cfg, smi) -> dict:
    """The engine with the parameters' dtype apart from the pool's.

    (a) Full width: qwen3-1.7b's seeded weights at f32 over a bf16 pool
    and at bf16 over an f32 pool (the JAX ``examples/serve_paged.py``
    mix), the f32 legs' 4 long requests through the engine phase's pool,
    so the decode runs paged attention's mixed instances at G 2, D 128.
    Each leg is held against the plain greedy decode on the card
    (``kernel=False``, its dense cache in the pool's dtype): a request's
    tokens equal it, or part from it on a near-tie (``near_tie_bar``).
    (b) Smoke width, card against the CPU engine (one weight draw, made on
    the CPU and copied): f32 parameters over the default bf16 pool through
    ``launch.serve.serve_run`` (the mix ``tests/test_torch_serve.py`` holds
    against the JAX package), whose rows must be equal (tokens digest,
    counters); bf16 parameters over an f32 pool on 12 smoke requests,
    with the CPU's counters (host-determined: no stop token) and its
    tokens' share reported, and the card's tokens held against the plain
    decode on the card as in (a).
    Returns the launches of the card's runs."""
    out, launches, failures = {"card": smi}, {k: 0 for k in KERNELS}, []

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    bf = Model(cfg, device="cuda", seed=SEED).params
    small = long_requests(cfg.vocab_size)
    for leg, p_dtype, pool_dtype in MIXED_LEGS:
        model = Model(cfg, unflatten((p, t.to(p_dtype)) for p, t in flatten(bf)))
        run = serve(model, small, pool_dtype=pool_dtype)
        add(run["launches"])
        mism = first_mismatches(model, cfg, small, run["tokens"], pool_dtype)
        out[leg] = {"requests": len(small),
                    "prompt_tokens": [len(p) for p, _ in small],
                    "equal_to_plain": not mism, "mismatches": mism,
                    "paged_attention_launches": run["launches"]["paged_attention"],
                    "compactions": run["metrics"]["compactions"],
                    "stream": stream_summary(run)}
        if not all(x["near_tie"] for x in mism):
            failures.append(f"{leg} at full width: tokens part from the "
                            f"plain decode off a near-tie: {mism}")
        if run["launches"]["paged_attention"] == 0:
            failures.append(f"{leg} at full width: paged attention never "
                            f"launched")
        del model
        torch.cuda.empty_cache()
    del bf

    smoke = cfg.smoke()
    bf = Model(smoke, device="cpu", seed=SEED).params

    def on(device, dtype):
        return Model(smoke, unflatten((p, t.to(device, dtype))
                                      for p, t in flatten(bf)))

    def f32_row(device):
        return serve_cli.serve_run(requests=10, policy="mdc",
                                   model=on(device, torch.float32),
                                   device=device, verbose=False)

    torch.cuda.synchronize()
    ops.reset_launches()
    rows = {"cuda": f32_row("cuda")}
    torch.cuda.synchronize()
    f32_launches = dict(ops.launches)
    add(f32_launches)
    rows["cpu"] = f32_row("cpu")
    keys = ("tokens", "finished_digest", "wamp", "compactions", "dispatches",
            "blocks_moved", "blocks_written")
    equal = all(rows["cuda"][k] == rows["cpu"][k] for k in keys)
    out["smoke_f32_params_bf16_pool"] = {
        "row": {k: rows["cuda"][k] for k in keys}, "equal_to_cpu": equal,
        "paged_attention_launches": f32_launches["paged_attention"]}
    if not equal:
        failures.append(f"f32 parameters over a bf16 pool at smoke width: the "
                        f"card's row {out['smoke_f32_params_bf16_pool']['row']}"
                        f" != the CPU's {({k: rows['cpu'][k] for k in keys})}")
    if f32_launches["paged_attention"] == 0:
        failures.append("f32 over bf16 at smoke width: paged attention never "
                        "launched")

    reqs = smoke_requests(smoke.vocab_size)
    card_model = on("cuda", torch.bfloat16)
    card, cpu = (run_engine(m, reqs, d, pool_dtype=torch.float32)
                 for m, d in ((card_model, "cuda"),
                              (on("cpu", torch.bfloat16), "cpu")))
    add(card["launches"])
    short = [i for i, (t, (_, n)) in enumerate(zip(card["tokens"], reqs))
             if len(t) != n]
    mism = first_mismatches(card_model, smoke, reqs, card["tokens"],
                            torch.float32)
    out["smoke_bf16_params_f32_pool"] = {
        "counters": card["counters"], "cpu_counters": cpu["counters"],
        "tokens_equal_share": sum(a == b for a, b in zip(
            card["tokens"], cpu["tokens"])) / len(reqs),
        "equal_to_plain": not mism, "mismatches": mism,
        "paged_attention_launches": card["launches"]["paged_attention"]}
    if short or card["counters"] != cpu["counters"]:
        failures.append(f"bf16 over f32 at smoke width: requests {short} "
                        f"short, or counters {card['counters']} against the "
                        f"CPU's {cpu['counters']}")
    if not all(x["near_tie"] for x in mism):
        failures.append(f"bf16 over f32 at smoke width: tokens part from the "
                        f"plain decode off a near-tie: {mism}")
    if card["launches"]["paged_attention"] == 0:
        failures.append("bf16 over f32 at smoke width: paged attention never "
                        "launched")
    emit({"phase": "mixed", "model": cfg.name, **out, "launches": launches,
          "failures": failures})
    if failures:
        raise AssertionError(f"mixed phase: {failures}")
    return launches


def phase_sim(smi) -> dict:
    """The port's cleaning simulator at the paper's store (``PAPER``: 51,200
    segments of 512 pages, F 0.8, trigger 32, batch 64, sort buffer 16)
    under 80:20 hot/cold updates and the MDC policy, with every cleaning
    cycle's victim state through ``mdc_priority`` on the card
    (``DeviceVictimCheck``: the host's f64 pick decides; the device's f32
    pick may differ from it only among near-ties).  Launch counters zeroed
    just before ``run_measured`` and read just after; the store's
    invariants checked at the end.  Reports Wamp and mean E at clean over
    the measured window beside the analytic minimum of hot/cold separation
    (``analysis.min_wamp_hotcold``)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(PAPER, seed=SEED)
    sim = Simulator(cfg, workload_name="hot_cold", **SIM_WORKLOAD)
    setup_s = time.perf_counter() - t0
    check = DeviceVictimCheck("cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t1 = time.perf_counter()
    with check.installed():
        window = sim.run_measured(SIM_UPDATES, warmup_frac=SIM_WARMUP)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = dict(ops.launches)
    t2 = time.perf_counter()
    sim.store.check_invariants()
    check_s = time.perf_counter() - t2
    st = sim.store.stats
    bound = analysis.min_wamp_hotcold(cfg.fill_factor, SIM_WORKLOAD["update_frac"],
                                      SIM_WORKLOAD["data_frac"])
    emit({"phase": "sim", "card": smi, "config": dataclasses.asdict(cfg),
          "workload": {"name": "hot_cold", **SIM_WORKLOAD},
          "pages": cfg.nseg * cfg.pages_per_seg, "updates": SIM_UPDATES,
          "warmup_frac": SIM_WARMUP, "clean_trigger": sim.clean_trigger,
          "clean_batch": sim.clean_batch, "cycles": st.cleanings,
          "window_cycles": window.cleanings,
          "mdc_priority_launches": launches["mdc_priority"],
          **check.report(), "wamp": window.wamp(), "mean_E": window.mean_E(),
          "min_wamp_hotcold": bound, "wamp_over_min": window.wamp() / bound,
          "fill_factor": sim.store.fill_factor(), "setup_s": setup_s,
          "host_s": run_s, "updates_per_s": SIM_UPDATES / run_s,
          "invariants_s": check_s, "invariants": "ok"})
    if not check.cycles or check.cycles != st.cleanings:
        raise AssertionError(f"sim: {check.cycles} checked cycles of "
                             f"{st.cleanings}")
    if launches["mdc_priority"] < check.cycles:
        raise AssertionError(f"sim: mdc_priority launched "
                             f"{launches['mdc_priority']} times in "
                             f"{check.cycles} cycles")
    return launches


def tp_paged(rank, mesh, Kh: int = 8, G: int = 2, D: int = 128) -> tuple:
    """(a) ``paged_attention_sharded`` on this rank's kv heads at the
    kernels phase's shape (B 8, P 64, Kh 8, G 2, D 128, 16-token pages,
    bf16; or other heads: Nemotron-4-340B's Kh 8, G 12, D 192): bit for
    bit the unsharded kernel's slice of the same heads, its gather the
    whole unsharded output, within ``paged_bar`` of the plain version on
    the local heads.  Returns (result, kernel, plain, library)."""
    n = mesh.size()
    T, B, P = 16, 8, 64
    q, k_pool, v_pool, bt, lens = paged_case(torch.bfloat16, torch.bfloat16,
                                             B, P, Kh, G, D, T, seed=SEED)
    ql = local_heads(q, 1, rank, n)
    kl, vl = (local_heads(t, 2, rank, n) for t in (k_pool, v_pool))
    n0 = ops.launches["paged_attention_sharded"]
    got = ops.paged_attention_sharded(ql, kl, vl, bt, lens, mesh=mesh)
    per_call = ops.launches["paged_attention_sharded"] - n0
    whole = ops.paged_attention(q, k_pool, v_pool, bt, lens)
    bitwise = torch.equal(got, local_heads(whole, 1, rank, n))
    gathered = torch.equal(ops.gather_heads(got, mesh), whole)
    if per_call != 1 or not (bitwise and gathered):
        raise AssertionError(f"paged_attention_sharded rank {rank}: "
                             f"{per_call} launches, bitwise {bitwise}, "
                             f"gathered {gathered}")
    want = ref.paged_attention_ref(ql, kl, vl, bt, lens)
    share = check_paged_close(got, want, paged_bar(ql, kl, vl, bt, lens, want))
    n_tok, Hl, Khl = int(lens.sum()), Kh * G // n, Kh // n
    b_ms, b_by = report.kernel_bound_ms(work.paged_attention(
        B=B, H=Hl, Kh=Khl, D=D, tokens=n_tok,
        pages=int(((lens + T - 1) // T).sum()), q_dtype=torch.bfloat16,
        kv_dtype=torch.bfloat16))
    result = {"rank": rank, "max_abs_err": max_err(got, want),
              "bar_share": share, "bitwise_unsharded_slice": bitwise,
              "gathered_equal_unsharded": gathered,
              "launches_per_call": per_call, "bound_ms": b_ms,
              "bound_by": b_by,
              "shape": {"B": B, "Kh_local": Khl, "G": G, "D": D,
                        "page_T": T, "P": P, "tokens": n_tok}}
    return (result,
            lambda: ops.paged_attention_sharded(ql, kl, vl, bt, lens,
                                                mesh=mesh),
            lambda: ref.paged_attention_ref(ql, kl, vl, bt, lens), None)


def tp_flash(rank, mesh, Sq: int, Skv: int = 1024) -> tuple:
    """(a) ``flash_attention_sharded`` on this rank's heads (H 16 / Kh 8
    whole, D 128, bf16, the tensor-core route): ``Sq`` query rows at offset
    ``Skv - Sq`` over ``Skv`` keys, causal.  Bit for bit the unsharded
    kernel's slice of the same heads, its gather the whole unsharded
    output, within 2e-2 of the plain version.  Returns (result, kernel,
    plain, library): the library is ``scaled_dot_product_attention`` on the
    local heads (kv heads expanded, lower-right causal mask)."""
    from torch.nn.attention.bias import causal_lower_right
    n = mesh.size()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    B, H, Kh, D, off = 1, 16, 8, 128, Skv - Sq
    q_all = torch.randn(B, Skv, H, D, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, Skv, Kh, D, generator=g, device="cuda").to(torch.bfloat16)
    q = q_all[:, off:]
    ql, kl, vl = (local_heads(t, 2, rank, n) for t in (q, k, v))
    r0 = ops.flash_routes["wgmma"]
    got = ops.flash_attention_sharded(ql, kl, vl, mesh=mesh, causal=True,
                                      q_offset=off)
    whole = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    bitwise = torch.equal(got, local_heads(whole, 2, rank, n))
    gathered = torch.equal(ops.gather_heads(got, mesh), whole)
    if ops.flash_routes["wgmma"] != r0 + 2 or not (bitwise and gathered):
        raise AssertionError(f"flash_attention_sharded rank {rank} Sq {Sq}: "
                             f"bitwise {bitwise}, gathered {gathered}, or "
                             f"not on the tensor-core route")
    want = ref.flash_attention_ref(ql, kl, vl, causal=True, q_offset=off)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    Hl, Khl = H // n, Kh // n
    qh = ql.transpose(1, 2).contiguous()
    k_h, v_h = (t.transpose(1, 2).repeat_interleave(H // Kh, dim=1)
                for t in (kl, vl))
    mask = causal_lower_right(Sq, Skv)
    b_ms, b_by = report.kernel_bound_ms(work.flash_attention(
        B=B, H=Hl, Kh=Khl, Sq=Sq, Skv=Skv, D=D, dtype=torch.bfloat16,
        causal=True, q_offset=off))
    result = {"rank": rank, "max_abs_err": max_err(got, want),
              "bitwise_unsharded_slice": bitwise,
              "gathered_equal_unsharded": gathered, "flash_route": "wgmma",
              "q_offset": off, "bound_ms": b_ms, "bound_by": b_by,
              "shape": {"B": B, "H_local": Hl, "Kh_local": Khl, "Sq": Sq,
                        "Skv": Skv, "D": D, "causal": True}}
    return (result,
            lambda: ops.flash_attention_sharded(ql, kl, vl, mesh=mesh,
                                                causal=True, q_offset=off),
            lambda: ref.flash_attention_ref(ql, kl, vl, causal=True,
                                            q_offset=off),
            lambda: F.scaled_dot_product_attention(qh, k_h, v_h,
                                                   attn_mask=mask))


def tp_rank(rank, device, cfg, requests) -> dict:
    """One rank of the tp phase (spawned: ``spawn_ranks`` imports it from
    this module by name).  (a) the wrappers' checks on this rank's heads,
    timed on rank 0 alone while the other rank waits at a barrier; (b)
    the sharded engine over ``requests`` at full width, bf16, launch
    counters zeroed just before it and read just after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_serving_mesh(TP_RANKS)
    nemo = get_config(NEMOTRON_ARCH)
    checks = {"paged": tp_paged(rank, mesh),
              "paged_nemotron": tp_paged(
                  rank, mesh, nemo.n_kv_heads, nemo.n_heads
                  // nemo.n_kv_heads, nemo.hd),
              "flash": tp_flash(rank, mesh, 1024),
              "flash_hit": tp_flash(rank, mesh, 512)}
    torch.cuda.synchronize()
    torch.distributed.barrier()
    if rank == 0:
        timer = Timer()
        for result, kernel, plain, library in checks.values():
            if library is None:
                result["kernel_ms"], result["library_ms"] = timer(kernel), None
            else:
                result["kernel_ms"], result["library_ms"] = timer(kernel,
                                                                  library)
            result["plain_ms"] = timer(plain)
        del timer
    torch.distributed.barrier()
    kernels = {k: c[0] for k, c in checks.items()}
    del checks
    torch.cuda.empty_cache()
    # the rank's model holds only its heads of wq / wk / wv
    model = shard_model(Model(cfg, device=device, seed=SEED), mesh)
    held = []
    run = serve(model, requests, setup=held.append, mesh=mesh,
                n_slabs=TP_SLABS, audit_every=TP_AUDIT_EVERY)
    eng = held.pop()
    held_summary = {"pool_sharded": eng._pool_sharded,
                    "pool_shape": list(eng.k_pools.shape), **run["memory"]}
    del eng, model
    return {"kernels": kernels,
            "engine": {"tokens": run["tokens"], "metrics": run["metrics"],
                       "launches": run["launches"],
                       "flash_routes": run["flash_routes"],
                       "stream": stream_summary(run), **held_summary}}


def tp_nccl_one(model, requests) -> dict:
    """(c) The engine over a one-rank ``nccl`` mesh in this process."""
    root = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    store = torch.distributed.FileStore(os.path.join(root, "store"), 1)
    torch.distributed.init_process_group("nccl", store=store, rank=0,
                                         world_size=1)
    try:
        mesh = make_serving_mesh(1)
        return serve(model, requests, mesh=mesh, n_slabs=TP_SLABS,
                     audit_every=TP_AUDIT_EVERY)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)


def phase_tp(cfg, smi) -> tuple[dict, dict]:
    """Tensor-parallel serving (docstring, phase 15): the unsharded engine
    and the one-rank ``nccl`` engine in this process, then two ``gloo``
    ranks on the card (this process's weights freed first).  Returns the
    rank-0 launches of the sharded run and the wrappers' kernel lines."""
    prompts, news = engine_requests(cfg.vocab_size)
    requests = [(p, int(n)) for p, n in zip(prompts[:TP_REQUESTS],
                                             news[:TP_REQUESTS])]
    model = Model(cfg, device="cuda", seed=SEED)
    base = serve(model, requests, n_slabs=TP_SLABS,
                 audit_every=TP_AUDIT_EVERY)
    nccl = tp_nccl_one(model, requests)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    failures = []
    counters = {k: base["metrics"][k] for k in COUNTERS}
    if base["metrics"]["compactions"] < 1:
        failures.append("the unsharded run never compacted")
    nccl_counters = {k: nccl["metrics"][k] for k in COUNTERS}
    nccl_equal = nccl["tokens"] == base["tokens"] and nccl_counters == counters
    if not nccl_equal:
        failures.append(f"nccl world size 1: tokens or counters "
                        f"{nccl_counters} differ from the unsharded "
                        f"{counters}")
    if min(nccl["launches"][k] for k in TP_KERNELS) == 0:
        failures.append(f"nccl world size 1 never launched a sharded "
                        f"wrapper: {nccl['launches']}")
    t0 = time.perf_counter()
    ranks = spawn_ranks(importlib.import_module("chip_smoke").tp_rank,
                        TP_RANKS, cfg, requests, backend="gloo",
                        device="cuda", timeout_s=TP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    engines = [r["engine"] for r in ranks]
    tokens = engines[0]["tokens"]
    if any(e["tokens"] != tokens for e in engines[1:]):
        failures.append("the ranks' tokens differ")
    for rank, e in enumerate(engines):
        got = {k: e["metrics"][k] for k in COUNTERS}
        if got != counters:
            failures.append(f"rank {rank}: counters {got} != unsharded "
                            f"{counters}")
        if not e["pool_sharded"] or e["pool_shape"][3] != cfg.n_kv_heads // TP_RANKS:
            failures.append(f"rank {rank}: pools {e['pool_shape']} not "
                            f"sharded to {cfg.n_kv_heads // TP_RANKS} kv heads")
        if min(e["launches"][k] for k in TP_KERNELS) == 0:
            failures.append(f"rank {rank} never launched a sharded wrapper: "
                            f"{e['launches']}")
    differ = [i for i, (a, b) in enumerate(zip(tokens, base["tokens"]))
              if a != b]
    mism = []
    if differ:
        model = Model(cfg, device="cuda", seed=SEED)
        mism = first_mismatches(model, cfg, [requests[i] for i in differ],
                                [tokens[i] for i in differ], torch.bfloat16)
        del model
        torch.cuda.empty_cache()
        if not all(x["near_tie"] for x in mism):
            failures.append(f"sharded tokens part from the plain decode off "
                            f"a near-tie: {mism}")
    out = {"phase": "tp", "card": smi, "model": cfg.name, "dtype": "bfloat16",
           "ranks": TP_RANKS, "backend": "gloo", "requests": len(requests),
           "n_slabs": TP_SLABS, "kernels": [r["kernels"] for r in ranks],
           "unsharded": {"counters": counters, **stream_summary(base),
                         "memory": base["memory"]},
           "sharded": {
               "tokens_equal_unsharded": not differ,
               "requests_differing": differ, "mismatches": mism,
               "counters": {k: engines[0]["metrics"][k] for k in COUNTERS},
               "pool_shape": engines[0]["pool_shape"],
               "memory_per_rank": [
                   {k: e[k] for k in ("memory_allocated", "param_bytes",
                                      "pool_bytes")} for e in engines],
               "wrapper_launches_per_rank": [
                   {k: e["launches"][k] for k in TP_KERNELS}
                   for e in engines],
               "streams": [e["stream"] for e in engines],
               "spawn_s": spawn_s},
           "nccl_world_1": {"bitwise_equal": nccl_equal,
                            "counters": nccl_counters,
                            "wrapper_launches": {k: nccl["launches"][k]
                                                 for k in TP_KERNELS},
                            **stream_summary(nccl)},
           "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"tp phase: {failures}")
    lead = ranks[0]["kernels"]
    return engines[0]["launches"], {
        "paged_attention_sharded": lead["paged"],
        "paged_attention_sharded_nemotron": lead["paged_nemotron"],
        "flash_attention_sharded": lead["flash"]}


# ------------------------------------------------------------ moe phase

def plain_partings(tokens, plain, dtype=torch.bfloat16) -> list:
    """Where each request's engine ``tokens`` first part from its plain
    path's (``moe_plain``), with the plain logits' top-2 margin there and
    whether it is a near-tie (``near_tie_bar`` of the logits' ``dtype``)."""
    parts = []
    for i, (got, want) in enumerate(zip(tokens, plain)):
        first = next((j for j, (a, b) in enumerate(zip(got, want["tokens"]))
                      if a != b), None)
        if first is None:
            continue
        bar = near_tie_bar(dtype, want["tops"][first])
        parts.append({"request": i, "first_mismatch": first,
                      "margin_at_mismatch": want["margins"][first],
                      "near_tie_bar": bar,
                      "near_tie": want["margins"][first] <= bar})
    return parts


def moe_plain(params, cfg, prompt, n_new, expect, bucket,
              kernel: bool = False, cache_dtype=torch.bfloat16) -> dict:
    """The plain path on the card for one request: ``tfm.prefill`` of the
    prompt right-padded to ``bucket``, the engine's (``kernel=False``:
    chunked attention; ``kernel=True``: the engine's flash kernel, so the
    first token is the engine's and the rest holds its decode alone; a
    dense cache in ``cache_dtype``), so a MoE groups its tokens as the
    engine does, then
    ``tfm.decode_step`` one token at a time, up to the first token that
    differs from ``expect`` (the engine's).  Per emitted token: the top-2
    logit margin and the top logit."""
    dev = params["embed"].device
    plen = len(prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt, device=dev)
    out, margins, tops = [], [], []
    logits, cache = tfm.prefill(params, toks, cfg,
                                max(bucket, plen + n_new + 1),
                                cache_dtype=cache_dtype, true_len=plen,
                                kernel=kernel)
    while True:
        a, b = torch.topk(logits[0].float(), 2).values.tolist()
        margins.append(a - b)
        tops.append(a)
        out.append(int(torch.argmax(logits[0])))
        if len(out) == n_new or out[-1] != expect[len(out) - 1]:
            break
        logits, cache = tfm.decode_step(
            params, cache, torch.tensor([out[-1]], device=dev), cfg)
    return {"tokens": out, "margins": margins, "tops": tops}


def moe_layer0(model, prompt, bucket) -> dict:
    """Layer 0 of one prompt right-padded to ``bucket`` (the engine's)
    through the port's moe functions: the capacity-dropped picks, and
    ``moe_ffn`` called twice at the prefill shape and at the decode shape
    (8 tokens), bitwise."""
    cfg, params = model.cfg, model.params
    dev = params["embed"].device
    plen = len(prompt)
    toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    toks[0, :plen] = torch.as_tensor(prompt, device=dev)
    lp = tfm.layer(params["blocks"], 0)
    x = tfm._embed(params, toks)
    a, _ = att.gqa_prefill(rmsnorm(x, lp["ln1"]), lp["attn"], cfg)
    h = rmsnorm(x + a, lp["ln2"])
    xg, top_p, top_e, cap = moe._route(h, lp["mlp"]["router"], cfg,
                                       cfg.capacity_factor, cfg.moe_groups)
    st_tok, _, _, keep = moe._dispatch_group(xg, top_e, top_p, cfg.n_experts,
                                             cfg.top_k, cap)[1]
    G, Tg = xg.shape[:2]
    real = (torch.arange(G, device=dev)[:, None] * Tg + st_tok) < plen
    repeat = {}
    for name, xs in (("prefill", h), ("decode", h[0, :8, None])):
        y1 = moe.moe_ffn(xs, lp["mlp"], cfg, cfg.capacity_factor,
                         cfg.moe_groups)
        y2 = moe.moe_ffn(xs, lp["mlp"], cfg, cfg.capacity_factor,
                         cfg.moe_groups)
        repeat[name] = bool(torch.equal(y1, y2)
                            and torch.isfinite(y1).all())
    return {"prompt_len": plen, "bucket": bucket, "groups": G,
            "tokens_per_group": Tg, "capacity": cap,
            "picks": int(keep.numel()),
            "dropped_picks": int((~keep).sum()),
            "dropped_real_picks": int((~keep & real).sum()),
            "moe_ffn_bitwise_repeat": repeat}


def moe_rank(rank, device) -> dict:
    """The moe phase's process (spawned by ``phase_moe``): Qwen3-30B-A3B at
    full width, its weights drawn on the card from the seed, through the
    engine on the tp phase's stream and pool, beside the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(MOE_ARCH)
    prompts, news = engine_requests(cfg.vocab_size)
    requests = [(p, int(n)) for p, n in zip(prompts[:TP_REQUESTS],
                                             news[:TP_REQUESTS])]
    specs = dict(flatten(tfm.model_specs(cfg)))
    weight_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                       for s in specs.values())
    pages = TP_SLABS * POOL["blocks_per_slab"] + 1
    pool_bytes = (2 * cfg.n_layers * pages * POOL["page_T"] * cfg.n_kv_heads
                  * cfg.hd * 2)
    free, total = torch.cuda.mem_get_info()
    if free < weight_bytes + pool_bytes + MOE_HEADROOM:
        raise MemoryError(f"moe: {free / 1e9:.2f} GB free of {total / 1e9:.2f}"
                          f", the weights need {weight_bytes / 1e9:.2f} GB, "
                          f"the pool {pool_bytes / 1e9:.3f} GB, headroom "
                          f"{MOE_HEADROOM / 1e9:.0f} GB")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    out = {"free_gb_before_draw": free / 1e9, "weight_gb": weight_bytes / 1e9,
           "pool_gb": pool_bytes / 1e9, "draw_s": draw_s,
           "n_params": model.n_params(),
           "n_active_params": model.n_active_params(),
           "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9}
    # each prompt's bucket, by the engine's own rule
    buckets = {}
    run = serve(model, requests, n_slabs=TP_SLABS, setup=lambda eng: (
        buckets.update({len(p): eng._prefill_bucket(len(p), 0)[0]
                        for p, _ in requests})))
    out["engine"] = {"tokens": run["tokens"],
                     "counters": {k: run["metrics"][k] for k in COUNTERS},
                     "launches": run["launches"],
                     "flash_routes": run["flash_routes"],
                     "move_plans": run["move_plans"],
                     "stream": stream_summary(run), "memory": run["memory"]}
    long = next(p for p, _ in requests if len(p) > 512)
    out["layer0"] = moe_layer0(model, long, buckets[len(long)])
    t1 = time.perf_counter()
    out["plain"] = [moe_plain(model.params, cfg, p,
                              min(n, MOE_PLAIN_TOKENS), want, buckets[len(p)])
                    for (p, n), want in zip(requests, run["tokens"])]
    out["plain_s"] = time.perf_counter() - t1
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_moe(smi) -> dict:
    """The MoE family at full width (docstring, phase 16), in a process of
    its own.  Returns the launches of its engine run."""
    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    r, = spawn_ranks(importlib.import_module("chip_smoke").moe_rank, 1,
                     backend="gloo", device="cuda", timeout_s=MOE_TIMEOUT_S)
    failures = []
    eng, plain = r["engine"], r["plain"]
    if eng["counters"] != MOE_REHEARSED:
        failures.append(f"counters {eng['counters']} != the rehearsal's "
                        f"{MOE_REHEARSED}")
    for k in ENGINE_KERNELS:
        if eng["launches"][k] == 0:
            failures.append(f"the engine never launched {k}")
    if eng["flash_routes"]["wgmma"] == 0:
        failures.append("the prefill's flash never took the wgmma route")
    if not all(r["layer0"]["moe_ffn_bitwise_repeat"].values()):
        failures.append(f"moe_ffn does not repeat bitwise: "
                        f"{r['layer0']['moe_ffn_bitwise_repeat']}")
    parts = plain_partings(eng["tokens"], plain)
    bad = [p for p in parts if not p["near_tie"]]
    if bad:
        failures.append(f"tokens part from the plain path off a logit "
                        f"near-tie: {bad}")
    out = {"phase": "moe", "card": smi, "model": MOE_ARCH, "dtype": "bfloat16",
           "requests": len(plain), "n_slabs": TP_SLABS,
           "parent_memory_allocated_gb": parent_gb,
           **{k: r[k] for k in ("n_params", "n_active_params", "weight_gb",
                                "pool_gb", "free_gb_before_draw", "draw_s",
                                "memory_allocated_gb",
                                "max_memory_allocated_gb", "layer0",
                                "plain_s")},
           "tokens": eng["tokens"],
           "counters": eng["counters"], "rehearsed": MOE_REHEARSED,
           "flash_routes": eng["flash_routes"],
           "move_plans": eng["move_plans"], "stream": eng["stream"],
           "tokens_equal_plain": not parts,
           "requests_parting": len(parts), "partings": parts,
           "plain_steps": sum(len(w["tokens"]) for w in plain),
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"moe phase: {failures}")
    return eng["launches"]


def paged_share(out, want, pv, live):
    """The largest share of ``YI_PAGED_BAR`` that ``out`` takes against the
    all-f32 plain version ``want``, over the live rows (a device
    scalar)."""
    bar = YI_PAGED_BAR["rel"] * want.abs() + YI_PAGED_BAR["sum"] * pv
    err = (out.float() - want).abs() / bar
    return torch.where(live[:, None, None], err, 0.0).max()


def paged_faults(q, k_pool, block_tables, seq_lens) -> dict:
    """The planted faults a paged call is also run with, each as the
    kernel's inputs altered: the last page's tokens dropped, the softmax
    scale of the next smaller head dim's instance (D - 16), and each query
    head reading its neighbour's q within its kv group."""
    B, H, D = q.shape
    T, Kh = k_pool.shape[1], k_pool.shape[2]
    return {
        "page_dropped": (q, torch.where(seq_lens > T, seq_lens - T,
                                        seq_lens)),
        "scale": ((q.float() * math.sqrt(D / (D - 16))).to(q.dtype),
                  seq_lens),
        "head": (q.view(B, Kh, H // Kh, D).roll(1, 2).reshape(B, H, D),
                 seq_lens)}


@contextlib.contextmanager
def paged_calls_held(shares: list, faults: dict):
    """While active, every card call of ``ops.paged_attention`` (the
    engine's, on its own pools, tables and lengths) is held against the
    plain version in all f32 (q and the pools read in f32, p unrounded) on
    the same inputs: |kernel - plain| <= ``YI_PAGED_BAR`` rel * |plain| +
    sum * sum_j p_j |v_j|.  The kernel is run again on each of
    ``paged_faults``' inputs, held to the same bar and plain version.  Each
    call's largest share of the bar over its live rows is appended to
    ``shares``, and each fault's to ``faults[name]``, as device tensors (no
    host sync)."""
    kernel = ops.paged_attention

    def held(q, k_pool, v_pool, block_tables, seq_lens, **kw):
        out = kernel(q, k_pool, v_pool, block_tables, seq_lens, **kw)
        if q.is_cuda:
            bt = block_tables.clamp(0, k_pool.shape[0] - 1)
            k32, v32 = k_pool.float(), v_pool.float()
            want = ref.paged_attention_ref(q.float(), k32, v32, bt, seq_lens)
            pv = ref.paged_attention_ref(q.float(), k32, v32.abs(), bt,
                                         seq_lens)
            live = seq_lens > 0
            shares.append(paged_share(out, want, pv, live))
            for name, (fq, flens) in paged_faults(q, k_pool, block_tables,
                                                  seq_lens).items():
                got = kernel(fq, k_pool, v_pool, block_tables, flens, **kw)
                faults.setdefault(name, []).append(
                    paged_share(got, want, pv, live))
        return out

    ops.paged_attention = held
    try:
        yield
    finally:
        ops.paged_attention = kernel


def yi_rank(rank, device) -> dict:
    """The yi phase's process (spawned by ``phase_yi``): yi-34b at full
    width, its weights drawn on the card from the seed, through the engine
    on ``yi_requests``, then again with its paged calls held, beside the
    plain path; then the f32 leg, the same weights cut to ``YI_F32_LAYERS``
    in f32 through the engine over an f32 pool beside the plain path in
    f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(YI_ARCH)
    requests = yi_requests(cfg.vocab_size)
    specs = dict(flatten(tfm.model_specs(cfg)))
    weight_bytes = sum(math.prod(s.shape) * s.dtype.itemsize
                       for s in specs.values())
    pages = YI_SLABS * POOL["blocks_per_slab"] + 1
    pool_bytes = (2 * cfg.n_layers * pages * POOL["page_T"] * cfg.n_kv_heads
                  * cfg.hd * 2)
    free, total = torch.cuda.mem_get_info()
    if free < weight_bytes + pool_bytes + YI_HEADROOM:
        raise MemoryError(f"yi: {free / 1e9:.2f} GB free of {total / 1e9:.2f}"
                          f", the weights need {weight_bytes / 1e9:.2f} GB, "
                          f"the pool {pool_bytes / 1e9:.3f} GB, headroom "
                          f"{YI_HEADROOM / 1e9:.0f} GB")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    out = {"free_gb_before_draw": free / 1e9, "weight_gb": weight_bytes / 1e9,
           "pool_gb": pool_bytes / 1e9,
           "draw_s": time.perf_counter() - t0, "n_params": model.n_params()}
    buckets = {}
    run = serve(model, requests, n_slabs=YI_SLABS, setup=lambda eng: (
        buckets.update({len(p): eng._prefill_bucket(len(p), 0)[0]
                        for p, _ in requests})))
    out["engine"] = {"tokens": run["tokens"],
                     "counters": {k: run["metrics"][k] for k in COUNTERS},
                     "launches": run["launches"],
                     "flash_routes": run["flash_routes"],
                     "stream": stream_summary(run), "memory": run["memory"]}
    # the same stream again with every paged call held (its times are not
    # the engine's: the checks run between its launches)
    shares, faults = [], {}
    with paged_calls_held(shares, faults):
        held = serve(model, requests, n_slabs=YI_SLABS)
    out["held"] = {"tokens_equal_clean": held["tokens"] == run["tokens"],
                   "calls": len(shares),
                   "share_max": float(torch.stack(shares).max()),
                   "faults": {name: {
                       "share_least": float(torch.stack(v).min()),
                       "share_median": float(torch.stack(v).median()),
                       "caught": float((torch.stack(v) > 1).float().mean())}
                       for name, v in faults.items()}}
    t1 = time.perf_counter()
    # the plain path's prefill through the engine's flash kernel, so its
    # first token is the engine's; and, to show what rounding alone does
    # to this stack, its first token through the chunked attention
    out["plain"] = [moe_plain(model.params, cfg, p, n, want, buckets[len(p)],
                              kernel=True)
                    for (p, n), want in zip(requests, run["tokens"])]
    out["chunked_first"] = [moe_plain(model.params, cfg, p, 1, want[:1],
                                      buckets[len(p)])
                            for (p, _), want in zip(requests, run["tokens"])]
    out["plain_s"] = time.perf_counter() - t1
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model
    free_card()
    fcfg = cfg.with_(n_layers=YI_F32_LAYERS)
    f32 = Model(fcfg, unflatten((p, t.float()) for p, t in flatten(
        Model(fcfg, params={}).init(SEED, device="cuda"))))
    frun = serve(f32, requests, n_slabs=YI_SLABS, pool_dtype=torch.float32)
    out["f32"] = {"n_layers": YI_F32_LAYERS, "tokens": frun["tokens"],
                  "counters": {k: frun["metrics"][k] for k in COUNTERS},
                  "launches": frun["launches"],
                  "plain": [moe_plain(f32.params, fcfg, p, n, want,
                                      buckets[len(p)], kernel=True,
                                      cache_dtype=torch.float32)
                            for (p, n), want in zip(requests,
                                                    frun["tokens"])]}
    return out


def phase_yi(smi) -> dict:
    """yi-34b at full width through the paged engine, in a process of its
    own (docstring, phase 16b): every paged launch at G 7 (the kernel's
    second instance family), the host counters of its CPU rehearsal, each
    paged call within its bar of the all-f32 plain version and the planted
    faults outside it; the
    uncut bf16 tokens beside the plain path (reported: the random stack
    carries rounding to O(1), ``YI_F32_LAYERS``), the f32 leg's equal to
    it or parting on a near-tie.  Returns the launches of its engine
    runs."""
    free_card()
    t0 = time.perf_counter()
    cfg = get_config(YI_ARCH)
    r, = spawn_ranks(importlib.import_module("chip_smoke").yi_rank, 1,
                     backend="gloo", device="cuda", timeout_s=YI_TIMEOUT_S)
    failures = []
    eng, plain, f32 = r["engine"], r["plain"], r["f32"]
    G = cfg.n_heads // cfg.n_kv_heads
    for name, leg in (("bf16", eng), ("f32", f32)):
        if G != 7 or leg["launches"]["paged_attention"] == 0:
            failures.append(f"{name}: no paged launch at G 7: G {G}, "
                            f"launches {leg['launches']}")
        if leg["counters"] != YI_REHEARSED:
            failures.append(f"{name}: counters {leg['counters']} != the "
                            f"rehearsal's {YI_REHEARSED}")
    if eng["flash_routes"]["wgmma"] == 0:
        failures.append("the prefill's flash never took the wgmma route")
    held = r["held"]
    if not held["tokens_equal_clean"]:
        failures.append("the held stream's tokens differ from the clean "
                        "stream's")
    if (held["calls"] != eng["launches"]["paged_attention"]
            or not held["share_max"] <= 1.0):
        failures.append(f"the engine's paged calls against the all-f32 "
                        f"plain version: {held['calls']} held of "
                        f"{eng['launches']['paged_attention']}, largest "
                        f"share of the bar {held['share_max']}")
    for name, f in held["faults"].items():
        if not f["caught"] >= YI_FAULT_CAUGHT:
            failures.append(f"the bar catches the planted fault {name} in "
                            f"{f['caught']:.3f} of the calls")
    parts = plain_partings(eng["tokens"], plain)
    f32_parts = plain_partings(f32["tokens"], f32["plain"], torch.float32)
    bad = [p for p in f32_parts if not p["near_tie"]]
    if bad:
        failures.append(f"f32: tokens part from the plain path off a logit "
                        f"near-tie: {bad}")
    chunked = [{"first_equal": c["tokens"][0] == t[0],
                "margin": c["margins"][0]}
               for c, t in zip(r["chunked_first"], eng["tokens"])]
    out = {"phase": "yi", "card": smi, "model": YI_ARCH, "dtype": "bfloat16",
           "heads": {"H": cfg.n_heads, "Kh": cfg.n_kv_heads, "G": G,
                     "D": cfg.hd, "layers": cfg.n_layers},
           "requests": len(plain), "n_slabs": YI_SLABS,
           **{k: r[k] for k in ("n_params", "weight_gb", "pool_gb",
                                "free_gb_before_draw", "draw_s",
                                "max_memory_allocated_gb", "plain_s")},
           "tokens": eng["tokens"], "counters": eng["counters"],
           "rehearsed": YI_REHEARSED, "flash_routes": eng["flash_routes"],
           "stream": eng["stream"], "memory": eng["memory"],
           "paged_calls_held": held, "paged_bar": YI_PAGED_BAR,
           "first_tokens_equal_plain": [p["tokens"][0] == t[0] for p, t in
                                        zip(plain, eng["tokens"])],
           "tokens_equal_plain": not parts, "partings": parts,
           "plain_chunked_prefill_first_token": chunked,
           "f32": {"n_layers": f32["n_layers"],
                   "counters": f32["counters"],
                   "paged_launches": f32["launches"]["paged_attention"],
                   "tokens_equal_plain": not f32_parts,
                   "partings": f32_parts},
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"yi phase: {failures}")
    return {k: eng["launches"][k] + f32["launches"][k]
            for k in eng["launches"]}


def train_state_bytes(cfg) -> int:
    """Bytes of one checkpoint of the trainer's state: the params at their
    spec dtypes and two f32 moments."""
    return sum(math.prod(sp.shape) * (sp.dtype.itemsize + 8)
               for _, sp in flatten(tfm.model_specs(cfg)))


def host_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def train_summary(log: dict, n_params: int, cfg) -> dict:
    """Step ms (median after the first), tokens/s and the share of the bf16
    dense peak: (6 * params * tokens + the causal attention's products,
    forward and backward) / step time / 989 TFLOP/s."""
    B, S = TRAIN_RUN["global_batch"], TRAIN_RUN["seq_len"]
    step_s = statistics.median(log["step_s"][1:])
    attn = 6 * B * S * S * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * n_params * B * S + attn
    return {"loss": log["loss"], "step_s": log["step_s"],
            "step_ms_median": step_s * 1e3, "tokens_per_s": B * S / step_s,
            "flops_per_step": flops,
            "share_of_bf16_peak": (flops / step_s
                                   / report.PEAK_FLOPS["bfloat16"]),
            "stragglers": log["stragglers"]}


def train_rank(rank, device) -> dict:
    """The train phase's process (spawned by ``phase_train``): deterministic
    kernels, then qwen3-1.7b at full width through ``launch.train.train``,
    a clean run and a faulty one that resumes from its checkpoint, then the
    smoke config at f32 on the card and on the CPU."""
    deterministic()
    from repro_torch.launch.train import train
    cfg = get_config(TRAIN_ARCH)
    n_params = Model(cfg, params={}).n_params()
    state_bytes = train_state_bytes(cfg)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free_disk = shutil.disk_usage(root).free
    host = host_available_bytes()
    out = {"n_params": n_params, "state_gb": state_bytes / 1e9,
           "tmp_free_gb": free_disk / 1e9, "host_available_gb": host / 1e9,
           "card_free_gb": torch.cuda.mem_get_info()[0] / 1e9}
    # the faulty leg holds two checkpoints on disk (keep_last=1 drops the
    # older after the newer is written) and one host snapshot
    if free_disk < 2.2 * state_bytes or host < 1.5 * state_bytes:
        raise MemoryError(f"train: two checkpoints of {state_bytes / 1e9:.1f}"
                          f" GB need the disk ({free_disk / 1e9:.1f} GB free"
                          f" under {root}) and the host "
                          f"({host / 1e9:.1f} GB available)")
    def note(what):  # progress on stderr: a timeout shows where it was
        print(f"train: {what} at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr, flush=True)

    t_start = time.perf_counter()
    ops.reset_launches()
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        clean = train(ckpt_dir=None, device=device, **TRAIN_RUN)
        out["clean_s"] = time.perf_counter() - t0
        note("clean run done")
        out["clean_max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        clean.pop("params")
        out["clean"] = train_summary(clean, n_params, cfg)
        out["memory_allocated_after_clean_gb"] = \
            (torch.cuda.memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        faulty = train(ckpt_dir=os.path.join(root, "ckpt"), device=device,
                       **TRAIN_RUN, **TRAIN_FAULT)
        out["faulty_s"] = time.perf_counter() - t0
        note("faulty run done")
        out["faulty_max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        faulty.pop("params")
        st = faulty["ckpt_stats"]
        out["faulty"] = {
            **train_summary(faulty, n_params, cfg),
            "restarts": faulty["restarts"],
            "resumed_from": faulty["resumed_from"],
            "steps_replayed": faulty["steps_replayed"],
            "ckpt_timings": faulty["ckpt_timings"],
            "ckpt_byte_wamp": faulty["ckpt_wamp"],
            "ckpt_user_bytes": st.user_bytes, "ckpt_gc_bytes": st.gc_bytes,
            "ckpt_segments_cleaned": st.cleaned_segments,
            "ckpt_cleanings": st.cleanings}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # smoke width at f32: the card against the CPU, one draw
    scfg = get_config(TRAIN_ARCH).smoke()
    p32 = unflatten((path, t.float()) for path, t in flatten(
        Model(scfg, params={}).init(SEED, device="cpu")))
    skw = dict(arch=TRAIN_ARCH, smoke=True, steps=TRAIN_SMOKE_STEPS,
               verbose=False, seed=SEED, params=p32)
    out["smoke"] = {"card": train(device=device, **skw)["loss"],
                    "cpu": train(device="cpu", **skw)["loss"]}
    note("smoke legs done")
    out["launches"] = dict(ops.launches)
    return out


def phase_train(smi) -> dict:
    """The training side (docstring, phase 17), in a process of its own.
    Returns its launches of the kernels (none)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r, = spawn_ranks(importlib.import_module("chip_smoke").train_rank, 1,
                     backend="gloo", device="cuda", timeout_s=TRAIN_TIMEOUT_S)
    failures = []
    clean, faulty = r["clean"], r["faulty"]
    if faulty["restarts"] != 1 or faulty["resumed_from"] != [4]:
        failures.append(f"restarts {faulty['restarts']}, resumed from "
                        f"{faulty['resumed_from']} (want 1, [4])")
    a, b = np.array(faulty["loss"][-2:]), np.array(clean["loss"][-2:])
    resume_err = float(np.abs(a - b).max())
    if not np.allclose(a, b, rtol=TRAIN_RESUME_TOL, atol=TRAIN_RESUME_TOL):
        failures.append(f"resumed losses {a.tolist()} against the clean "
                        f"run's {b.tolist()}")
    if not all(np.isfinite(clean["loss"])):
        failures.append(f"non-finite losses {clean['loss']}")
    sc, scpu = np.array(r["smoke"]["card"]), np.array(r["smoke"]["cpu"])
    smoke_rel = float(np.abs(sc - scpu).max() / np.abs(scpu).max())
    if not np.allclose(sc, scpu, rtol=TRAIN_SMOKE_RTOL, atol=0):
        failures.append(f"smoke losses on the card {sc.tolist()} against "
                        f"the CPU's {scpu.tolist()}")
    if any(r["launches"].values()):
        failures.append(f"the train phase launched kernels: {r['launches']}")
    out = {"phase": "train", "card": smi, "model": TRAIN_ARCH,
           "dtype": "bfloat16", "remat": get_config(TRAIN_ARCH).remat,
           "deterministic": True,
           **{k: r[k] for k in ("n_params", "state_gb", "tmp_free_gb",
                                "host_available_gb", "card_free_gb",
                                "clean_s", "faulty_s",
                                "clean_max_memory_allocated_gb",
                                "faulty_max_memory_allocated_gb",
                                "memory_allocated_after_clean_gb")},
           "clean": clean, "faulty": faulty,
           "resumed_max_abs_diff": resume_err,
           "resumed_bitwise": bool(np.array_equal(a, b)),
           "smoke": {"steps": TRAIN_SMOKE_STEPS, "dtype": "float32",
                     "card": sc.tolist(), "cpu": scpu.tolist(),
                     "max_rel_diff": smoke_rel},
           "launches": r["launches"],
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"train phase: {failures}")
    return r["launches"]



# ------------------------------------------------------- families phase

@contextlib.contextmanager
def count_drops(tally: dict):
    """Count the MoE picks and the capacity-dropped picks of every
    ``moe_ffn`` call inside the block (one host read per call)."""
    real = moe._dispatch_group

    def spy(*a, **k):
        out = real(*a, **k)
        keep = out[1][3]
        tally["picks"] = tally.get("picks", 0) + int(keep.numel())
        tally["dropped"] = tally.get("dropped", 0) + int((~keep).sum())
        return out

    moe._dispatch_group = spy
    try:
        yield tally
    finally:
        moe._dispatch_group = real


@contextlib.contextmanager
def flash_inputs(seen: dict):
    """Per shape of the ``ops.flash_attention`` calls made inside the block,
    keyed ``(causal, Sq, Skv)`` in order of first use: the number of calls
    and the inputs of the first (the wrapper itself runs, and counts, as
    always)."""
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        key = (kw["causal"], q.shape[1], k.shape[1])
        if key not in seen:
            seen[key] = {"calls": 0,
                         "inputs": (q.clone(), k.clone(), v.clone(), kw)}
        seen[key]["calls"] += 1
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        yield seen
    finally:
        ops.flash_attention = real


def flash_check(q, k, v, kw) -> dict:
    """One of a prefill's flash launches, on the inputs it had, against the
    plain version: within ``TOL`` relative and ``TOL`` of max |v| absolute.
    The model's V is far from unit scale (|v| up to ~30 at Zamba2's random
    weights, whose near-one-hot softmax passes v through), and P·V in the
    operands' dtype rounds p to 2**-8 of itself in bf16 in both versions,
    so the absolute part follows v's scale.  Also each version's distance
    from the attention computed from the same inputs wholly in f32."""
    kw = dict(causal=kw["causal"], q_offset=kw["q_offset"])
    got = ops.flash_attention(q, k, v, **kw).float()
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    tol, v_max = TOL[q.dtype], float(v.abs().max())
    return {"shape": list(q.shape), "kv_shape": list(k.shape),
            "dtype": str(q.dtype).removeprefix("torch."),
            "route": ops.flash_route(q.dtype, q.shape[-1]),
            "v_max_abs": v_max, "max_abs_err": max_err(got, want),
            "bar_share": float(((got - want).abs()
                                / (tol * v_max + tol * want.abs())).max()),
            "kernel_vs_f32_max_abs": max_err(got, exact),
            "plain_vs_f32_max_abs": max_err(want, exact)}


def encdec_frames(cfg, B: int, dtype, seed: int = SEED):
    """Whisper's stub frontend: (B, n_frames, d) frame embeddings drawn
    from a seeded ``torch.Generator`` on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(B, cfg.n_frames, cfg.d_model, generator=g,
                       device="cuda").to(dtype)


def family_prompt_run(params, cfg, B: int, S: int, rng,
                      cache_dtype=torch.bfloat16, extras=None,
                      n_decode: int = FAMILY_DECODE) -> dict:
    """One prompt batch through the port's contiguous-cache path on the
    card: ``prefill`` of B prompts of S tokens (with ``extras``, Whisper's
    frames), then ``n_decode`` ``decode_step``s fed the true next tokens;
    against ``forward`` over the prompt (the prefill's last row) and over
    the prompt and the fed tokens (each decode step's row).  The launch
    counters are zeroed just before the prefill and read just after the
    last decode step.  At f32 also ``forward`` with its embeddings (and
    frames) perturbed by ``FAMILY_PERTURB`` (relative): how far rounding
    alone moves this stack's logits."""
    n = n_decode
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + n))
                            ).cuda()
    drops = {}
    with count_drops(drops) if cfg.n_experts else contextlib.nullcontext():
        short = tfm.forward(params, toks[:, :S], cfg, extras)[:, -1].float()
        full = tfm.forward(params, toks, cfg, extras)[:, S - 1:].float()
    seen = {}
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    ops.reset_launches()
    with flash_inputs(seen):
        start.record()
        logits, cache = tfm.prefill(params, toks[:, :S], cfg, S + n + 1,
                                    extras, cache_dtype=cache_dtype)
        mid.record()
    steps = [logits.float()]
    for j in range(n):
        logits, cache = tfm.decode_step(params, cache, toks[:, S + j], cfg)
        steps.append(logits.float())
    end.record()
    torch.cuda.synchronize()
    launches, routes = dict(ops.launches), dict(ops.flash_routes)
    dec = torch.stack(steps, 1)               # (B, n + 1, V): rows S-1 ..
    agree = (dec[:, 1:].argmax(-1) == full[:, 1:].argmax(-1)).float()
    pre = dec[:, 0]
    out = {"batch": B, "prompt": S, "decode_steps": n,
           "cache_dtype": str(cache_dtype).removeprefix("torch."),
           "finite": bool(torch.isfinite(dec).all()
                          and torch.isfinite(full).all()),
           "logits_max_abs": float(full.abs().max()),
           "prefill_ms": start.elapsed_time(mid),
           "decode_ms_per_step": mid.elapsed_time(end) / n,
           "prefill_vs_forward_max_abs": max_err(pre, short),
           "prefill_vs_forward_close": bool(torch.allclose(
               pre, short, **FAMILY_PREFILL_BAR)),
           "prefill_top1_equal": bool(torch.equal(pre.argmax(-1),
                                                  short.argmax(-1))),
           "decode_vs_forward_max_abs": max_err(dec[:, 1:], full[:, 1:]),
           "top1_agree": float(agree.mean()), "agree_count": int(agree.sum()),
           "rows": int(agree.numel()),
           "launches": launches,
           "flash_launches": launches["flash_attention"],
           "flash_routes": routes,
           "cur_len": int(cache["cur_len"][0])}
    if drops:
        out["forward_moe"] = drops
    if seen:  # per shape, one of the prefill's flash launches against the
        # plain version
        out["flash_checks"] = [
            {"causal": c, "Sq": sq, "Skv": skv, "calls": e["calls"],
             **flash_check(*e["inputs"])}
            for (c, sq, skv), e in seen.items()]
    if cache_dtype == torch.float32:
        g = torch.Generator(device="cuda").manual_seed(SEED)

        def nudge(t):
            return t * (1 + FAMILY_PERTURB * torch.randn(
                t.shape, generator=g, device="cuda"))

        bumped = dict(params, embed=nudge(params["embed"]))
        ex = (None if extras is None
              else {k: nudge(v) for k, v in extras.items()})
        moved = tfm.forward(bumped, toks, cfg, ex)[:, S:].float()
        out["perturbed_forward_max_abs"] = max_err(moved, full[:, 1:])
    return out


def family_smoke(arch: str) -> dict:
    """The family's smoke config at f32 (TF32 off) on the card against the
    CPU, one draw: forward logits (with Whisper's frames, or the VLM's
    patches), then prefill of 21 tokens (the VLM's text only) and 4 decode
    steps; the largest difference as a share of the CPU's max-abs."""
    cfg = get_config(arch).smoke()
    p32 = unflatten((path, t.float()) for path, t in flatten(
        Model(cfg, params={}).init(SEED, device="cpu")))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 25)))
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frames, cfg.d_model)).astype(np.float32))
    if cfg.n_patches:
        extras["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, tfm.VISION_DIM)).astype(np.float32))
    rows = {}
    for device in ("cpu", "cuda"):
        p = unflatten((path, t.to(device)) for path, t in flatten(p32))
        tk = toks.to(device)
        ex = {k: v.to(device) for k, v in extras.items()} or None
        out = [tfm.forward(p, tk, cfg, ex)]
        lg, cache = tfm.prefill(p, tk[:, :21], cfg, 26,
                                ex if cfg.family == "encdec" else None,
                                cache_dtype=torch.float32)
        out.append(lg)
        for t in range(21, 25):
            lg, cache = tfm.decode_step(p, cache, tk[:, t], cfg)
            out.append(lg)
        rows[device] = [o.cpu() for o in out]
    rel = max(max_err(a, b) / float(b.abs().max())
              for a, b in zip(rows["cuda"], rows["cpu"]))
    return {"max_rel_diff": rel, "close": rel <= FAMILY_SMOKE_TOL}


def families_rank(rank, device) -> dict:
    """The families phase's process (spawned by ``phase_families``): each
    architecture of ``FAMILY_ARCHS`` at full width on the card in turn,
    uncut in bf16, then cut to ``FAMILY_F32_LAYERS`` in f32, each model
    freed before the next is drawn; then the smoke configs card against
    CPU.  ``launches`` sums the kernels' launches of the uncut prefill and
    decode runs (the checks' launches not counted)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    path = {k: 0 for k in ops.launches}
    with torch.no_grad():
        for arch in FAMILY_ARCHS:
            cfg = get_config(arch)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = Model(cfg, device="cuda", seed=SEED)
            torch.cuda.synchronize()
            r = {"family": cfg.family, "draw_s": time.perf_counter() - t0,
                 "n_params": model.n_params(),
                 "n_active_params": model.n_active_params(),
                 "weight_gb": torch.cuda.memory_allocated() / 1e9}
            rng = np.random.default_rng(SEED)
            r["runs"] = [family_prompt_run(model.params, cfg, B, S, rng)
                         for B, S in FAMILY_PROMPTS]
            for run in r["runs"]:
                for k, n in run["launches"].items():
                    path[k] += n
            r["max_memory_allocated_gb"] = \
                torch.cuda.max_memory_allocated() / 1e9
            del model
            gc.collect()
            torch.cuda.empty_cache()
            fcfg = cfg.with_(n_layers=FAMILY_F32_LAYERS[arch])
            if cfg.n_experts:
                fcfg = fcfg.with_(capacity_factor=cfg.n_experts / cfg.top_k)
            p32 = unflatten((p, t.float()) for p, t in flatten(
                Model(fcfg, params={}).init(SEED, device="cuda")))
            r["f32"] = {"n_layers": fcfg.n_layers,
                        "capacity_factor": fcfg.capacity_factor,
                        **family_prompt_run(p32, fcfg, *FAMILY_F32_PROMPT,
                                            rng, cache_dtype=torch.float32)}
            del p32
            gc.collect()
            torch.cuda.empty_cache()
            out[arch] = r
        for arch in FAMILY_ARCHS:
            out[arch]["smoke_f32"] = family_smoke(arch)
    out["launches"] = path
    return out


def phase_families(smi) -> dict:
    """The MLA-MoE, SSM and hybrid families at full width (docstring, phase
    18), in a process of its own.  Returns its launches."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r, = spawn_ranks(importlib.import_module("chip_smoke").families_rank, 1,
                     backend="gloo", device="cuda",
                     timeout_s=FAMILY_TIMEOUT_S)
    failures = []
    archs = {}
    for arch, (n_jax, n_active_jax) in FAMILY_ARCHS.items():
        a = r[arch]
        cfg = get_config(arch)
        if (a["n_params"], a["n_active_params"]) != (n_jax, n_active_jax):
            failures.append(f"{arch}: parameter counts {a['n_params']} / "
                            f"{a['n_active_params']} != JAX's {n_jax} / "
                            f"{n_active_jax}")
        for run in a["runs"] + [a["f32"]]:
            tag = f"{arch} {run['cache_dtype']} B{run['batch']} S{run['prompt']}"
            if not run["finite"]:
                failures.append(f"{tag}: non-finite logits")
            if run["cur_len"] != run["prompt"] + FAMILY_DECODE:
                failures.append(f"{tag}: cur_len {run['cur_len']}")
            if cfg.family == "hybrid":
                groups = run.get("n_layers", cfg.n_layers) // cfg.attn_period
                dt = getattr(torch, run["cache_dtype"])
                route = ops.flash_route(dt, cfg.hd)
                if (run["flash_launches"], run["flash_routes"][route]) != (
                        groups, groups):
                    failures.append(f"{tag}: {run['flash_launches']} flash "
                                    f"launches {run['flash_routes']} per "
                                    f"prefill, want {groups} on {route}")
                chk = run.get("flash_checks", [None])[0]
                if chk is None or chk["bar_share"] > 1:
                    failures.append(f"{tag}: flash against its plain "
                                    f"version: {chk}")
            elif run["flash_launches"]:
                failures.append(f"{tag}: {run['flash_launches']} flash "
                                f"launches off the hybrid")
        # decode against forward where rounding is not amplified past the
        # logits' margins: the f32 leg (FAMILY_F32_LAYERS)
        f32 = a["f32"]
        if not f32["prefill_vs_forward_close"]:
            failures.append(f"{arch} f32: prefill's last row "
                            f"{f32['prefill_vs_forward_max_abs']} from "
                            f"forward's, beyond {FAMILY_PREFILL_BAR}")
        if cfg.family in ("ssm", "hybrid") and f32["top1_agree"] < FAMILY_AGREE:
            failures.append(f"{arch} f32: decode agrees with forward on "
                            f"{f32['top1_agree']:.3f} of top-1, below "
                            f"{FAMILY_AGREE}")
        a["top1_agree_bf16"] = (sum(x["agree_count"] for x in a["runs"])
                                / sum(x["rows"] for x in a["runs"]))
        if not a["smoke_f32"]["close"]:
            failures.append(f"{arch}: smoke f32 card against CPU "
                            f"{a['smoke_f32']['max_rel_diff']}")
        archs[arch] = {**a, "n_params_jax": n_jax,
                       "n_active_params_jax": n_active_jax}
    out = {"phase": "families", "card": smi, "dtype": "bfloat16",
           "prompts": FAMILY_PROMPTS, "archs": archs,
           "launches": r["launches"],
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"families phase: {failures}")
    return r["launches"]


# ---------------------------------------------------------- encdec phase

def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def whisper_loss(params, cfg) -> dict:
    """``Model.loss`` forward and backward at full width with frames, one
    batch of ``ENCDEC_LOSS`` (the training path: the plain chunked
    attention under autograd); the parameters' storage is shared, not
    copied."""
    B, S = ENCDEC_LOSS
    leaves_ = [t.detach().requires_grad_(True) for _, t in flatten(params)]
    p = unflatten((path, t) for (path, _), t in zip(flatten(params), leaves_))
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (B, S))).cuda()
    batch = {"tokens": toks, "frames": encdec_frames(cfg, B, torch.bfloat16,
                                                     SEED + 1)}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start, mid, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    with torch.enable_grad():
        start.record()
        loss = Model(cfg, params={}).loss(p, batch)
        mid.record()
        grads = torch.autograd.grad(loss, leaves_)
        end.record()
    torch.cuda.synchronize()
    # the random full-width stack's gradient reaches ~1e20 (PERF.md): the
    # norm is summed in f64, where the f32 squares overflow
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    sq = sum(float(g.double().pow(2).sum()) for g in grads)
    return {"batch": B, "tokens": S, "loss": float(loss),
            "grad_norm": math.sqrt(sq),
            "grad_max_abs": max(float(g.abs().max()) for g in grads),
            "finite": finite,
            "forward_ms": start.elapsed_time(mid),
            "backward_ms": mid.elapsed_time(end),
            "peak_gb_above_weights": (torch.cuda.max_memory_allocated()
                                      - base) / 1e9,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}


def encdec_rank(rank, device) -> dict:
    """The encdec phase's process (spawned by ``phase_encdec``):
    Whisper-medium uncut in bf16 (prefill and decode, the loss forward and
    backward), in f32 at ``ENCDEC_F32_LAYERS``, then InternVL2-76B cut to
    ``VLM_LAYERS`` (forward with patches, text prefill and decode), each
    model freed before the next is drawn; then both smoke configs card
    against CPU.  ``launches`` sums the kernels' launches of the two bf16
    prefill and decode runs (the checks' launches not counted)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    with torch.no_grad():
        cfg = get_config(ENCDEC_ARCH)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        w = {"family": cfg.family, "draw_s": time.perf_counter() - t0,
             "n_params": model.n_params(),
             "weight_gb": torch.cuda.memory_allocated() / 1e9}
        B, S = ENCDEC_PROMPT
        rng = np.random.default_rng(SEED)
        w["run"] = family_prompt_run(
            model.params, cfg, B, S, rng, n_decode=ENCDEC_DECODE,
            extras={"frames": encdec_frames(cfg, B, torch.bfloat16)})
        w["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        w["loss"] = whisper_loss(model.params, cfg)
        del model
        free_card()
        fcfg = cfg.with_(n_layers=ENCDEC_F32_LAYERS,
                         n_enc_layers=ENCDEC_F32_LAYERS)
        p32 = unflatten((p, t.float()) for p, t in flatten(
            Model(fcfg, params={}).init(SEED, device="cuda")))
        B, S = ENCDEC_F32_PROMPT
        w["f32"] = {"n_layers": fcfg.n_layers,
                    "n_enc_layers": fcfg.n_enc_layers,
                    **family_prompt_run(
                        p32, fcfg, B, S, rng, cache_dtype=torch.float32,
                        n_decode=ENCDEC_DECODE,
                        extras={"frames": encdec_frames(fcfg, B,
                                                        torch.float32)})}
        del p32
        free_card()
        out[ENCDEC_ARCH] = w

        full = get_config(VLM_ARCH)
        cfg = full.with_(n_layers=VLM_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        v = {"family": cfg.family, "n_layers": VLM_LAYERS,
             "n_layers_uncut": full.n_layers,
             "draw_s": time.perf_counter() - t0,
             "n_params": Model(full, params={}).n_params(),
             "n_params_run": model.n_params(),
             "weight_gb": torch.cuda.memory_allocated() / 1e9}
        Bf, Sf = VLM_FORWARD
        g = torch.Generator(device="cuda").manual_seed(SEED)
        patches = torch.randn(Bf, cfg.n_patches, tfm.VISION_DIM, generator=g,
                              device="cuda").to(torch.bfloat16)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bf, Sf))
                                ).cuda()
        logits = tfm.forward(model.params, toks, cfg, {"patches": patches})
        v["forward_patches"] = {
            "shape": list(logits.shape),
            "finite": bool(torch.isfinite(logits).all()),
            "logits_max_abs": float(logits.float().abs().max())}
        del logits
        B, S = VLM_PROMPT
        v["run"] = family_prompt_run(model.params, cfg, B, S, rng,
                                     n_decode=VLM_DECODE)
        v["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model
        free_card()
        out[VLM_ARCH] = v
        for arch in (ENCDEC_ARCH, VLM_ARCH):
            out[arch]["smoke_f32"] = family_smoke(arch)
    out["launches"] = {k: out[ENCDEC_ARCH]["run"]["launches"][k]
                       + out[VLM_ARCH]["run"]["launches"][k]
                       for k in ops.launches}
    return out


def encdec_failures(r) -> list:
    """What the encdec phase's results fail of its contract (docstring,
    phase 19)."""
    failures = []
    for arch, n_jax in ENCDEC_N_PARAMS.items():
        if r[arch]["n_params"] != n_jax:
            failures.append(f"{arch}: {r[arch]['n_params']} parameters, "
                            f"JAX's {n_jax}")
        if not r[arch]["smoke_f32"]["close"]:
            failures.append(f"{arch}: smoke f32 card against CPU "
                            f"{r[arch]['smoke_f32']['max_rel_diff']}")
    w, v = r[ENCDEC_ARCH], r[VLM_ARCH]
    cfg = get_config(ENCDEC_ARCH)
    F = cfg.n_frames
    for run, L, dt in ((w["run"], cfg.n_layers, torch.bfloat16),
                       (w["f32"], ENCDEC_F32_LAYERS, torch.float32),
                       (v["run"], VLM_LAYERS, torch.bfloat16)):
        tag = f"{run['cache_dtype']} B{run['batch']} S{run['prompt']}"
        S = run["prompt"]
        if not run["finite"]:
            failures.append(f"{tag}: non-finite logits")
        if run["cur_len"] != S + run["decode_steps"]:
            failures.append(f"{tag}: cur_len {run['cur_len']}")
        hd = get_config(VLM_ARCH).hd if run is v["run"] else cfg.hd
        route = ops.flash_route(dt, hd)
        want = ({(True, S, S): L} if run is v["run"] else
                {(True, S, S): L, (False, F, F): L, (False, S, F): L})
        got = {(c["causal"], c["Sq"], c["Skv"]): c["calls"]
               for c in run.get("flash_checks", [])}
        n = sum(want.values())
        if got != want or (run["flash_launches"], run["flash_routes"][route]
                           ) != (n, n):
            failures.append(f"{tag}: flash calls {got}, launches "
                            f"{run['flash_launches']} {run['flash_routes']}"
                            f", want {want} on {route}")
        for c in run.get("flash_checks", []):
            if c["bar_share"] > 1:
                failures.append(f"{tag}: flash {c['Sq']}x{c['Skv']} against "
                                f"its plain version: {c}")
    f32 = w["f32"]
    if not f32["prefill_vs_forward_close"]:
        failures.append(f"{ENCDEC_ARCH} f32: prefill's last row "
                        f"{f32['prefill_vs_forward_max_abs']} from forward's,"
                        f" beyond {FAMILY_PREFILL_BAR}")
    if f32["top1_agree"] < FAMILY_AGREE:
        failures.append(f"{ENCDEC_ARCH} f32: decode agrees with forward on "
                        f"{f32['top1_agree']:.3f} of top-1, below "
                        f"{FAMILY_AGREE}")
    if not w["loss"]["finite"]:
        failures.append(f"{ENCDEC_ARCH}: loss or gradients not finite: "
                        f"{w['loss']}")
    fp = v["forward_patches"]
    Bf, Sf = VLM_FORWARD
    vcfg = get_config(VLM_ARCH)
    if fp["shape"] != [Bf, vcfg.n_patches + Sf, vcfg.vocab_size] or not (
            fp["finite"]):
        failures.append(f"{VLM_ARCH}: forward with patches {fp}")
    return failures


def phase_encdec(smi) -> dict:
    """The encoder-decoder family and the VLM stub at full width
    (docstring, phase 19), in a process of its own.  Returns its
    launches."""
    free_card()
    t0 = time.perf_counter()
    r, = spawn_ranks(importlib.import_module("chip_smoke").encdec_rank, 1,
                     backend="gloo", device="cuda",
                     timeout_s=ENCDEC_TIMEOUT_S)
    failures = encdec_failures(r)
    r[ENCDEC_ARCH]["n_params_jax"] = ENCDEC_N_PARAMS[ENCDEC_ARCH]
    r[VLM_ARCH]["n_params_jax"] = ENCDEC_N_PARAMS[VLM_ARCH]
    r[VLM_ARCH]["cut"] = (f"{VLM_LAYERS} of {get_config(VLM_ARCH).n_layers} "
                          f"layers: the uncut bf16 weights do not fit on "
                          f"the card")
    out = {"phase": "encdec", "card": smi, "dtype": "bfloat16",
           "archs": {a: r[a] for a in ENCDEC_N_PARAMS},
           "launches": r["launches"],
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"encdec phase: {failures}")
    return r["launches"]


# ---------------------------------------------------------- dryrun phase

def dryrun_diff(a: OpCost, b: OpCost) -> dict:
    """The aten ops whose calls or bytes differ between two counts."""
    return {k: {"calls": [a.op_counts[k], b.op_counts[k]],
                "bytes": [a.op_bytes[k], b.op_bytes[k]]}
            for k in sorted(set(a.op_counts) | set(b.op_counts))
            if (a.op_counts[k], a.op_bytes[k]) != (b.op_counts[k],
                                                   b.op_bytes[k])}


def dryrun_cell(cfg, shape, n_active: int) -> dict:
    """One cell of the dryrun phase (docstring, phase 20): counted on
    ``meta`` and on the card, the card's peak beside the predicted one, the
    step timed without the counter beside its bound."""
    fn, args = build_cell(cfg, shape, "meta")
    with OpCost(inputs=args) as om:
        fn(*args)
    del fn, args
    meta = om.summary()

    free_card()
    base = torch.cuda.memory_allocated()
    fn, args = build_cell(cfg, shape, "cuda", seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = dict(ops.launches)
    with OpCost(inputs=args) as oc:
        fn(*args)
    torch.cuda.synchronize()
    launches = {k: n - n0[k] for k, n in ops.launches.items()}
    measured = torch.cuda.max_memory_allocated() - base
    card = oc.summary()
    keys = ("flops_by_dtype", "hbm_bytes_per_device", "kernel_charges")
    equal = {k: meta[k] == card[k] for k in keys}

    def step():
        if shape.kind == "decode":   # the same last position every step
            args[1]["cur_len"].fill_(shape.seq_len - 1)
        fn(*args)

    step()
    events = []
    for _ in range(DRYRUN_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    del fn, args
    free_card()

    rec = {"kind": shape.kind, "global_batch": shape.global_batch,
           "seq_len": shape.seq_len, "n_active_params": n_active,
           "op_cost": meta, "peak_live_bytes": meta["peak_live_bytes"]}
    t = report.term_seconds(rec)
    predicted = meta["peak_live_bytes"]
    out = {"cell": shape.name, "B": shape.global_batch, "S": shape.seq_len,
           "counts_equal": equal,
           "flops_by_dtype": meta["flops_by_dtype"],
           "hbm_bytes": meta["hbm_bytes_per_device"],
           "kernel_charges": meta["kernel_charges"], "n_ops": meta["n_ops"],
           "launches_in_counted_run": launches,
           "peak_predicted_gb": predicted / 1e9,
           "peak_card_counted_run_gb": card["peak_live_bytes"] / 1e9,
           "peak_measured_gb": measured / 1e9,
           "peak_ratio": measured / predicted,
           "step_ms_median": step_ms, "bound_ms": t["bound_step_s"] * 1e3,
           "bound_terms_ms": {k: t[f"{k}_s"] * 1e3 for k in (
               "compute", "memory", "collective")},
           "dominant": t["dominant"],
           "share_of_bound": t["bound_step_s"] * 1e3 / step_ms,
           "model_flops": t["model_flops_per_dev"],
           "model_flop_share_of_bf16_peak": (
               t["model_flops_per_dev"] / (step_ms / 1e3)
               / report.PEAK_FLOPS["bfloat16"])}
    if not all(equal.values()):
        out["op_diff"] = dryrun_diff(om, oc)
    return out


def dryrun_flash_call(cfg) -> dict:
    """One flash call at ``cfg``'s heads (B 2 x S 1,024, bf16), launched at
    its head dim (Zamba2's 112, which was zero-padded to 128 before the
    kernel had an instance of it): its count on ``meta`` and on the card,
    and the card's ``max_memory_allocated`` above the inputs beside the
    count's peak (the output alone: no scratch)."""
    free_card()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((2, 1024, cfg.n_heads, cfg.hd), generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    metas = [torch.empty_like(t, device="meta") for t in (q, k, v)]
    with OpCost() as om:
        ops.flash_attention(*metas)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    n0 = ops.launches["flash_attention"]
    with OpCost() as oc:
        ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    meta, card = om.summary(), oc.summary()
    out = {"shape": list(q.shape), "route": ops.flash_route(torch.bfloat16,
                                                          cfg.hd),
           "counts_equal": meta == card,
           "launches": ops.launches["flash_attention"] - n0,
           "kernel_charges": card["kernel_charges"],
           "peak_predicted_bytes": card["peak_live_bytes"],
           "peak_measured_bytes": measured,
           "peak_ratio": measured / card["peak_live_bytes"]}
    del q, k, v
    free_card()
    return out


def phase_dryrun(smi) -> dict:
    """The dry-run's count held against the card (docstring, phase 20), in
    this process.  Returns the phase's launches."""
    t0 = time.perf_counter()
    qwen = get_config(DRYRUN_ARCH)
    zamba = get_config(DRYRUN_ZAMBA_ARCH).with_(n_layers=DRYRUN_ZAMBA_LAYERS)
    ops.reset_launches()
    cells, failures = [], []
    for cfg, shape in [(qwen, s) for s in DRYRUN_CELLS] + [
            (zamba, DRYRUN_CELLS[1])]:
        n_active = Model(cfg, params={}).n_active_params()
        r = dryrun_cell(cfg, shape, n_active)
        r["arch"], r["n_layers"] = cfg.name, cfg.n_layers
        cells.append(r)
        name = f"{cfg.name} {shape.name}"
        if not all(r["counts_equal"].values()):
            failures.append(f"{name}: meta and card counts differ "
                            f"{r['counts_equal']}")
        charges = r["kernel_charges"]
        flash = charges.get("flash_attention", {}).get("calls", 0)
        launched = r["launches_in_counted_run"]["flash_attention"]
        want = (0 if shape.kind != "prefill" else cfg.n_layers
                if cfg.family == "dense" else cfg.n_layers // cfg.attn_period)
        if flash != launched or flash != want:
            failures.append(f"{name}: {flash} flash charges, {launched} "
                            f"launches, {want} wanted")
        lo, hi = DRYRUN_PEAK_BAR
        if not lo <= r["peak_ratio"] <= hi:
            failures.append(f"{name}: measured peak {r['peak_ratio']:.4f}"
                            f" of the predicted one, outside {DRYRUN_PEAK_BAR}")
    call = dryrun_flash_call(zamba)
    if not (call["counts_equal"] and call["launches"] == 1
            and set(call["kernel_charges"]) == {"flash_attention"}
            and lo <= call["peak_ratio"] <= hi):
        failures.append(f"flash call at D {zamba.hd}: {call}")
    launches = dict(ops.launches)
    out = {"phase": "dryrun", "card": smi,
           "dtype": "bfloat16", "peaks": report.CARD,
           "peak_bar": DRYRUN_PEAK_BAR, "cells": cells,
           "flash_call_d112": call, "launches": launches,
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"dryrun phase: {failures}")
    return launches


# ---------------------------------------------------------- mesh phase

def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_note(what: str, t0: float) -> None:
    """Progress on stderr: a timeout shows where a rank was."""
    print(f"mesh: {what} at {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


@contextlib.contextmanager
def collective_timer(device):
    """Host ms inside ``torch.distributed``'s all_gather, all_reduce and
    reduce_scatter while active, by name, the card synchronised before and
    after each call (so it times the collective and not the work queued
    before it)."""
    import torch.distributed as dist
    names = ("all_gather", "all_reduce", "reduce_scatter")
    box = {n: 0.0 for n in names} | {"calls": 0}
    saved = {n: getattr(dist, n) for n in names}

    def timed(name, fn):
        def call(*a, **k):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(device)
            box[name] += (time.perf_counter() - t0) * 1e3
            box["calls"] += 1
            return out
        return call

    for n, fn in saved.items():
        setattr(dist, n, timed(n, fn))
    try:
        yield box
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def mesh_batches(cfg, device, seed: int = SEED) -> list:
    """The mesh phase's global batches: ``MESH_STEPS`` of B x S tokens."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    B, S = MESH_SHAPE.global_batch, MESH_SHAPE.seq_len
    return [{"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device=device, dtype=torch.int32)}
            for _ in range(MESH_STEPS)]


def mesh_params(cfg, device, mesh=None, seed: int = SEED) -> dict:
    """The seed's params, whole or this rank's shards of ``mesh``."""
    model = Model(cfg, params={})
    params = model.init(seed, device=device)
    if mesh is not None:
        it = iter(tree_specs(model.axes(), params, mesh))
        params = tree_map(lambda t: shard_spec(t, next(it), mesh), params)
    return params


def mesh_train(cfg, device, mesh=None, seed: int = SEED,
               count: bool = False) -> dict:
    """``MESH_STEPS`` AdamW steps of the phase's batches from the seed's
    params, on one device (``mesh`` None) or as this rank of ``mesh`` (its
    shards, its batch slices): losses, params (this rank's), each step's ms
    up to its loss on the host, and its collectives' ms.  ``count``: the
    first step runs under a counter (``launch.steps.build_cell``'s train
    cell, the same step on the same arguments), with the card's peak above
    its level before the params were drawn."""
    model = Model(cfg, params={})
    base = torch.cuda.memory_allocated() if count else 0
    params = mesh_params(cfg, device, mesh, seed)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = AdamW(**MESH_OPT)
    state = opt.init(params)
    step = (make_train_fn(model, opt) if mesh is None else make_train_fn(
        model, opt, mesh, global_batch=MESH_SHAPE.global_batch))
    out = {"loss": [], "step_ms": [], "all_gather_ms": [],
           "all_reduce_ms": [], "reduce_scatter_ms": [],
           "collective_calls": [], "compute": step.compute}
    for i, b in enumerate(mesh_batches(cfg, device, seed)):
        if mesh is not None:
            b = shard_batch(b, TOKENS_AXES, mesh)
        counter = contextlib.nullcontext()
        if count and i == 0:
            sync(device)
            torch.cuda.reset_peak_memory_stats()
            n0 = dict(ops.launches)
            counter = OpCost(inputs=(params, state, b))
        with collective_timer(device) as ct, counter:
            sync(device)
            t0 = time.perf_counter()
            params, state, loss = step(params, state, b)
            out["loss"].append(float(loss))
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if count and i == 0:
            out["count"] = {
                "card": counter.summary(),
                "measured_peak": torch.cuda.max_memory_allocated() - base,
                "launches": {k: n - n0[k] for k, n in ops.launches.items()}}
        for name in ("all_gather", "all_reduce", "reduce_scatter"):
            out[f"{name}_ms"].append(ct[name])
        out["collective_calls"].append(ct["calls"])
    out["params"] = params
    return out


def mesh_cell(cfg, shape, sizes: dict, count: dict) -> dict:
    """(d): a cell's count on the card (``count``: ``card``, the measured
    peak, the launches) beside ``build_cell``'s on ``meta`` at the mesh's
    ``sizes``."""
    fn, args = build_cell(cfg, shape, "meta", mesh=sizes)
    with OpCost(inputs=args) as om:
        fn(*args)
    del fn, args
    meta, card = om.summary(), count["card"]
    keys = ("flops_by_dtype", "hbm_bytes_per_device", "kernel_charges",
            "collective_bytes_per_device")
    return {"cell": shape.name, "B": shape.global_batch, "S": shape.seq_len,
            "counts_equal": {k: meta[k] == card[k] for k in keys},
            "flops_by_dtype": meta["flops_by_dtype"],
            "hbm_bytes": meta["hbm_bytes_per_device"],
            "collective_bytes": meta["collective_bytes_per_device"],
            "collective_counts": meta["collective_counts"],
            "kernel_charges": meta["kernel_charges"],
            "launches_in_counted_run": count["launches"],
            "peak_predicted_gb": meta["peak_live_bytes"] / 1e9,
            "peak_measured_gb": count["measured_peak"] / 1e9,
            "peak_ratio": count["measured_peak"] / meta["peak_live_bytes"]}


def tree_digests(tree) -> dict:
    return {"/".join(path): digest(t.detach().reshape(-1))
            for path, t in leaves_with_path(tree)}


def mesh_manager(root) -> CheckpointManager:
    return CheckpointManager(os.path.join(root, "ckpt"), keep_last=1,
                             **MESH_CKPT)


MESH_KEYS = ("loss", "step_ms", "all_gather_ms", "all_reduce_ms",
             "reduce_scatter_ms", "collective_calls", "compute")


def mesh_leg(cfg, device, shape: tuple, root, name: str, card: bool,
             seed: int) -> dict:
    """One leg's steps on a ``shape`` (data, model) mesh of this spawn's two
    ranks: the rank's param shards written to ``root`` as ``name`` for (a)
    to hold against; with ``card``, its peak ``max_memory_allocated`` and
    the first step counted as (d)'s train cell at the mesh's sizes."""
    mesh = make_debug_mesh(*shape, device.type)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    r = mesh_train(cfg, device, mesh, seed, count=card)
    out = {k: r[k] for k in MESH_KEYS}
    torch.save({"/".join(p): t.detach().cpu()
                for p, t in leaves_with_path(r["params"])},
               os.path.join(root, f"{name}_{torch.distributed.get_rank()}"
                                  f".pt"))
    if on_card:
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if card:
        count = r["count"]
        del r
        free_card()
        out["train_cell"] = mesh_cell(cfg, MESH_SHAPE,
                                      dict(zip(("data", "model"), shape)),
                                      count)
        out["train_cell"]["mesh"] = list(shape)
    return out


def mesh_family_config(leg: str, smoke: bool):
    """A family leg's config (``MESH_FAMILY_LEGS``), cut in depth (at
    ``smoke``, its smoke config at its own capacity factor: for the MoE
    families 1.25, where the capacity binds)."""
    _, arch, layers = MESH_FAMILY_LEGS[leg]
    cfg = get_config(arch)
    if smoke:
        return cfg.smoke().with_(capacity_factor=cfg.capacity_factor)
    return cfg if layers is None else cfg.with_(n_layers=layers)


def mesh_grad_config(leg: str, smoke: bool):
    """The config of a leg's f32 first gradient (``MESH_GRAD_LEGS``): at
    ``smoke`` the leg's own, else cut to the check's depth."""
    cfg = mesh_family_config(leg, smoke)
    layers = MESH_GRAD_LEGS[leg]
    return cfg if smoke or layers is None else cfg.with_(n_layers=layers)


def mesh_first_grads(rank, device, cfg, seed: int = SEED) -> dict:
    """(g)-(i)'s f32 check on this rank of the (1, 2) mesh: the first
    step's loss and gradient from the seed's params (the phase's bf16 draw,
    in f32) on the phase's first batch, the partitioned route's (this
    rank's shards, ``launch.steps.partitioned_grads``) against the
    one-device step's, which each rank computes in turn (one whole gradient
    on the card at a time) and keeps its own slices of.  Returns the loss's
    relative gap and, per leaf, the largest |difference| over the
    one-device leaf's largest |value|: the worst leaf's and the mean over
    the leaves; and the partitioned gradient's ms."""
    model = Model(cfg, params={})
    mesh = make_debug_mesh(*MESH_TP, device.type)
    whole = mesh_params(cfg, device, None, seed)
    batch = mesh_batches(cfg, device, seed)[0]
    specs = tree_specs(model.axes(), whole, mesh)
    names = ["/".join(path) for path, _ in leaves_with_path(whole)]
    for r in range(torch.distributed.get_world_size()):
        if r == rank:
            p = tree_map(lambda t: t.detach().float().requires_grad_(True),
                         whole)
            loss = model.loss(p, batch)
            grads = torch.autograd.grad(loss, leaves(p))
            one_loss = float(loss.detach())
            leaf_max = [float(g.abs().max()) for g in grads]
            want = [shard_view(g, sp, mesh).clone()
                    for g, sp in zip(grads, specs)]
            del p, loss, grads
            free_card()
        torch.distributed.barrier()
    it = iter(specs)
    p = tree_map(lambda t: shard_spec(t, next(it), mesh).detach().float()
                 .requires_grad_(True), whole)
    del whole
    sync(device)
    t0 = time.perf_counter()
    loss, grads = partitioned_grads(model, Partition(model, mesh), p,
                                    shard_batch(batch, TOKENS_AXES, mesh))
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    over = []
    for g, w, m in zip(grads, want, leaf_max):
        d = float((g - w).abs().max())
        over.append(d / m if m else (0.0 if d == 0 else math.inf))
    worst = max(range(len(over)), key=over.__getitem__)
    loss = float(loss.detach())
    del p, grads, want
    free_card()
    return {"loss": loss, "one_loss": one_loss,
            "loss_rel_gap": abs(loss / one_loss - 1),
            "worst_over_leaf_max": over[worst], "worst_leaf": names[worst],
            "mean_over_leaf_max": sum(over) / len(over),
            "leaves": len(over), "grad_ms": ms}


def mesh_grads_rank(rank, device, smoke: bool, seed: int = SEED,
                    legs: tuple = tuple(MESH_GRAD_LEGS)) -> dict:
    """:func:`mesh_first_grads` of each of ``legs`` alone, on each of a
    spawn's two ranks (``scripts/rehearse_mesh.py --grads``)."""
    deterministic()
    return {leg: mesh_first_grads(rank, device, mesh_grad_config(leg, smoke),
                                  seed) for leg in legs}


def mesh_pair_rank(rank, device, smoke: bool, root, card: bool,
                   seed: int = SEED,
                   legs: tuple = ("pair", "tp", *MESH_FAMILY_LEGS)) -> dict:
    """(b), (e) and (f)-(i), on each of this spawn's two ranks: the steps on
    the (2, 1) mesh, then on the (1, 2) mesh, then each family leg's config
    on the (1, 2) mesh (``legs`` names which run), each rank's param shards
    written to ``root`` for (a) to hold against; with ``card``, (b)'s and
    (e)'s first step counted as (d)'s train cell, then (d)'s prefill cell,
    then (c): the params at ``MESH_ELASTIC_LAYERS`` saved from the (2, 1)
    mesh (each shard's digest) and restored (``mesh_regrow``)."""
    t0 = time.perf_counter()
    deterministic()
    ops.reset_launches()
    cfg = get_config(MESH_ARCH)
    cfg = cfg.smoke() if smoke else cfg
    out = {}
    for leg in legs:
        shape = MESH_PAIR if leg == "pair" else MESH_TP
        leg_cfg = (cfg if leg in ("pair", "tp")
                   else mesh_family_config(leg, smoke))
        out[leg] = mesh_leg(leg_cfg, device, shape, root, leg,
                            card and leg in ("pair", "tp"), seed)
        free_card()
        mesh_note(f"{leg} {shape} steps done", t0)
        if leg in MESH_GRAD_LEGS:
            out[leg]["grad32"] = mesh_first_grads(
                rank, device, mesh_grad_config(leg, smoke), seed)
            mesh_note(f"{leg} f32 first gradient done", t0)
    if card:
        out["prefill_cell"] = mesh_prefill_cell(cfg, device)
        mesh_note("prefill cell counted", t0)
        mesh = make_debug_mesh(*MESH_PAIR, device.type)
        cut = cfg.with_(n_layers=MESH_ELASTIC_LAYERS)
        params = mesh_params(cut, device, mesh, seed)
        specs = tree_specs(Model(cut, params={}).axes(),
                           Model(cut, params={}).abstract(), mesh)
        t1 = time.perf_counter()
        mesh_manager(root).save(1, params, mesh=mesh, specs=specs)
        out["elastic"] = {"save_s": time.perf_counter() - t1,
                          "digests": tree_digests(params)}
        del params
        free_card()
        mesh_note("elastic save done", t0)
        saved = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(saved, out["elastic"]["digests"])
        out["regrow"] = mesh_regrow(rank, device, root, saved, t0)
    out["launches"] = dict(ops.launches)
    return out


def mesh_gap(one_params, root, device, name: str = "pair",
             shape: tuple = MESH_PAIR, cfg=None) -> dict:
    """A leg against (a): each rank's param shards (``name``, on a
    ``shape`` mesh) against the same slices of the one-device params, as
    the share of elements that differ and the largest and mean |difference|
    over its cap, ``MESH_STEPS`` times 2 lr plus one unit in the last place
    of the larger of the two values (each step's update rounds to the
    leaf's type); on a mesh with a "model" axis, the same over the leaves
    every "model" rank holds whole (``model_whole``: the norms, whose
    gradients are summed over "model"), and whether those ranks' copies of
    them are bitwise equal."""
    sizes = dict(zip(("data", "model"), shape))
    axes = Model(cfg or get_config(MESH_ARCH), params={}).axes()
    specs = tree_specs(axes, one_params, sizes)
    # per subset: worst, sum of |d| / cap, elements that differ, elements
    acc = {k: [0.0, 0.0, 0, 0] for k in ("all", "model_whole")}
    copies: dict = {}
    worst_leaf = None
    for r in range(shape[0] * shape[1]):
        shards = torch.load(os.path.join(root, f"{name}_{r}.pt"))
        coords = {"data": r // shape[1], "model": r % shape[1]}
        for (path, a), sp in zip(leaves_with_path(one_params), specs):
            want = shard_view(a.detach(), sp, sizes, coords).float()
            got = shards.pop("/".join(path)).to(device).float()
            ulp = torch.finfo(a.dtype).eps * torch.exp2(torch.frexp(
                torch.maximum(want.abs(), got.abs())).exponent.float() - 1)
            d = (got - want).abs() / (MESH_STEPS * (ulp + 2 * MESH_OPT["lr"]))
            over = float(d.max())
            if over > acc["all"][0]:
                worst_leaf = "/".join(path)
            held_whole = shape[1] > 1 and "model" not in sp
            for k in ("all", "model_whole")[:1 + held_whole]:
                acc[k][0] = max(acc[k][0], over)
                acc[k][1] += float(d.sum())
                acc[k][2] += int((d > 0).sum())
                acc[k][3] += d.numel()
            if held_whole:
                copies.setdefault(("/".join(path), coords["data"]),
                                  []).append(got)

    def read(k):
        worst, total, differ, n = acc[k]
        return {"share_differ": differ / n, "worst_over_cap": worst,
                "mean_over_cap": total / n, "elements": n}

    out = read("all") | {"worst_leaf": worst_leaf}
    if copies:
        out["model_whole"] = read("model_whole") | {"copies_equal": all(
            torch.equal(c[0], x) for c in copies.values() for x in c)}
    return out


def mesh_one(root) -> dict:
    """(a) in this process, one ``nccl`` rank at world size 1 (the tp
    phase's way), deterministic kernels while it runs: the one-device
    steps (and their peak above the level before), (b)'s and (e)'s shards
    held against them, (f)-(i)'s each against its config's own one-device
    steps, then the same steps on a (1, 1) mesh."""
    t0 = time.perf_counter()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(MESH_ARCH)
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    store = torch.distributed.FileStore(os.path.join(root, "nccl_store"), 1)
    torch.distributed.init_process_group("nccl", store=store, rank=0,
                                         world_size=1)
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one = mesh_train(cfg, device)
        out = {"one": {"loss": one["loss"], "step_ms": one["step_ms"],
                       "digests": tree_digests(one["params"]),
                       "max_memory_allocated_gb": (
                           torch.cuda.max_memory_allocated() - base) / 1e9}}
        out["gap"] = mesh_gap(one["params"], root, device)
        out["gap_tp"] = mesh_gap(one["params"], root, device, "tp", MESH_TP)
        del one
        free_card()
        mesh_note("one-device steps and gap done", t0)
        for leg in MESH_FAMILY_LEGS:
            leg_cfg = mesh_family_config(leg, False)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            one = mesh_train(leg_cfg, device)
            out[leg] = {"loss": one["loss"], "step_ms": one["step_ms"],
                        "max_memory_allocated_gb": (
                            torch.cuda.max_memory_allocated() - base) / 1e9,
                        "gap": mesh_gap(one["params"], root, device, leg,
                                        MESH_TP, leg_cfg)}
            del one
            free_card()
            mesh_note(f"one-device {leg} steps and gap done", t0)
        m = mesh_train(cfg, device, make_debug_mesh(1, 1, device.type))
        out["mesh11"] = {"loss": m["loss"], "step_ms": m["step_ms"],
                         "digests": tree_digests(m["params"])}
        del m
        free_card()
        mesh_note("(1, 1) steps done", t0)
    finally:
        torch.distributed.destroy_process_group()
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    return out


def mesh_prefill_cell(cfg, device) -> dict:
    """(d)'s prefill cell (B 2 x 1,024) on this rank of the (2, 1) mesh,
    counted on the card and on ``meta``."""
    n0 = dict(ops.launches)
    mesh = make_debug_mesh(*MESH_PAIR, device.type)
    base = torch.cuda.memory_allocated()
    fn, args = build_cell(cfg, MESH_PREFILL, device, mesh=mesh, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with OpCost(inputs=args) as oc:
        fn(*args)
    torch.cuda.synchronize()
    count = {"card": oc.summary(),
             "launches": {k: n - n0[k] for k, n in ops.launches.items()},
             "measured_peak": torch.cuda.max_memory_allocated() - base}
    del fn, args
    free_card()
    return mesh_cell(cfg, MESH_PREFILL, dict(zip(("data", "model"),
                                                 MESH_PAIR)), count)


def mesh_restore(root, cfg, device, mesh) -> tuple[dict, float]:
    """(c)'s params, restored onto ``mesh`` (None: whole, on ``device``):
    this rank's shards, seconds."""
    model = Model(cfg, params={})
    t0 = time.perf_counter()
    got = mesh_manager(root).restore(model.abstract(), 1, device=device,
                                     mesh=mesh, axes=model.axes())
    return got, time.perf_counter() - t0


def mesh_regrow(rank, device, root, saved: list, t0: float) -> dict:
    """(c) restored, in the saving spawn once every rank has saved: first
    onto one rank (rank 0 alone, no mesh: the whole params, each leaf's
    (2, 1) slices digested against the saving ranks' shards), then onto
    the (2, 1) mesh again (this rank's shards against the saving rank's),
    and one step taken from fresh moments (as ``tests/test_elastic.py``)."""
    cut = get_config(MESH_ARCH).with_(n_layers=MESH_ELASTIC_LAYERS)
    model = Model(cut, params={})
    mesh = make_debug_mesh(*MESH_PAIR, device.type)
    out = {}
    if rank == 0:
        got, out["restore_one_rank_s"] = mesh_restore(root, cut, device,
                                                      None)
        sizes = dict(zip(("data", "model"), MESH_PAIR))
        specs = tree_specs(model.axes(), got, sizes)
        out["restored_one_rank_bitwise"] = all(
            digest(shard_view(t, sp, sizes, {"data": r, "model": 0})
                   .reshape(-1)) == saved[r]["/".join(path)]
            for (path, t), sp in zip(leaves_with_path(got), specs)
            for r in range(MESH_PAIR[0]))
        del got
        free_card()
    torch.distributed.barrier()
    mesh_note("restore onto one rank done", t0)
    params, out["restore_s"] = mesh_restore(root, cut, device, mesh)
    out["restored_bitwise"] = tree_digests(params) == saved[rank]
    mesh_note("restore onto (2, 1) done", t0)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = AdamW(**MESH_OPT)
    step = make_train_fn(model, opt, mesh,
                         global_batch=MESH_SHAPE.global_batch)
    b = shard_batch(mesh_batches(cut, device)[0], TOKENS_AXES, mesh)
    _, _, loss = step(params, opt.init(params), b)
    out["loss_after_regrow"] = float(loss)
    del params
    free_card()
    mesh_note("regrow step done", t0)
    return out


def mesh_family_gap(leg: str, ranks: list, one: dict, failures: list) -> dict:
    """A family leg (f)-(i) against its config's one-device steps: the
    losses' largest relative gap, the params' (``mesh_gap``), each within
    ``MESH_BARS_FAMILY``, the norms' copies equal (failures appended); the
    leg's report line."""
    letter, arch, layers = MESH_FAMILY_LEGS[leg]
    bars = MESH_BARS_FAMILY[leg]
    losses = np.array(ranks[0]["loss"])
    gap_loss = float(np.abs(losses / np.array(one["loss"]) - 1).max())
    name = f"({letter}) {arch} (1, 2)"
    if any(r["loss"] != ranks[0]["loss"] for r in ranks):
        failures.append(f"{name}: the ranks read different losses")
    if gap_loss > bars["loss_rtol"]:
        failures.append(f"{name}: losses {losses.tolist()} against "
                        f"{one['loss']}: {gap_loss:.3g} relative")
    gap, whole = one["gap"], one["gap"]["model_whole"]
    if (gap["share_differ"] > bars["param_share_differ"]
            or gap["worst_over_cap"] > 1.0
            or whole["mean_over_cap"] > bars["model_whole_mean_over_cap"]
            or not whole["copies_equal"]):
        failures.append(f"{name}: params against its one-device steps: "
                        f"{gap}")
    n_layers = get_config(arch).n_layers
    row = {"model": arch,
           "cut": ("uncut" if layers is None
                   else f"{layers} of {n_layers} layers"),
           "ranks": [{k: r[k] for k in MESH_KEYS + (
               "max_memory_allocated_gb",)} for r in ranks],
           "one_device": {k: one[k] for k in (
               "loss", "step_ms", "max_memory_allocated_gb")},
           "bars": bars, "loss_max_rel_gap": gap_loss, "params": gap}
    if leg in MESH_GRAD_LEGS:
        bars32 = MESH_GRAD_BARS[leg]
        cut = MESH_GRAD_LEGS[leg]
        row["f32_first_gradient"] = {
            "cut": "uncut" if cut is None else f"{cut} of {n_layers} layers",
            "bars": bars32, "ranks": [r["grad32"] for r in ranks]}
        for i, r in enumerate(ranks):
            g = r["grad32"]
            if (g["loss_rel_gap"] > bars32["loss_rtol"]
                    or g["worst_over_leaf_max"] > bars32[
                        "worst_over_leaf_max"]):
                failures.append(f"{name} rank {i}: f32 first gradient "
                                f"against one device's: {g}")
    return row


def phase_mesh(smi) -> dict:
    """Training on the JAX package's data x model mesh (docstring, phase
    21): a spawn of two ranks, then (a) in this process.  Returns the
    phase's launches, summed over its ranks."""
    free_card()
    t0 = time.perf_counter()
    chip = importlib.import_module("chip_smoke")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    failures, spawn_s = [], {}
    try:
        pair = spawn_ranks(chip.mesh_pair_rank, 2, False, root, True,
                           backend="gloo", device="cuda",
                           timeout_s=MESH_TIMEOUT_S)
        spawn_s["pair"] = time.perf_counter() - t0
        one = mesh_one(root)
        spawn_s["one"] = time.perf_counter() - t0 - spawn_s["pair"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # (a) the (1, 1) nccl mesh is the one-device step, bit for bit
    a_bitwise = (one["mesh11"]["loss"] == one["one"]["loss"]
                 and one["mesh11"]["digests"] == one["one"]["digests"])
    if not a_bitwise:
        failures.append("(1, 1) mesh steps differ from the one-device "
                        "steps")
    # (b) the two gloo ranks within their bars of (a)
    losses = np.array(pair[0]["pair"]["loss"])
    want = np.array(one["one"]["loss"])
    loss_gap = float(np.abs(losses / want - 1).max())
    if any(r["pair"]["loss"] != pair[0]["pair"]["loss"] for r in pair):
        failures.append("the ranks read different losses")
    if loss_gap > MESH_BARS["loss_rtol"]:
        failures.append(f"(2, 1) losses {losses.tolist()} against "
                        f"{want.tolist()}: {loss_gap:.3g} relative")
    gap = one["gap"]
    if (gap["share_differ"] > MESH_BARS["param_share_differ"]
            or gap["worst_over_cap"] > 1.0):
        failures.append(f"(2, 1) params against (a): {gap}")
    b_ranks, e_ranks = [r["pair"] for r in pair], [r["tp"] for r in pair]
    for r in b_ranks:
        if r["max_memory_allocated_gb"] >= MESH_PAIR_PEAK_REPLICATED_GB:
            failures.append(f"(2, 1) rank peak {r['max_memory_allocated_gb']}"
                            f" GB, not below the replicated route's "
                            f"{MESH_PAIR_PEAK_REPLICATED_GB}")
    # (e) the (1, 2) mesh's partitioned steps within their bars of (a)
    e_losses = np.array(e_ranks[0]["loss"])
    e_loss_gap = float(np.abs(e_losses / want - 1).max())
    if any(r["loss"] != e_ranks[0]["loss"] for r in e_ranks):
        failures.append("the (1, 2) ranks read different losses")
    if e_loss_gap > MESH_BARS_TP["loss_rtol"]:
        failures.append(f"(1, 2) losses {e_losses.tolist()} against "
                        f"{want.tolist()}: {e_loss_gap:.3g} relative")
    gap_tp = one["gap_tp"]
    whole = gap_tp["model_whole"]
    if (gap_tp["share_differ"] > MESH_BARS_TP["param_share_differ"]
            or gap_tp["worst_over_cap"] > 1.0
            or whole["mean_over_cap"] > MESH_BARS_TP[
                "model_whole_mean_over_cap"]
            or not whole["copies_equal"]):
        failures.append(f"(1, 2) params against (a): {gap_tp}")
    # (f)-(i) each family's partitioned steps within their bars of its own
    # one-device steps
    family = {leg: mesh_family_gap(leg, [r[leg] for r in pair], one[leg],
                                   failures) for leg in MESH_FAMILY_LEGS}
    for r in b_ranks + e_ranks + [x for r in pair for x in (
            r[leg] for leg in MESH_FAMILY_LEGS)]:
        if r["compute"] != "partitioned":
            failures.append(f"a leg ran the {r['compute']} route")
    # (c) elastic
    regrow = [r["regrow"] for r in pair]
    if not regrow[0]["restored_one_rank_bitwise"]:
        failures.append("restore onto one rank is not the saved leaves")
    for r in regrow:
        if not r["restored_bitwise"]:
            failures.append("restore onto (2, 1) is not the saved leaves")
        if not np.isfinite(r["loss_after_regrow"]):
            failures.append(f"loss after the regrow {r['loss_after_regrow']}")
    # (d) meta and card counts, flash launches = charges, the peak
    lo, hi = DRYRUN_PEAK_BAR
    cells = [[p["pair"]["train_cell"], p["tp"]["train_cell"],
              p["prefill_cell"]] for p in pair]
    for rank, rank_cells in enumerate(cells):
        for c in rank_cells:
            name = f"rank {rank} {c['cell']} {tuple(c.get('mesh', MESH_PAIR))}"
            if not all(c["counts_equal"].values()):
                failures.append(f"{name}: meta and card counts differ "
                                f"{c['counts_equal']}")
            flash = c["kernel_charges"].get("flash_attention", {}).get(
                "calls", 0)
            launched = c["launches_in_counted_run"]["flash_attention"]
            want_flash = get_config(MESH_ARCH).n_layers if (
                c["cell"] == "prefill") else 0
            if not flash == launched == want_flash:
                failures.append(f"{name}: {flash} flash charges, {launched}"
                                f" launches, {want_flash} wanted")
            if c["cell"] == "train" and not c["collective_bytes"].get(
                    "reduce-scatter"):
                failures.append(f"{name}: no reduce-scatter counted")
            if not lo <= c["peak_ratio"] <= hi:
                failures.append(f"{name}: measured peak {c['peak_ratio']:.4f}"
                                f" of the predicted one, outside "
                                f"{DRYRUN_PEAK_BAR}")
    launches = {k: sum(r["launches"][k] for r in pair)
                for k in ops.launches}
    out = {"phase": "mesh", "card": smi, "model": MESH_ARCH,
           "dtype": "bfloat16", "deterministic": True,
           "shape": [MESH_SHAPE.global_batch, MESH_SHAPE.seq_len],
           "steps": MESH_STEPS, "opt": MESH_OPT, "bars": MESH_BARS,
           "a_one_device": {k: one["one"][k] for k in ("loss", "step_ms")},
           "a_nccl_mesh_1x1": {"loss": one["mesh11"]["loss"],
                               "step_ms": one["mesh11"]["step_ms"],
                               "bitwise_equal": a_bitwise},
           "a_one_device_peak_gb": one["one"]["max_memory_allocated_gb"],
           "b_gloo_mesh_2x1": {
               "ranks": [{k: r[k] for k in MESH_KEYS + (
                   "max_memory_allocated_gb",)} for r in b_ranks],
               "peak_replicated_route_gb": MESH_PAIR_PEAK_REPLICATED_GB,
               "loss_max_rel_gap": loss_gap, "params": gap},
           "e_gloo_mesh_1x2": {
               "ranks": [{k: r[k] for k in MESH_KEYS + (
                   "max_memory_allocated_gb",)} for r in e_ranks],
               "peak_one_device_train_phase_gb": MESH_ONE_DEVICE_PEAK_GB,
               "bars": MESH_BARS_TP,
               "loss_max_rel_gap": e_loss_gap, "params": gap_tp},
           **{f"{MESH_FAMILY_LEGS[leg][0]}_gloo_mesh_1x2_{leg}": row
              for leg, row in family.items()},
           "c_elastic": {
               "what": "params", "n_layers": MESH_ELASTIC_LAYERS,
               "cut": f"{MESH_ELASTIC_LAYERS} of "
                      f"{get_config(MESH_ARCH).n_layers} layers",
               "save_s": [r["elastic"]["save_s"] for r in pair],
               "restore_one_rank_s": regrow[0]["restore_one_rank_s"],
               "restored_one_rank_bitwise": regrow[0][
                   "restored_one_rank_bitwise"],
               "restore_2x1_s": [r["restore_s"] for r in regrow],
               "restored_2x1_bitwise": [r["restored_bitwise"]
                                        for r in regrow],
               "loss_after_regrow": [r["loss_after_regrow"]
                                     for r in regrow]},
           "d_counts": cells, "spawn_s": spawn_s, "launches": launches,
           "phase_seconds": time.perf_counter() - t0, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"mesh phase: {failures}")
    return launches


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    cfg = get_config("qwen3-1.7b")
    mono = phase_engine(cfg)
    launches = dict(mono["launches"])
    torch.cuda.empty_cache()
    phase_tokens(cfg)
    torch.cuda.empty_cache()
    results["mdc_priority"], launches["mdc_priority"] = phase_victims()
    paths = {"prefix": phase_prefix(cfg), "preemption": phase_preemption(cfg)}
    paths["chunked"] = phase_chunked(cfg, mono)
    paths["async"] = phase_async(cfg, mono)
    paths["recovery"] = phase_recovery(cfg, mono)
    paths["serve"] = phase_serve(cfg, mono, smi)
    paths["mixed"] = phase_mixed(cfg, smi)
    paths["sim"] = phase_sim(smi)
    torch.cuda.empty_cache()
    paths["tp"], tp_results = phase_tp(cfg, smi)
    results.update(tp_results)
    for name in TP_KERNELS:
        launches[name] = paths["tp"][name]
    torch.cuda.empty_cache()
    paths["moe"] = phase_moe(smi)
    torch.cuda.empty_cache()
    paths["yi"] = phase_yi(smi)
    torch.cuda.empty_cache()
    paths["train"] = phase_train(smi)
    torch.cuda.empty_cache()
    paths["families"] = phase_families(smi)
    torch.cuda.empty_cache()
    paths["encdec"] = phase_encdec(smi)
    free_card()
    paths["dryrun"] = phase_dryrun(smi)
    free_card()
    paths["mesh"] = phase_mesh(smi)
    emit({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name],
         "path": ("victims, sim" if name == "mdc_priority"
                  else "engine, moe, yi, families, encdec, dryrun, mesh"
                  if name == "flash_attention"
                  else "engine, moe, yi" if name == "paged_attention"
                  else "engine, moe" if name in ENGINE_KERNELS
                  else "tp" if name in TP_KERNELS else "none"),
         "launches": launches[name],
         "path_launches": {p: n[name] for p, n in paths.items()},
         "ms": results[name]["kernel_ms"],
         **{k: results[name][k] for k in ("max_abs_err", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
         # the same kernel at the moe phase's heads (H 32 over Kh 4; paged
         # G 8), at the yi phase's (paged G 7 over Kh 8), at the families
         # phase's Zamba2 heads (H 32 over Kh 32, D 112), at Nemotron-4's
         # (H 96 over Kh 8, D 192; bf16 and f32; paged G 12 and, sharded,
         # G 12 over a rank's 4 kv heads), at the
         # encdec phase's shapes (Whisper's encoder and cross attention,
         # non-causal, D 64; InternVL2's H 64 over Kh 8), and in f32 on
         # the CUDA cores at qwen3's heads (S 1,024 and the prefix hit)
         **{f"at_{model}_heads": {k: results[f"{name}_{model}"][k] for k in (
             "kernel_ms", "max_abs_err", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "flash_route")
             if k in results[f"{name}_{model}"]} for model in (
                 "moe", "yi", "zamba2", "nemotron", "nemotron_f32",
                 *encdec_flash_shapes(), "f32", "f32_hit")
            if f"{name}_{model}" in results}}
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
