"""Paged serving engine: continuous batching over the log-structured KV pool.

The port of the main path of ``repro.serving.engine.PagedServingEngine``.
The engine owns the tensor pool (per-layer K/V page arrays) and executes on
the device the two data paths the host-side pool manager plans:

  * decode      — up to ``max_decode_chunk`` tokens for every active slot per
                  dispatch; each token writes its K/V in place at
                  ``(page, off)`` and attends through the block tables with
                  the ``paged_attention`` kernel;
  * compaction  — the paper's cleaning: gather the live pages of MDC victims
                  with the ``segment_compact`` kernel, scatter them to their
                  new pages, and remap the block tables;

plus the bucketed monolithic prefill, whose attention is the
``flash_attention`` kernel, and the scatter of the prompt's K/V into pages.

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
(``rid``, ``lens``, ``to_gen``, ``npages``, ``tokens``) plus the ``bt``
block-table matrix.  Supported family: dense (GQA attention).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..core.logstructure import Placement
from ..device import resolve_device
from ..kernels import ops
from ..models import attention as att
from ..models import transformer as tfm
from ..models.layers import rmsnorm
from .kvcache import LogStructuredKVPool
from .scheduler import make_length_predictor


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int


def _pow2(n: int) -> int:
    """Smallest power of two ≥ n (≥ 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


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
                 predictor: str = "ewma", device=None):
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

        self.pool = LogStructuredKVPool(
            n_slabs, blocks_per_slab, policy=policy, streams=streams,
            demote_survivors=demote_survivors,
            compact_trigger=compact_trigger, compact_batch=compact_batch)
        self.streams = self.pool.n_open
        # synchronous plan execution: tensor move + block-table remap happen
        # before any compaction-freed page id can be re-allocated
        self.pool.on_compaction = self._execute_plan
        n_pages = n_slabs * blocks_per_slab
        self.trash_page = n_pages  # reserved scratch page for inactive slots

        L, Kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        shape = (L, n_pages + 1, page_T, Kh, hd)
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

        # --- device mirrors, uploaded only when an event dirties them ------
        self._bt_dev = self._put(self.bt)
        self._lens_dev = self._put(self.lens)
        self._tok_dev = self._put(self.tokens)
        self._act_dev = self._put(self.rid >= 0)
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
        self.dispatches = 0
        self._next_rid = 0

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # ------------------------------------------------------------- requests
    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens))
        return rid

    def slot_active(self, i: int) -> bool:
        return self.rid[i] >= 0

    def slot_pages(self, i: int) -> np.ndarray:
        """Physical pages held by slot i (a view of the block-table row)."""
        return self.bt[i, :self.npages[i]]

    def has_work(self) -> bool:
        return bool(self.queue) or bool((self.rid >= 0).any())

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

    def _predict_remaining(self, max_new: int, emitted: int) -> int:
        """Tokens a request is *predicted* to still emit: exact without stop
        tokens, else the length predictor's estimate in [1, tokens-left]."""
        cap = max(max_new - emitted, 1)
        if self.stop_token is None:
            return cap
        pred = self.length_predictor.predict(max_new)
        return int(np.clip(pred - emitted, 1, cap))

    def _admit(self) -> None:
        for i in np.flatnonzero(self.rid < 0):
            if not self.queue:
                break
            req = self.queue[0]
            worst = (len(req.prompt) + req.max_new_tokens + self.page_T - 1
                     ) // self.page_T
            if worst > self.max_pages_per_seq:
                raise ValueError("request exceeds max_seq")
            need = worst  # the conservative bound: max_new_tokens
            # the compaction reserve is compact_trigger *slabs*, waived when
            # nothing is active so a request sized to the pool can run alone
            reserve = (self.pool.admission_reserve()
                       if (self.rid >= 0).any() else 0)
            if self.pool.free_blocks() < need + reserve:
                break  # admission control: wait for deaths / compaction
            self.queue.popleft()
            self._start(int(i), req)

    def _start(self, i: int, req: Request) -> None:
        prompt = req.prompt
        plen = len(prompt)
        T = self.page_T
        n_pages = (plen + T - 1) // T
        # §5.3 placement estimator: blocks die when their sequence finishes
        # ⇒ expected death clock = now + blocks that will die then
        est = (self.pool.u_now + plen
               + self._predict_remaining(req.max_new_tokens, 0))
        # any compaction fires (and remaps the *other* slots' pages via the
        # callback) before these page ids are handed out
        pages_new = self.pool.alloc_blocks(
            np.full(n_pages, req.rid, dtype=np.int64), Placement(est_death=est))
        self.bt[i, :] = self.trash_page
        self.bt[i, :n_pages] = pages_new
        self.npages[i] = n_pages

        # bucketed dense prefill, then scatter the whole bucket's pages;
        # pages beyond the allocation land in the trash page
        tok_bucket, max_len = self._prefill_bucket(plen, n_pages)
        toks = np.zeros(tok_bucket, np.int64)
        toks[:plen] = prompt
        logits, cache = tfm.prefill(self.params, self._put(toks)[None],
                                    self.cfg, max_len,
                                    cache_dtype=self.pool_dtype, true_len=plen)
        first_tok = int(torch.argmax(logits[0]))
        L, _, _, Kh, hd = cache["k"].shape
        nb = max_len // T
        pages_pad = np.full(nb, self.trash_page, np.int64)
        pages_pad[:n_pages] = pages_new
        pages_dev = self._put(pages_pad)
        self.k_pools[:, pages_dev] = cache["k"][:, 0].reshape(L, nb, T, Kh, hd)
        self.v_pools[:, pages_dev] = cache["v"][:, 0].reshape(L, nb, T, Kh, hd)

        self.rid[i] = req.rid
        self.lens[i] = plen
        self.tokens[i] = first_tok
        self.to_gen[i] = req.max_new_tokens - 1
        out = np.empty(req.max_new_tokens, np.int32)
        out[0] = first_tok
        self._out[i] = out
        self._out_n[i] = 1
        self._bt_dirty = self._state_dirty = True
        # the prefill token may already complete the request: cap reached,
        # or (stop-token decode) the first emitted token is the stop token
        if self.to_gen[i] <= 0 or (self.stop_token is not None
                                   and first_tok == self.stop_token):
            self._admit_done.append(req.rid)
            self._finish(i)

    def _finish(self, i: int) -> None:
        rid = int(self.rid[i])
        self.finished[rid] = self._out[i][:self._out_n[i]].tolist()
        self.length_predictor.observe(int(self._out_n[i]))
        self.pool.free_pages(self.slot_pages(i).astype(np.int64))
        self.bt[i, :] = self.trash_page
        self.rid[i] = -1
        self.lens[i] = self.to_gen[i] = self.npages[i] = 0
        self.tokens[i] = 0
        self._out[i] = None
        self._out_n[i] = 0
        self._bt_dirty = self._state_dirty = True

    # ---------------------------------------------------------------- step
    def _sync_device(self) -> None:
        """Upload host state that an event dirtied since the last dispatch."""
        if self._bt_dirty:
            self._bt_dev = self._put(self.bt)
            self._bt_dirty = False
        if self._state_dirty:
            self._lens_dev = self._put(self.lens)
            self._tok_dev = self._put(self.tokens)
            self._act_dev = self._put(self.rid >= 0)
            self._state_dirty = False

    def _event_horizon(self, active: np.ndarray) -> int:
        """Tokens until the earliest host event: a slot crossing into an
        unallocated page (from ``seq_len % page_T``) or finishing.  With
        stop-token decode and work waiting, a slot's exit is invisible to
        the horizon, so dispatches shrink to one token (every exit is seen
        — and admission re-run — at the next token)."""
        if active.any():
            room = self.npages * self.page_T - self.lens
            until = np.minimum(room, self.to_gen)[active]
            n = min(int(until.min()), self.max_decode_chunk)
        else:
            n = 1
        if self.stop_token is not None and self.queue:
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
            o = ops.paged_attention(q[:, 0], kp, vp, self._bt_dev, attend)
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
        active slot in one dispatch.  Returns finished request ids."""
        self._admit()
        done, self._admit_done = self._admit_done, []
        active = self.rid >= 0
        if not active.any():
            return done
        self.dispatches += 1

        # pages for the incoming tokens must exist before the dispatch writes
        # them; one batched alloc covers every slot at a page boundary
        # (compaction, if it fires, remaps held pages first)
        growing = np.flatnonzero(active & (self.lens >= self.npages * self.page_T))
        if growing.size:
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

        n = self._event_horizon(active)
        self._sync_device()
        toks = self._decode(n).cpu().numpy()   # the one host sync

        # with stop tokens a slot may have stopped mid-dispatch: it emitted
        # tokens up to and including its first stop token
        act = np.flatnonzero(active)
        emitted = np.full(self.max_batch, n, np.int32)
        stopped = np.zeros(self.max_batch, bool)
        if self.stop_token is not None:
            hit = toks[:, act] == self.stop_token          # (n, |act|)
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
        for i in act:
            if stopped[i] or self.to_gen[i] <= 0:
                done.append(int(self.rid[i]))
                self._finish(int(i))
        return done

    def run_to_completion(self, max_steps: int = 100_000) -> dict:
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
        return self.finished

    # ----------------------------------------------------------- compaction
    def _move_plan(self, plan) -> None:
        """Compaction data path: pool[:, dst] = pool[:, src] for K and V.

        ``ops.segment_move`` moves both pools in one launch, or, when a
        survivor is placed into a page that the same plan frees (src/dst
        overlap), gathers every source into a buffer before it scatters, so
        each destination receives the old content."""
        src = np.asarray(plan.src_pages, np.int64)
        dst = np.asarray(plan.dst_pages, np.int64)
        if ((src < 0) | (src >= self.trash_page)).any() or \
                ((dst < 0) | (dst >= self.trash_page)).any():
            raise AssertionError("compaction plan outside the pool's pages")
        ops.segment_move((self.k_pools, self.v_pools), src, dst)

    def _apply_remap(self, plan) -> None:
        """Remap block tables: one vectorized page-id lookup over the
        matrix."""
        lut = np.arange(self.trash_page + 1, dtype=np.int32)
        lut[plan.src_pages] = plan.dst_pages
        self.bt = lut[self.bt]
        self._bt_dirty = True

    def _execute_plan(self, plan) -> None:
        """``pool.on_compaction``: move + remap, run to completion before
        the pool hands out any plan-freed page id."""
        if len(plan) == 0:
            return
        self._move_plan(plan)
        self._apply_remap(plan)

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        st = self.pool.stats
        return {
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
            "dispatches": self.dispatches,
        }
