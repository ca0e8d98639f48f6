"""Entry points of the port's kernels.

Layouts and argument order follow ``repro.kernels.ops``: attention tensors
are (B, S, H, D), pools (num_pages, T, Kh, D), flattened pool payloads
(N, E), per-segment arrays (N,).  A wrapper takes the plain PyTorch version
(:mod:`.ref`) for a tensor on the CPU; for a CUDA tensor it launches its
hand-written kernel on the current stream or raises — it never falls back.
``launches`` counts the kernel launches of each wrapper, so a run can show
which path it took; ``flash_routes`` splits flash attention's launches by
route, and ``move_plans`` counts the compaction plans ``segment_move`` moved
directly and staged.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build, ref

launches = {"paged_attention": 0, "segment_compact": 0, "flash_attention": 0,
            "mdc_priority": 0, "segment_move": 0}
# flash_attention launches by route: tensor cores (bf16, D in 64 / 128) or
# CUDA cores (f32, other head dims)
flash_routes = {"wgmma": 0, "simt": 0}
# segment_move plans by form, on any device: one launch pool to pool, or a
# gather and a scatter launch because a destination is another move's source
move_plans = {"direct": 0, "staged": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ROUTE = {"simt": 0, "wgmma": 1}


def reset_launches() -> None:
    for counts in (launches, flash_routes, move_plans):
        for name in counts:
            counts[name] = 0


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor is on the CPU; False when all sit on one CUDA
    device; raises for anything else."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    return False


def _check_kernel_inputs(name: str, *tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must be 16-byte aligned")


def _dtype_code(name: str, *tensors) -> int:
    dt = tensors[0].dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name}: kernel takes one dtype among float32 and "
                         f"bfloat16, got {[t.dtype for t in tensors]}")
    return _DTYPE_CODE[dt]


def _launch(name: str, device, *args) -> None:
    fn = getattr(build.load(name), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")
    launches[name] += 1


def _operand_strides(name: str, t) -> tuple[int, int, int]:
    """(batch, sequence, head) element strides of one (B, S, heads, D)
    operand as the kernel reads it; raises for a layout it cannot read."""
    shape, stride = t.shape, t.stride()
    if shape[3] > 1 and stride[3] != 1:
        raise ValueError(f"flash_attention: {name} needs a contiguous head "
                         f"dim, got strides {stride}")
    es = t.element_size()
    out = []
    for d in (0, 1, 2):
        st = stride[d]
        if shape[d] == 1:
            st = math.prod(shape[d + 1:])
        elif st <= 0 or st * es % 16:
            raise ValueError(
                f"flash_attention: {name}'s strides {stride} must be positive "
                f"multiples of 16 bytes outside the head dim")
        out.append(st)
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    return tuple(out)


def flash_layout(q, k, v) -> list[tuple[int, int, int]]:
    """The element strides (batch, sequence, head) of q (B, Sq, H, D) and
    k / v (B, Skv, Kh, D) as the kernel reads them, in place: D contiguous,
    every other stride positive and a multiple of 16 bytes, every base
    16-byte aligned.  Raises for anything else; nothing is copied.  A size-1
    dimension's stride is never read, so it is reported as the one a
    contiguous tensor would have."""
    qs, ks = q.shape, k.shape
    if (len(qs) != 4 or len(ks) != 4 or ks != v.shape or ks[0] != qs[0]
            or ks[3] != qs[3] or ks[2] == 0 or qs[2] % ks[2]):
        raise ValueError(f"flash_attention: bad shapes q {tuple(qs)} "
                         f"k {tuple(ks)} v {tuple(v.shape)}")
    return [_operand_strides("q", q), _operand_strides("k", k),
            _operand_strides("v", v)]


def flash_route(dtype, D: int) -> str:
    """The kernel route of a launch: tensor cores (``"wgmma"``) for bf16 at
    D 64 or 128, CUDA cores (``"simt"``) otherwise.  Dispatch, not fallback:
    a failure on either route raises."""
    return "wgmma" if dtype == torch.bfloat16 and D in (64, 128) else "simt"


def _flash(q, k, v, out, causal: bool) -> None:
    """Launch over (B, S, heads, D)-indexed views, any strides that
    :func:`flash_layout` takes, writing ``out`` (same index order as q)."""
    layout = flash_layout(q, k, v) + [_operand_strides("out", out)]
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, D)
    if route == "simt" and D not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: head dim {D} not in (16, 32, 64, 128)")
    code = _dtype_code("flash_attention", q, k, v, out)
    if Skv == 0:  # softmax over nothing: the plain version's zeros
        out.zero_()
        return
    strides = (ctypes.c_longlong * 12)(*(x for st in layout for x in st))
    _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), strides, B, H, Kh, Sq, Skv, D,
            1.0 / math.sqrt(D), int(causal), code, _FLASH_ROUTE[route])
    flash_routes[route] += 1


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """Core entry: q (B, H, Sq, D); k/v (B, Kh, Skv, D); H % Kh == 0 →
    (B, H, Sq, D).  The same kernel as :func:`flash_attention` over the
    other stride set.  Its tiles are fixed by each route's design, so unlike
    the Pallas entry there are no block-size arguments."""
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    if _on_cpu("flash_attention", q, k, v):
        flash_layout(qs, ks, vs)
        return ref.flash_attention_ref(qs, ks, vs, causal=causal).transpose(1, 2)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash(qs, ks, vs, out.transpose(1, 2), causal)
    return out


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k/v: (B, Skv, Kh, D) → (B, Sq, H, D): the model's
    head-interleaved layout, read in place (no transposes)."""
    if _on_cpu("flash_attention", q, k, v):
        flash_layout(q, k, v)
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _flash(q, k, v, out, causal)
    return out


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens):
    """q: (B, H, D); pools: (num_pages, T, Kh, D); block_tables: (B, P);
    seq_lens: (B,) → (B, H, D).  Table entries are clamped to
    ``[0, num_pages)``: by the kernel itself on the card, before the plain
    version on the CPU.  On the card a call with int32 tables and lengths is
    one launch whose grid depends only on B and Kh (no host sync, nothing
    sized by the data), so it can be captured in a CUDA graph."""
    B, H, D = q.shape
    num_pages, T, Kh, _ = k_pool.shape
    if _on_cpu("paged_attention", q, k_pool, v_pool, block_tables, seq_lens):
        bt = block_tables.clamp(0, num_pages - 1).to(torch.int32)
        return ref.paged_attention_ref(q, k_pool, v_pool, bt, seq_lens)
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != D or H % Kh
            or block_tables.dim() != 2 or block_tables.shape[0] != B
            or seq_lens.shape != (B,)):
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} bt "
                         f"{tuple(block_tables.shape)} seq_lens "
                         f"{tuple(seq_lens.shape)}")
    G = H // Kh
    if D not in (32, 64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"paged_attention: head dim {D} / group {G} not "
                         f"instantiated (D in 32, 64, 128; G in 1, 2, 4, 8)")
    code = _dtype_code("paged_attention", q, k_pool, v_pool)
    bt = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _check_kernel_inputs("paged_attention", q, k_pool, v_pool, bt, lens, out)
    _launch("paged_attention", q.device, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Kh, G, D, T, bt.shape[1], num_pages, 1.0 / math.sqrt(D), code)
    return out


def segment_compact(pool, src_idx):
    """pool: (N, E); src_idx: (M,) int32 in [0, N) → (M, E) relocated
    payloads.  An exact byte copy, for any dtype."""
    if _on_cpu("segment_compact", pool, src_idx):
        return ref.segment_compact_ref(pool, src_idx)
    if pool.dim() != 2 or src_idx.dim() != 1 or src_idx.dtype != torch.int32:
        raise ValueError(f"segment_compact: want pool (N, E) and int32 "
                         f"src (M,), got {tuple(pool.shape)} "
                         f"{tuple(src_idx.shape)} {src_idx.dtype}")
    N, E = pool.shape
    out = torch.empty((src_idx.shape[0], E), dtype=pool.dtype,
                      device=pool.device)
    if not pool.is_contiguous() or not src_idx.is_contiguous():
        raise ValueError("segment_compact: kernel inputs must be contiguous")
    _launch("segment_compact", pool.device, pool.data_ptr(),
            src_idx.data_ptr(), out.data_ptr(), N, src_idx.shape[0],
            E * pool.element_size())
    return out


# page ids per segment_move launch: they ride in the kernel's parameters
MOVE_CHUNK = 2048


def segment_move(pools, src, dst) -> None:
    """The compaction move, in place, for the K and V pools together: for
    each pool (L, n_pages, *page), ``pool[:, dst[i]] = pool[:, src[i]]``,
    every source read before any destination is written.  ``src`` / ``dst``
    are the plan's page ids as host integer arrays (the plan lives on the
    host); destinations must be distinct.  A plan whose destinations avoid
    its sources moves pool to pool in one launch; one in which a destination
    is another move's source is staged: a gather launch into a buffer, then
    a scatter launch (per ``MOVE_CHUNK`` moves each).  The page ids go to
    the kernel as launch parameters, so nothing is uploaded.  An exact byte
    copy, for any dtype."""
    kp, vp = pools
    src = np.asarray(src, np.int64).reshape(-1)
    dst = np.asarray(dst, np.int64).reshape(-1)
    if (kp.dim() < 2 or kp.shape != vp.shape or kp.dtype != vp.dtype
            or src.shape != dst.shape):
        raise ValueError(f"segment_move: want K and V pools of one shape and "
                         f"dtype and as many sources as destinations, got "
                         f"{tuple(kp.shape)} {kp.dtype}, {tuple(vp.shape)} "
                         f"{vp.dtype}, {src.shape} {dst.shape}")
    L, n_pages = kp.shape[:2]
    if src.size == 0:
        return
    if min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n_pages:
        raise ValueError(f"segment_move: page ids outside [0, {n_pages})")
    if np.unique(dst).size != dst.size:
        raise ValueError("segment_move: destinations must be distinct")
    staged = bool(np.isin(dst, src).any())
    move_plans["staged" if staged else "direct"] += 1
    if _on_cpu("segment_move", kp, vp):
        ref.segment_move_ref(pools, src, dst)
        return
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("segment_move: kernel pools must be contiguous")
    M, E = src.size, math.prod(kp.shape[2:])
    row_bytes = E * kp.element_size()
    src32, dst32 = src.astype(np.int32), dst.astype(np.int32)
    chunks = [slice(m0, min(m0 + MOVE_CHUNK, M)) for m0 in range(0, M, MOVE_CHUNK)]
    k_ptr, v_ptr = kp.data_ptr(), vp.data_ptr()

    def move(srcs, dsts, src_pages, dst_pages, c):
        _launch("segment_move", kp.device, *srcs, *dsts,
                src_pages[c].ctypes.data if src_pages is not None else None,
                dst_pages[c].ctypes.data if dst_pages is not None else None,
                L, n_pages, M, c.start, c.stop - c.start, row_bytes)

    if not staged:
        for c in chunks:
            move((k_ptr, v_ptr), (k_ptr, v_ptr), src32, dst32, c)
        return
    stage = torch.empty((2, L, M, E), dtype=kp.dtype, device=kp.device)
    s_ptrs = (stage[0].data_ptr(), stage[1].data_ptr())
    for c in chunks:  # every source is read ...
        move((k_ptr, v_ptr), s_ptrs, src32, None, c)
    for c in chunks:  # ... before any destination is written
        move(s_ptrs, (k_ptr, v_ptr), None, dst32, c)


def mdc_priority(live, up2, u_now, *, S: int):
    """Fused §5.1.3 key over all segments: live (N,) int/float live-page
    counts, up2 (N,) penultimate-update clocks, u_now scalar → (N,) f32.
    Exactly N keys: no padding, so no eligibility mask either (full segments
    key +inf by themselves)."""
    if _on_cpu("mdc_priority", live, up2):
        return ref.mdc_priority_ref(live, up2, u_now, S)
    if live.dim() != 1 or up2.shape != live.shape:
        raise ValueError(f"mdc_priority: want live and up2 of one shape (N,), "
                         f"got {tuple(live.shape)} {tuple(up2.shape)}")
    livef = live.to(torch.float32).contiguous()
    up2f = up2.to(torch.float32).contiguous()
    out = torch.empty_like(livef)
    if out.numel():
        _launch("mdc_priority", live.device, livef.data_ptr(), up2f.data_ptr(),
                out.data_ptr(), out.numel(), float(u_now), int(S))
    return out


def mdc_select_victims(live, up2, u_now, *, S: int, k: int):
    """Fused priority + on-device top-k victim selection → (ids (k,),
    valid (k,) bool); an entry is invalid when nothing cleanable is left
    (its key is +inf).  No host sync."""
    key = mdc_priority(live, up2, u_now, S=S)
    neg, ids = torch.topk(-key, k)
    return ids, torch.isfinite(neg)
