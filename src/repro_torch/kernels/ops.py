"""Entry points of the port's kernels.

Layouts and argument order follow ``repro.kernels.ops``: attention tensors
are (B, S, H, D), pools (num_pages, T, Kh, D), flattened pool payloads
(N, E), per-segment arrays (N,).  A wrapper takes the plain PyTorch version
(:mod:`.ref`) for a tensor on the CPU; for a CUDA tensor it launches its
hand-written kernel on the current stream or raises — it never falls back.
``launches`` counts the kernel launches of each wrapper, so a run can show
which path it took.
"""

from __future__ import annotations

import math

import torch

from . import build, ref

launches = {"paged_attention": 0, "segment_compact": 0, "flash_attention": 0,
            "mdc_priority": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")
    launches[name] += 1


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """Core entry: q (B, H, Sq, D); k/v (B, Kh, Skv, D); H % Kh == 0 →
    (B, H, Sq, D).  The kernel's tiles are fixed by its design (32 query
    rows × 32 kv rows), so unlike the Pallas entry there are no block-size
    arguments."""
    if _on_cpu("flash_attention", q, k, v):
        return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2),
                                       causal=causal).transpose(1, 2)
    B, H, Sq, D = q.shape
    _, Kh, Skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % Kh:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: head dim {D} not in (16, 32, 64, 128)")
    code = _dtype_code("flash_attention", q, k, v)
    out = torch.empty_like(q)
    _check_kernel_inputs("flash_attention", q, k, v, out)
    _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, Kh, Sq, Skv, D,
            1.0 / math.sqrt(D), int(causal), code)
    return out


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k/v: (B, Skv, Kh, D) → (B, Sq, H, D): the model's
    head-interleaved layout, transposed around :func:`flash_attention_bhsd`."""
    if _on_cpu("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), causal=causal)
    return out.transpose(1, 2)


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens):
    """q: (B, H, D); pools: (num_pages, T, Kh, D); block_tables: (B, P);
    seq_lens: (B,) → (B, H, D).  Table entries are clamped to
    ``[0, num_pages)``."""
    B, H, D = q.shape
    num_pages, T, Kh, _ = k_pool.shape
    bt = block_tables.clamp(0, num_pages - 1).to(torch.int32)
    if _on_cpu("paged_attention", q, k_pool, v_pool, bt, seq_lens):
        return ref.paged_attention_ref(q, k_pool, v_pool, bt, seq_lens)
    if (v_pool.shape != k_pool.shape or k_pool.shape[3] != D or H % Kh
            or bt.shape[0] != B or seq_lens.shape != (B,)):
        raise ValueError(f"paged_attention: bad shapes q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)} bt {tuple(bt.shape)} "
                         f"seq_lens {tuple(seq_lens.shape)}")
    G = H // Kh
    if D not in (32, 64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"paged_attention: head dim {D} / group {G} not "
                         f"instantiated (D in 32, 64, 128; G in 1, 2, 4, 8)")
    code = _dtype_code("paged_attention", q, k_pool, v_pool)
    bt = bt.contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _check_kernel_inputs("paged_attention", q, k_pool, v_pool, bt, lens, out)
    _launch("paged_attention", q.device, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Kh, G, D, T, bt.shape[1], 1.0 / math.sqrt(D), code)
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
