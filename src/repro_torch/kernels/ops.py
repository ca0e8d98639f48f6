"""Entry points of the port's kernels.

Layouts and argument order follow ``repro.kernels.ops``: attention tensors
are (B, S, H, D), pools (num_pages, T, Kh, D), flattened pool payloads
(N, E), per-segment arrays (N,).  A wrapper takes the plain PyTorch version
(:mod:`.ref`) for a tensor on the CPU; for a CUDA tensor it launches its
hand-written kernel on the current stream or raises — it never falls back;
for ``meta`` tensors (a dry-run) it checks the shapes as the launch would and
returns a ``meta`` output of the kernel's shape and dtype, running nothing.
While a counter is registered in :data:`.work.counters` (the dry-run's
``OpCost``), each call charges it its kernel's own work and what the
wrapper moves around the launch (:mod:`.work`) once, and the ops of its
body are not counted: a step counts the same whichever device ran it.
``launches`` counts the kernel launches of each wrapper, so a run can show
which path it took; ``flash_routes`` splits flash attention's launches by
route, ``flash_offsets`` by whether the query rows start at position 0 (a
whole prompt) or later (a continuation after a cached prefix), and
``move_plans`` counts the compaction plans ``segment_move`` moved
directly and staged, and ``stream_launches`` splits each kernel's launches
by the CUDA stream they went to (keyed by the stream's handle, as
``torch.cuda.Stream.cuda_stream`` gives it).

Tensor-parallel serving (``mesh=``, a ``"model"`` ``DeviceMesh`` of one
process per rank): :func:`paged_attention_sharded` and
:func:`flash_attention_sharded` are the counterparts of the JAX package's
``shard_map`` wrappers.  Each rank passes its own kv heads' slice and
launches the same kernel on it; heads are independent, so a rank's output
is its heads' slice of the unsharded call.  :func:`gather_heads`
all-gathers the per-head context in rank order, so the cross-head output
projection runs in full on every rank.  The two wrappers count their
launches under their own names as well as under the kernel's.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import build, ref, work

launches = {"paged_attention": 0, "segment_compact": 0, "flash_attention": 0,
            "mdc_priority": 0, "segment_move": 0,
            "paged_attention_sharded": 0, "flash_attention_sharded": 0}
# flash_attention launches by route: tensor cores (bf16 at D 64 to 128 and
# 192) or CUDA cores (f32, bf16 below 64)
flash_routes = {"wgmma": 0, "simt": 0}
# flash_attention launches by q_offset: 0, or > 0 (a prefix-hit tail)
flash_offsets = {"zero": 0, "nonzero": 0}
# segment_move plans by form, on any device: one launch pool to pool, or a
# gather and a scatter launch because a destination is another move's source
move_plans = {"direct": 0, "staged": 0}
# launches by stream: kernel name -> {stream handle: launches}
stream_launches: dict[str, dict[int, int]] = {name: {} for name in launches}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FLASH_ROUTE = {"simt": 0, "wgmma": 1}


def reset_launches() -> None:
    for counts in (launches, flash_routes, flash_offsets, move_plans):
        for name in counts:
            counts[name] = 0
    for by_stream in stream_launches.values():
        by_stream.clear()


def _route(name: str, *tensors) -> str:
    """``"cpu"`` when every tensor is on the CPU (the plain version),
    ``"meta"`` when every one is a ``meta`` tensor (shapes only), ``"cuda"``
    when all sit on one CUDA device (the kernel); raises for anything
    else."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if kinds in ({"cpu"}, {"meta"}):
        return kinds.pop()
    if len(devs) != 1 or kinds != {"cuda"}:
        raise ValueError(f"{name}: tensors must all be on the CPU or all on "
                         f"one CUDA device (or all on meta), got "
                         f"{sorted(map(str, devs))}")
    return "cuda"


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
    by_stream = stream_launches[name]
    by_stream[stream] = by_stream.get(stream, 0) + 1


def _operand_strides(name: str, t) -> tuple[int, int, int]:
    """(batch, sequence, head) element strides of one (B, S, heads, D)
    operand as the kernel reads it; raises for a layout it cannot read (a
    ``meta`` tensor's base counts as aligned)."""
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


# the head dims each flash route has an instance of; bf16 takes the CUDA
# cores' only below the tensor cores' least
FLASH_DIMS = {"wgmma": (64, 80, 96, 112, 128, 192),
              "simt": (16, 32, 48, 64, 80, 96, 112, 128, 192)}


def flash_route(dtype, D: int) -> str:
    """The kernel route of a launch at head dim D: tensor cores
    (``"wgmma"``) for bf16 at one of their dims, CUDA cores (``"simt"``)
    for f32 at one of theirs and for bf16 below 64.  Every launch runs at D
    itself: no head dim is padded.  Raises ``ValueError`` for a D no route
    takes.  Dispatch, not fallback: a failure on either route raises."""
    if dtype == torch.bfloat16 and D in FLASH_DIMS["wgmma"]:
        return "wgmma"
    if D in FLASH_DIMS["simt"] and (dtype != torch.bfloat16
                                    or D < min(FLASH_DIMS["wgmma"])):
        return "simt"
    raise ValueError(f"flash_attention: no route takes head dim {D}: the "
                     f"kernel takes {FLASH_DIMS['simt']} (bf16 from 64 up "
                     f"on the tensor cores)")


def _flash(q, k, v, out, causal: bool, q_offset: int = 0) -> None:
    """Launch over (B, S, heads, D)-indexed views, any strides that
    :func:`flash_layout` takes, writing ``out`` (same index order as q);
    query row i at absolute position ``q_offset + i``."""
    layout = flash_layout(q, k, v) + [_operand_strides("out", out)]
    B, Sq, H, D = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    route = flash_route(q.dtype, D)
    code = _dtype_code("flash_attention", q, k, v, out)
    if Skv == 0:  # softmax over nothing: the plain version's zeros
        out.zero_()
        return
    strides = (ctypes.c_longlong * 12)(*(x for st in layout for x in st))
    _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), strides, B, H, Kh, Sq, Skv, D,
            1.0 / math.sqrt(D), int(causal), int(q_offset), code,
            _FLASH_ROUTE[route])
    flash_routes[route] += 1
    flash_offsets["nonzero" if q_offset else "zero"] += 1


def flash_attention_bhsd(q, k, v, *, causal: bool = True):
    """Core entry: q (B, H, Sq, D); k/v (B, Kh, Skv, D); H % Kh == 0 →
    (B, H, Sq, D).  The same kernel as :func:`flash_attention` over the
    other stride set.  Its tiles are fixed by each route's design, so unlike
    the Pallas entry there are no block-size arguments."""
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    where = _route("flash_attention", q, k, v)
    args = (where, qs, ks, vs, causal, 0, True)
    if work.counters:
        out = work.charged(lambda: _flash_charges(qs, ks, causal, 0),
                           _flash_call, *args)
    else:
        out = _flash_call(*args)
    return out.transpose(1, 2)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    mesh=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, Kh, D) → (B, Sq, H, D): the model's
    head-interleaved layout, read in place (no transposes).  Query row i
    sits at absolute position ``q_offset + i`` (causal: it attends keys
    ``0 .. q_offset + i``), as after a cached prefix of ``q_offset``
    tokens.  On the card a row's result depends only on its absolute
    position, so ``flash_attention(q[:, P:], k, v, q_offset=P)`` is bit for
    bit the rows ``P:`` of ``flash_attention(q, k, v)``.  With ``mesh``,
    q / k / v are this rank's heads: :func:`flash_attention_sharded`."""
    if mesh is not None:
        return flash_attention_sharded(q, k, v, mesh=mesh, causal=causal,
                                       q_offset=q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    where = _route("flash_attention", q, k, v)
    args = (where, q, k, v, causal, q_offset)
    if work.counters:
        return work.charged(lambda: _flash_charges(q, k, causal, q_offset),
                            _flash_call, *args)
    return _flash_call(*args)


def _flash_call(where: str, q, k, v, causal: bool, q_offset: int,
                bhsd_out: bool = False):
    """One flash call on its route over (B, S, heads, D)-indexed operands:
    the plain version (CPU), the launch's checks (``meta``) or the launch
    (card).  Returns (B, Sq, H, D)-indexed; ``bhsd_out`` lays the output
    out as (B, H, Sq, D) in memory."""
    if where == "cpu":
        flash_layout(q, k, v)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    B, Sq, H, D = q.shape
    if bhsd_out:
        out = torch.empty((B, H, Sq, D), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if where == "meta":
        flash_layout(q, k, v)
        _dtype_code("flash_attention", q, k, v)
        flash_route(q.dtype, D)
    else:
        _flash(q, k, v, out, causal, q_offset)
    return out


def _flash_charges(q, k, causal: bool, q_offset: int) -> list:
    """The kernel's work of one call (q (B, Sq, H, D) and k (B, Skv, Kh, D)
    in that index order), at D itself."""
    B, Sq, H, D = q.shape
    return [("flash_attention", work.flash_attention(
        B=B, H=H, Kh=k.shape[2], Sq=Sq, Skv=k.shape[1], D=D, dtype=q.dtype,
        causal=causal, q_offset=q_offset))]


# the head dims paged attention has an instance of, at any group G >= 1:
# flash's (the prefill's) own
PAGED_DIMS = FLASH_DIMS["simt"]


def paged_dim(D: int) -> None:
    """Raises ``ValueError`` for a head dim no paged attention instance
    takes; any query-head group G >= 1 is taken."""
    if D not in PAGED_DIMS:
        raise ValueError(f"paged_attention: no instance takes head dim {D}: "
                         f"the kernel takes {PAGED_DIMS} at any group")


def paged_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                    mesh=None):
    """q: (B, H, D); pools: (num_pages, T, Kh, D); block_tables: (B, P);
    seq_lens: (B,) → (B, H, D) in q's dtype.  q and the pools may differ in
    dtype (each float32 or bfloat16; the two pools share one): the
    arithmetic is the plain version's promotion, in the same one launch.
    Table entries are clamped to ``[0, num_pages)``: by the kernel itself on
    the card, before the plain version on the CPU.  On the card a call with
    int32 tables and lengths is one launch whose grid depends only on B and
    Kh (no host sync, nothing sized by the data), so it can be captured in a
    CUDA graph.  Any group H / Kh >= 1 and any D in :data:`PAGED_DIMS`
    (a ``ValueError`` otherwise, on the card and on ``meta`` alike; the
    plain version takes any shape).  With ``mesh``, q and the pools are
    this rank's heads: :func:`paged_attention_sharded`."""
    if mesh is not None:
        return paged_attention_sharded(q, k_pool, v_pool, block_tables,
                                       seq_lens, mesh=mesh)
    where = _route("paged_attention", q, k_pool, v_pool, block_tables,
                   seq_lens)
    args = (where, q, k_pool, v_pool, block_tables, seq_lens)
    if work.counters:
        return work.charged(lambda: _paged_charges(*args), _paged_call, *args)
    return _paged_call(*args)


def _paged_call(where: str, q, k_pool, v_pool, block_tables, seq_lens):
    B, H, D = q.shape
    num_pages, T, Kh, _ = k_pool.shape
    if where == "cpu":
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
    paged_dim(D)
    q_code = _dtype_code("paged_attention", q)
    kv_code = _dtype_code("paged_attention", k_pool, v_pool)
    out = torch.empty_like(q)
    if where == "meta":
        return out
    bt = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    _check_kernel_inputs("paged_attention", q, k_pool, v_pool, bt, lens, out)
    _launch("paged_attention", q.device, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Kh, G, D, T, bt.shape[1], num_pages, 1.0 / math.sqrt(D),
            q_code, kv_code)
    return out


def _paged_charges(where: str, q, k_pool, v_pool, block_tables,
                   seq_lens) -> list:
    """The kernel's work of one call: the tokens and table pages the
    lengths cover (read back to the host), or, on ``meta``, where there are
    no lengths, every table full; and the copies of tables or lengths that
    are not contiguous int32."""
    B, H, D = q.shape
    T, Kh = k_pool.shape[1], k_pool.shape[2]
    if where == "meta":
        pages = B * block_tables.shape[1]
        tokens = pages * T
    else:
        lens = seq_lens.to(torch.int64).cpu()
        tokens = int(lens.sum())
        pages = int(((lens + T - 1) // T).sum())
    return [("paged_attention", work.paged_attention(
        B=B, H=H, Kh=Kh, D=D, tokens=tokens, pages=pages, q_dtype=q.dtype,
        kv_dtype=k_pool.dtype))] + _cast_charges(
            "paged_attention", torch.int32, block_tables, seq_lens)


def _cast_charges(name: str, dtype, *tensors) -> list:
    """A :func:`.work.cast` charge, named ``<name>_cast``, for each tensor
    the wrapper copies before its launch: one not of ``dtype`` or not
    contiguous."""
    return [(f"{name}_cast", work.cast(n=t.numel(), src_dtype=t.dtype,
                                       dtype=dtype))
            for t in tensors if t.dtype != dtype or not t.is_contiguous()]


def _count_sharded(name: str, *tensors) -> None:
    """A sharded wrapper's own launch count: one where its kernel launched
    (a tensor on the card), none for the plain version on the CPU."""
    if tensors[0].device.type == "cuda":
        launches[name] += 1


def paged_attention_sharded(q, k_pool, v_pool, block_tables, seq_lens, *,
                            mesh):
    """Tensor-parallel paged attention, one rank of ``mesh``: q (B, H/n, D)
    and the pools (num_pages, T, Kh/n, D) are this rank's kv heads (and
    their query groups), the block tables and lengths are every rank's
    (one host plan, global page ids).  Launches the paged kernel on the
    local heads (grid (B, Kh/n), one launch) and returns them, (B, H/n, D):
    each head's softmax runs whole on its rank, so the result is those
    heads' slice of the unsharded call, and no rank talks to another.
    :func:`gather_heads` joins the ranks' heads."""
    _check_mesh("paged_attention_sharded", mesh)
    out = paged_attention(q, k_pool, v_pool, block_tables, seq_lens)
    _count_sharded("paged_attention_sharded", q)
    return out


def flash_attention_sharded(q, k, v, *, mesh, causal: bool = True,
                            q_offset: int = 0):
    """Tensor-parallel flash attention, one rank of ``mesh``: q
    (B, Sq, H/n, D) and k / v (B, Skv, Kh/n, D) are this rank's heads, with
    the group size of the unsharded call.  Launches the flash kernel on
    them and returns (B, Sq, H/n, D), those heads' slice of the unsharded
    call; :func:`gather_heads` joins the ranks' heads."""
    _check_mesh("flash_attention_sharded", mesh)
    out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    _count_sharded("flash_attention_sharded", q)
    return out


def _check_mesh(name: str, mesh) -> None:
    if tuple(mesh.mesh_dim_names or ()) != ("model",):
        raise ValueError(f"{name}: wants a 1-D mesh named 'model', got "
                         f"{mesh.mesh_dim_names}")


def gather_heads(o_local, mesh):
    """All-gather the ranks' heads of ``o_local`` (..., H/n, D) along its
    head axis in rank order → (..., H, D) on every rank: the counterpart of
    the JAX engine's replicated-sharding constraint before the output
    projection.  The ranks exchange the tensors where they lie (on the
    card, also through ``gloo``, which stages them through the host)."""
    _check_mesh("gather_heads", mesh)
    if work.counters:
        payload = mesh.size() * o_local.numel() * o_local.element_size()
        return work.charged(lambda: [("gather_heads", None)], _gather,
                            o_local, mesh, collective=("all-gather", payload))
    return _gather(o_local, mesh)


def _gather(o_local, mesh):
    o_local = o_local.contiguous()
    parts = [torch.empty_like(o_local) for _ in range(mesh.size())]
    if o_local.device.type != "meta":
        torch.distributed.all_gather(parts, o_local,
                                     group=mesh.get_group("model"))
    return torch.cat(parts, dim=-2)


def segment_compact(pool, src_idx):
    """pool: (N, E); src_idx: (M,) int32 in [0, N) → (M, E) relocated
    payloads.  An exact byte copy, for any dtype."""
    where = _route("segment_compact", pool, src_idx)
    if work.counters:
        return work.charged(lambda: [("segment_compact", work.segment_compact(
            M=src_idx.shape[0], E=pool.shape[-1], dtype=pool.dtype))],
            _compact_call, where, pool, src_idx)
    return _compact_call(where, pool, src_idx)


def _compact_call(where: str, pool, src_idx):
    if where == "cpu":
        return ref.segment_compact_ref(pool, src_idx)
    if pool.dim() != 2 or src_idx.dim() != 1 or src_idx.dtype != torch.int32:
        raise ValueError(f"segment_compact: want pool (N, E) and int32 src "
                         f"(M,), got {tuple(pool.shape)} "
                         f"{tuple(src_idx.shape)} {src_idx.dtype}")
    N, E = pool.shape
    out = torch.empty((src_idx.shape[0], E), dtype=pool.dtype,
                      device=pool.device)
    if not pool.is_contiguous() or not src_idx.is_contiguous():
        raise ValueError("segment_compact: kernel inputs must be contiguous")
    if where == "cuda":
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
    where = _route("segment_move", kp, vp)
    args = (where, kp, vp, src, dst, staged)
    if work.counters:
        shape = dict(L=L, moves=src.size, E=math.prod(kp.shape[2:]),
                     dtype=kp.dtype)
        charges = [("segment_move", work.segment_move(**shape))]
        if staged:
            charges.append(("segment_move_stage",
                            work.segment_move_stage(**shape)))
        work.charged(lambda: charges, _move_call, *args)
    else:
        _move_call(*args)


def _move_call(where: str, kp, vp, src, dst, staged: bool) -> None:
    if where == "cpu":
        ref.segment_move_ref((kp, vp), src, dst)
    elif not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("segment_move: kernel pools must be contiguous")
    elif where == "cuda":
        _segment_move_launch(kp, vp, src, dst, staged)


def _segment_move_launch(kp, vp, src, dst, staged: bool) -> None:
    L, n_pages = kp.shape[:2]
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
    where = _route("mdc_priority", live, up2)
    args = (where, live, up2, u_now, S)
    if work.counters:
        return work.charged(lambda: [
            ("mdc_priority", work.mdc_priority(N=live.numel()))]
            + _cast_charges("mdc_priority", torch.float32, live, up2),
            _mdc_call, *args)
    return _mdc_call(*args)


def _mdc_call(where: str, live, up2, u_now, S: int):
    if where == "cpu":
        return ref.mdc_priority_ref(live, up2, u_now, S)
    if live.dim() != 1 or up2.shape != live.shape:
        raise ValueError(f"mdc_priority: want live and up2 of one shape "
                         f"(N,), got {tuple(live.shape)} {tuple(up2.shape)}")
    out = torch.empty(live.shape, dtype=torch.float32, device=live.device)
    if where == "cuda" and out.numel():
        livef = live.to(torch.float32).contiguous()
        up2f = up2.to(torch.float32).contiguous()
        _launch("mdc_priority", live.device, livef.data_ptr(),
                up2f.data_ptr(), out.data_ptr(), out.numel(), float(u_now),
                int(S))
    return out


def mdc_select_victims(live, up2, u_now, *, S: int, k: int):
    """Fused priority + on-device top-k victim selection → (ids (k,),
    valid (k,) bool); an entry is invalid when nothing cleanable is left
    (its key is +inf).  No host sync."""
    key = mdc_priority(live, up2, u_now, S=S)
    neg, ids = torch.topk(-key, k)
    return ids, torch.isfinite(neg)
