"""The work of each hand-written kernel, and the hook through which a
counter sees it.

Each work function gives the HBM bytes a call must move (each input read
once, each output written once) and the operations it must do, from the
shapes of one call; ``chip_smoke.py``'s kernels phase sets each kernel's
time beside the bound :func:`repro_torch.roofline.report.kernel_bound_ms`
makes of the same figures.  Where the work depends on the data (paged
attention reads each sequence's own pages), the caller passes what the
call's data needs.  Beside the kernels' own work, a wrapper of :mod:`.ops`
charges what it moves around a launch: a staged move's pass through its
buffer, a conversion to the type a kernel takes.

``counters`` is the hook.  A counter (the dry-run's
:class:`repro_torch.roofline.op_cost.OpCost`) puts itself in the list
while it counts; a wrapper that finds the list empty runs its body and
nothing else, and otherwise runs it through :func:`charged`.  A counter
has a ``hidden`` depth (while above 0 it counts no op) and a
``charge(charges, out, collective)`` method.  The kernels depend on no
layer above them.
"""

from __future__ import annotations

import dataclasses

# the counters active now, innermost last
counters: list = []


@dataclasses.dataclass(frozen=True)
class KernelWork:
    bytes: int     # HBM bytes moved: inputs read once, outputs written once
    flops: float   # operations, at the peak rate of ``dtype``
    dtype: str     # "bfloat16", "float32", ...: the type the flops run in
    products: bool = True  # dot products (a tensor-core rate), else elementwise
    scratch: int = 0       # bytes of device storage held only during the call


def charged(charges, fn, *args, collective=None):
    """``fn(*args)`` as one kernel call on every active counter: its ops
    hidden from each, then each charged once.  ``charges`` is a function of
    no arguments giving ``[(name, KernelWork or None), ...]``, called while
    the ops are hidden (a card call may read its lengths back);
    ``collective`` is ``(kind, payload bytes)`` or None; ``fn``'s result (a
    tensor or None) is the call's output."""
    active = tuple(counters)
    for c in active:
        c.hidden += 1
    try:
        works = charges()
        out = fn(*args)
    finally:
        for c in active:
            c.hidden -= 1
    for c in active:
        c.charge(works, out, collective)
    return out


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype) -> int:
    return dtype.itemsize


def paged_attention(*, B: int, H: int, Kh: int, D: int, tokens: int,
                    pages: int, q_dtype, kv_dtype) -> KernelWork:
    """One decode token per sequence over ``tokens`` cached tokens in all:
    their K and V rows, q and the output, the ``pages`` block-table entries
    the lengths cover and the lengths (int32); two multiply-adds per query
    head, cached token and head-dim element (q·k, then p·v), at the pools'
    type."""
    es, es_q = _itemsize(kv_dtype), _itemsize(q_dtype)
    n_bytes = (2 * tokens * Kh * D * es + 2 * B * H * D * es_q
               + 4 * pages + 4 * B)
    return KernelWork(n_bytes, 4.0 * tokens * H * D, dtype_name(kv_dtype))


def flash_attention(*, B: int, H: int, Kh: int, Sq: int, Skv: int, D: int,
                    dtype, causal: bool, q_offset: int = 0) -> KernelWork:
    """q and the output (B, Sq, H, D), K and V (B, Skv, Kh, D); two
    multiply-adds per scored (query, key) pair, query head and head-dim
    element, at D itself (every launch runs at D).  Every row scores every key,
    or, causal, row i (at position ``q_offset + i``) the keys up to its
    position."""
    es = _itemsize(dtype)
    n_bytes = (2 * B * H * Sq * D + 2 * B * Kh * Skv * D) * es
    if causal:
        rows = min(Sq, max(Skv - q_offset, 0))  # rows whose keys end in Skv
        pairs = rows * q_offset + rows * (rows + 1) / 2 + (Sq - rows) * Skv
    else:
        pairs = Sq * Skv
    return KernelWork(n_bytes, 4.0 * B * H * D * pairs, dtype_name(dtype))


def segment_compact(*, M: int, E: int, dtype) -> KernelWork:
    """M rows of E elements read and written, and M int32 indices: a copy,
    no operations."""
    return KernelWork(2 * M * E * _itemsize(dtype) + 4 * M, 0.0,
                      dtype_name(dtype))


def segment_move(*, L: int, moves: int, E: int, dtype) -> KernelWork:
    """``moves`` pages of E elements in each of L layers of the K and V
    pools, each read and written once, and a source and a destination id
    per row (int32): a copy, no operations."""
    rows = L * moves
    return KernelWork(2 * (2 * rows * E * _itemsize(dtype)) + 2 * 4 * rows,
                      0.0, dtype_name(dtype))


def segment_move_stage(*, L: int, moves: int, E: int, dtype) -> KernelWork:
    """A staged plan's pass through its buffer (a destination is another
    move's source): the K and V rows written to the stage and read back, on
    top of :func:`segment_move`; the stage is scratch."""
    n = 2 * L * moves * E * _itemsize(dtype)
    return KernelWork(2 * n, 0.0, dtype_name(dtype), scratch=n)


def cast(*, n: int, src_dtype, dtype) -> KernelWork:
    """A wrapper's copy of n elements into the type (and the contiguous
    layout) its kernel takes: read at one type, written at the other, one
    elementwise operation each where the type changes; the copy is
    scratch."""
    es = _itemsize(dtype)
    return KernelWork(n * (_itemsize(src_dtype) + es),
                      float(n) if src_dtype != dtype else 0.0,
                      dtype_name(dtype), products=False, scratch=n * es)


def mdc_priority(*, N: int) -> KernelWork:
    """Live counts and ``up2`` read, the key written (f32 each), and ~10
    f32 operations per segment."""
    return KernelWork(12 * N, 10.0 * N, "float32", products=False)
