"""Count a step's work op by op: the port's counterpart of the JAX package's
``repro.roofline.hlo_cost.HloCost``.

The JAX dry-run walks the compiled HLO; the port has none, so :class:`OpCost`
counts what eager PyTorch dispatches, aten op by aten op, while the step runs
under it.  The step may run on ``meta`` tensors, which carry shapes and no
storage: a full-width cell is counted without a card and without memory.

* **FLOPs, by dtype.**  Products exactly, from ``torch.utils.flop_counter``'s
  formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, ...), at
  their inputs' type, and kept apart as ``product_flops_by_dtype`` (the
  tensor cores run them); every other op that computes ~1 per output
  element, as ``HloCost`` counts elementwise ops and reductions (a dtype
  conversion is one).  Pure data movement (copies, concatenation, gathers
  and scatters, padding, fills) counts none.
* **HBM bytes.**  Each op that is not a view costs its operands' bytes plus
  its outputs' bytes.  Views (``view``, ``expand``, ``slice``, ``select``,
  ``transpose``, ``as_strided``, ...) and allocations cost nothing.  An
  in-place op reads and writes its destination, a copy or fill only writes
  it, and an indexed write (``index_put_``, ``scatter_``, ...) writes only
  its source's worth of it.  Eager PyTorch fuses nothing, so this is the
  traffic the port really makes, where ``HloCost`` models XLA's fusions.
* **Hand-written kernels.**  A wrapper of :mod:`repro_torch.kernels.ops`
  charges its kernel's own work (:mod:`repro_torch.kernels.work`) once per
  call, by name, and what it moves around the launch under names of its
  own (``segment_move_stage``; ``<kernel>_cast``); the ops its body runs
  (the plain version on the CPU, the copies around a launch on the card)
  are not counted.  So a step counts the same whether the CUDA
  kernel, the plain version or the ``meta`` route ran it.
* **Collectives**, by kind: ``ops.gather_heads`` and the training mesh's
  ``distributed.collectives`` charge each call's payload (an all-gather's
  gathered bytes, an all-reduce's tensor), counted as ``HloCost`` counts
  them: an all-reduce twice (the ring's send and receive), every other
  kind once, and twice the payload added to the HBM bytes.
* **The peak of live bytes.**  The tracked inputs' storages, plus every
  storage an op allocates, each dropped when Python frees it (autograd's
  saved tensors stay live, as on the card), plus a kernel call's scratch
  (a stage, a cast) while it runs.  A storage counts
  once, however many views of it there are.

Counting does not depend on the device: the same step on ``meta``, on the
CPU and on the card gives the same FLOPs, bytes and charges.  One
exception: paged attention's work depends on the sequence lengths, which a
``meta`` call does not have (it charges full block tables) and a card call
reads back to the host (one sync per call, only while counting).
"""

from __future__ import annotations

import threading
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import work
from ..kernels.work import dtype_name

# ops that cost nothing: metadata, host scalars, aliases
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "_reshape_alias",
         "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "record_stream",
         "_has_compatible_shallow_copy_type", "_to_dense"}
# allocations: their storage is live, no traffic
_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted"}
# data movement: bytes, no FLOPs
_MOVE = {"copy", "copy_", "clone", "_to_copy", "cat", "stack", "index_select",
         "gather", "scatter", "scatter_", "index", "_unsafe_index",
         "index_put", "index_put_", "_index_put_impl_", "index_copy",
         "index_copy_", "constant_pad_nd", "repeat", "fill", "fill_", "zero_",
         "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
         "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange",
         "embedding", "slice_scatter", "select_scatter", "diagonal_scatter",
         "as_strided_scatter", "flip", "roll", "lift_fresh_copy",
         "masked_scatter", "masked_scatter_", "put_", "unfold_copy",
         "expand_copy", "permute_copy", "t_copy", "transpose_copy",
         "view_copy", "slice_copy", "select_copy", "split_with_sizes_copy"}
# destinations written without being read
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "geometric_", "log_normal_",
               "cauchy_"}
# destinations written only where the source lands (+ read there, if added)
_INDEXED = {"index_put_": False, "_index_put_impl_": False, "scatter_": False,
            "index_copy_": False, "masked_scatter_": False, "put_": False,
            "scatter_add_": True, "index_add_": True, "scatter_reduce_": True,
            "index_reduce_": True}


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _accumulates(name: str, args, kwargs) -> bool:
    if name in ("index_put_", "_index_put_impl_"):
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        return bool(acc)
    return _INDEXED[name]


class OpCost(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (module
    docstring).  ``inputs``: a tree of tensors (nested dicts, lists, tuples,
    NamedTuples) whose storages are live from the start, for the peak.

        with OpCost(inputs=args) as oc:
            step(*args)
        oc.summary()
    """

    def __init__(self, inputs=None):
        super().__init__()
        self.flops_by_dtype: dict[str, float] = defaultdict(float)
        self.product_flops_by_dtype: dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0
        self.coll_bytes: dict[str, int] = defaultdict(int)
        self.coll_counts: dict[str, int] = defaultdict(int)
        self.kernel_charges: dict[str, dict] = {}
        self.op_counts: Counter = Counter()   # aten op name -> calls
        self.op_bytes: Counter = Counter()    # aten op name -> bytes
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, int] = {}       # id(storage) -> bytes
        self._lock = threading.Lock()
        self.hidden = 0   # > 0 inside a kernel wrapper's body: no op counts
        if inputs is not None:
            self.track(inputs)

    # -- the mode ---------------------------------------------------------
    def __enter__(self):
        work.counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.counters.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden:
            self._count(func, args, kwargs, out)
        return out

    # -- live bytes -------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now on."""
        for t in _tensors(tree, []):
            self._add(t, t.untyped_storage().nbytes())

    def _add(self, t, nbytes: int) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            self._live[key] = nbytes
            self.live_bytes += nbytes
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._drop, key).atexit = False

    def _drop(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # -- one op -----------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if (func.namespace != "aten" or name in _FREE or func.is_view):
            return
        self.op_counts[name] += 1
        schema = func._schema
        outs = _tensors(out, [])
        rets = schema.returns
        fresh = [o for i, o in enumerate(outs)
                 if i >= len(rets) or rets[i].alias_info is None]
        for o in fresh:
            self._add(o, o.untyped_storage().nbytes())
        if name in _ALLOC:
            return
        # which arguments are written (their alias info says so), and how
        written, read = [], []
        for i, a in enumerate(schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            ts = _tensors(v, [])
            if a.alias_info is not None and a.alias_info.is_write:
                written.extend((a, t) for t in ts)
            else:
                read.extend(ts)
        seen, n_read = set(), 0
        for t in read:
            if id(t) not in seen:
                seen.add(id(t))
                n_read += _nbytes(t)
        n_write = sum(_nbytes(o) for o in fresh)
        flops_out = sum(o.numel() for o in fresh)
        for a, t in written:
            if a.kwarg_only or name in _WRITE_ONLY:   # out= and fills
                n_write += _nbytes(t)
                flops_out += t.numel()
            elif name in _INDEXED:                    # where the source lands
                src = read[-1] if read else t
                n_write += _nbytes(src)
                if _accumulates(name, args, kwargs):
                    n_read += _nbytes(src)
                    flops_out += src.numel()
            else:                                     # add_, mul_, ...
                n_read += _nbytes(t)
                n_write += _nbytes(t)
                flops_out += t.numel()
        self.hbm_bytes += n_read + n_write
        self.op_bytes[name] += n_read + n_write
        packet = func.overloadpacket
        if packet in flop_registry:
            dt = dtype_name(read[0].dtype if read else outs[0].dtype)
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops_by_dtype[dt] += f
            self.product_flops_by_dtype[dt] += f
        elif name not in _MOVE or (name == "_to_copy" and "dtype" in kwargs
                                   and read and kwargs["dtype"] != read[0].dtype):
            if flops_out:
                dt = (outs[0] if outs else written[0][1]).dtype
                self.flops_by_dtype[dtype_name(dt)] += float(flops_out)

    # -- charges from the kernel wrappers ----------------------------------
    def charge(self, charges, out, collective=None) -> None:
        """One kernel wrapper's call (:func:`repro_torch.kernels.work.charged`):
        each ``(name, KernelWork or None)`` of ``charges`` once, the
        collective's ``(kind, payload)``, the call's output (a tensor or
        None) live from now on, and its charges' scratch beside what is
        live while it ran."""
        for name, w in charges:
            rec = self.kernel_charges.setdefault(
                name, {"calls": 0, "bytes": 0, "flops": {}})
            rec["calls"] += 1
            if w is None:
                continue
            rec["bytes"] += w.bytes
            self.hbm_bytes += w.bytes
            if w.flops:
                rec["flops"][w.dtype] = rec["flops"].get(w.dtype, 0.0) + w.flops
                self.flops_by_dtype[w.dtype] += w.flops
                if w.products:
                    self.product_flops_by_dtype[w.dtype] += w.flops
        if collective is not None:
            kind, payload = collective
            self.coll_bytes[kind] += (2 if kind == "all-reduce" else 1) * payload
            self.coll_counts[kind] += 1
            self.hbm_bytes += 2 * payload
        if isinstance(out, torch.Tensor):
            self._add(out, _nbytes(out))
        scratch = sum(w.scratch for _, w in charges if w is not None)
        with self._lock:
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes + scratch)

    def summary(self) -> dict:
        """``HloCost.summary()``'s keys, and beside them the FLOPs by dtype
        (all, and the products'), the kernels' charges and the peak of live
        bytes."""
        return {
            "flops_per_device": float(sum(self.flops_by_dtype.values())),
            "hbm_bytes_per_device": float(self.hbm_bytes),
            "collective_bytes_per_device": {k: float(v) for k, v
                                            in self.coll_bytes.items()},
            "collective_counts": {k: int(v) for k, v
                                  in self.coll_counts.items()},
            "total_collective_bytes": float(sum(self.coll_bytes.values())),
            "flops_by_dtype": {k: float(v) for k, v
                               in sorted(self.flops_by_dtype.items()) if v},
            "product_flops_by_dtype": {
                k: float(v) for k, v
                in sorted(self.product_flops_by_dtype.items()) if v},
            "kernel_charges": {k: {"calls": v["calls"], "bytes": v["bytes"],
                                   "flops": dict(v["flops"])}
                               for k, v in sorted(self.kernel_charges.items())},
            "peak_live_bytes": int(self.peak_live_bytes),
            "n_ops": int(sum(self.op_counts.values())),
        }
