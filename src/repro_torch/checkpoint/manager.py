"""Checkpoint manager: async incremental saves of a tree of tensors into the
log-structured store, and restore onto a device.  A port of
``repro.checkpoint.manager``.

Save path: the tree's leaves are copied to host memory on the calling
thread (``flatten_tree``: a blocking, pageable device-to-host copy per
leaf), then a background thread chunks, hashes and appends the numpy
leaves into the :class:`LogStructuredCheckpointStore` while training goes
on.  The copy is blocking on purpose: the next train step updates the
params and moments in place, and a pinned, non-blocking copy would race
that update unless the step waited on an event recorded after the copy;
the blocking copy needs no event, and the background thread touches only
numpy.

Flat paths are the JAX manager's (:mod:`repro_torch.tree`): dict keys
sorted, NamedTuple fields as ``.name``, list indices as digits, joined by
``/``; bf16 leaves go through the store as :class:`BFloat16Bits`.  So a
checkpoint written by either package restores in the other, bit for bit.

Restore rebuilds a ``template``-shaped tree (its leaves may be ``meta``
tensors: only their shapes and dtypes are read) with each leaf on the asked
device in the template leaf's dtype.

On a mesh (the JAX manager's elastic re-sharding), every rank of the mesh
calls the manager, and rank 0 alone touches the store.  ``save(...,
mesh=, specs=)`` takes each rank's shards: each leaf is gathered whole
(``distributed.collectives.gather``, one leaf at a time), rank 0 copies it
to the host and writes the checkpoint, blocking, and the others wait at a
barrier; the store's contents are those of a one-device save of the same
values, so either package restores it.  ``restore(template, ...,
mesh=, axes=)`` on whatever mesh it is given: rank 0 reads the checkpoint
and broadcasts it leaf by leaf, and each rank keeps its shard by the
template's global shapes and the logical ``axes`` (``DEFAULT_RULES``).
A checkpoint of one mesh restores onto any other, or onto one
device.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.collectives import gather
from ..distributed.sharding import (DEFAULT_RULES, is_axes, resolve_spec,
                                    shard_spec)
from ..tree import leaves, leaves_with_path, map_with_path
from .logstore import BFloat16Bits, LogStructuredCheckpointStore

SEP = "/"


def host_array(leaf) -> np.ndarray:
    """A host copy of one leaf as numpy (a bf16 tensor as
    :class:`BFloat16Bits`); never a view of the live tensor."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BFloat16Bits)
        return t.numpy()
    return np.array(leaf)


def flatten_tree(tree) -> dict[str, np.ndarray]:
    """Tree -> flat {path: host ndarray}, the JAX manager's paths."""
    return {SEP.join(path): host_array(leaf)
            for path, leaf in leaves_with_path(tree)}


def tensor_from_host(arr: np.ndarray) -> torch.Tensor:
    if isinstance(arr, BFloat16Bits) or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def unflatten_like(template, flat: dict[str, np.ndarray], *, device="cpu"):
    """Rebuild a tree shaped like ``template`` from a flat dict: each leaf
    on ``device``, in its template leaf's dtype and shape."""
    def leaf(path, tmpl):
        t = tensor_from_host(flat[SEP.join(path)])
        return t.to(device=device, dtype=tmpl.dtype).reshape(tmpl.shape)

    return map_with_path(leaf, template)


class CheckpointManager:
    def __init__(self, root, *, keep_last: int = 3, async_save: bool = True,
                 **store_kw):
        self.store = LogStructuredCheckpointStore(root, **store_kw)
        self.keep_last = keep_last
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        # seconds per call: the host copy, the background write, restore
        self.timings: dict[str, list[float]] = {
            "snapshot_s": [], "write_s": [], "restore_s": []}

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, block: bool = False, *, mesh=None,
             specs: list | None = None) -> None:
        """Snapshot to host, then write (async by default).

        A failure in the background write is captured and re-raised by the
        next ``save()``/``wait()`` — a silently-lost checkpoint would
        otherwise surface only at restore time, long after the data is gone.

        On ``mesh`` the leaves are this rank's shards, ``specs`` their specs
        in leaf order (``distributed.sharding.tree_specs`` of the whole
        tree), and every rank of the mesh calls this: the save is blocking
        (module docstring).
        """
        if mesh is not None and specs is None:
            raise ValueError("a save from a mesh needs its leaves' specs "
                             "(specs=)")
        self.wait()  # at most one in-flight save; ordering preserved
        t0 = time.perf_counter()
        if mesh is not None:
            self._save_sharded(step, tree, mesh, specs, t0)
            return
        flat = flatten_tree(tree)  # device->host copy happens here
        self.timings["snapshot_s"].append(time.perf_counter() - t0)

        def _write():
            try:
                t1 = time.perf_counter()
                with self._lock:
                    self.store.save(step, flat, keep_last=self.keep_last)
                self.timings["write_s"].append(time.perf_counter() - t1)
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e

        if self.async_save and not block:
            self._pending = threading.Thread(target=_write, daemon=True)
            self._pending.start()
        else:
            _write()
            self._raise_pending_error()

    def _save_sharded(self, step, tree, mesh, specs, t0) -> None:
        first = dist.get_rank() == 0
        flat = {}
        for (path, leaf), spec in zip(leaves_with_path(tree), specs):
            whole = gather(leaf, spec, mesh)
            if first:
                flat[SEP.join(path)] = host_array(whole)
            del whole
        if first:
            self.timings["snapshot_s"].append(time.perf_counter() - t0)
            t1 = time.perf_counter()
            with self._lock:
                self.store.save(step, flat, keep_last=self.keep_last)
            self.timings["write_s"].append(time.perf_counter() - t1)
        dist.barrier()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        self._raise_pending_error()

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    # --------------------------------------------------------------- restore
    def latest_step(self, *, mesh=None):
        """The newest step in the store (None if empty); on ``mesh``, rank
        0's answer on every rank."""
        self.wait()
        if mesh is None:
            return self.store.latest_step()
        box = [self.store.latest_step() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def restore(self, template, step: int | None = None, *, device=None,
                mesh=None, axes=None):
        """Rebuild ``template``-shaped tree with each leaf on ``device`` (the
        CUDA card when None, as every entry point of the port).  On
        ``mesh``, with ``axes`` (a logical-axes tree shaped like
        ``template``, required there), each rank gets its shard of each
        leaf on that mesh under ``DEFAULT_RULES``: elastic re-sharding,
        whatever mesh wrote the checkpoint."""
        if mesh is not None and axes is None:
            raise ValueError("restore onto a mesh needs the template's "
                             "logical axes (axes=)")
        dev = resolve_device(device)
        self.wait()
        t0 = time.perf_counter()
        if mesh is not None:
            tree = self._restore_sharded(template, step, dev, mesh, axes)
        else:
            with self._lock:
                flat = self.store.restore(step)
            tree = unflatten_like(template, flat, device=dev)
        self.timings["restore_s"].append(time.perf_counter() - t0)
        return tree

    def _restore_sharded(self, template, step, dev, mesh, axes):
        first = dist.get_rank() == 0
        if first:
            with self._lock:
                flat = self.store.restore(step)
        ax = iter(leaves(axes, is_leaf=is_axes))

        def leaf(path, tmpl):
            if first:
                t = tensor_from_host(flat.pop(SEP.join(path))).to(
                    device=dev, dtype=tmpl.dtype).reshape(tmpl.shape)
            else:
                t = torch.empty(tmpl.shape, dtype=tmpl.dtype, device=dev)
            dist.broadcast(t, src=0)
            spec = resolve_spec(tuple(tmpl.shape), next(ax), mesh,
                                DEFAULT_RULES)
            return shard_spec(t, spec, mesh)

        return map_with_path(leaf, template)

    # --------------------------------------------------------------- metrics
    def stats(self):
        return self.store.stats

    def wamp(self) -> float:
        return self.store.stats.wamp()
