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
device in the template leaf's dtype.  Restoring onto a mesh with
re-sharding (the JAX ``mesh=`` / ``axes=``) waits for training under a
mesh.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..tree import leaves_with_path, map_with_path
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
    def save(self, step: int, tree: Any, block: bool = False) -> None:
        """Snapshot to host, then write (async by default).

        A failure in the background write is captured and re-raised by the
        next ``save()``/``wait()`` — a silently-lost checkpoint would
        otherwise surface only at restore time, long after the data is gone.
        """
        self.wait()  # at most one in-flight save; ordering preserved
        t0 = time.perf_counter()
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
    def latest_step(self):
        self.wait()
        return self.store.latest_step()

    def restore(self, template, step: int | None = None, *, device=None):
        """Rebuild ``template``-shaped tree with each leaf on ``device`` (the
        CUDA card when None, as every entry point of the port)."""
        dev = resolve_device(device)
        self.wait()
        t0 = time.perf_counter()
        with self._lock:
            flat = self.store.restore(step)
        tree = unflatten_like(template, flat, device=dev)
        self.timings["restore_s"].append(time.perf_counter() - t0)
        return tree

    # --------------------------------------------------------------- metrics
    def stats(self):
        return self.store.stats

    def wamp(self) -> float:
        return self.store.stats.wamp()
