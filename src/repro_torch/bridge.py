"""JAX parameter trees → the port's parameter trees.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of each
leaf, so this module needs no JAX) and keeps its layout leaf for leaf:
``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``, ``embed (V, d)``,
``lm_head (d, V)``, and so on.  ``torch.from_numpy`` rejects the
``ml_dtypes.bfloat16`` arrays JAX hands out, so a bf16 leaf goes through a
``uint16`` view of its bits, which is exact.  The optimizer's state comes
across as well (:func:`opt_state_from_jax`), and so does a decode cache
(:func:`cache_from_jax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.layers import flatten, unflatten
from .optim import AdamWState


def tensor_from_numpy(a) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree) -> dict:
    """Nested dicts of numpy arrays → nested dicts of CPU tensors, leaf for
    leaf, bit-exact; move them with ``.to(device)``."""
    return unflatten((path, tensor_from_numpy(leaf))
                     for path, leaf in flatten(tree))


def opt_state_from_jax(state) -> AdamWState:
    """A JAX ``AdamWState(step, mu, nu)`` (leaves as numpy arrays) → the
    port's: ``step`` a 0-d int32 tensor on the host, the moments as
    :func:`params_from_jax` makes them."""
    step, mu, nu = state
    return AdamWState(torch.tensor(int(np.asarray(step)), dtype=torch.int32),
                      params_from_jax(mu), params_from_jax(nu))


def cache_from_jax(cache) -> dict:
    """A JAX decode cache (``repro.models.transformer.init_cache``'s dict,
    leaves as numpy arrays) → the port's (``transformer.cache_spec``'s):
    the same names and layouts (``k`` / ``v``, ``c`` / ``r``, ``state``,
    ``conv_x`` / ``conv_bc``, the encoder-decoder's cross attention ``xk``
    / ``xv``, ``cur_len``), each leaf bit-exact on the CPU.  The port's ``decode_step`` writes the cache in place, so each
    leaf is a fresh copy."""
    return {name: tensor_from_numpy(leaf) for name, leaf in cache.items()}
