"""JAX parameter trees → the port's parameter trees.

The JAX tree arrives as nested dicts of numpy arrays (``np.asarray`` of each
leaf, so this module needs no JAX) and keeps its layout leaf for leaf:
``wq (L, d, H, hd)``, ``wo (L, H, hd, d)``, ``embed (V, d)``,
``lm_head (d, V)``, and so on.  ``torch.from_numpy`` rejects the
``ml_dtypes.bfloat16`` arrays JAX hands out, so a bf16 leaf goes through a
``uint16`` view of its bits, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.layers import flatten, unflatten


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
