"""The model as an ``nn.Module`` holding its parameters at the JAX package's
layout."""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import transformer as tfm
from .layers import flatten, init_params, unflatten


class Model(nn.Module):
    """Holds one parameter tree (nested dict, the JAX layout) as frozen
    ``nn.Parameter``s named by their path (``"blocks/attn/wq"``).

    ``params`` given (e.g. from :func:`repro_torch.bridge.params_from_jax`)
    are taken as they are, on their own device; otherwise the tree is drawn
    from ``torch.Generator(device).manual_seed(seed)``.  ``device=None``
    means the CUDA card and raises without one."""

    def __init__(self, cfg: ModelConfig, params=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        if params is None:
            dev = resolve_device(device)
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(tfm.model_specs(cfg), gen, device=dev)
        for path, t in flatten(params):
            self.register_parameter("/".join(path),
                                    nn.Parameter(t, requires_grad=False))

    @property
    def params(self) -> dict:
        """The parameter tree as nested dicts (views of the module's
        parameters, so ``.to()`` and ``state_dict()`` stay in step)."""
        return unflatten((tuple(name.split("/")), p)
                         for name, p in self.named_parameters())

    def greedy_decode(self, prompt, max_new_tokens, **kw):
        return tfm.greedy_decode(self.params, prompt, self.cfg,
                                 max_new_tokens, **kw)
