"""AdamW with f32 moments over (possibly bf16) params, updated in place.

A port of ``repro.optim.adamw`` that keeps its arithmetic: the gradients
are cast to f32 and clipped by their global norm, the moments are f32
whatever the param dtype, the bias correction is the f32
``1 - b ** step``, weight decay is added to the update ``u``, and the new
value is computed in f32 and cast back to the param's dtype (round to
nearest even, as JAX's ``astype``).  ``torch.optim.AdamW`` keeps its
moments in the param's dtype and applies the decay to the param before the
step, so it is not this optimizer.

The state is ``AdamWState(step, mu, nu)``, the JAX NamedTuple, so a
checkpoint of it has the JAX manager's flat paths (``opt_state/.step``,
``opt_state/.mu/blocks/attn/wq``, ...).  ``step`` is a 0-d int32 tensor on
the host: the schedule's learning rate and the bias correction are computed
from it on the host, so no step waits on the card for them.  The moments
and the params are updated in place under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32, on the host
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Any = 1e-3  # float or callable(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 0.0  # 0 ⇒ no clipping

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(zeros, params), tree_map(zeros, params))

    def abstract_state(self, abstract_params) -> AdamWState:
        """The state of :meth:`init` for a tree of ``meta`` parameters:
        ``meta`` f32 moments, and the step on the host as always."""
        f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,
                                    device="meta")
        return AdamWState(torch.zeros((), dtype=torch.int32),
                          tree_map(f32, abstract_params),
                          tree_map(f32, abstract_params))

    @torch.no_grad()
    def update(self, params, grads, state: AdamWState, *, gnorm=None):
        """One step: writes the params and the moments in place and returns
        ``(params, AdamWState(step + 1, mu, nu))``.

        On a mesh, ``params``, ``grads`` and the moments are this rank's
        shards of each leaf and ``gnorm`` is the global norm of the whole
        gradient (:func:`global_norm` over the whole leaves), so the clip
        scale is the one-device step's and the update of each shard is the
        same slice of the one-device update.  Without ``gnorm`` the norm is
        that of ``grads``."""
        step = int(state.step) + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        gs = leaves(grads)
        scale = None
        if self.clip_norm:
            if gnorm is None:
                gnorm = global_norm(gs)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        b1, b2 = self.b1, self.b2
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(step))
        bc2 = float(f32(1) - f32(b2) ** f32(step))
        for p, g, m, v in zip(leaves(params), gs, leaves(state.mu),
                              leaves(state.nu)):
            g = g.to(torch.float32, copy=True)
            if scale is not None:
                g.mul_(scale)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            p32 = p.float()
            if self.weight_decay:
                u.add_(self.weight_decay * p32)
            p.copy_(p32 - lr * u)
        return params, AdamWState(torch.tensor(step, dtype=torch.int32),
                                  state.mu, state.nu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, added
    in leaf order; a 0-d f32 tensor on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))
