"""The train step: autograd through ``Model.loss``, then the in-place AdamW
update.  A port of ``repro.launch.steps.make_train_fn``; the JAX module's
prefill and decode steps have no caller in the port (the engine serves),
and ``build_cell`` (the dry-run's lowering of a config × shape × mesh
cell) comes with the dry-run (ROADMAP item 16)."""

from __future__ import annotations

import torch

from ..models import Model
from ..optim import AdamW
from ..tree import leaves


def make_train_fn(model: Model, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.
    The params (leaves with ``requires_grad``) and the moments are updated
    in place; the loss comes back detached, a 0-d f32 tensor on the
    params' device (reading it waits for the step)."""
    def train_step(params, opt_state, batch):
        loss = model.loss(params, batch)
        # the gradients as a list in the params' leaf order, which is how
        # AdamW.update walks a gradient tree
        grads = list(torch.autograd.grad(loss, leaves(params)))
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return train_step
