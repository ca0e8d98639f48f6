"""LR schedules (callable(step) -> lr, usable as AdamW.lr).

A port of ``repro.optim.schedule``.  The step is a host integer (the port's
``AdamW`` keeps its step counter on the host), and the schedule is computed
in float32 scalars in the JAX function's order of operations, so it gives
the f32 value the JAX schedule traces; it returns a Python float.
"""

from __future__ import annotations

import numpy as np


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    f32 = np.float32

    def lr(step):
        step = f32(step)
        warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
        t = np.clip((step - f32(warmup_steps))
                    / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        cos = f32(peak_lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * t)))
        return float(warm if step < warmup_steps else cos)

    return lr


def constant(lr_value: float):
    return lambda step: lr_value
