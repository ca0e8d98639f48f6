"""AdamW with f32 moments, its learning-rate schedules, and gradient
compression with error feedback (a port of ``repro.optim``)."""
from .adamw import AdamW, AdamWState, global_norm  # noqa: F401
from .schedule import constant, cosine_with_warmup  # noqa: F401
from . import grad  # noqa: F401
