"""Architecture registry of the port: the dense GQA family, which is what the
paged serving engine runs."""
from . import granite_3_2b, nemotron_4_340b, qwen3_1p7b, yi_34b
from .base import ModelConfig

_MODULES = [qwen3_1p7b, granite_3_2b, nemotron_4_340b, yi_34b]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCHS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return REGISTRY[name]
