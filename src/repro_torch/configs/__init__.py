"""Architecture registry of the port, the JAX package's ten: the families the
paged serving engine runs, dense GQA and GQA with a top-k MoE FFN, and those
served from the contiguous cache, DeepSeek's MLA with MoE, Mamba2's SSM,
Zamba2's hybrid of the two, Whisper's encoder-decoder (precomputed frame
embeddings) and InternVL2's dense backbone with its stub vision frontend
(precomputed patch embeddings)."""
from . import (deepseek_v2_lite_16b, granite_3_2b, internvl2_76b, mamba2_1p3b,
               nemotron_4_340b, qwen3_1p7b, qwen3_moe_30b_a3b, whisper_medium,
               yi_34b, zamba2_7b)
from .base import SHAPES, ModelConfig, ShapeConfig, applicable_shapes, skip_reason

_MODULES = [qwen3_1p7b, granite_3_2b, nemotron_4_340b, yi_34b,
            qwen3_moe_30b_a3b, deepseek_v2_lite_16b, mamba2_1p3b, zamba2_7b,
            whisper_medium, internvl2_76b]

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCHS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return REGISTRY[name]
