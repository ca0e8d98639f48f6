"""DeepSeek-V2-Lite (15.7B): MLA (kv_lora=512, rope 64) + 64 routed experts
top-6 + 2 shared. [arXiv:2405.04434; hf]  The published Lite config (64
routed experts, top-6); the real model's first dense layer is simplified to
MoE-everywhere, as in the JAX package."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="mla_moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, n_experts=64, n_shared_experts=2, top_k=6,
    kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    rope_theta=1e4,
)
