"""Qwen3-30B-A3B: 128-expert top-8 MoE, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]  d_ff is per-expert (moe_intermediate=768)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, n_experts=128, top_k=8,
    qk_norm=True, rope_theta=1e6,
)
