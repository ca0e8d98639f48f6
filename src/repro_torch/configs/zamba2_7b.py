"""Zamba2-7B: Mamba2 backbone + weight-tied shared attention block every
`attn_period` layers. [arXiv:2411.15242; unverified]  LoRA deltas on the
shared block are omitted, as in the JAX package."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    attn_period=6, rope_theta=1e4,
)
