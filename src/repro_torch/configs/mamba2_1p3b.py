"""Mamba2-1.3B: attention-free SSD. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280, ssm_state=128, ssm_head_dim=64,
)
