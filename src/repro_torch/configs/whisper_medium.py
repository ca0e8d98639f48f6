"""Whisper-medium: 24+24 enc-dec, conv/mel frontend stubbed (precomputed
frame embeddings). [arXiv:2212.04356; unverified]
Deviations, as in the JAX package: RoPE instead of learned/sinusoidal positions,
bias-free projections."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865, n_frames=1500, rope_theta=1e4,
)
