"""Nemotron-4-340B: dense GQA with squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp_act="sq_relu", rope_theta=1e4,
)
