"""InternVL2-Llama3-76B backbone: InternLM2/Llama3-arch dense GQA LM.
[arXiv:2404.16821; unverified]  Vision frontend is a STUB: input_specs()
provides 256 precomputed patch embeddings prepended to the text sequence."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256, n_patches=256, rope_theta=5e5,
)
