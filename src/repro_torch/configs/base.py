"""Model configuration dataclass (a copy of ``repro.configs.base.ModelConfig``:
the port keeps its own copy instead of importing the JAX package)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | mla_moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 ⇒ d_model // n_heads

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    # mla (deepseek)
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid (zamba2): shared attention block applied every `attn_period`
    # mamba layers (weight-tied across invocations)
    attn_period: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500  # stub audio frontend: precomputed frame embeddings
    # vlm (internvl2)
    n_patches: int = 0  # stub vision frontend: precomputed patch embeddings

    mlp_act: str = "swiglu"  # swiglu | sq_relu
    qk_norm: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False

    # implementation knobs: the plain chunked attention's block sizes
    q_block: int = 1024
    kv_block: int = 1024
    remat: str = "none"  # none | dots | full
    capacity_factor: float = 1.25
    moe_groups: int = 32  # dispatch groups

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_period else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32,
            d_ff=96 if self.n_experts else 256,
            vocab_size=512,
            n_frames=16,
            n_patches=4 if self.n_patches else 0,
            q_block=64,
            kv_block=64,
            ssm_chunk=16,
        )
        if self.n_experts:
            kw.update(n_experts=8, top_k=min(self.top_k, 2), capacity_factor=4.0)
        if self.kv_lora_rank:
            kw.update(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32,
                      v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32)
        if self.attn_period:
            kw.update(attn_period=2)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2)
        return self.with_(**kw)
