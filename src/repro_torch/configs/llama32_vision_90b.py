"""Llama 3.2 Vision 90B — cross-attention image layers [hf:meta-llama/Llama-3.2-*-Vision].

80 self-attention layers d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, head_dim 128, and a cross-attention layer after every 4th
(20 superblocks). The vision encoder is a stub: the model takes
precomputed patch embeddings (``batch["image_embeds"]``, n_image_tokens
x d_model). Same numbers as ``repro.configs.llama32_vision_90b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28_672, vocab_size=128_256,
        cross_attn_every=4, n_image_tokens=1600,
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        cross_attn_every=2, n_image_tokens=16,
    )
