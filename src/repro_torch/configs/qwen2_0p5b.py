"""Qwen2 0.5B — GQA with QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936, head_dim 64;
tied embeddings (per the released model). Same numbers as
``repro.configs.qwen2_0p5b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151_936,
        qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        qkv_bias=True, tie_embeddings=True,
    )
