"""Qwen3 4B — qk_norm, GQA [hf:Qwen/Qwen3-*].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim 128;
tied embeddings. Same numbers as ``repro.configs.qwen3_4b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151_936,
        qk_norm=True, tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        qk_norm=True, tie_embeddings=True,
    )
