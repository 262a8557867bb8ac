"""Gemma 3 4B — 5:1 local:global attention, 128k context [hf:google/gemma-3-*].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim 256;
sliding window 1024 on local layers, every 6th layer global; qk-norm;
tied embeddings. Same numbers as ``repro.configs.gemma3_4b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10_240, vocab_size=262_144,
        qk_norm=True, tie_embeddings=True,
        sliding_window=1024, local_global_ratio=5,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        qk_norm=True, tie_embeddings=True,
        sliding_window=16, local_global_ratio=2,
    )
