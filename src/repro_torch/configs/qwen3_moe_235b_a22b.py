"""Qwen3-MoE 235B-A22B — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936,
MoE 128e top-8, qk_norm, head_dim 128; no shared expert, every layer
MoE, untied head. Same numbers as ``repro.configs.qwen3_moe_235b_a22b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab_size=151_936,
        n_experts=128, top_k=8, qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        n_experts=4, top_k=2, qk_norm=True,
    )
