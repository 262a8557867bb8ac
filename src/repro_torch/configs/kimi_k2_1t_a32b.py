"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per expert) vocab=163840,
MoE 384 experts top-8, 1 shared expert, the first layer dense (d_ff
18432), head_dim 128. Same numbers as ``repro.configs.kimi_k2_1t_a32b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=2048, vocab_size=163_840,
        n_experts=384, top_k=8, n_shared_experts=1,
        first_k_dense=1, d_ff_dense=18_432,
        rope_theta=50_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=256,
        n_experts=8, top_k=2, n_shared_experts=1,
        first_k_dense=1, d_ff_dense=128,
    )
