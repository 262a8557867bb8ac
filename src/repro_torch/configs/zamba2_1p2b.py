"""Zamba2 1.2B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

38L d_model=2048 32H (kv=32: full multi-head) d_ff=8192 vocab=32000,
ssm_state=64. The 38 layers are Mamba2 blocks (no per-layer FFN); one
*shared* attention+MLP block (d_ff 8192) is applied after every 6th
layer with shared weights (per-site LoRA deltas omitted, as in the
reference). Same numbers as ``repro.configs.zamba2_1p2b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32_000,
        ssm_state=64, ssm_headdim=64, d_inner_mult=2, attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_headdim=16, d_inner_mult=2, attn_every=2,
    )
