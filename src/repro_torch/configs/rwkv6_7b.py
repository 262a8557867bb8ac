"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892].

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536. Head size 64 (64
heads); channel-mix uses the RWKV r/k/v form. Same numbers as
``repro.configs.rwkv6_7b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14_336, vocab_size=65_536,
        rwkv_head_size=64, ffn_kind="rwkv",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        rwkv_head_size=16, ffn_kind="rwkv",
    )
