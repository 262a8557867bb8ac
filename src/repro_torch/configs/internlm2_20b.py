"""InternLM2 20B — GQA [arXiv:2403.17297].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, head_dim 128;
no QKV bias, untied head. Same numbers as ``repro.configs.internlm2_20b``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16_384, vocab_size=92_544,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
    )
