"""MusicGen medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (kv=24: full multi-head) d_ff=6144 vocab=2048,
head_dim 64; a two-matrix GELU FFN. The EnCodec frontend is a stub:
the model takes precomputed frame embeddings (``batch["embeds"]``) or
codec tokens, and predicts codec tokens (vocab 2048). Same numbers as
``repro.configs.musicgen_medium``.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab_size=2048,
        ffn_kind="gelu", embeds_input=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64,
        ffn_kind="gelu", embeds_input=True,
    )
