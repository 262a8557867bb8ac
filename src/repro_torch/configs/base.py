"""Model configuration: the port's copy of ``repro.configs.base.ModelConfig``.

The dataclass, its field defaults and the properties the models read
are the reference's, so a config built here compares field for field
with the JAX package's. The shapes
table and the analytic parameter counters stay with the dry-run tools,
which the port does not have yet (ROADMAP A9.6).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (superset across the assigned archs)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # >0: window size for local layers
    local_global_ratio: int = 0    # gemma3: N local layers per 1 global
    attn_logit_softcap: float = 0.0

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0         # leading dense layers before MoE layers
    d_ff_dense: int = 0            # d_ff of the dense layers in an MoE model
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM / linear-attention ----------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    d_inner_mult: int = 2
    attn_every: int = 0            # zamba2: shared attn block every N layers
    rwkv_head_size: int = 64

    # --- multimodal -----------------------------------------------------------
    cross_attn_every: int = 0      # vlm: insert a cross-attn layer after every N
    n_image_tokens: int = 0
    embeds_input: bool = False     # audio/vlm stub frontend: embeddings in

    # --- ffn -------------------------------------------------------------------
    ffn_kind: str = "swiglu"       # swiglu | gelu (2-matrix) | rwkv (r,k,v mix)

    # --- numerics --------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ----------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"
