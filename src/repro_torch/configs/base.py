"""Configurations: the port's copy of ``repro.configs.base``'s
``ModelConfig``, ``OptimizerConfig`` and ``TrainConfig``.

The dataclasses, their field defaults (but for the checkpoint directory,
which follows ``$TMPDIR``) and the properties the models read are the
reference's, so a config built here compares field for field with the
JAX package's. The shapes table and the analytic parameter counters stay
with the dry-run tools, which the port does not have yet (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile


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


# ---------------------------------------------------------------------------
# Training / runtime configs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_states: bool = False       # quantized Adam m/v (distributed-memory trick)
    grad_compression: bool = False  # int8 gradient all-reduce w/ error feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    opt: OptimizerConfig = OptimizerConfig()
    seq_len: int = 4096
    global_batch: int = 256
    microbatches: int = 1
    remat: bool = True
    seed: int = 0
    checkpoint_every: int = 200
    # the reference's /tmp/repro_ckpt, under $TMPDIR where that is set
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    keep_checkpoints: int = 3
