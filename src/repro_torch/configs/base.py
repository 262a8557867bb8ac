"""Configurations: the port's copy of ``repro.configs.base``'s
``ModelConfig``, ``OptimizerConfig`` and ``TrainConfig``.

The dataclasses, their field defaults (but for the checkpoint directory,
which follows ``$TMPDIR``) and the properties the models read are the
reference's, so a config built here compares field for field with the
JAX package's, and so are the analytic parameter counters
(``param_count``, ``active_param_count``), the four input shapes
(``SHAPES``) and ``shape_applicable``, which the dry run
(``launch/dryrun.py``) reads.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Tuple


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

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic rule for the long_500k shape (see DESIGN.md)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # gemma3-style mostly-local attention qualifies (5:1 local:global).
        return self.local_global_ratio > 0 and self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS roofline terms)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        return _param_count(self, active_only=True)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    if cfg.ffn_kind == "gelu":      # up + down
        return 2 * cfg.d_model * d_ff
    if cfg.ffn_kind == "rwkv":      # receptance (d,d) + key (d,ff) + value (ff,d)
        return cfg.d_model * cfg.d_model + 2 * cfg.d_model * d_ff
    return 3 * cfg.d_model * d_ff   # swiglu: gate + up + down


def _attn_params(cfg: ModelConfig) -> int:
    p = cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim + cfg.q_dim * cfg.d_model
    if cfg.qkv_bias:
        p += cfg.q_dim + 2 * cfg.kv_dim
    return p


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total = emb + head + d  # final norm

    if cfg.family == "ssm":  # rwkv6
        H = d // cfg.rwkv_head_size
        per_layer = (
            5 * d * d          # r,k,v,g,o projections
            + 6 * d            # token-shift lerp mus (r,k,v,g,w + x)
            + 2 * 64 * d       # w lora (d->64->d)
            + d                # u bonus
            + H * cfg.rwkv_head_size  # group-norm scale approx
            + _ffn_params(cfg, cfg.d_ff)
            + 2 * d            # norms
        )
        return total + cfg.n_layers * per_layer

    if cfg.family == "hybrid":  # zamba2: mamba2 layers + one shared attn block
        d_in = cfg.d_inner
        nh = d_in // cfg.ssm_headdim
        # Zamba2 mamba blocks carry no per-layer FFN; the shared attention
        # block owns the MLP (matches the 1.2B total).
        per_mamba = (
            d * d_in * 2       # in proj -> x, z
            + d * (2 * cfg.ssm_state + nh)  # B, C, dt projections
            + nh * 2           # A_log, D
            + d_in             # dt bias
            + d_in * d         # out proj
            + d                # norm
        )
        shared_attn = _attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d
        return total + cfg.n_layers * per_mamba + shared_attn

    # transformer families
    per_layer = _attn_params(cfg) + 2 * d
    if cfg.qk_norm:
        per_layer += 2 * cfg.head_dim
    n_moe_layers = 0
    if cfg.n_experts > 0:
        n_moe_layers = cfg.n_layers - cfg.first_k_dense
        d_ff_dense = cfg.d_ff_dense or cfg.d_ff
        total += cfg.first_k_dense * _ffn_params(cfg, d_ff_dense)
        router = cfg.d_model * cfg.n_experts
        experts = cfg.n_experts * _ffn_params(cfg, cfg.d_ff)
        shared = cfg.n_shared_experts * _ffn_params(cfg, cfg.d_ff)
        if active_only:
            experts = cfg.top_k * _ffn_params(cfg, cfg.d_ff)
        total += n_moe_layers * (router + experts + shared)
    else:
        total += cfg.n_layers * _ffn_params(cfg, cfg.d_ff)
    total += cfg.n_layers * per_layer

    if cfg.cross_attn_every > 0:  # vlm: extra cross-attn blocks
        n_cross = cfg.n_layers // (cfg.cross_attn_every + 1)
        total += n_cross * (_attn_params(cfg) + _ffn_params(cfg, cfg.d_ff) + 2 * d)
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md)"
    return True, ""



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
