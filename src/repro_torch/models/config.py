"""Unified model configuration (the port of ``repro.models.config``).

One frozen dataclass with the JAX package's fields, defaults and
``reduced()`` rule; dtypes are torch dtypes.  The published configs are
in ``repro_torch.configs`` (``get_config``); ``lm_100m`` here is the
repository's own scale target from the JAX package's ``examples/``,
which LM path B builds.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"  # decoder | hybrid_rg | ssm | encdec | vlm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None           # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    activation: str = "swiglu"               # swiglu | geglu | gelu
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embeddings: bool = False           # gemma: x *= sqrt(d_model)
    rope_theta: float = 10000.0
    max_seq_len: int = 8192

    # --- attention variants -------------------------------------------------
    attn_pattern: Tuple[str, ...] = ("S",)   # S=global, L=local, R=rg-lru,
                                             # M=mamba2, X=cross-attn
    sliding_window: Optional[int] = None     # window for 'L' layers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qk_norm: bool = False
    attn_bias: bool = False
    use_post_norms: bool = False
    residual_scale: Optional[float] = None

    # --- MLA ---------------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    experts_top_k: int = 2
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    moe_dense_residual: bool = False
    first_k_dense: int = 0
    router_capacity_factor: float = 1.25
    router_aux_loss_weight: float = 0.01

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state_dim: int = 128
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_expand: int = 2

    # --- RG-LRU hybrid -------------------------------------------------------
    lru_width: Optional[int] = None
    conv1d_width: int = 4

    # --- enc-dec -------------------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # --- VLM -----------------------------------------------------------------
    n_image_tokens: int = 0
    cross_attn_every: int = 0

    # --- training-time -------------------------------------------------------
    dropout_rate: float = 0.0                # >0 enables MC-dropout uncertainty
    remat: bool = True                       # XLA rematerialisation; unused here
    shard_hints: bool = False                # activation placement hints under
                                             # a mesh (nn.shard_hints)
    param_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.float32       # activation dtype

    # ---------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def q_rep(self) -> int:
        assert self.n_heads % max(self.n_kv_heads, 1) == 0
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def pattern_units(self) -> int:
        """Full pattern repetitions in ``n_layers`` (the remainder becomes
        tail layers)."""
        body = self.n_layers - self.first_k_dense
        return body // len(self.attn_pattern)

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        body = self.n_layers - self.first_k_dense
        return tuple(self.attn_pattern[:body % len(self.attn_pattern)])

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                n_experts: int = 4, vocab_size: Optional[int] = None,
                max_seq_len: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family (the reference's rule)."""
        d_model = min(d_model, 512)
        heads = max(1, min(self.n_heads, d_model // 64))
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        changes = dict(
            n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
            head_dim=64, d_ff=min(self.d_ff, 4 * d_model),
            vocab_size=(vocab_size if vocab_size is not None
                        else min(self.vocab_size, 512)),
            max_seq_len=max_seq_len,
            sliding_window=(min(self.sliding_window, 128)
                            if self.sliding_window else None),
            param_dtype=torch.float32, dtype=torch.float32)
        if self.n_experts:
            changes.update(n_experts=min(self.n_experts, n_experts),
                           experts_top_k=min(self.experts_top_k, 2),
                           moe_d_ff=min(self.moe_hidden, 2 * d_model),
                           first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            changes.update(kv_lora_rank=64,
                           q_lora_rank=96 if self.q_lora_rank else None,
                           qk_nope_head_dim=32, qk_rope_head_dim=16,
                           v_head_dim=32)
        if self.family == "ssm":
            changes.update(ssm_state_dim=min(self.ssm_state_dim, 32),
                           ssm_head_dim=32, ssm_chunk=64)
        if self.family == "hybrid_rg":
            changes.update(lru_width=d_model, n_layers=max(n_layers, 3))
        if self.family == "encdec":
            changes.update(n_encoder_layers=n_layers, encoder_seq_len=64)
        if self.family == "vlm":
            changes.update(n_image_tokens=16,
                           n_layers=max(n_layers, len(self.attn_pattern)))
        return replace(self, **changes)


def lm_100m() -> ModelConfig:
    """The repository's ~100M decoder scale target
    (``examples/train_lm_selection.py``): 12 global-attention layers,
    d_model 640, 10 heads over 5 KV heads of 64, SwiGLU d_ff 2560, vocab
    32768 tied, dropout 0.1."""
    return ModelConfig(
        name="lm-100m", family="decoder", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=32768,
        attn_pattern=("S",), tie_embeddings=True, dropout_rate=0.1,
        max_seq_len=512)
