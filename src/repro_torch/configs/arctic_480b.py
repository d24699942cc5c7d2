"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — dense-MoE hybrid:
128 experts top-2 IN PARALLEL with a dense residual MLP every layer.
35L / d_model 7168 / 56H (kv 8, head_dim 128) / d_ff 4864 / vocab 32000."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="decoder",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        activation="swiglu",
        attn_pattern=("S",),
        n_experts=128,
        experts_top_k=2,
        moe_d_ff=4864,
        moe_dense_residual=True,
        tie_embeddings=False,
        rope_theta=10000.0,
        max_seq_len=32768,                 # pure full attention → long_500k skipped
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
