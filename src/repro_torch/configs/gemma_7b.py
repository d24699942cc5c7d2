"""gemma-7b [arXiv:2403.08295] — dense, GeGLU, head_dim 256, 28L /
d_model 3072 / 16H (kv 16) / d_ff 24576 / vocab 256000."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        family="decoder",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        activation="geglu",
        attn_pattern=("S",),
        scale_embeddings=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        max_seq_len=32768,                 # pure full attention → long_500k skipped
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
