"""qwen3-8b [hf:Qwen/Qwen3-8B] — dense, per-head qk-norm, GQA, 36L /
d_model 4096 / 32H (kv 8, head_dim 128) / d_ff 12288 / vocab 151936."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="decoder",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        activation="swiglu",
        attn_pattern=("S",),
        qk_norm=True,
        tie_embeddings=False,
        rope_theta=1000000.0,
        max_seq_len=32768,                 # pure full attention → long_500k skipped
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
