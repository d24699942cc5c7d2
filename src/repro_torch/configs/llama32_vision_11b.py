"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision] — VLM: decoder
with gated cross-attention to image tokens every 5th layer (pattern
S,S,S,S,X ×8 = 40L). Vision encoder STUBBED (precomputed patch embeddings).
d_model 4096 / 32H (kv 8, head_dim 128) / d_ff 14336 / vocab 128256."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        activation="swiglu",
        attn_pattern=("S", "S", "S", "S", "X"),
        n_image_tokens=1600,               # stub ViT output length
        tie_embeddings=False,
        rope_theta=500000.0,
        max_seq_len=32768,                 # full attention → long_500k skipped
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
