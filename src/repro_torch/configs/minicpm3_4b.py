"""minicpm3-4b [hf:openbmb/MiniCPM3-4B] — dense with MLA (kv_lora 256,
q_lora 768, rope 32, nope 64, v 64) and depth-scaled residuals,
62L / d_model 2560 / 40H / d_ff 6400 / vocab 73448."""
import math

import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="decoder",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73456,  # 73448 padded to /16 for TP
        activation="swiglu",
        attn_pattern=("S",),
        use_mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        residual_scale=1.4 / math.sqrt(62),  # scale_depth / sqrt(L)
        tie_embeddings=True,
        rope_theta=10000.0,
        max_seq_len=524288,                # MLA latent cache → long_500k runs
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
