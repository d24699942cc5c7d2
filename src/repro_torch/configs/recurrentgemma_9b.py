"""recurrentgemma-9b [arXiv:2402.19427 Griffin; model card google/recurrentgemma-9b]
— hybrid: RG-LRU recurrent blocks + local attention at 2:1 (pattern R,R,L),
38L / d_model 4096 / 16H MQA (kv 1) / d_ff 12288 / vocab 256000 / window 2048."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid_rg",
        n_layers=38,                       # 12×(R,R,L) + (R,R) tail
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,                      # MQA on the attention layers
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        activation="geglu",
        attn_pattern=("R", "R", "L"),
        sliding_window=2048,
        lru_width=4096,
        conv1d_width=4,
        scale_embeddings=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        max_seq_len=524288,                # O(1)/windowed state → long_500k runs
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
