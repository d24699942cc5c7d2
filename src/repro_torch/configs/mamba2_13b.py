"""mamba2-1.3b [arXiv:2405.21060] — attention-free SSM with SSD (state-space
duality), 48L / d_model 2048 / ssm_state 128 / head_dim 64 / expand 2 /
vocab 50280."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,                         # unused by SSD; kept for API shape
        n_kv_heads=1,
        d_ff=0,                            # attention-free, no MLP stack
        vocab_size=50288,   # 50280 padded to /16 for TP (standard practice)
        attn_pattern=("M",),
        ssm_state_dim=128,
        ssm_head_dim=64,
        ssm_n_groups=1,
        ssm_expand=2,
        ssm_conv_width=4,
        ssm_chunk=256,
        tie_embeddings=True,
        max_seq_len=524288,                # O(1) state → long_500k runs
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
