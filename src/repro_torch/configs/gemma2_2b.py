"""gemma2-2b [arXiv:2408.00118] — dense, local/global alternating attention,
logit softcapping, GeGLU, post-norms, 26L / d_model 2304 / 8H (kv 4,
head_dim 256) / d_ff 9216 / vocab 256000."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="decoder",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256000,
        activation="geglu",
        attn_pattern=("L", "S"),          # alternating local / global
        sliding_window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        use_post_norms=True,
        scale_embeddings=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        max_seq_len=524288,               # long_500k runs windowed
        dropout_rate=0.0,
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
