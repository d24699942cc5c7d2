"""whisper-small [arXiv:2212.04356] — encoder-decoder audio backbone, 12+12L /
d_model 768 / 12H (kv 12) / d_ff 3072 / vocab 51865. Conv/mel frontend is
STUBBED (precomputed frame embeddings); the assigned 32k shapes exceed the
family's native 1500-frame/448-token spec and are lowered mechanically.
The model is ``repro_torch.models.whisper``, served through
``models.api`` and ``launch.serve``."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,                        # decoder layers
        n_encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51872,  # 51865 padded to /16 for TP
        activation="gelu",
        norm="layernorm",
        attn_bias=True,
        tie_embeddings=True,
        encoder_seq_len=1500,
        max_seq_len=32768,                  # decode_32k lowered mechanically
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
