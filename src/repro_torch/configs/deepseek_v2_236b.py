"""deepseek-v2-236b [arXiv:2405.04434] — MoE with Multi-head Latent Attention.
60L / d_model 5120 / 128H MLA (kv_lora 512, q_lora 1536, rope 64, nope 128,
v 128) / 160 routed experts top-6 + 2 shared (expert d_ff 1536) / first layer
dense (d_ff 12288) / vocab 102400. MLA latent cache → long_500k runs."""
import torch

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="decoder",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,                        # dense first layer / shared-expert base
        vocab_size=102400,
        activation="swiglu",
        attn_pattern=("S",),
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        experts_top_k=6,
        n_shared_experts=2,
        moe_d_ff=1536,
        first_k_dense=1,
        tie_embeddings=False,
        rope_theta=10000.0,
        max_seq_len=524288,
        param_dtype=torch.bfloat16,
        dtype=torch.bfloat16,
    )
