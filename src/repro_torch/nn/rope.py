"""Rotary position embeddings, split-half convention (``repro.nn.rope``
ported)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for an even ``head_dim``."""
    assert head_dim % 2 == 0, head_dim
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """RoPE on ``x [..., seq, heads, head_dim]`` at ``positions [..., seq]``
    (rotate_half, as llama and gemma)."""
    inv_freq = rope_frequencies(x.shape[-1], theta=theta, device=x.device)
    angles = positions[..., None].float() * inv_freq     # [..., seq, hd/2]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
