"""Normalization layers (RMSNorm, LayerNorm) over stacked parameters
(``repro.nn.norms`` ported).  ``scale`` / ``bias`` are ``[D, dim]``;
activations ``[D, ..., dim]``."""
from __future__ import annotations

import torch

from repro_torch.nn.layers import per_device


def rmsnorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, *, eps: float = 1e-6,
                  zero_centered: bool = True) -> torch.Tensor:
    """RMSNorm.  ``zero_centered=True`` is the gemma convention: the weight
    is ``1 + scale``."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.reciprocal(torch.sqrt(var + eps))
    scale = per_device(params["scale"].float(), x)
    w = 1.0 + scale if zero_centered else scale
    return (x * w).to(dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, *,
                    eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out = (x * per_device(params["scale"].float(), x)
           + per_device(params["bias"].float(), x))
    return out.to(dtype)
