"""Grouped-query attention over a leading device axis (``repro.nn.attention``
ported: projections, RoPE, the masked softmax core and gated
cross-attention; no KV cache).

The core has the JAX package's routes, chosen by ``impl``:

* ``"naive"`` — full ``[B, H, Sq, Skv]`` scores: the plain PyTorch
  version of the flash-attention kernel
  (``kernels.flash_attention.flash_attention_plain``), differentiable (the
  training loss takes it);
* ``"pallas"`` — the kernel's wrapper (``kernels.flash_attention``): the
  CUDA kernel for tensors on the card, the plain version on the CPU.  The
  name is the JAX package's; here it means the hand-written kernel;
* ``"blockwise"`` — the reference's XLA scan over KV blocks, which
  ``"auto"`` picks above 2048 keys.  Not ported: it raises.

Decode caches (full and ring, and the cross-attention caches) arrive with
the serve path (ROADMAP.md Queue 1 item 16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.nn import init as initializers
from repro_torch.nn.layers import dense_apply, per_device
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope

_UNPORTED = "ROADMAP.md Queue 1 item 16"


# =============================================================== core
def attention_core(q, k, v, *, causal: bool = True,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None, impl: str = "auto"):
    """q ``[B, Sq, H, d]``; k, v ``[B, Skv, Hkv, d]`` → ``[B, Sq, H, d]``,
    queries and keys at contiguous positions from 0 (no cache is ported,
    so the reference's position arrays are always that)."""
    if impl == "auto":
        impl = "blockwise" if k.shape[1] > 2048 and q.shape[1] > 1 else "naive"
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if impl == "naive":
        return flash_attention_plain(q, k, v, **kw)
    if impl == "pallas":
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               **kw)
    if impl == "blockwise":
        raise NotImplementedError(
            f"attention impl='blockwise' (the XLA scan over KV blocks, chosen "
            f"above 2048 keys) is not ported yet: {_UNPORTED}")
    raise ValueError(f"unknown attention impl {impl!r}: use auto | naive | "
                     "pallas")


# =============================================================== projections
def gqa_init(cfg, generator: torch.Generator, *, dtype=None):
    """GQA projection params for one model."""
    dtype = dtype or cfg.param_dtype
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    ki = initializers.lecun_normal()
    dev = generator.device
    p = {"wq": {"kernel": ki((d, H * hd), generator, dtype)},
         "wk": {"kernel": ki((d, Hkv * hd), generator, dtype)},
         "wv": {"kernel": ki((d, Hkv * hd), generator, dtype)},
         "wo": {"kernel": ki((H * hd, d), generator, dtype)}}
    if cfg.attn_bias:
        p["wq"]["bias"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["wv"]["bias"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
        p["wo"]["bias"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


def _proj(p, x, heads, hd):
    y = dense_apply(p, x)
    return y.reshape(y.shape[:-1] + (heads, hd))


def gqa_apply(params, x: torch.Tensor, *, cfg, positions: torch.Tensor,
              window: Optional[int] = None,
              impl: str = "auto") -> torch.Tensor:
    """Self-attention layer body over stacked params: x ``[D, Nb, S,
    d_model]`` → ``[D, Nb, S, d_model]``.  Devices and sequences fold into
    the core's batch axis."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(params["wq"], x, H, hd)                    # [D, Nb, S, H, hd]
    k = _proj(params["wk"], x, Hkv, hd)
    v = _proj(params["wv"], x, Hkv, hd)
    if "q_norm" in params:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)

    Dn, Nb, S = x.shape[:3]
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k).to(q.dtype), fold(v).to(q.dtype),
                         causal=True, window=window,
                         softcap=cfg.attn_logit_softcap, impl=impl)
    return dense_apply(params["wo"], out.reshape(Dn, Nb, S, H * hd))


# =============================================================== cross-attn
def cross_attn_init(cfg, generator: torch.Generator):
    """GQA projections, plus the zero ``gate_attn`` scalar of
    llama-3.2-vision's tanh gate."""
    p = gqa_init(cfg, generator)
    p["gate_attn"] = torch.zeros((), dtype=cfg.param_dtype,
                                 device=generator.device)
    return p


def cross_attn_apply(params, x: torch.Tensor, kv_src: torch.Tensor, *, cfg,
                     impl: str = "auto") -> torch.Tensor:
    """Cross-attention over stacked params: queries from x ``[D, Nb, Sq,
    d_model]``, keys and values from kv_src ``[D, Nb, Skv, d_model]`` (or
    ``[1, Nb, Skv, d_model]``, shared by every device: encoder output or
    image embeddings).  No RoPE, no causality; the optional ``wo`` bias
    and the ``tanh(gate_attn)`` gate as in the reference."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(params["wq"], x, H, hd)                    # [D, Nb, Sq, H, hd]
    k = _proj(params["wk"], kv_src, Hkv, hd)             # [D, Nb, Skv, ...]
    v = _proj(params["wv"], kv_src, Hkv, hd)
    Dn, Nb, Sq = x.shape[:3]
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k).to(q.dtype), fold(v).to(q.dtype),
                         causal=False, impl=impl)
    y = dense_apply(params["wo"], out.reshape(Dn, Nb, Sq, H * hd))
    if "gate_attn" in params:
        y = per_device(torch.tanh(params["gate_attn"].to(y.dtype)), y) * y
    return y
