"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) over
a leading device axis (``repro.nn.rglru`` ported: the full-sequence form).

Recurrence, per channel:
    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Λ) * r_t        (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ x_t)

The reference runs the linear recurrence as ``jax.lax.associative_scan``
over time.  Here it is a log-depth Hillis–Steele scan: ``ceil(log2 S)``
steps, each one whole-tensor combine ``(a_l a_r, b_l a_r + b_r)`` of
every position with the one ``2^j`` before it.  At the decoder's 32
tokens that is 5 steps of a few elementwise ops over the whole
``[D, Nb, S, W]`` tensor, against 32 of a loop over S, each a kernel
launch on the card (forward and backward); the extra ``log S`` factor of
work is nothing at these lengths.  Sums associate differently from the
reference's scan: float32 rounding apart, the same recurrence.

The enclosing residual block is Griffin's: a GeLU gate branch and a
conv1d → RG-LRU branch, multiplied and projected back.  Decode steps one
token (``rglru_step``) against the cache ``{"conv": [..., B, W-1, w],
"state": [..., B, w] float32}`` and writes the new conv tail and state
into the cache it is given.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn import init as initializers
from repro_torch.nn.layers import dense_apply, dense_init, gelu, per_device
from repro_torch.nn.ssm import causal_conv1d

_C = 8.0


def rglru_init(width: int, generator: torch.Generator, *,
               dtype=torch.float32):
    """One RG-LRU's params; Λ so that the decays ``a = exp(-c·softplus(Λ))``
    at ``r = 1`` spread uniformly over [0.9, 0.999]."""
    dev = generator.device
    wa = dense_init(width, width, generator, use_bias=True, dtype=dtype)
    wx = dense_init(width, width, generator, use_bias=True, dtype=dtype)
    u = 0.9 + 0.099 * torch.rand((width,), generator=generator, device=dev)
    lam = torch.log(torch.expm1(-torch.log(u ** (1.0 / _C))))
    return {"wa": wa, "wx": wx, "lambda": lam.float()}


def _gates(params, x: torch.Tensor):
    """``(a, gated_x)`` in float32 for x ``[D, ..., W]``."""
    r = torch.sigmoid(dense_apply(params["wa"], x))
    i = torch.sigmoid(dense_apply(params["wx"], x))
    lam = per_device(params["lambda"], r)
    log_a = (-_C * F.softplus(lam)) * r.float()
    a = torch.exp(log_a)
    gated_x = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-12))
               * (i.float() * x.float()))
    return a, gated_x


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis -2, by
    a log-depth inclusive scan."""
    S = a.shape[-2]
    off = 1
    while off < S:
        b = torch.cat([b[..., :off, :],
                       b[..., :-off, :] * a[..., off:, :] + b[..., off:, :]],
                      dim=-2)
        a = torch.cat([a[..., :off, :], a[..., :-off, :] * a[..., off:, :]],
                      dim=-2)
        off *= 2
    return b


def rglru_apply(params, x: torch.Tensor, *,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """x ``[D, Nb, S, W]`` → ``[D, Nb, S, W]``; ``initial_state [D, Nb,
    W]``; ``return_state`` also returns the last step's float32 state."""
    a, b = _gates(params, x)
    if initial_state is not None:
        b = torch.cat([b[..., :1, :] + a[..., :1, :]
                       * initial_state.float()[..., None, :],
                       b[..., 1:, :]], dim=-2)
    h = _scan(a, b)
    out = h.to(x.dtype)
    if return_state:
        return out, h[..., -1, :]
    return out


def rglru_step(params, x_t: torch.Tensor, state: torch.Tensor):
    """One step: x_t ``[D, Nb, 1, W]``, state ``[D, Nb, W]`` → ``(y [D, Nb,
    1, W], new_state)``."""
    a, b = _gates(params, x_t)
    h = a[..., 0, :] * state.float() + b[..., 0, :]
    return h[..., None, :].to(x_t.dtype), h


# ------------------------------------------------------------------ block
def recurrent_block_init(cfg, generator: torch.Generator):
    """One Griffin recurrent block's params (the reference's shapes and
    initializers)."""
    dtype = cfg.param_dtype
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    ki = initializers.lecun_normal()
    return {
        "gate_proj": {"kernel": ki((d, w), generator, dtype)},
        "rnn_proj": {"kernel": ki((d, w), generator, dtype)},
        "conv": {
            "kernel": initializers.normal(0.1)((cfg.conv1d_width, w),
                                               generator, dtype),
            "bias": torch.zeros((w,), dtype=dtype, device=generator.device),
        },
        "rglru": rglru_init(w, generator, dtype=dtype),
        "out_proj": {"kernel": ki((w, d), generator, dtype)},
    }


def recurrent_block_apply(params, x: torch.Tensor, *, cfg, cache=None,
                          decode: bool = False):
    """Griffin recurrent block over stacked params.  Full sequence: x
    ``[D, Nb, S, d]`` → ``(out, {"conv": the last W-1 pre-conv
    activations, "state": the last RG-LRU state})``, the prefill's decode
    cache.  Decode (``cache`` the ``[D, ...]`` stacked cache, x ``[D, Nb,
    1, d]``): ``(out, cache)``, the cache updated in place."""
    gate = gelu(dense_apply(params["gate_proj"], x))
    h = dense_apply(params["rnn_proj"], x)
    if decode:
        h, conv_state = causal_conv1d(h, params["conv"]["kernel"],
                                      params["conv"]["bias"],
                                      state=cache["conv"])
        h, rnn_state = rglru_step(params["rglru"], h, cache["state"])
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(rnn_state)
        new_cache = cache
    else:
        h, conv_tail = causal_conv1d(h, params["conv"]["kernel"],
                                     params["conv"]["bias"])
        h, last = rglru_apply(params["rglru"], h, return_state=True)
        new_cache = {"conv": conv_tail, "state": last}
    return dense_apply(params["out_proj"], h * gate), new_cache


def recurrent_block_init_cache(batch: int, cfg, *, dtype=torch.float32,
                               device=None):
    """One model's empty decode cache (the state always float32)."""
    w = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device)}
