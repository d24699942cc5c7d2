"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] over a
leading device axis (``repro.nn.ssm`` ported).

Chunked SSD: the sequence is split into chunks of length L; the
intra-chunk term is the masked quadratic form (C_l·B_m · decay(l, m)) and
the inter-chunk term a linear recurrence over per-chunk states.  The
intra-chunk block has two routes, chosen by ``impl``:

* ``"ref"`` — the plain PyTorch version of the SSD intra-chunk kernel
  (``kernels.ssd_scan.ssd_intra_chunk_plain``), differentiable (the
  training loss always takes it);
* ``"pallas"`` — the kernel's wrapper (``kernels.ssd_scan``): the CUDA
  kernel for tensors on the card, the plain version on the CPU.  The name
  is the JAX package's; here it means the hand-written kernel.

Decode carries ``{"conv": [..., B, W-1, conv_ch], "state": [..., B, H, P,
N]}`` (``[D, ...]`` stacked): ``mamba2_apply(return_cache=True)`` builds it
from a prefill, ``mamba2_init_cache`` empty, and ``mamba2_decode`` steps
one token with ``ssd_step``, writing the new conv tail and state INTO the
cache it is given (each leaf keeps its storage dtype: the state, computed
in the activation dtype as the reference computes it, is stored exactly
in a float32 cache).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import (ssd_intra_chunk,
                                          ssd_intra_chunk_plain)
from repro_torch.nn import init as initializers
from repro_torch.nn.layers import device_matmul, per_device
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.shard_hints import padded

IMPLS = ("ref", "pallas")


# ------------------------------------------------------------------ params
def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state_dim, cfg.ssm_n_groups


def mamba2_init(cfg, generator: torch.Generator, *, dtype=None):
    """One block's params (the reference's shapes and initializers)."""
    dtype = dtype or cfg.param_dtype
    dev = generator.device
    d = cfg.d_model
    d_inner, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    ki = initializers.lecun_normal()
    # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1] (mamba default)
    u = torch.rand((H,), generator=generator, device=dev)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
    return {
        "in_proj": {"kernel": ki((d, 2 * d_inner + 2 * G * N + H), generator,
                                 dtype)},
        "conv": {
            "kernel": initializers.normal(0.1)((cfg.ssm_conv_width, conv_ch),
                                               generator, dtype),
            "bias": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        },
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": dt_init.float(),
        "norm": rmsnorm_init(d_inner, dtype, dev),
        "out_proj": {"kernel": ki((d_inner, d), generator, dtype)},
    }


# ------------------------------------------------------------------ conv1d
def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  *, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over ``x [D, ..., S, C]`` with per-device
    ``kernel [D, W, C]`` and ``bias [D, C]``.  With ``state [D, ..., W-1,
    C]`` (decode) the history is prepended instead of zeros.  Returns
    ``(y, new_state)``, the last W-1 inputs of the padded sequence."""
    W, S = kernel.shape[1], x.shape[-2]
    if state is None:
        x_pad = padded(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=-2)
    y = sum(x_pad[..., i:i + S, :] * per_device(kernel[:, i].to(x.dtype), x)
            for i in range(W))
    return y + per_device(bias.to(x.dtype), x), x_pad[..., -(W - 1):, :]


# ------------------------------------------------------------------ SSD core
def ssd_chunked(x, dt, A, B, C, *, chunk: int, initial_state=None,
                impl: str = "ref"):
    """SSD over a full sequence.

    x ``[b, s, h, p]``, dt ``[b, s, h]`` (post-softplus), A ``[h]`` or
    ``[b, h]`` (negative decay rates), B and C ``[b, s, g, n]``,
    ``initial_state [b, h, p, n]``.  Returns ``(y [b, s, h, p],
    final_state [b, h, p, n])``.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown SSD impl {impl!r}: use "
                         + " | ".join(IMPLS))
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    # A sequence no longer than one chunk is ONE chunk of its own length.
    # The JAX package pads it to `chunk` rows, but padded rows carry
    # xdt = 0 and dt = 0 (so la stays flat after the last real row): they
    # change neither y nor the chunk state, and at s = 32 < 256 they would
    # be 7/8 of the work.  Longer sequences pad to whole chunks as JAX does.
    L = s if s <= chunk else chunk
    nc = -(-s // L)
    pad = nc * L - s
    if pad:
        x = padded(x, (0, 0, 0, 0, 0, pad))
        dt = padded(dt, (0, 0, 0, pad))
        B = padded(B, (0, 0, 0, 0, 0, pad))
        C = padded(C, (0, 0, 0, 0, 0, pad))

    rep = h // g
    xs = x.reshape(b, nc, L, h, p)
    dts = dt.reshape(b, nc, L, h)
    Bs = B.reshape(b, nc, L, g, n)
    Cs = C.reshape(b, nc, L, g, n)

    A2 = A.reshape(-1, h)                                # [b or 1, h]
    dA = dts * A2[:, None, None, :]                      # [b, nc, L, h]
    la = torch.cumsum(dA, dim=2)                         # cumulative log-decay
    x_dt = xs * dts[..., None]

    # the intra-chunk block: the kernel, or its plain (differentiable)
    # version; either reads B and C once per (batch·chunk, group)
    intra = ssd_intra_chunk if impl == "pallas" else ssd_intra_chunk_plain
    y_k, st_k = intra(Cs.reshape(b * nc, L, g, n).contiguous(),
                      Bs.reshape(b * nc, L, g, n).contiguous(),
                      la.reshape(b * nc, L, h).contiguous(),
                      x_dt.reshape(b * nc, L, h, p).contiguous())
    y_diag = y_k.reshape(b, nc, L, h, p).to(x.dtype)
    chunk_states = st_k.reshape(b, nc, h, p, n).to(x.dtype)

    # inter-chunk recurrence over the chunk states
    chunk_decay = torch.exp(torch.sum(dA, dim=2))        # [b, nc, h]
    st = (initial_state if initial_state is not None
          else torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)               # [b, nc, h, p, n]

    # inter-chunk contribution: y_off[l] = (C_l · S_prev) exp(la_l)
    Cg = Cs.repeat_interleave(rep, dim=3)                # [b, nc, L, h, n]
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cg, prev_states) \
        * torch.exp(la)[..., None]
    y = (y_diag + y_off).reshape(b, nc * L, h, p)[:, :s]
    return y, st


def ssd_step(x_t, dt_t, A, B_t, C_t, state):
    """One decode step: x_t ``[b, h, p]``, dt_t ``[b, h]``, A ``[h]`` or
    ``[b, h]``, B_t and C_t ``[b, g, n]``, state ``[b, h, p, n]`` →
    ``(y [b, h, p], new_state)``."""
    h = x_t.shape[1]
    rep = h // B_t.shape[-2]
    a = torch.exp(dt_t * A.reshape(-1, h))               # [b, h]
    Bg = B_t.repeat_interleave(rep, dim=1)               # [b, h, n]
    Cg = C_t.repeat_interleave(rep, dim=1)
    dBx = torch.einsum("bhn,bhp->bhpn", Bg, x_t * dt_t[..., None])
    new_state = state * a[:, :, None, None] + dBx
    return torch.einsum("bhpn,bhn->bhp", new_state, Cg), new_state


# ------------------------------------------------------------------ block
def _split_proj(z, cfg):
    d_inner, H, P, N, G = ssm_dims(cfg)
    sizes = [d_inner, d_inner, G * N, G * N, H]
    return torch.split(z, sizes, dim=-1)  # gate z, conv-input x, B, C, dt


def mamba2_apply(params, x: torch.Tensor, *, cfg,
                 initial_state: Optional[torch.Tensor] = None,
                 return_state: bool = False, return_cache: bool = False,
                 impl: str = "ref"):
    """Full-sequence Mamba-2 block over stacked params: x ``[D, Nb, S,
    d_model]`` → ``[D, Nb, S, d_model]``; ``initial_state [D, Nb, H, P,
    N]``.  ``impl`` selects the intra-chunk SSD route (``ssd_chunked``).
    ``return_cache`` (prefill) also returns the decode cache: the last W-1
    pre-conv activations and the final SSD state."""
    Dn, Nb, S, _ = x.shape
    d_inner, H, P, N, G = ssm_dims(cfg)
    z, xc, Bx, Cx, dt = _split_proj(
        device_matmul(x, params["in_proj"]["kernel"].to(x.dtype)), cfg)

    conv_in = torch.cat([xc, Bx, Cx], dim=-1)
    conv_out, conv_tail = causal_conv1d(conv_in, params["conv"]["kernel"],
                                        params["conv"]["bias"])
    conv_out = F.silu(conv_out)
    rows = Dn * Nb
    xc = conv_out[..., :d_inner].reshape(rows, S, H, P)
    Bm = conv_out[..., d_inner:d_inner + G * N].reshape(rows, S, G, N)
    Cm = conv_out[..., d_inner + G * N:].reshape(rows, S, G, N)

    dt = F.softplus(dt.float() + per_device(params["dt_bias"], dt))
    A = -torch.exp(params["A_log"]).repeat_interleave(Nb, dim=0)  # [rows, H]
    init = (initial_state.reshape(rows, H, P, N)
            if initial_state is not None else None)
    y, final_state = ssd_chunked(xc, dt.to(x.dtype).reshape(rows, S, H),
                                 A.to(x.dtype), Bm, Cm, chunk=cfg.ssm_chunk,
                                 initial_state=init, impl=impl)
    Dp = params["D"].to(x.dtype).repeat_interleave(Nb, dim=0)     # [rows, H]
    y = y + xc * Dp[:, None, :, None]
    y = y.reshape(Dn, Nb, S, d_inner)
    y = rmsnorm_apply(params["norm"], y * F.silu(z), zero_centered=False)
    out = device_matmul(y, params["out_proj"]["kernel"].to(x.dtype))
    final_state = final_state.reshape(Dn, Nb, H, P, N)
    if return_cache:
        return out, {"conv": conv_tail, "state": final_state}
    if return_state:
        return out, final_state
    return out


def mamba2_init_cache(batch: int, cfg, *, dtype=torch.float32, device=None):
    """One model's empty decode cache."""
    d_inner, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {"conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, H, P, N), dtype=dtype,
                                 device=device)}


def mamba2_decode(params, x: torch.Tensor, cache, *, cfg):
    """One-token step over stacked params: x ``[D, Nb, 1, d_model]``,
    ``cache`` the ``[D, ...]`` stacked decode cache → ``(out [D, Nb, 1,
    d_model], cache)``, the cache updated in place."""
    Dn, Nb = x.shape[:2]
    d_inner, H, P, N, G = ssm_dims(cfg)
    z, xc, Bx, Cx, dt = _split_proj(
        device_matmul(x, params["in_proj"]["kernel"].to(x.dtype)), cfg)
    conv_out, conv_state = causal_conv1d(
        torch.cat([xc, Bx, Cx], dim=-1), params["conv"]["kernel"],
        params["conv"]["bias"], state=cache["conv"])
    conv_out = F.silu(conv_out)[..., 0, :]                # [D, Nb, ch]
    rows = Dn * Nb
    xc = conv_out[..., :d_inner].reshape(rows, H, P)
    Bm = conv_out[..., d_inner:d_inner + G * N].reshape(rows, G, N)
    Cm = conv_out[..., d_inner + G * N:].reshape(rows, G, N)

    dt = F.softplus(dt[..., 0, :].float()
                    + per_device(params["dt_bias"], dt[..., 0, :]))
    A = -torch.exp(params["A_log"]).repeat_interleave(Nb, dim=0)  # [rows, H]
    y, new_state = ssd_step(xc, dt.to(x.dtype).reshape(rows, H),
                            A.to(x.dtype), Bm, Cm,
                            cache["state"].reshape(rows, H, P, N)
                            .to(x.dtype))
    Dp = params["D"].to(x.dtype).repeat_interleave(Nb, dim=0)     # [rows, H]
    y = (y + xc * Dp[:, :, None]).reshape(Dn, Nb, 1, d_inner)
    y = rmsnorm_apply(params["norm"], y * F.silu(z), zero_centered=False)
    out = device_matmul(y, params["out_proj"]["kernel"].to(x.dtype))
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(new_state.reshape(cache["state"].shape))
    return out, cache
