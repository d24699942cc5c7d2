"""Core layers over a leading device axis (``repro.nn.layers`` ported):
dense, dropout, the gated and GELU MLPs of the LMs, and LeNet's conv/pool.

Every layer takes STACKED parameters: each leaf carries a leading device
axis ``[D, ...]`` (``D = 1`` for a single model), the written-out form of
the JAX package's ``vmap`` over devices.  Activations are ``[D, ...]``
with any number of middle axes (``[D, N, C]`` for LeNet's dense layers,
``[D, N, S, d]`` for a token sequence); the first convolution also accepts
images ``[N, H, W, C]`` shared by every device (a validation set), which it
broadcasts instead of copying.

Layouts are the JAX package's: NHWC images, HWIO conv kernels, ``[in, out]``
dense kernels.  ``conv2d_apply`` is the im2col + GEMM lowering of
``repro.nn.layers.conv2d_apply``: patches are cut by slicing and contracted
with ``torch.matmul``, which runs in full float32 on the card (cuDNN's
convolutions would default to TF32).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.sharding import rand_rows
from repro_torch.nn import init as initializers


# ---------------------------------------------------------------- helpers
def per_device(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stacked parameter ``[D, *s]`` reshaped to broadcast against
    activations ``x [D, ..., *s]``."""
    return p.reshape(p.shape[:1] + (1,) * (x.dim() - p.dim()) + p.shape[1:])


def device_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-device product: x ``[D, ..., in]`` (or ``[1, ..., in]``, shared)
    @ w ``[D, in, out]`` → ``[D, ..., out]``, as one batched GEMM over the
    flattened middle axes."""
    y = torch.matmul(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return y.reshape((y.shape[0],) + tuple(x.shape[1:-1]) + (w.shape[-1],))


# ---------------------------------------------------------------- dense
def dense_init(in_dim: int, out_dim: int, generator: torch.Generator, *,
               use_bias: bool = False, dtype=torch.float32):
    p = {"kernel": initializers.lecun_normal()((in_dim, out_dim), generator,
                                               dtype)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype,
                                device=generator.device)
    return p


def dense_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x ``[D, ..., in]`` @ kernel ``[D, in, out]`` (+ bias ``[D, out]``)."""
    y = device_matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + per_device(params["bias"].to(x.dtype), y)
    return y


# ---------------------------------------------------------------- dropout
def dropout(x: torch.Tensor, rate: float, *,
            generator: Optional[torch.Generator] = None,
            keep_mask: Optional[torch.Tensor] = None,
            deterministic: bool = False) -> torch.Tensor:
    """Inverted dropout; the identity when ``deterministic`` or ``rate == 0``.

    The keep-mask is ``keep_mask`` when given (tests inject the JAX
    package's own Bernoulli draws), else ``uniform < 1 - rate`` drawn from
    ``generator`` — the construction of ``jax.random.bernoulli``.  ``x``
    carries the leading device axis, so a sharded fleet draws it at the
    global shape (``launch.sharding.rand_rows``).
    """
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep_mask is None:
        if generator is None:
            raise ValueError("stochastic dropout needs a generator or a "
                             "keep_mask")
        keep_mask = rand_rows(x.shape, generator=generator,
                              device=x.device) < keep
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------- activations
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def geglu(x, gate):
    return gelu(gate) * x


def swiglu(x, gate):
    return torch.nn.functional.silu(gate) * x


# ---------------------------------------------------------------- gated MLP
def mlp_init(d_model: int, d_ff: int, generator: torch.Generator, *,
             dtype=torch.float32):
    """Gated MLP (GeGLU and SwiGLU share parameter shapes)."""
    ki = initializers.lecun_normal()
    return {"wi_gate": {"kernel": ki((d_model, d_ff), generator, dtype)},
            "wi_up": {"kernel": ki((d_model, d_ff), generator, dtype)},
            "wo": {"kernel": ki((d_ff, d_model), generator, dtype)}}


def mlp_apply(params, x, *, activation: str = "swiglu"):
    gate = dense_apply(params["wi_gate"], x)
    up = dense_apply(params["wi_up"], x)
    h = swiglu(up, gate) if activation == "swiglu" else geglu(up, gate)
    return dense_apply(params["wo"], h)


def mlp_gelu_init(d_model: int, d_ff: int, generator: torch.Generator, *,
                  use_bias: bool = True, dtype=torch.float32):
    """Plain two-layer GELU MLP."""
    return {"wi": dense_init(d_model, d_ff, generator, use_bias=use_bias,
                             dtype=dtype),
            "wo": dense_init(d_ff, d_model, generator, use_bias=use_bias,
                             dtype=dtype)}


def mlp_gelu_apply(params, x):
    return dense_apply(params["wo"], gelu(dense_apply(params["wi"], x)))


# ---------------------------------------------------------------- conv
def conv2d_init(in_ch: int, out_ch: int, ksize: int,
                generator: torch.Generator, *, dtype=torch.float32):
    ki = initializers.he_normal(in_axis=-2, out_axis=-1)
    return {
        "kernel": ki((ksize, ksize, in_ch, out_ch), generator, dtype),
        "bias": torch.zeros((out_ch,), dtype=dtype,
                            device=generator.device),
    }


def _im2col(x: torch.Tensor, kh: int, kw: int, padding: str):
    """Stride-1 conv patches ``[..., oh, ow, kh*kw*c]`` cut by slicing,
    flattened in (ki, kj, c) order so they contract against
    ``kernel.reshape(-1, cout)``.  SAME splits its padding as
    ``(k-1)//2`` before and the rest after, like XLA at stride 1."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"im2col lowering supports SAME/VALID, got {padding!r}")
    if padding == "SAME":
        ph, pw = (kh - 1) // 2, (kw - 1) // 2
        x = torch.nn.functional.pad(
            x, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = h - kh + 1, w - kw + 1
    cols = [x[..., i:i + oh, j:j + ow, :] for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1)


def conv2d_apply(params, x: torch.Tensor, *, padding: str = "VALID"):
    """x ``[D, N, h, w, c]`` (or shared ``[N, h, w, c]``) → ``[D, N, oh, ow,
    cout]`` against kernels ``[D, kh, kw, c, cout]``, stride 1."""
    kernel = params["kernel"].to(x.dtype)
    D, kh, kw, cin, cout = kernel.shape
    cols = _im2col(x, kh, kw, padding)
    N, oh, ow, K = cols.shape[-4:]
    lead = 1 if x.dim() == 4 else D
    y = torch.matmul(cols.reshape(lead, N * oh * ow, K),
                     kernel.reshape(D, K, cout))
    y = y.reshape(D, N, oh, ow, cout)
    return y + params["bias"].to(x.dtype).reshape(D, 1, 1, 1, cout)


def avg_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping ``window``×``window`` mean over the H, W axes of
    ``[..., H, W, C]`` (VALID: a ragged edge is dropped)."""
    h, w, c = x.shape[-3:]
    oh, ow = h // window, w // window
    x = x[..., :oh * window, :ow * window, :]
    x = x.reshape(*x.shape[:-3], oh, window, ow, window, c)
    return x.sum(dim=(-4, -2)) / float(window * window)
