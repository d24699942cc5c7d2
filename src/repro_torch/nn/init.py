"""Parameter initializers (the part of ``repro.nn.init`` the ported models
use).

Each initializer takes ``(shape, generator, dtype)`` and draws from the
explicit ``torch.Generator`` (on the generator's device), never from global
RNG state.  The variance rules match the JAX package; the bits do not
(threefry vs Philox), so parity tests carry weights across with
``repro_torch.interop`` instead of matching init draws.
"""
from __future__ import annotations

import math

import torch

# std of a standard normal truncated to [-2, 2] (TF/JAX stddev correction)
_TRUNC_STD = 0.87962566103423978


def _fans(shape, in_axis=-2, out_axis=-1):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape) / (shape[in_axis] * shape[out_axis])
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def normal(stddev: float = 1.0):
    def _init(shape, generator, dtype=torch.float32):
        return (stddev * torch.randn(shape, generator=generator,
                                     device=generator.device)).to(dtype)

    return _init


def truncated_normal(shape, generator: torch.Generator, lower: float = -2.0,
                     upper: float = 2.0, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to ``[lower, upper]`` by inverse CDF (the
    construction ``jax.random.truncated_normal`` uses)."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    a, b = cdf(lower), cdf(upper)
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    p = a + u * (b - a)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return x.clamp(lower, upper).to(dtype)


def variance_scaling(scale: float, mode: str, in_axis=-2, out_axis=-1):
    """Truncated-normal variance scaling (the only distribution the ported
    models use)."""

    def _init(shape, generator, dtype=torch.float32):
        fan_in, fan_out = _fans(shape, in_axis, out_axis)
        denom = {"fan_in": fan_in, "fan_out": fan_out,
                 "fan_avg": (fan_in + fan_out) / 2}[mode]
        std = math.sqrt(scale / max(1.0, denom)) / _TRUNC_STD
        return (truncated_normal(shape, generator) * std).to(dtype)

    return _init


def lecun_normal(in_axis=-2, out_axis=-1):
    return variance_scaling(1.0, "fan_in", in_axis, out_axis)


def he_normal(in_axis=-2, out_axis=-1):
    return variance_scaling(2.0, "fan_in", in_axis, out_axis)
