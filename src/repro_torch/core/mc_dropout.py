"""MC-dropout posterior sampling (paper §III-A, Eq. 13; ``repro.core.mc_dropout``).

The T stochastic forwards run as ONE batched forward: the images are
repeated T times along the row axis, each row draws its own dropout masks,
and the logits fold back to ``[..., T, N, C]`` — the written-out form of
the reference's ``vmap`` over T keys.
"""
from __future__ import annotations

import math

import torch


def mc_logprobs(stochastic_apply, params, x: torch.Tensor, T: int,
                generator: torch.Generator) -> torch.Tensor:
    """T MC-dropout draws → log-probs ``[D, T, N, C]``.

    ``stochastic_apply(params, x, generator)`` maps stacked params and
    images ``[D, M, ...]`` to logits ``[D, M, C]`` with dropout ACTIVE;
    ``x`` is ``[D, N, ...]``.
    """
    D, N = x.shape[:2]
    xr = x.unsqueeze(1).expand(D, T, *x.shape[1:]).reshape(D, T * N,
                                                           *x.shape[2:])
    logits = stochastic_apply(params, xr, generator)
    return torch.log_softmax(logits, dim=-1).reshape(D, T, N, -1)


def predictive_log_posterior(log_probs: torch.Tensor) -> torch.Tensor:
    """log p̄(y|x) over the T axis (third from last): ``[..., T, N, C] →
    [..., N, C]``, via logsumexp."""
    T = log_probs.shape[-3]
    return torch.logsumexp(log_probs, dim=-3) - math.log(T)


def predictive_posterior(log_probs: torch.Tensor) -> torch.Tensor:
    """Mean posterior p̄(y|x) in probability space: ``[..., N, C]``."""
    return torch.exp(predictive_log_posterior(log_probs))
