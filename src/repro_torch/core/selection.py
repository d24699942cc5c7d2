"""Uncertainty-driven batch selection at LM scale (``repro.core.selection``
ported): the paper's acquisition step over candidate sequences.

A candidate batch ``[B_cand, S]`` is scored with T MC-dropout forward
passes, the token-level uncertainty of each sequence reduced to one score
with the paper's acquisition functions, and the top ``keep`` sequences
gathered for the train step.

``sequence_scores`` scores through the engines' route
(``core.engine.score_logprobs``): entropy, BALD and VR come from the
acquisition-score kernel (K1) on a card tensor and from its plain version
on the CPU, one call for the whole ``[T, B·S, V]`` block; the other
functions stay plain.  ``select_batch`` takes its indices from
``core.acquisition.select_topk`` (``lax.top_k``'s tie order: the lower
index first).  ``mc_sequence_logprobs`` makes all T draws from the one
generator it is given.

``router_entropy_scores`` derives uncertainty from the MoE router logits
of one deterministic pass: no extra forward.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import acquisition as acq
from repro_torch.core.engine import score_logprobs

REDUCTIONS = {"mean": torch.mean, "max": torch.amax, "sum": torch.sum}


def sequence_scores(token_logprobs: torch.Tensor, *,
                    acquisition_fn: str = "entropy",
                    reduce: str = "mean") -> torch.Tensor:
    """MC token log-probs ``[T, B, S, V]`` → sequence scores ``[B]``: the
    token scores of ``[T, B·S, V]`` in one call, reduced over S by
    ``mean``, ``max`` or ``sum``."""
    if reduce not in REDUCTIONS:
        raise ValueError(reduce)
    T, B, S, V = token_logprobs.shape
    flat = token_logprobs.reshape(T, B * S, V)
    tok = score_logprobs(acquisition_fn, flat).reshape(B, S)
    return REDUCTIONS[reduce](tok, dim=-1)


def router_entropy_scores(router_logits: torch.Tensor) -> torch.Tensor:
    """Uncertainty from MoE router logits ``[B, S, E]`` → ``[B]``."""
    logp = torch.log_softmax(router_logits, dim=-1)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)        # [B, S]
    return torch.mean(ent, dim=-1)


def select_batch(scores: torch.Tensor, tokens: torch.Tensor,
                 targets: torch.Tensor, keep: int):
    """The ``keep`` highest-scoring sequences: ``(tokens, targets, idx)``,
    ties to the lower index first."""
    idx = acq.select_topk(scores, keep)
    return tokens[idx], targets[idx], idx


def mc_sequence_logprobs(apply_fn: Callable, params, tokens: torch.Tensor,
                         generator, T: int) -> torch.Tensor:
    """T stochastic forwards over a candidate batch → ``[T, B, S, V]``
    log-probs in the logits' dtype.  ``apply_fn(params, tokens,
    generator)`` runs with dropout active; its T calls draw from
    ``generator`` in turn.  The passes are written into one block as they
    come, so one pass's logits are alive at a time besides it."""
    out = None
    with torch.no_grad():
        for t in range(T):
            logp = torch.log_softmax(apply_fn(params, tokens, generator),
                                     dim=-1)
            if out is None:
                out = torch.empty((T,) + tuple(logp.shape), dtype=logp.dtype,
                                  device=logp.device)
            out[t] = logp
            del logp
    return out
