"""Acquisition functions (paper §II-D) over MC-dropout log-probs
(``repro.core.acquisition`` ported).

Every score takes ``log_probs [..., T, N, C]`` — T MC samples, N pool
points, C classes, with any leading (device) axes — and returns ``[..., N]``
where HIGHER = more desirable to query.  These are the plain versions the
acquisition-score kernel (``repro_torch.kernels.acquisition_scores``) is
held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.mc_dropout import predictive_log_posterior

_EPS = 1e-10


def entropy(log_probs):
    """H[y|x, D] of the MC-mean posterior (paper Eq. 2)."""
    logp_bar = predictive_log_posterior(log_probs)          # [..., N, C]
    return -torch.sum(torch.exp(logp_bar) * logp_bar, dim=-1)


def expected_entropy(log_probs):
    """E_t[H[y|x, w_t]] — the second term of BALD."""
    ent_per_sample = -torch.sum(torch.exp(log_probs) * log_probs, dim=-1)
    return torch.mean(ent_per_sample, dim=-2)               # over T


def bald(log_probs):
    """I[y; w | x, D] = H[mean] - mean[H] (paper Eq. 3, Houlsby et al.)."""
    return entropy(log_probs) - expected_entropy(log_probs)


def variational_ratio(log_probs):
    """V[x] = 1 - max_y p̄(y|x) (paper Eq. 4)."""
    logp_bar = predictive_log_posterior(log_probs)
    return 1.0 - torch.exp(torch.amax(logp_bar, dim=-1))


def least_confidence(log_probs):
    """Beyond-paper: 1 - p̄(ŷ|x) — identical ordering to VR."""
    return variational_ratio(log_probs)


def margin(log_probs):
    """Beyond-paper: negative margin between top-2 posterior classes."""
    top2 = torch.topk(predictive_log_posterior(log_probs), 2, dim=-1).values
    return -(torch.exp(top2[..., 0]) - torch.exp(top2[..., 1]))


def random_scores(log_probs, *, generator: torch.Generator):
    """Uniform-random baseline (paper's 'random' curves)."""
    shape = log_probs.shape[:-3] + log_probs.shape[-2:-1]
    return torch.rand(shape, generator=generator, device=log_probs.device)


ACQUISITIONS = {
    "entropy": entropy,
    "bald": bald,
    "vr": variational_ratio,
    "margin": margin,
    "least_confidence": least_confidence,
}


def acquisition_scores(name: str, log_probs, *, generator=None):
    if name == "random":
        if generator is None:
            raise ValueError("random acquisition needs a generator")
        return random_scores(log_probs, generator=generator)
    return ACQUISITIONS[name](log_probs)


def select_topk(scores, k: int):
    """Indices ``[..., k]`` of the k highest scores along the last axis.

    A stable descending sort, so ties go to the lower index first — the
    order ``jax.lax.top_k`` gives (``torch.topk`` leaves ties unordered)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def batch_bald_lite(log_probs, k: int):
    """Greedy diversity-aware BALD (a cheap BatchBALD approximation) on one
    device's ``[T, N, C]`` log-probs → indices ``[k]``.

    Tracks a running joint-sample matrix ``[T, J]`` (the standard MC
    approximation of the joint predictive entropy), keeping the 128 heaviest
    joint bins once it grows past that.
    """
    T, N, C = log_probs.shape
    p = torch.exp(log_probs)                                 # [T, N, C]
    cond_ent = -torch.mean(torch.sum(p * log_probs, dim=-1), dim=0)  # [N]
    joint = torch.ones((T, 1), dtype=p.dtype, device=p.device)
    chosen = torch.zeros(N, dtype=torch.bool, device=p.device)
    picks = []
    for _ in range(k):
        mean_joint = torch.einsum("tj,tnc->njc", joint, p) / T  # [N, J, C]
        h_joint = -torch.sum(mean_joint * torch.log(mean_joint + _EPS),
                             dim=(1, 2))
        score = torch.where(chosen, torch.tensor(-float("inf"),
                                                 device=p.device),
                            h_joint - cond_ent)
        nxt = int(torch.argmax(score))
        picks.append(nxt)
        chosen[nxt] = True
        joint = (joint[:, :, None] * p[:, nxt, None, :]).reshape(T, -1)
        if joint.shape[1] > 128:
            top_idx = select_topk(joint.mean(0), 128)
            joint = joint[:, top_idx]
            joint = joint / (joint.sum(1, keepdim=True) + _EPS)
    return torch.tensor(picks, dtype=torch.long, device=p.device)
