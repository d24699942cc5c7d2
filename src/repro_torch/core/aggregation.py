"""Fog-node aggregation strategies (paper §III-B, Eq. 1; ``repro.core.aggregation``
ported).

Two families, as in the reference:

* **List variants** (``fedavg`` / ``fedavg_n`` / ``weighted_average`` /
  ``opt_model``) take a Python list of per-device param trees — the host
  fog-node path of ``run_federated_round``.
* **Stacked variants** work on the engine's ``[D, ...]`` stacked params.
  ``aggregate_stacked`` is THE Eq. 1 reduce of the fused rounds: it routes
  to the fused-aggregation kernel (``repro_torch.kernels
  .fused_aggregation``), which launches the CUDA kernel for tensors on the
  card and runs its plain PyTorch version for tensors on the CPU.

Weight hygiene: ``masked_normalize`` is the one home of the zero-sum guard
(Σw = 0 over participants → uniform over participants; no participants →
uniform over all slots), with the reference's 1e-30 floor.  Σα = 1 is
load-bearing: it makes Eq. 1 exact in delta form, which the comms codecs
rely on.

Per-segment sums of a ``[D]`` vector (``segment_sum``) reduce through a
one-hot mask rather than ``index_add``, whose atomics on the card would
make the weights' bits differ from run to run.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.tree import tree_leaves, tree_map


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def masked_normalize(weights, mask=None, *, segment_ids=None,
                     num_segments: Optional[int] = None) -> torch.Tensor:
    """Raw weights ``[D]`` → convex Eq. 1 coefficients, zero-sum guarded.

    Flat mode: one normalization over the vector, Σα = 1.  Segment mode
    (``segment_ids [D]`` int, ``num_segments`` G): one independent
    normalization per segment, with the same degenerate-case guards."""
    w = _f32(weights)
    m = torch.ones_like(w) if mask is None else _f32(mask, w.device)
    w = w * m
    one = torch.ones((), dtype=torch.float32, device=w.device)
    if segment_ids is None:
        wsum, msum = w.sum(), m.sum()
        uniform = torch.where(msum > 0, m / torch.maximum(msum, one),
                              torch.full_like(w, 1.0 / w.shape[0]))
        return torch.where(wsum > 0, w / torch.clamp(wsum, min=1e-30),
                           uniform)
    if num_segments is None:
        raise ValueError("segment_ids requires a static num_segments")
    ids = torch.as_tensor(segment_ids, device=w.device).long()
    seg = lambda v: segment_sum(v, ids, num_segments)[ids]
    wsum, msum, size = seg(w), seg(m), seg(torch.ones_like(w))
    uniform = torch.where(msum > 0, m / torch.clamp(msum, min=1.0),
                          1.0 / torch.clamp(size, min=1.0))
    return torch.where(wsum > 0, w / torch.clamp(wsum, min=1e-30), uniform)


def segment_sum(values, ids, num_segments: int) -> torch.Tensor:
    """``[G]`` float32 per-segment sums of ``values [D]`` (``ids [D]`` int
    in ``[0, G)``), deterministic on the card: a one-hot ``[G, D]`` mask
    and a row reduce."""
    v = _f32(values)
    ids = torch.as_tensor(ids, device=v.device).long()
    onehot = ids[None, :] == torch.arange(num_segments, device=v.device)[
        :, None]
    return torch.where(onehot, v[None, :], torch.zeros((), device=v.device)
                       ).sum(dim=1)


def normalize_weights(weights, mask=None) -> torch.Tensor:
    """Raw per-device weights → Eq. 1 coefficients α over the ``mask``
    participants (see ``masked_normalize``)."""
    return masked_normalize(weights, mask)


def staleness_decay(staleness, *, kind: str = "exp",
                    rate: float = 0.5) -> torch.Tensor:
    """``decay(s_i)``: ``exp`` → ``rate**s``, ``poly`` → ``(1+s)**-rate``,
    ``none`` → 1; decay(0) == 1 exactly for every kind."""
    s = _f32(staleness)
    if kind == "none":
        return torch.ones_like(s)
    if kind == "exp":
        return torch.pow(_f32(rate, s.device), s)
    if kind == "poly":
        return torch.pow(1.0 + s, -_f32(rate, s.device))
    raise ValueError(f"unknown staleness decay {kind!r}: use none | exp | poly")


def staleness_weights(raw, staleness, mask=None, *, kind: str = "exp",
                      rate: float = 0.5, segment_ids=None,
                      num_segments: Optional[int] = None) -> torch.Tensor:
    """``alpha_i ∝ raw_i · decay(s_i)`` normalized over the ``mask``
    arrivals (flat, or per segment)."""
    w = _f32(raw) * staleness_decay(staleness, kind=kind, rate=rate)
    return masked_normalize(w, mask, segment_ids=segment_ids,
                            num_segments=num_segments)


# ------------------------------------------------------------- list forms
def weighted_average(models: Sequence, weights: Sequence[float]):
    """W ← Σ_i α_i W_i (paper Eq. 1) over a list of param trees; the
    weights are normalized here (zero-sum guarded)."""
    w = normalize_weights(torch.as_tensor(weights, dtype=torch.float32))
    w = w.tolist()

    def agg(*leaves):
        acc = sum(wi * leaf.float() for wi, leaf in zip(w, leaves))
        return acc.to(leaves[0].dtype)

    return tree_map(agg, models[0], *models[1:])


def fedavg(models: Sequence):
    """Uniform-α federated averaging — the paper's default."""
    return weighted_average(models, [1.0] * len(models))


def fedavg_n(models: Sequence, counts: Sequence[float]):
    """Size-aware Eq. 1: α_i ∝ n_i, the device's labeled-sample count."""
    return weighted_average(models, counts)


def opt_model(models: Sequence, scores: Sequence[float]):
    """Paper's 'choosing the best-trained model': argmax validation score
    (first index on ties, like ``jnp.argmax``)."""
    best = int(torch.argmax(torch.as_tensor(scores, dtype=torch.float32)))
    return models[best], best


# ------------------------------------------------------------ stacked forms
def weighted_sum_stacked(stacked, w, *, out_dtype=None):
    """Σ_i w_i · leaf[i] over the leading device axis, ``w [D]`` applied
    as-is; accumulates f32, casts each leaf to ``out_dtype`` (default: its
    own dtype)."""

    def agg(leaf):
        wb = w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.sum(wb * leaf.float(), dim=0).to(
            leaf.dtype if out_dtype is None else out_dtype)

    return tree_map(agg, stacked)


def aggregate_stacked(stacked, w, *, segment_ids=None,
                      num_segments: Optional[int] = None, scales=None,
                      out_dtype=None):
    """THE routed Eq. 1 reduce: Σ_i w_i · leaf[i], flat (→ ``[...]``) or
    per segment (→ ``[G, ...]``), ``w`` applied AS-IS (preweighted).
    ``scales`` (a tree of ``[D]`` float32) makes the leaves int8 codes,
    dequantized as ``q · scale`` first.

    Goes through the fused-aggregation kernel's wrapper: the CUDA kernel
    for tensors on the card, its plain version on the CPU."""
    from repro_torch.kernels.fused_aggregation import fused_aggregate
    return fused_aggregate(stacked, w, normalize=False,
                           segment_ids=segment_ids,
                           num_segments=num_segments, scales=scales,
                           out_dtype=out_dtype)


def weighted_average_stacked(stacked, weights, *, mask=None):
    """Eq. 1 directly on ``[D, ...]`` stacked params: normalize (mask-aware,
    zero-sum guarded), then reduce the device axis."""
    return weighted_sum_stacked(stacked, normalize_weights(weights, mask))


def fedavg_stacked(stacked, *, mask=None):
    """Uniform federated averaging over the stacked device axis."""
    D = tree_leaves(stacked)[0].shape[0]
    return weighted_average_stacked(stacked, torch.ones(D), mask=mask)


def opt_model_stacked(stacked, scores, *, mask=None):
    """'Best-trained model' on stacked params: ``(params_of_best, index)``
    for the argmax of the (masked) scores."""
    s = _f32(scores)
    if mask is not None:
        s = torch.where(_f32(mask, s.device) > 0, s,
                        torch.full_like(s, -float("inf")))
    best = int(torch.argmax(s))
    return tree_map(lambda leaf: leaf[best], stacked), best


def stacked_accuracy(eval_logits_fn, stacked_params, x, y) -> torch.Tensor:
    """Per-device accuracy ``[D]`` in one batched forward over shared
    images ``x [N, ...]`` and labels ``y [N]``."""
    preds = torch.argmax(eval_logits_fn(stacked_params, x), dim=-1)  # [D, N]
    return (preds == y.long()[None, :]).float().mean(dim=1)


def stack_models(models: Sequence):
    """Stack device models along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls), *models)


def unstack_models(stacked) -> List:
    """Inverse of ``stack_models``: ``[D, ...]`` tree → list of D trees."""
    D = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda a: a[d], stacked) for d in range(D)]
