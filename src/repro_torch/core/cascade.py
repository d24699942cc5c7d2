"""Cascades (``repro.core.cascade`` ported): the training cascade of the
massively distributed regime (paper §IV-D) and the selection cascade of
live traffic.

``cascade_train`` chains devices (each trains, hands its model to the
next); ``pipelined_cascade_schedule`` lays the chain out as a pipeline in
which link g trains micro-round r while link g+1 trains on r−1's model,
and ``pipelined_cascade_speedup`` is its analytic gain.

``cascade_decide`` is the selection cascade of ``core.stream``: a device
scores its queued requests with the acquisition scorer, and the
thresholds split them into served (confident: answered at the edge),
escalated (informative: labeled at the fog, joining the training pool)
and kept queued.  The port decides for every device of the fleet at once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.acquisition import select_topk


def cascade_train(params, devices: Sequence, *, acquisitions_per_link: int,
                  eval_set=None, rng_seed: int = 0):
    """The sequential cascade: link g (a ``federated.EdgeDevice``) runs its
    active learning from link g−1's model and hands the result on, drawing
    from a generator seeded ``rng_seed + 31·(g + 1)`` on its trainer's
    device.  Returns ``(final params, every link's params)``."""
    link_params = []
    for g, dev in enumerate(devices):
        gen = torch.Generator(device=dev.trainer.device).manual_seed(
            rng_seed + 31 * (g + 1))
        params = dev.run_active_learning(
            params, eval_set=eval_set, generator=gen,
            acquisitions=acquisitions_per_link)
        link_params.append(params)
    return params, link_params


@dataclass(frozen=True)
class CascadeSlot:
    micro_round: int
    link: int
    consumes_from: Optional[Tuple[int, int]]  # (link, micro_round) consumed


def pipelined_cascade_schedule(chain_len: int,
                               micro_rounds: int) -> List[List[CascadeSlot]]:
    """The pipeline: wall-clock step t runs every (link g, micro-round r)
    with g + r == t and r < micro_rounds; ``chain_len + micro_rounds − 1``
    steps against ``chain_len · micro_rounds`` for the blocking cascade.
    Returns each step's concurrently runnable slots."""
    steps: List[List[CascadeSlot]] = []
    for t in range(chain_len + micro_rounds - 1):
        group = []
        for g in range(chain_len):
            r = t - g
            if 0 <= r < micro_rounds:
                consumes = ((g - 1, r) if g > 0
                            else ((g, r - 1) if r > 0 else None))
                group.append(CascadeSlot(micro_round=r, link=g,
                                         consumes_from=consumes))
        steps.append(group)
    return steps


def pipelined_cascade_speedup(chain_len: int, micro_rounds: int) -> float:
    """Analytic speedup of the pipelined cascade over the blocking one."""
    return (chain_len * micro_rounds) / (chain_len + micro_rounds - 1)


def cascade_decide(scores: torch.Tensor, rank: torch.Tensor,
                   idx: torch.Tensor, labeled: torch.Tensor,
                   valid: torch.Tensor, serve_threshold: float,
                   escalate_threshold: float, escalate_k: int):
    """Serve / escalate / keep decisions over request queues ``[..., Q]``
    (one row a device).

    ``scores`` are the acquisition scores of the queued requests, ``rank``
    the selection order (the scores, or uniforms for the random arm),
    ``idx`` their dataset slots, ``labeled`` / ``valid`` bool masks
    (already in the training pool / a live queue entry).  Returns
    ``(serve [..., Q], escalated [..., Q], sel [..., k], sel_valid [...,
    k])``:

    * escalation candidates are valid, unlabeled and score at least
      ``escalate_threshold``; the ``escalate_k`` best by ``rank`` win (a
      stable descending sort: ties, the ``-inf`` of the ineligible among
      them, go to the lower position, as ``lax.top_k`` orders them), and
      a dataset slot queued twice is escalated once, at its best-ranked
      position;
    * of the rest, valid requests scoring at most ``serve_threshold`` are
      served;
    * everything else stays queued."""
    eligible = valid & ~labeled & (scores >= escalate_threshold)
    masked = torch.where(eligible, rank, torch.full_like(rank, -float("inf")))
    sel = select_topk(masked, escalate_k)
    sel_valid = torch.gather(eligible, -1, sel)
    sel_idx = torch.gather(idx, -1, sel)
    earlier = torch.tril(torch.ones((escalate_k, escalate_k), dtype=torch.bool,
                                    device=sel.device), -1)
    dup = ((sel_idx.unsqueeze(-1) == sel_idx.unsqueeze(-2)) & earlier
           & sel_valid.unsqueeze(-2)).any(-1)
    sel_valid = sel_valid & ~dup
    escalated = torch.zeros_like(valid).scatter(-1, sel, sel_valid)
    serve = valid & ~escalated & (scores <= serve_threshold)
    return serve, escalated, sel, sel_valid
