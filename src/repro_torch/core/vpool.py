"""Fixed-capacity masked active pool over a leading device axis
(``repro.core.vpool`` ported).

Every field carries the device axis ``D`` first:

  * ``labeled_mask [D, n_pad] bool`` — True = already labeled OR padding.
  * ``labeled_idx  [D, capacity] int32`` — dataset indices in acquisition
    order (-1 where unused); the training gather is ``images[labeled_idx]``
    with ``labeled_valid`` as the loss mask.
  * ``n_filled [D] int32`` — slots consumed so far (k per acquisition;
    invalid picks are appended masked-out, as in the reference).

The window draw is the reference's: uniform scores on unlabeled points, -1
on labeled/pad slots, top-``window`` — a uniform random subset of the
unlabeled pool.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.sharding import rand_rows


class VPool(NamedTuple):
    labeled_mask: torch.Tensor   # bool [D, n_pad]
    labeled_idx: torch.Tensor    # int32 [D, capacity]
    labeled_valid: torch.Tensor  # bool [D, capacity]
    n_filled: torch.Tensor       # int32 [D]


def vpool_init(valid: torch.Tensor, capacity: int) -> VPool:
    """``valid [D, n_pad] bool`` marks real (non-padding) dataset slots."""
    D, dev = valid.shape[0], valid.device
    return VPool(
        labeled_mask=~valid,
        labeled_idx=torch.full((D, capacity), -1, dtype=torch.int32,
                               device=dev),
        labeled_valid=torch.zeros((D, capacity), dtype=torch.bool, device=dev),
        n_filled=torch.zeros((D,), dtype=torch.int32, device=dev),
    )


def n_labeled(pool: VPool) -> torch.Tensor:
    return pool.labeled_valid.sum(dim=1, dtype=torch.int32)


def n_unlabeled(pool: VPool) -> torch.Tensor:
    return (~pool.labeled_mask).sum(dim=1, dtype=torch.int32)


def draw_window(pool: VPool, generator: torch.Generator, window: int):
    """Uniform random subsample of each device's unlabeled pool.

    Returns ``(indices [D, window] int64, valid [D, window] bool)``; when
    fewer than ``window`` points remain unlabeled the tail is invalid.  A
    sharded fleet draws the uniforms at the global shape
    (``launch.sharding.rand_rows``)."""
    mask = pool.labeled_mask
    u = rand_rows(mask.shape, generator=generator, device=mask.device)
    scores = torch.where(mask, torch.full_like(u, -1.0), 1.0 + u)
    k = min(window, scores.shape[1])
    top, idx = torch.topk(scores, k, dim=1)
    pad = window - k
    if pad > 0:  # window larger than the whole dataset: tail is invalid
        top = torch.nn.functional.pad(top, (0, pad), value=-1.0)
        idx = torch.nn.functional.pad(idx, (0, pad))
    return idx, top > 0.0


def acquire(pool: VPool, window_idx: torch.Tensor, selected: torch.Tensor,
            selected_valid: torch.Tensor) -> VPool:
    """Mark ``window_idx[selected]`` labeled where ``selected_valid``.

    Always appends ``k = selected.shape[1]`` slots per device.  Invalid
    picks are DROPPED from the mask update (the reference's
    ``.at[].set(mode="drop")``: they scatter into a spare column that is cut
    off), and the slot write clamps its start to ``capacity - k`` like
    ``dynamic_update_slice``."""
    D, n_pad = pool.labeled_mask.shape
    k = selected.shape[1]
    chosen = torch.gather(window_idx, 1, selected)
    safe = torch.where(selected_valid, chosen, torch.full_like(chosen, n_pad))
    spare = torch.zeros((D, 1), dtype=torch.bool, device=chosen.device)
    mask = torch.cat([pool.labeled_mask, spare], dim=1)
    mask = mask.scatter(1, safe, True)[:, :n_pad]
    cap = pool.labeled_idx.shape[1]
    start = pool.n_filled.long().clamp(0, max(cap - k, 0))
    pos = start[:, None] + torch.arange(k, device=chosen.device)
    idx = pool.labeled_idx.scatter(1, pos, chosen.to(torch.int32))
    val = pool.labeled_valid.scatter(1, pos, selected_valid)
    return VPool(mask, idx, val, pool.n_filled + k)
