"""Split a dataset across edge devices (a copy of
``repro.data.federated_split``, byte-equal for the same seed).

The paper: "we randomly shuffle the whole training dataset, split it and
distribute them to edge devices. All the sub-dataset contains 10 classes,
with different proportions" — i.e. same distribution, unbalanced. We provide
that (``federated_split``) plus a Dirichlet non-IID splitter for
beyond-paper heterogeneity experiments.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.digits import SyntheticDigits


def _partition_sizes(raw: np.ndarray, n: int) -> np.ndarray:
    """Integer shard sizes ∝ ``raw`` with every size >= 1 and sum == n.

    The old floor-then-dump-remainder-on-the-last-shard sizing could make
    ``sizes[-1]`` zero or negative under high unbalance or when
    ``num_devices`` approaches ``len(ds)`` (the floors of D-1 shards can
    overshoot n − 1); requires n >= len(raw).
    """
    num = len(raw)
    sizes = np.maximum(np.floor(raw / raw.sum() * n).astype(int), 1)
    excess = int(sizes.sum()) - n
    if excess < 0:                       # floors undershot: top up the largest
        sizes[np.argmax(sizes)] += -excess
    order = np.argsort(-sizes)           # shed overshoot largest-first, never <1
    i = 0
    while excess > 0:
        d = order[i % num]
        if sizes[d] > 1:
            take = min(excess, sizes[d] - 1)
            sizes[d] -= take
            excess -= take
        i += 1
    assert sizes.sum() == n and sizes.min() >= 1, (sizes, n)
    return sizes


def federated_split(ds: SyntheticDigits, num_devices: int, *, seed: int = 0,
                    unbalance: float = 0.3,
                    class_skew: float = 2.0) -> List[SyntheticDigits]:
    """Shuffle + split with unbalanced sizes AND per-device class skew.

    The paper: "All the sub-dataset contains 10 classes, with different
    proportions". ``class_skew`` is the Dirichlet concentration of each
    device's class proportions (lower = more skew; ~2.0 keeps every class
    present but 2-4x over/under-represented — the regime where uncertainty
    sampling can rebalance and random sampling cannot).
    """
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    n = len(ds)
    if num_devices > n:
        raise ValueError(
            f"cannot split {n} samples over {num_devices} devices: every "
            f"device needs at least one sample (num_devices <= len(ds))")
    rng = np.random.default_rng(seed)
    raw = 1.0 + rng.uniform(-unbalance, unbalance, size=num_devices)
    # unbalance >= 1 can draw non-positive proportions; keep every device
    # a positive sliver instead of producing negative floor sizes
    raw = np.maximum(raw, 0.05)
    sizes = _partition_sizes(raw, n)

    idx_by_class = [list(rng.permutation(np.where(ds.labels == c)[0]))
                    for c in range(10)]
    out = []
    for d in range(num_devices):
        props = rng.dirichlet([class_skew] * 10)
        take = np.floor(props * sizes[d]).astype(int)
        take[np.argmax(take)] += sizes[d] - take.sum()
        chosen: List[int] = []
        for c in range(10):
            got = idx_by_class[c][:take[c]]
            idx_by_class[c] = idx_by_class[c][take[c]:]
            chosen.extend(got)
        # top up from whatever classes still have stock
        deficit = sizes[d] - len(chosen)
        for c in range(10):
            if deficit <= 0:
                break
            got = idx_by_class[c][:deficit]
            idx_by_class[c] = idx_by_class[c][deficit:]
            chosen.extend(got)
            deficit = sizes[d] - len(chosen)
        out.append(ds.subset(np.asarray(sorted(chosen), dtype=int)))
    return out


def dirichlet_split(ds: SyntheticDigits, num_devices: int, *, alpha: float = 0.5,
                    seed: int = 0) -> List[SyntheticDigits]:
    """Non-IID label-skew split: per-class proportions ~ Dir(alpha)."""
    rng = np.random.default_rng(seed)
    idx_by_class = [np.where(ds.labels == c)[0] for c in range(10)]
    device_idx = [[] for _ in range(num_devices)]
    for idx in idx_by_class:
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_devices)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for d, part in enumerate(np.split(idx, cuts)):
            device_idx[d].extend(part.tolist())
    return [ds.subset(np.array(sorted(ix), dtype=int)) for ix in device_idx]
