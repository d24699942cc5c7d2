"""Hierarchical fog topology: two-tier edge × fog aggregation (paper §II;
``repro.core.topology`` ported).

The paper's architecture is cloud → fog → edge: fog nodes aggregate their
own edge group before anything moves upward.  ``FogTopology`` is that
tier as a static config:

* ``group_ids``: a ``[D]`` vector assigning every device slot to one of G
  fog groups;
* ``local_steps``: fog groups aggregate their own slots every round
  (intra-fog Eq. 1); the fog models cross the fog→cloud link only every
  ``local_steps``-th round (inter-fog Eq. 1);
* per-fog profiles: ``latency_scale`` (the async engine's latency
  multiplier a group), ``compute_scale`` (the share of the fit steps a
  group's slots get) and ``uplink_scale`` (relative per-byte uplink cost,
  accounting only).

Two-tier Eq. 1, both levels through ``aggregation.masked_normalize``:

    intra-fog:  F_g ← Σ_{i∈g} α_i W_i,   α = masked_normalize(w·accept | g)
    inter-fog:  W   ← Σ_g   β_g F_g,     β = masked_normalize(Σ_{i∈g} w·accept)

β_g is each group's share of the total arrival mass, so α_i·β_{g(i)} is
the flat weight: a sync round's global model is the flat engine's, and
``G = 1`` (β ≡ 1.0 exactly) reduces bit for bit to the flat run.

The host helpers are numpy, element for element the reference's.  The
tensor helpers take ``[D, ...]`` or ``[G, ...]`` trees on any device; the
intra-fog reduce of the engines goes through the fused-aggregation kernel
in its segment form (``aggregation.aggregate_stacked(segment_ids=...)``),
and ``segment_sum_stacked`` is its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import masked_normalize, segment_sum
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class FogTopology:
    """Static two-tier fleet layout: G fog groups over the ``[D]`` device
    axis (the reference's fields, defaults and messages).

    ``group_ids``: D ints in ``[0, num_groups)``, slot i reports to fog
    group ``group_ids[i]`` (``validate_for`` checks the length against
    the fleet).  ``num_groups``: G >= 1, every group owning at least one
    slot.  ``local_steps`` (>= 1, default 1): round t crosses the upper
    tier iff ``(t + 1) % local_steps == 0`` at the absolute round index.
    ``latency_scale`` / ``compute_scale`` / ``uplink_scale``: optional
    per-group profiles of G positive floats."""

    group_ids: Tuple[int, ...]
    num_groups: int
    local_steps: int = 1
    latency_scale: Optional[Tuple[float, ...]] = None
    compute_scale: Optional[Tuple[float, ...]] = None
    uplink_scale: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {self.num_groups}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        ids = np.asarray(self.group_ids, np.int64)
        if ids.size == 0:
            raise ValueError("group_ids must be non-empty")
        if ids.min() < 0 or ids.max() >= self.num_groups:
            raise ValueError(
                f"group_ids must lie in [0, {self.num_groups}), got range "
                f"[{ids.min()}, {ids.max()}]")
        present = np.unique(ids)
        if present.size != self.num_groups:
            missing = sorted(set(range(self.num_groups))
                             - set(present.tolist()))
            raise ValueError(f"every fog group needs at least one device "
                             f"slot; empty groups: {missing}")
        for name in ("latency_scale", "compute_scale", "uplink_scale"):
            prof = getattr(self, name)
            if prof is None:
                continue
            if len(prof) != self.num_groups:
                raise ValueError(f"{name} must have one entry per fog group "
                                 f"({self.num_groups}), got {len(prof)}")
            if min(prof) <= 0.0:
                raise ValueError(f"{name} entries must be > 0, got {prof}")

    def validate_for(self, num_devices: int) -> None:
        """Raise when the group-id vector does not cover the fleet."""
        if len(self.group_ids) != num_devices:
            raise ValueError(
                f"topology group_ids has length {len(self.group_ids)} but "
                f"the fleet has {num_devices} device slots")

    @property
    def ids(self) -> np.ndarray:
        return np.asarray(self.group_ids, np.int32)

    def group_sizes(self) -> np.ndarray:
        """``[G]`` slot count per fog group."""
        return np.bincount(self.ids, minlength=self.num_groups).astype(
            np.int32)

    def segment_ids(self, device) -> torch.Tensor:
        """The group ids as the int64 tensor on ``device`` that segment
        reduces and gathers index with."""
        return torch.as_tensor(self.ids, dtype=torch.int64, device=device)


def uniform_topology(num_devices: int, num_groups: int,
                     **kwargs) -> FogTopology:
    """Balanced contiguous grouping: slot i → group ``i·G // D`` (group
    sizes differ by at most one); ``uniform_topology(D, 1)`` is the
    flat-equivalent layout."""
    ids = (np.arange(num_devices, dtype=np.int64) * num_groups) // max(
        num_devices, 1)
    return FogTopology(group_ids=tuple(int(i) for i in ids),
                       num_groups=num_groups, **kwargs)


def sync_schedule(topo: FogTopology, rounds: int,
                  start_round: int = 0) -> np.ndarray:
    """``[rounds]`` float32 flags, 1.0 where the round crosses the
    fog→cloud tier, at absolute round indices from ``start_round`` (a
    chained or resumed run replays the uninterrupted cadence)."""
    t = start_round + np.arange(rounds, dtype=np.int64)
    return ((t + 1) % topo.local_steps == 0).astype(np.float32)


def first_slots(topo: FogTopology) -> np.ndarray:
    """``[G]`` int64: the first slot of each group, in group order (the
    engines rebuild the ``[G, ...]`` fog models from these rows)."""
    _, first_idx = np.unique(topo.ids, return_index=True)
    return first_idx.astype(np.int64)


def group_representatives(topo: FogTopology) -> np.ndarray:
    """``[D]`` float32 selector, 1.0 at the FIRST slot of each group."""
    first = np.zeros(topo.ids.shape[0], np.float32)
    first[first_slots(topo)] = 1.0
    return first


def topology_step_limits(topo: FogTopology, num_devices: int,
                         train_steps: int,
                         base: Optional[np.ndarray] = None
                         ) -> Optional[np.ndarray]:
    """Per-device step budgets ``[D]`` int32 from the per-group compute
    profile, capped by an existing per-device profile ``base`` (the
    elementwise min); ``base`` itself without a compute profile."""
    if topo.compute_scale is None:
        return base
    scale = np.asarray(topo.compute_scale, np.float64)[topo.ids]
    limits = np.clip(np.round(scale * train_steps), 1,
                     train_steps).astype(np.int32)
    if base is not None:
        limits = np.minimum(limits, np.asarray(base, np.int32))
    return limits


def topology_latency_means(topo: FogTopology,
                           means: np.ndarray) -> np.ndarray:
    """The per-fog latency profile applied to per-device latency means
    ``[D]`` (async engine), float32."""
    if topo.latency_scale is None:
        return np.asarray(means, np.float32)
    scale = np.asarray(topo.latency_scale, np.float32)[topo.ids]
    return np.asarray(means, np.float32) * scale


# ------------------------------------------------------------- tensor helpers
def segment_sum_stacked(stacked, coeff, ids, num_groups: int, *,
                        out_dtype=None):
    """Per-group Σ_{i∈g} coeff_i · leaf[i] → ``[G, ...]`` per leaf (the
    intra-fog Eq. 1 reduce in plain PyTorch), float32 accumulation, each
    leaf cast to ``out_dtype`` (default: its own dtype)."""
    ids = torch.as_tensor(ids).long()

    def red(leaf):
        cb = coeff.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out = torch.zeros((num_groups,) + tuple(leaf.shape[1:]),
                          dtype=torch.float32, device=leaf.device)
        out.index_add_(0, ids.to(leaf.device), cb * leaf.float())
        return out.to(leaf.dtype if out_dtype is None else out_dtype)

    return tree_map(red, stacked)


def group_reduce_stacked(fog_stacked, beta):
    """Inter-fog Eq. 1: Σ_g β_g · F_g over the leading ``[G, ...]`` axis,
    float32, each leaf back to its dtype."""

    def red(leaf):
        bb = beta.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.sum(bb * leaf.float(), dim=0).to(leaf.dtype)

    return tree_map(red, fog_stacked)


def take_group_rows(fog_stacked, ids):
    """Dispatch: slot i reads its fog group's model, ``[G, ...]`` →
    ``[D, ...]`` by one ``index_select`` a leaf (``ids`` int64 on the
    leaves' device)."""
    return tree_map(lambda leaf: torch.index_select(leaf, 0, ids),
                    fog_stacked)


def two_tier_weights(raw_decayed, accept, ids, num_groups: int):
    """Both Eq. 1 levels' coefficients from one weight basis
    ``raw_decayed [D]`` and the arrival mask ``accept [D]``:
    ``(alpha [D], beta [G], group_any [G] bool)``.  α sums to 1 in each
    group (the per-segment guards of ``masked_normalize``), β is each
    group's share of the total arrival mass, ``group_any`` says whether
    the group accepted anything (a silent group keeps its fog model)."""
    w = torch.as_tensor(raw_decayed, dtype=torch.float32)
    a = torch.as_tensor(accept, dtype=torch.float32, device=w.device)
    ids = torch.as_tensor(ids, device=w.device).long()
    alpha = masked_normalize(w, a, segment_ids=ids, num_segments=num_groups)
    mass = segment_sum(w * a, ids, num_groups)
    group_any = segment_sum(a, ids, num_groups) > 0
    beta = masked_normalize(mass, group_any.float())
    return alpha, beta, group_any
