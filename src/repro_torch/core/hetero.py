"""Heterogeneous fleets: stragglers, staleness and per-device compute
(``repro.core.hetero`` ported).

Three ingredients, all consumed by ``EdgeEngine.run_rounds_fused(hetero=)``:

* **Compute profile**: per-device local fit step budgets
  (``device_step_limits``).  A slow device trains ``step_limit_i <
  train_steps_per_acq`` steps an acquisition: the trainer masks the
  updates past its budget (``Trainer.fit_steps(step_limit=)``), so the
  device contributes less-trained work, the fleet still trains in one
  batched pass, and the masked prefix equals a shorter fit.

* **Straggler model**: which devices ARRIVE at the fog node each round.
  Either a host schedule (an explicit ``[rounds, D]`` arrival mask, e.g.
  ``straggler_schedule``) or a Bernoulli draw at rate ``straggler_rate``
  (the engine's ``upload_fraction`` draw at ``1 - straggler_rate``).

* **Staleness-aware aggregation**: a straggler's delta is BUFFERED in
  ``EngineState.pending`` and folded in when it arrives, weighted down by
  its age: Eq. 1 with ``alpha_i ∝ n_i · decay(staleness_i)``
  (``aggregation.staleness_weights``).  The ages ride in
  ``EngineState.staleness``.

Under churn (``core.faults``) the staleness counters age only LIVE slots:
a dead slot's pending delta and age freeze with it, and a reborn slot
delivers its backlog decay-weighted by its frozen age.

With ``straggler_rate == 0``, no profile, and any ``decay``, the hetero
round is the synchronous fused round; with ``decay="none"`` and
``buffer_stale=False`` the weights reduce to ``fedavg_n`` over arrivals.
Everything here is host numpy, the reference's arrays element for element.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

DECAYS = ("none", "exp", "poly")


@dataclass(frozen=True)
class HeteroConfig:
    """Heterogeneity policy of an experiment (the reference's fields and
    defaults).

    ``straggler_rate`` in [0, 1) (default 0.0): a device's chance per round
    of missing the upload deadline; 0 = a synchronous fleet.  ``decay``
    ``"none" | "exp" | "poly"`` (default ``"exp"``): the staleness
    discount, ``exp`` → ``decay_rate**s``, ``poly`` → ``(1+s)**-decay_rate``,
    ``none`` → 1, ``s`` in whole rounds missed.  ``decay_rate`` > 0
    (default 0.5; at most 1 for ``exp``).  ``buffer_stale`` (default True)
    folds a straggler's buffered delta in on arrival instead of discarding
    it.  ``slow_fraction`` in [0, 1] (default 0.0) of the fleet is limited
    to ``slow_steps_fraction`` in (0, 1] (default 0.5) of the local fit
    steps (at least 1).  ``step_limits`` (D ints, default None): explicit
    per-device step budgets, which win over ``slow_fraction`` and are
    clipped to ``[1, train_steps_per_acq]``.  ``seed`` (default 0) fixes
    the slow-device draw, independent of the experiment seed."""

    straggler_rate: float = 0.0
    decay: str = "exp"
    decay_rate: float = 0.5
    buffer_stale: bool = True
    slow_fraction: float = 0.0
    slow_steps_fraction: float = 0.5
    step_limits: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.straggler_rate < 1.0:
            raise ValueError(
                f"straggler_rate must be in [0, 1), got {self.straggler_rate}")
        if self.decay not in DECAYS:
            raise ValueError(f"unknown decay {self.decay!r}: "
                             f"use {' | '.join(DECAYS)}")
        if self.decay_rate <= 0.0:
            raise ValueError(f"decay_rate must be > 0, got {self.decay_rate}")
        if self.decay == "exp" and self.decay_rate > 1.0:
            raise ValueError(
                f"exp decay_rate is the per-round factor gamma in (0, 1], "
                f"got {self.decay_rate}")
        if not 0.0 <= self.slow_fraction <= 1.0:
            raise ValueError(
                f"slow_fraction must be in [0, 1], got {self.slow_fraction}")
        if not 0.0 < self.slow_steps_fraction <= 1.0:
            raise ValueError(f"slow_steps_fraction must be in (0, 1], "
                             f"got {self.slow_steps_fraction}")
        if self.step_limits is not None and min(self.step_limits) < 1:
            raise ValueError("step_limits must all be >= 1")

    @property
    def has_compute_profile(self) -> bool:
        return self.step_limits is not None or self.slow_fraction > 0.0


def device_step_limits(cfg: HeteroConfig, num_devices: int,
                       train_steps: int) -> Optional[np.ndarray]:
    """Per-device local fit step budgets ``[D] int32``, or None (uniform).

    Explicit ``cfg.step_limits`` win (clipped to ``[1, train_steps]``);
    otherwise a ``slow_fraction`` subset of the fleet, drawn from
    ``cfg.seed``, is limited to ``slow_steps_fraction`` of the steps."""
    if cfg.step_limits is not None:
        limits = np.asarray(cfg.step_limits, np.int32)
        if limits.shape != (num_devices,):
            raise ValueError(f"step_limits shape {limits.shape} != "
                             f"({num_devices},)")
        return np.clip(limits, 1, train_steps)
    if cfg.slow_fraction > 0.0:
        rng = np.random.default_rng([cfg.seed, 0x5745])
        slow = rng.random(num_devices) < cfg.slow_fraction
        slow_steps = max(1, int(round(cfg.slow_steps_fraction * train_steps)))
        return np.where(slow, slow_steps, train_steps).astype(np.int32)
    return None


def straggler_schedule(num_devices: int, straggler_rate: float, seed: int,
                       rounds: int) -> np.ndarray:
    """Host arrival schedule ``[rounds, D]`` (1 = arrived on time), the
    same straggler pattern for every engine and both packages."""
    rng = np.random.default_rng([seed, 0x73747261])
    return (rng.random((rounds, num_devices)) >= straggler_rate).astype(
        np.float32)


def expected_staleness(straggler_rate: float) -> float:
    """Mean staleness of an arriving buffered delta at straggler rate
    ``p``: a geometric number of missed rounds, p/(1-p)."""
    return straggler_rate / max(1.0 - straggler_rate, 1e-12)


def summarize_staleness(staleness_recs: Sequence) -> dict:
    """Round-by-round staleness telemetry from the fused recs
    (``recs["staleness"]`` ``[rounds, D]``: each round's ages before
    aggregation, the ones the Eq. 1 decay weighted)."""
    s = np.asarray(staleness_recs)
    return {
        "mean": float(s.mean()),
        "max": int(s.max()),
        "per_round_mean": [float(m) for m in s.mean(axis=1)],
        "stale_fraction": float((s > 0).mean()),
    }
