"""Live traffic for the async event loop, ``scenario="stream"``
(``repro.core.stream`` ported).

Unlabeled requests ARRIVE per device on the event loop's simulated clock:
over each event's gap ``Δt`` device i receives ``n ~ Poisson(rate_i · Δt ·
boost)`` requests (``process="det"`` rounds the mean instead), ``rate_i``
from ``device_arrival_rates`` (log-spaced hot / cold skew) and ``boost =
1 + burst·(E − 1)``, ``E ~ Exp(1)``, a mean-preserving overdispersion.
Requests are sampled from the device's shard under ``drift_logits``, a
tilt that rotates through the label space once a ``drift_period``.  Each
device holds a bounded FIFO queue of ``queue_cap`` slots (``queue_append``;
overflow drops and is counted).  Devices that commit a round score their
queue with the acquisition scorer and ``core.cascade.cascade_decide``
serves the confident requests locally, escalates the informative ones to
the fog (labeled there and added to the training pool; each one sample of
uplink, ``comms.sample_bytes``) and keeps the rest queued.
``core.async_engine.run_events_fused(stream=...)`` runs it.

Randomness.  The reference draws in-trace from ``jax.random`` keys folded
at the absolute event index; the port cannot replay those bits.  So an
event's stream draws are made by one function, ``stream_draws``, with
numpy from the seed ``(StreamConfig.seed + STREAM_SEED, absolute event)``
at the whole fleet's shape ``[D, ...]`` (a sharded run slices its rows):
the burst factors, the arrival counts, the picks, and the rank and score
uniforms.  Tests replace it to feed the reference's draws.  The queue's
MC-dropout masks come from a torch generator of their own
(``EdgeEngine.stream_generator``), never from the round's, so zero
traffic replays the plain event loop bit for bit.  The reference's
``stream_keys``, ``draw_arrival_count`` and ``stream_static_key`` (keys,
an in-trace draw and a jit cache key) have no counterpart: ``stream_draws``
takes their place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comms as comms_mod
from repro_torch.core.faults import _host

PROCESSES = ("poisson", "det")
SELECTIONS = ("score", "random")

#: per-event rows every stream run emits (scalars except ``queue_depth``,
#: a per-device ``[D]`` row): the report-schema contract
STREAM_REPORT_KEYS = ("offered", "stream_dropped", "served",
                      "serve_correct", "escalated", "queue_depth")

# offset of the stream's seed from ``StreamConfig.seed`` (the reference's)
STREAM_SEED = 0x737472


@dataclass(frozen=True)
class StreamConfig:
    """Policy of live traffic on the async event loop (the reference's
    fields, defaults and messages).

    Traffic, in requests per SIMULATED second per device: ``arrival_rate``
    (>= 0, default 1.0) the fleet's geometric-mean rate, 0 no traffic;
    ``device_rates`` explicit per-device rates (D floats, overriding
    ``arrival_rate`` and ``rate_skew``); ``rate_skew`` (>= 1, default 1.0)
    hottest / coldest, log-spaced with device 0 coldest; ``burst`` (>= 0,
    default 0.0) the overdispersion ``rate·(1 + burst·(E − 1))``;
    ``process`` ``"poisson" | "det"`` (``det`` rounds ``rate·Δt``);
    ``queue_cap`` (>= 1, default 16) pending requests a device, overflow
    dropped; ``max_arrivals`` (>= 1, default 8) arrivals an event, counts
    above it dropped.

    Cascade (scores are the acquisition scorer's, entropy in nats):
    ``serve_threshold`` (default 0.5) serves requests scoring at most
    this; ``escalate_threshold`` (default 1.0) makes requests scoring at
    least this escalation candidates, of which the top ``escalate_k`` (in
    [1, queue_cap], default 1) a device an event are labeled;
    ``selection`` ``"score" | "random"`` (``random`` spends the same
    budget on uniformly random queued requests, the control arm).

    Drift: ``drift_kappa`` (>= 0, default 0.0) the tilt's concentration,
    ``drift_period`` (simulated seconds, > 0 when ``drift_kappa`` > 0) one
    rotation through the labels.  ``seed`` (default 0) the stream's own,
    independent of the experiment and latency seeds."""

    arrival_rate: float = 1.0
    device_rates: Optional[Tuple[float, ...]] = None
    rate_skew: float = 1.0
    burst: float = 0.0
    process: str = "poisson"
    queue_cap: int = 16
    max_arrivals: int = 8
    serve_threshold: float = 0.5
    escalate_threshold: float = 1.0
    escalate_k: int = 1
    selection: str = "score"
    drift_kappa: float = 0.0
    drift_period: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.arrival_rate < 0.0:
            raise ValueError(
                f"arrival_rate must be >= 0 requests/simulated second, "
                f"got {self.arrival_rate}")
        if self.rate_skew < 1.0:
            raise ValueError(
                f"rate_skew is hottest/coldest >= 1, got {self.rate_skew}")
        if self.burst < 0.0:
            raise ValueError(f"burst must be >= 0, got {self.burst}")
        if self.process not in PROCESSES:
            raise ValueError(f"unknown arrival process {self.process!r}: "
                             f"use {' | '.join(PROCESSES)}")
        if self.queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {self.queue_cap}")
        if self.max_arrivals < 1:
            raise ValueError(
                f"max_arrivals must be >= 1, got {self.max_arrivals}")
        if not 1 <= self.escalate_k <= self.queue_cap:
            raise ValueError(
                f"escalate_k must be in [1, queue_cap={self.queue_cap}], "
                f"got {self.escalate_k}")
        if self.selection not in SELECTIONS:
            raise ValueError(f"unknown selection {self.selection!r}: "
                             f"use {' | '.join(SELECTIONS)}")
        if self.drift_kappa < 0.0:
            raise ValueError(
                f"drift_kappa must be >= 0, got {self.drift_kappa}")
        if self.drift_kappa > 0.0 and self.drift_period <= 0.0:
            raise ValueError(
                "drift_kappa > 0 needs drift_period > 0 simulated seconds")


def device_arrival_rates(cfg: StreamConfig, num_devices: int) -> np.ndarray:
    """Per-device arrival rates ``[D] float32``, requests a simulated
    second: ``cfg.device_rates`` (shape-checked), else log-spaced over
    ``[rate/√skew, rate·√skew]`` with device 0 coldest."""
    if cfg.device_rates is not None:
        rates = np.asarray(cfg.device_rates, np.float32)
        if rates.shape != (num_devices,):
            raise ValueError(f"device_rates shape {rates.shape} != "
                             f"({num_devices},)")
        if (rates < 0).any():
            raise ValueError("device_rates must be >= 0 requests/second")
        return rates
    if cfg.rate_skew == 1.0 or num_devices == 1:
        return np.full((num_devices,), cfg.arrival_rate, np.float32)
    half = np.sqrt(cfg.rate_skew)
    return (cfg.arrival_rate
            * np.geomspace(1.0 / half, half, num_devices)).astype(np.float32)


def drift_logits(labels, valid, kappa, period, t,
                 num_classes: int) -> np.ndarray:
    """Categorical logits ``[..., n_pad] float32`` over each device's
    dataset slots under temporal label drift: ``κ·cos(2π·(y/C −
    t/period))``, so the favoured class rotates through all ``C`` labels
    once a ``period`` simulated seconds; ``κ = 0`` is uniform over the
    shard, and padding slots (``valid`` False) get ``-inf``.  Host numpy
    in float32, as the reference computes it."""
    f32 = np.float32
    kappa, period, t = f32(kappa), f32(period), f32(t)
    phase = t / max(period, f32(1e-9)) if period > 0 else f32(0.0)
    ang = f32(2.0 * np.pi) * (np.asarray(labels).astype(f32)
                              / f32(num_classes) - phase)
    return np.where(np.asarray(valid), kappa * np.cos(ang),
                    f32(-np.inf)).astype(f32)


class StreamDraws(NamedTuple):
    """One event's stream draws for the whole fleet (numpy, ``[D, ...]``)."""
    boost: np.ndarray    # [D] float32 burst factors 1 + burst·(E − 1)
    counts: np.ndarray   # [D] int64 arrival counts (before the cap)
    picks: np.ndarray    # [D, max_arrivals] int64 dataset slots
    rank_u: np.ndarray   # [D, queue_cap] float32 random-selection ranks
    score_u: np.ndarray  # [D, queue_cap] float32 random-acquisition scores


def stream_draws(cfg: StreamConfig, event_idx: int, lam,
                 logits) -> StreamDraws:
    """Event ``event_idx``'s (absolute index) stream draws, with numpy
    from the seed ``(cfg.seed + STREAM_SEED, event_idx)``, given each
    device's mean arrivals before the burst ``lam = rate·Δt [D] float32``
    and the pick logits ``[D, n_pad]`` (``drift_logits``).  The counts are
    Poisson at ``lam·boost`` (float32, as the reference multiplies), or
    that mean rounded half to even for ``"det"``; the picks are
    categorical over each row's logits (inverse CDF), never a ``-inf``
    slot of a row that has a finite one."""
    rng = np.random.default_rng([cfg.seed + STREAM_SEED, event_idx])
    lam = np.asarray(lam, np.float32)
    D = lam.shape[0]
    A, Q = cfg.max_arrivals, cfg.queue_cap
    e = rng.standard_exponential(D, dtype=np.float32)
    boost = (np.float32(1.0) + np.float32(cfg.burst) * (e - np.float32(1.0))
             ).astype(np.float32)
    mean = np.maximum(lam * boost, np.float32(0.0))
    counts = (np.round(mean).astype(np.int64) if cfg.process == "det"
              else rng.poisson(mean.astype(np.float64)).astype(np.int64))
    logits = np.asarray(logits, np.float64)
    top = logits.max(axis=1, keepdims=True)
    p = np.where(np.isfinite(logits),
                 np.exp(logits - np.where(np.isfinite(top), top, 0.0)), 0.0)
    cdf = np.cumsum(p, axis=1)
    cdf = cdf / np.maximum(cdf[:, -1:], np.finfo(np.float64).tiny)
    u = 1.0 - rng.random((D, A))                        # (0, 1]
    picks = (cdf[:, None, :] < u[:, :, None]).sum(axis=2)
    picks = np.minimum(picks, logits.shape[1] - 1).astype(np.int64)
    rank_u = rng.random((D, Q), dtype=np.float32)
    score_u = rng.random((D, Q), dtype=np.float32)
    return StreamDraws(boost, counts, picks, rank_u, score_u)


def queue_append(q_idx: torch.Tensor, q_valid: torch.Tensor,
                 new_idx: torch.Tensor, new_valid: torch.Tensor):
    """Append an arrival batch to bounded FIFO queues, rows batched over
    any leading axes.

    ``(q_idx, q_valid) [..., Q]`` are the queues, ``(new_idx, new_valid)
    [..., A]`` the batch.  Live entries are compacted to the front in
    their order (a stable sort of the reference's unique key ``(~valid)·(Q
    + 1) + position``), arrivals fill the free tail in theirs, and the
    overflow past ``Q`` is dropped.  Returns ``(q_idx, q_valid, dropped
    [...])``; the write touches the in-range slots only (the reference's
    ``mode="drop"``: the rest scatter into a spare column that is cut
    off)."""
    Q = q_idx.shape[-1]
    pos = torch.arange(Q, device=q_idx.device)
    order = torch.argsort((~q_valid).long() * (Q + 1) + pos, dim=-1,
                          stable=True)
    q_idx = torch.gather(q_idx, -1, order)
    q_valid = torch.gather(q_valid, -1, order)
    n_q = q_valid.sum(-1, keepdim=True)
    slots = n_q + torch.cumsum(new_valid.long(), -1) - 1
    dropped = (new_valid & (slots >= Q)).sum(-1)
    target = torch.where(new_valid & (slots < Q), slots,
                         torch.full_like(slots, Q))
    spare = lambda x: torch.cat(
        [x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    q_idx = spare(q_idx).scatter(-1, target, new_idx.to(q_idx.dtype))[..., :Q]
    q_valid = spare(q_valid).scatter(
        -1, target, torch.ones_like(new_valid))[..., :Q]
    return q_idx, q_valid, dropped


def stream_telemetry(recs, image_shape=None) -> dict:
    """The traffic summary from the event recs: offered load, drops,
    serve accuracy, escalations, queue depths and, given the sample
    shape, the escalation uplink bytes (one ``comms.sample_bytes`` an
    escalated request)."""
    host = lambda k: _host(recs[k]).astype(np.float64)
    offered, dropped = host("offered"), host("stream_dropped")
    served, correct = host("served"), host("serve_correct")
    escal, depth = host("escalated"), host("queue_depth")
    out = {
        "events": int(offered.shape[0]),
        "offered_total": int(offered.sum()),
        "dropped_total": int(dropped.sum()),
        "drop_fraction": float(dropped.sum() / max(offered.sum(), 1.0)),
        "served_total": int(served.sum()),
        "serve_accuracy": float(correct.sum() / max(served.sum(), 1.0)),
        "escalated_total": int(escal.sum()),
        "escalation_fraction": float(escal.sum() / max(offered.sum(), 1.0)),
        "offered_per_event": [float(x) for x in offered],
        "escalated_per_event": [float(x) for x in escal],
        "mean_queue_depth": float(depth.mean()) if depth.size else 0.0,
        "max_queue_depth": int(depth.max()) if depth.size else 0,
    }
    if image_shape is not None:
        out["escalation_uplink_bytes"] = (
            int(escal.sum()) * comms_mod.sample_bytes(image_shape))
    return out


def report_stream_telemetry(round_reports, image_shape=None) -> dict:
    """``stream_telemetry`` over the per-event reports of
    ``run_federated_rounds(engine="async", stream=...)`` (a stream
    repeat's ``"stream"`` entry)."""
    return stream_telemetry(
        {k: [r[k] for r in round_reports] for k in STREAM_REPORT_KEYS},
        image_shape=image_shape)
