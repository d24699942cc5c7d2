"""Fault injection and aggregation guards for fault-tolerant fleets
(``repro.core.faults`` ported).

* **``FaultConfig``**: the injected fault surface.  Devices join and
  leave (a birth/death churn process), crash mid-round, lose uploads on
  the wire, ship corrupted deltas, or train a round on scrambled labels.
  The rates pack into one ``[N_RATES]`` vector (``rates_vector``).

* **``GuardConfig``**: the fog node's defence.  It rejects non-finite
  uploads and norm outliers (norm > ``norm_factor`` × the masked median
  of the round's finite arrival norms), dropping them from the Eq. 1
  weights (``policy="drop"``) or clipping them back to the threshold
  (``policy="clip"``).  A round that accepts nothing keeps the previous
  fog model.

* **Liveness**: churn is a ``[D]`` 0/1 float vector carried in
  ``EngineState.live``.  Dead slots are inert (params, optimizer state,
  pool, pending backlog, residual and staleness frozen; Eq. 1 normalizes
  over live arrivals only).  It evolves by the birth/death process
  (``update_liveness``) or follows a host schedule (``liveness_schedule``
  → ``run_rounds_fused(live_mask=...)``).

Randomness.  Every draw function takes its uniforms as arguments: JAX's
``bernoulli(key, p, shape)`` is ``uniform(key, shape) < p``, so a caller
that hands over the reference's uniforms gets its masks bit for bit.  A
round's draws come from one function, ``round_draws``, on the host with
numpy, from a stream of their own (seed ``FaultConfig.seed + 0x666C74`` at
the ABSOLUTE round index): the card and the CPU see the same fault trace,
and a resumed run replays the uninterrupted one.  It is another stream
than the reference's ``jax.random`` one; tests replace ``round_draws`` to
feed the reference's draws.

On the round-synchronous engine a crashed device loses its local round
(no commit, no upload).  ``restart_mult`` (``RATE_RESTART``) is the async
engine's crash latency and is validated here only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

CORRUPT_MODES = ("scale", "nan")
GUARD_POLICIES = ("off", "drop", "clip")

# Indices into the rates vector (``rates_vector``).
(RATE_DEATH, RATE_BIRTH, RATE_CRASH, RATE_DROP, RATE_CORRUPT,
 RATE_NOISE, RATE_CORRUPT_SCALE, RATE_RESTART) = range(8)
N_RATES = 8

# offset of the fault stream's seed from ``FaultConfig.seed``
FAULT_STREAM = 0x666C74


@dataclass(frozen=True)
class FaultConfig:
    """Injected fault surface of a fleet run (the reference's fields and
    defaults; every rate per device per round, in [0, 1]).

    ``death_rate`` / ``birth_rate``: the churn process, a live device
    leaves with ``death_rate`` and a dead slot (re)joins with
    ``birth_rate`` each round (both 0: drive churn from a host schedule,
    ``run_rounds_fused(live_mask=...)``).  ``crash_rate``: the device
    loses its local round.  ``restart_mult`` (>= 1): the async engine's
    crash latency multiplier.  ``drop_rate``: the upload is lost on the
    wire (the device believes it delivered).  ``corrupt_rate`` /
    ``corrupt_mode`` / ``corrupt_scale``: the received upload is
    multiplied by ``corrupt_scale`` (``"scale"``) or replaced by NaN
    (``"nan"``), after any codec; the device's error-feedback residual
    stays clean.  ``label_noise_rate``: the device trains the round on
    uniformly random labels.  ``seed``: the fault stream's seed,
    independent of the experiment seed."""

    death_rate: float = 0.0
    birth_rate: float = 0.0
    crash_rate: float = 0.0
    restart_mult: float = 3.0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_mode: str = "scale"
    corrupt_scale: float = 50.0
    label_noise_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for name in ("death_rate", "birth_rate", "crash_rate", "drop_rate",
                     "corrupt_rate", "label_noise_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} is a probability in [0, 1], "
                                 f"got {v}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt_mode {self.corrupt_mode!r}: "
                f"use {' | '.join(CORRUPT_MODES)}")
        if self.corrupt_scale <= 0.0:
            raise ValueError(
                f"corrupt_scale must be > 0, got {self.corrupt_scale}")
        if self.restart_mult < 1.0:
            raise ValueError(
                f"restart_mult must be >= 1, got {self.restart_mult}")

    @property
    def has_churn(self) -> bool:
        return self.death_rate > 0.0 or self.birth_rate > 0.0


@dataclass(frozen=True)
class GuardConfig:
    """Fog-side aggregation guards.  ``policy`` ``"drop"`` (rejected
    uploads get zero Eq. 1 weight), ``"clip"`` (norm outliers are scaled
    back to the threshold; non-finite uploads are dropped) or ``"off"``
    (the same as no guards).  ``norm_factor`` (> 1, default 8.0): an
    upload is an outlier when its L2 norm exceeds ``norm_factor`` × the
    median norm of the round's finite arrivals; an all-zero median
    disables outlier detection for the round."""

    policy: str = "drop"
    norm_factor: float = 8.0

    def __post_init__(self):
        if self.policy not in GUARD_POLICIES:
            raise ValueError(f"unknown guard policy {self.policy!r}: "
                             f"use {' | '.join(GUARD_POLICIES)}")
        if self.norm_factor <= 1.0:
            raise ValueError(
                f"norm_factor must be > 1 (it multiplies the median "
                f"arrival norm), got {self.norm_factor}")


def rates_vector(cfg: Optional[FaultConfig]) -> np.ndarray:
    """A ``FaultConfig`` as the ``[N_RATES] float32`` rates vector (zeros
    when faults are off)."""
    v = np.zeros((N_RATES,), np.float32)
    if cfg is not None:
        v[RATE_DEATH] = cfg.death_rate
        v[RATE_BIRTH] = cfg.birth_rate
        v[RATE_CRASH] = cfg.crash_rate
        v[RATE_DROP] = cfg.drop_rate
        v[RATE_CORRUPT] = cfg.corrupt_rate
        v[RATE_NOISE] = cfg.label_noise_rate
        v[RATE_CORRUPT_SCALE] = cfg.corrupt_scale
        v[RATE_RESTART] = cfg.restart_mult
    return v


class FaultDraws(NamedTuple):
    """One round's fault draws: uniforms in [0, 1) for the churn process
    (``u_death``, ``u_birth``, ``[D]``) and for the crash / drop / corrupt
    / label-noise masks (``u_faults``, ``[4, D]`` in that order), and the
    labels a label-noise burst trains on (``noisy_labels``, ``[D,
    n_pad]``)."""
    u_death: np.ndarray
    u_birth: np.ndarray
    u_faults: np.ndarray
    noisy_labels: np.ndarray


def round_draws(cfg: FaultConfig, round_idx: int, num_devices: int,
                n_pad: int, num_classes: int) -> FaultDraws:
    """Round ``round_idx``'s (absolute index) fault draws, with numpy from
    the seed ``(cfg.seed + FAULT_STREAM, round_idx)``: float32 uniforms
    and int64 labels in ``[0, num_classes)``."""
    rng = np.random.default_rng([cfg.seed + FAULT_STREAM, round_idx])
    D = num_devices
    return FaultDraws(rng.random(D, dtype=np.float32),
                      rng.random(D, dtype=np.float32),
                      rng.random((4, D), dtype=np.float32),
                      rng.integers(0, num_classes, (D, n_pad)))


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def update_liveness(live, u_death, u_birth, death_rate,
                    birth_rate) -> torch.Tensor:
    """One step of the churn process on the ``[D]`` 0/1 liveness vector:
    a live device survives unless ``u_death < death_rate``, a dead slot
    joins where ``u_birth < birth_rate`` (float32 comparisons)."""
    live = _f32(live)
    dev = live.device
    survive = ~(_f32(u_death, dev) < _f32(death_rate, dev))
    join = _f32(u_birth, dev) < _f32(birth_rate, dev)
    return torch.where(live > 0, survive, join).float()


def liveness_schedule(num_devices: int, rounds: int, *, death_rate: float,
                      birth_rate: float, seed: int = 0,
                      init=None, group_ids=None) -> np.ndarray:
    """Host churn schedule ``[rounds, D]`` (0/1 float) for
    ``run_rounds_fused(live_mask=...)``: the same birth/death semantics as
    ``update_liveness``, from its own numpy stream (the reference's, draw
    for draw).  ``init`` (``[D]``, default all live) seeds round 0's
    transition.  ``group_ids`` (``[D]`` ints, e.g. ``FogTopology.ids``)
    draws once per fog group and broadcasts the draw to the group's slots:
    a fog node going dark takes its edge group with it."""
    rng = np.random.default_rng([seed, 0x6C697665])
    ids = None if group_ids is None else np.asarray(group_ids, np.int64)
    n_draw = num_devices if ids is None else int(ids.max()) + 1
    live = (np.ones((num_devices,), np.float32) if init is None
            else np.asarray(init, np.float32))
    out = np.zeros((rounds, num_devices), np.float32)
    for t in range(rounds):
        survive = rng.random(n_draw) >= death_rate
        join = rng.random(n_draw) < birth_rate
        if ids is not None:
            survive, join = survive[ids], join[ids]
        live = np.where(live > 0, survive, join).astype(np.float32)
        out[t] = live
    return out


def draw_fault_masks(u, rates):
    """This round's per-device fault masks ``(crash, drop, corrupt,
    noise)``, 0/1 float ``[D]``: ``u[j] < rate_j`` for the uniforms ``u
    [4, D]`` and the rates vector."""
    u = _f32(u)
    r = _f32(np.asarray(rates)[[RATE_CRASH, RATE_DROP, RATE_CORRUPT,
                                RATE_NOISE]], u.device)
    flags = (u < r[:, None]).float()
    return flags[0], flags[1], flags[2], flags[3]


def _rows_like(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def corrupt_stacked(mode: str, tree, flags, scale):
    """Wire corruption of the flagged rows (``flags [D]`` 0/1) of a stacked
    ``[D, ...]`` upload tree: ``"scale"`` multiplies them by ``scale``,
    ``"nan"`` replaces them with NaN; other rows pass through bitwise."""
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt_mode {mode!r}: "
                         f"use {' | '.join(CORRUPT_MODES)}")

    def leaf(x):
        f = _rows_like(_f32(flags, x.device), x) > 0
        if mode == "nan":
            return torch.where(f, torch.full_like(x, float("nan")), x)
        return torch.where(f, x * _f32(scale, x.device), x)

    return tree_map(leaf, tree)


def stacked_norms(tree) -> torch.Tensor:
    """Per-device L2 norm ``[D]`` over every leaf of a stacked tree."""
    leaves = tree_leaves(tree)
    sq = sum(torch.sum(torch.square(l.float()).reshape(l.shape[0], -1),
                       dim=1) for l in leaves)
    return torch.sqrt(sq)


def stacked_finite(tree) -> torch.Tensor:
    """Per-device all-finite flag ``[D] bool`` over a stacked tree."""
    leaves = tree_leaves(tree)
    ok = torch.ones((leaves[0].shape[0],), dtype=torch.bool,
                    device=leaves[0].device)
    for l in leaves:
        ok = ok & torch.isfinite(l.reshape(l.shape[0], -1)).all(dim=1)
    return ok


def _masked_median(norms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The LOWER median of ``norms [D]`` over each row of ``valid [G, D]``:
    the inf-filled sort's entry ``(count - 1) // 2``, clipped to the
    vector (inf when nothing is valid); ``[G]``."""
    filled = torch.where(valid, norms[None, :],
                         torch.full_like(norms, float("inf")))
    order = torch.sort(filled, dim=1).values
    count = valid.sum(dim=1, keepdim=True)
    idx = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), 0,
                      norms.shape[0] - 1)
    return torch.gather(order, 1, idx)[:, 0]


def guard_verdict(norms, finite, mask, *, policy: str, factor,
                  group_ids=None, num_groups: Optional[int] = None):
    """The fog node's guard decision over the round's received uploads.

    ``norms`` / ``finite`` are the ``[D]`` upload statistics, ``mask`` the
    received mask (1 = an upload reached the fog node), ``factor`` the
    outlier multiplier.  Returns ``(rejected, clipped, scale)`` ``[D]``
    float vectors: rejected uploads get zero weight (and their leaves
    zeroed), clipped ones (clip policy) are scaled by ``scale`` back to
    the threshold.  The median is ``_masked_median``'s over the finite
    arrivals, so an empty round has an infinite threshold.  With a fog
    topology (``group_ids [D]`` and ``num_groups``) each fog node takes
    the median of its own arrivals only; ``num_groups=1`` is the flat
    verdict exactly."""
    if policy not in ("drop", "clip"):
        raise ValueError(f"guard policy must be 'drop' or 'clip' here, "
                         f"got {policy!r}")
    norms = _f32(norms)
    m = _f32(mask, norms.device)
    finite = torch.as_tensor(finite, device=norms.device)
    valid = (m > 0) & finite & torch.isfinite(norms)
    if group_ids is None:
        med = _masked_median(norms, valid[None, :])[0]
    else:
        if num_groups is None:
            raise ValueError("group_ids requires a static num_groups")
        ids = torch.as_tensor(group_ids, device=norms.device).long()
        member = ids[None, :] == torch.arange(num_groups,
                                              device=norms.device)[:, None]
        med = _masked_median(norms, valid[None, :] & member)[ids]
    thresh = _f32(factor, norms.device) * med
    # an all-zero median leaves nothing to compare against
    outlier = valid & (med > 0) & (norms > thresh)
    nonfinite = (m > 0) & ~(finite & torch.isfinite(norms))
    if policy == "drop":
        rejected = nonfinite | outlier
        clipped = torch.zeros_like(outlier)
        scale = torch.ones_like(m)
    else:
        rejected = nonfinite
        clipped = outlier
        scale = torch.where(outlier,
                            thresh / torch.clamp(norms, min=1e-30),
                            torch.ones_like(m))
    return rejected.float(), clipped.float(), scale.float()


# ------------------------------------------------------------- telemetry
# Per-device [T, D] rows the fused rounds record when the matching feature
# is on; the drivers copy them into the per-round reports.
REPORT_KEYS = ("live", "crashed", "dropped", "corrupted", "rejected",
               "clipped")


def _host(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.detach().cpu().numpy()
    return np.asarray(rows)


def summarize_faults(recs) -> dict:
    """Fault and guard telemetry from the fused recs (or any dict of
    stacked ``[T, D]`` rows): per-round live fractions and the crash /
    drop / corrupt / reject / clip totals of the keys present."""
    out: dict = {}
    if "live" in recs:
        live = _host(recs["live"]).astype(np.float64)
        out["live_fraction_per_round"] = [float(x) for x in live.mean(1)]
        out["mean_live_fraction"] = float(live.mean())
    for key in ("crashed", "dropped", "corrupted", "rejected", "clipped"):
        if key in recs:
            out[f"{key}_total"] = int(_host(recs[key]).sum())
    return out


def report_summary(round_reports) -> dict:
    """``summarize_faults`` over the per-round report dicts
    ``run_federated_rounds`` returns (a churn repeat's ``"faults"``
    entry)."""
    stacked: dict = {}
    for key in REPORT_KEYS:
        if round_reports and key in round_reports[0]:
            stacked[key] = [r[key] for r in round_reports]
    return summarize_faults(stacked)
