"""Rounds-free async aggregation: the fog node's event loop
(``repro.core.async_engine`` ported, flat form: one fog node).

Devices finish whenever they finish.  Each draws a completion latency, in
SIMULATED seconds, for every local round it is dispatched
(``AsyncConfig.dist``: exponential, lognormal or deterministic, around a
per-device mean from ``device_latency_means``).  The fog node aggregates
at ``t_event = min(K-th smallest completion time, t_last + timer)``:
``quorum=1`` is FedAsync, ``quorum=K`` FedBuff, a ``timer`` alone a
wall-clock cadence.  Arrivals fold their banked deltas into the fog model
with ``αᵢ ∝ rawᵢ·decay(stalenessᵢ)`` (``aggregation.staleness_weights``),
staleness counted in model versions, and are dispatched again.

The reference compiles the whole loop into one ``lax.scan``.  The port
runs it as a Python loop over events: the event queue (the ``[D]``
completion times, dispatch flags, liveness and staleness, and the clock)
is host numpy, and each event's device work is one candidate round over
the whole fleet (the acquisition-score kernel scores it), masked to the
dispatched rows, then Eq. 1 over the arrivals through the
fused-aggregation kernel.  An event that accepts nothing launches no
reduce and keeps the fog model.

Randomness.  JAX's latency draws cannot be replayed in torch, so one
function, ``latency_draws``, makes an event's standard draws with numpy
from the seed ``(AsyncConfig.seed + LATENCY_STREAM, absolute event
index)``, and ``scale_latency`` scales them by the means in float32 as the
reference's ``_draw_latency`` does.  Fault draws come from
``faults.round_draws`` at the absolute event index (the reference splits
its per-event fault key as it splits a round's).  Tests replace both
functions to feed the reference's draws.  The candidate round draws from
``state.rng`` at event 0 and from ``device_generator(start_event + t)``
after, as ``run_rounds_fused`` does, and the returned state carries
``device_generator(start_event + events)``; the int8 codec draws from
``comms_generator(start_event + t)``.

With ``mean_latency=0`` and ``quorum >= D`` every event is a full barrier
and the loop equals ``EdgeEngine.run_rounds_fused`` within 1e-5 (delta
form against the direct reduce).  A fog topology (``topology=``) carries
a ``[G, ...]`` stack of fog models: arrivals fold into their own group
(the kernel's segment form) and every ``local_steps``-th event collapses
the tier.  Live traffic (``stream=``, ``core.stream``) adds step 2b:
requests arrive into bounded per-device queues over each event's
simulated gap, and the devices that committed a round score their queue
(the acquisition-score kernel again) and serve, escalate or keep each
request (``core.cascade.cascade_decide``).  ``fleet=``
(``core.fleet.FleetConfig``) bundles the options.

Under a mesh (``EdgeEngine(mesh=...)``) the event queue stays host numpy
and is the same on every rank: each computes the completion times,
dispatch and clock from the whole fleet's draws and gathered ``[D]``
vectors.  A rank runs the candidate round on its rows (draws at the global
shape, ``launch.sharding.rand_rows``), and each accepting event's reduce
sums the ranks' partial reduces, so every rank holds the same fog model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation as agg_mod
from repro_torch.core import comms as comms_mod
from repro_torch.core import counters, vpool
from repro_torch.core import faults as faults_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import hetero as hetero_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.cascade import cascade_decide
from repro_torch.core.engine import (CODEC_SPAN, EngineState, _on_fleet,
                                     _reduce, _rows, _slot0, _where_rows,
                                     copy_generator, score_logprobs)
from repro_torch.core.hetero import DECAYS
from repro_torch.core.model_adapter import excluded_paths
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_map_with_path)

DISTS = ("exp", "lognormal", "det")

_ASYNC_AGGREGATIONS = ("average", "weighted", "fedavg_n")

# offset of the latency stream's seed from ``AsyncConfig.seed``
LATENCY_STREAM = 0x6C6174


@dataclass(frozen=True)
class AsyncConfig:
    """Policy of the rounds-free event loop (the reference's fields,
    defaults and messages).

    Trigger, at least one of: ``quorum`` (int >= 1; aggregate once this
    many devices have completed, clipped to D; 1 = FedAsync) and ``timer``
    (> 0 simulated seconds after the previous event, possibly aggregating
    nothing).

    Latency, in simulated seconds: ``dist`` ``"exp" | "lognormal" |
    "det"`` (default ``"exp"``) around each device's mean; ``mean_latency``
    (>= 0, default 1.0) the fleet's geometric-mean latency;
    ``latency_skew`` (>= 1, default 1.0) slowest / fastest mean, log-spaced
    with device 0 fastest; ``device_means`` explicit per-device means (D
    floats, overriding both); ``sigma`` (> 0, default 0.5) the
    mean-preserving lognormal shape, ``mean·exp(σZ − σ²/2)``.

    Aggregation: ``decay`` / ``decay_rate`` the staleness discount in
    model versions (``exp`` → ``rate**s`` with rate in (0, 1], ``poly`` →
    ``(1+s)**-rate``, ``none`` → 1; default ``"poly"`` / 0.5, FedAsync's);
    ``mix_rate`` η in (0, 1] (default 1.0; 1.0 for the synchronous limit):
    ``W ← W + η·Σ αᵢ·Δᵢ``; ``seed`` (default 0) the latency stream's,
    independent of the experiment seed."""

    quorum: Optional[int] = None
    timer: Optional[float] = None
    dist: str = "exp"
    mean_latency: float = 1.0
    latency_skew: float = 1.0
    device_means: Optional[Tuple[float, ...]] = None
    sigma: float = 0.5
    decay: str = "poly"
    decay_rate: float = 0.5
    mix_rate: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.quorum is None and self.timer is None:
            raise ValueError(
                "AsyncConfig needs a trigger: set quorum (K completions), "
                "timer (simulated seconds), or both")
        if self.quorum is not None and self.quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {self.quorum}")
        if self.timer is not None and self.timer <= 0.0:
            raise ValueError(f"timer must be > 0 simulated seconds, "
                             f"got {self.timer}")
        if self.dist not in DISTS:
            raise ValueError(f"unknown latency dist {self.dist!r}: "
                             f"use {' | '.join(DISTS)}")
        if self.mean_latency < 0.0:
            raise ValueError(
                f"mean_latency must be >= 0, got {self.mean_latency}")
        if self.latency_skew < 1.0:
            raise ValueError(
                f"latency_skew is slowest/fastest >= 1, "
                f"got {self.latency_skew}")
        if self.sigma <= 0.0:
            raise ValueError(f"sigma must be > 0, got {self.sigma}")
        if self.decay not in DECAYS:
            raise ValueError(f"unknown decay {self.decay!r}: "
                             f"use {' | '.join(DECAYS)}")
        if self.decay_rate <= 0.0:
            raise ValueError(f"decay_rate must be > 0, got {self.decay_rate}")
        if self.decay == "exp" and self.decay_rate > 1.0:
            raise ValueError(
                f"exp decay_rate is the per-version factor gamma in (0, 1], "
                f"got {self.decay_rate}")
        if not 0.0 < self.mix_rate <= 1.0:
            raise ValueError(f"mix_rate must be in (0, 1], "
                             f"got {self.mix_rate}")


def device_latency_means(cfg: AsyncConfig, num_devices: int) -> np.ndarray:
    """Per-device mean completion latency ``[D] float32``, simulated
    seconds: ``cfg.device_means`` (shape-checked), else log-spaced over
    ``[mean/√skew, mean·√skew]`` with device 0 fastest."""
    if cfg.device_means is not None:
        means = np.asarray(cfg.device_means, np.float32)
        if means.shape != (num_devices,):
            raise ValueError(f"device_means shape {means.shape} != "
                             f"({num_devices},)")
        if (means < 0).any():
            raise ValueError("device_means must be >= 0 simulated seconds")
        return means
    if cfg.latency_skew == 1.0 or num_devices == 1:
        return np.full((num_devices,), cfg.mean_latency, np.float32)
    half = np.sqrt(cfg.latency_skew)
    return (cfg.mean_latency
            * np.geomspace(1.0 / half, half, num_devices)).astype(np.float32)


def latency_draws(cfg: AsyncConfig, event_idx: int,
                  num_devices: int) -> Optional[np.ndarray]:
    """Event ``event_idx``'s (absolute index) standard latency draws ``[D]
    float32``, with numpy from the seed ``(cfg.seed + LATENCY_STREAM,
    event_idx)``: exponential for ``"exp"``, normal for ``"lognormal"``,
    None for ``"det"``."""
    if cfg.dist == "det":
        return None
    rng = np.random.default_rng([cfg.seed + LATENCY_STREAM, event_idx])
    if cfg.dist == "exp":
        return rng.standard_exponential(num_devices, dtype=np.float32)
    return rng.standard_normal(num_devices, dtype=np.float32)


def scale_latency(cfg: AsyncConfig, draws, means) -> np.ndarray:
    """Completion latencies ``[D] float32`` from the standard ``draws``
    and the per-device ``means``, in float32 as the reference's
    ``_draw_latency``: ``means`` (det), ``means·z`` (exp), ``means·exp(σz
    − σ²/2)`` (lognormal).  A zero mean is zero latency under every
    dist."""
    means = np.asarray(means, np.float32)
    if cfg.dist == "det":
        return means.copy()
    z = np.asarray(draws, np.float32)
    if cfg.dist == "exp":
        return means * z
    sigma = np.float32(cfg.sigma)
    return means * np.exp(sigma * z
                          - np.float32(0.5 * cfg.sigma * cfg.sigma))


def _event_uploads(codec, pending, residual, arrived, excl, generator, *,
                   wire: bool):
    """An event's uploads ``pending (+ residual)`` over the leaves outside
    ``excl``, as the fog node receives them: ``(rows, scales)``, ``rows``
    a ``{path: [D, ...]}`` dict.  Without a codec the rows are the uploads
    themselves and ``scales`` None.  With one, each leaf is encoded in
    turn and the error-feedback ``residual`` (or None) updates IN PLACE
    from the clean payload on the ``arrived`` rows; the rows are then the
    wire payload (``wire``: int8 codes with ``scales``, or values at the
    wire dtype), or its float32 decoding."""
    res = None if residual is None else dict(tree_items(residual))
    rows, scales = {}, {}
    for path, pend in tree_items(pending):
        if path in excl:
            continue
        x = pend if res is None else pend + res[path]
        if codec is None:
            rows[path] = x
            continue
        # the profiler's span for the codec's own device work
        with torch.profiler.record_function(CODEC_SPAN):
            payload, scale = comms_mod.encode_rows(codec, x, generator)
            dec = (comms_mod.decode_rows(payload, scale)
                   if res is not None or not wire else None)
            if res is not None:
                res[path].copy_(torch.where(_rows(arrived, x) > 0, x - dec,
                                            res[path]))
        if wire:
            rows[path] = payload
            if scale is not None:
                scales[path] = scale
        else:
            rows[path] = dec
    return rows, (scales or None)


def _traffic(engine, stream, event_idx: int, t_next, lam, shards, queue,
             params, pool, commit_l):
    """Step 2b of an event: live traffic (``core.stream``).

    ``t_next`` is the end of the event's gap on the simulated clock (the
    drift's phase), ``lam [D]`` each device's mean arrivals over the gap
    before the burst (rate · Δt, 0 for a dead device), ``shards`` the
    whole fleet's ``(labels, valid)`` as host numpy, ``queue`` this
    rank's ``(idx, valid) [D_local, Q]``.  The arrivals (``stream_draws``,
    at the global shape, sliced) join the queues; every device scores
    its queue (through the acquisition-score kernel, or uniforms for
    ``acquisition_fn="random"``) and ``cascade_decide`` splits it; the
    decisions of devices that did not commit this event's round are
    dropped.  Escalations enter the pool
    through ``vpool.acquire`` on the rows that escalated something, and
    served and escalated requests leave the queue.  Returns ``(pool,
    queue, rows)``, ``rows`` the event's fleet sums and ``queue_depth
    [D]``."""
    fl, dev, trainer, cfg = (engine.fleet, engine.device, engine.trainer,
                             engine.cfg)
    loc, gather = fl.local, fl.gather
    to_dev = lambda a: torch.as_tensor(a, device=dev)
    labels, valid = shards
    A = stream.max_arrivals
    logits = stream_mod.drift_logits(labels, valid, stream.drift_kappa,
                                     stream.drift_period, t_next,
                                     trainer.adapter.num_classes)
    draws = stream_mod.stream_draws(stream, event_idx, lam, logits)
    n = np.clip(draws.counts, 0, A)
    ok = (np.arange(A)[None, :] < n[:, None]) & valid.any(axis=1)[:, None]
    q_idx, q_valid, dropped = stream_mod.queue_append(
        *queue, loc(to_dev(draws.picks)), loc(to_dev(ok)))

    rows = torch.arange(q_idx.shape[0], device=dev)[:, None]
    x_q = engine.images[rows, q_idx]
    preds = trainer.eval_logits(params, x_q).argmax(-1)
    if cfg.acquisition_fn == "random":
        scores = loc(to_dev(draws.score_u))
    else:
        scores = score_logprobs(cfg.acquisition_fn, trainer.score_logprobs(
            params, x_q, engine.stream_generator(stream, event_idx),
            cfg.mc_samples))
    # the thresholds as the float32 values the reference compares with
    f32 = lambda v: float(np.float32(v))
    if stream.selection == "random":
        # the control arm: the same budget on uniformly random requests
        rank, esc_thr = loc(to_dev(draws.rank_u)), -float("inf")
    else:
        rank, esc_thr = scores, f32(stream.escalate_threshold)
    serve, escal, sel, sel_ok = cascade_decide(
        scores, rank, q_idx, torch.gather(pool.labeled_mask, 1, q_idx),
        q_valid, f32(stream.serve_threshold), esc_thr, stream.escalate_k)
    committed = (commit_l > 0)[:, None]
    serve, escal, sel_ok = serve & committed, escal & committed, \
        sel_ok & committed
    n_esc = sel_ok.sum(1)
    # the fog labels the escalations; they train from the next dispatch
    pool = vpool.VPool(*_where_rows(
        n_esc, tuple(vpool.acquire(pool, q_idx, sel, sel_ok)), tuple(pool)))
    correct = torch.gather(engine.labels, 1, q_idx) == preds
    q_valid = q_valid & ~(serve | escal)
    total = lambda v: gather(v).sum().float()
    out = {"offered": torch.tensor(float(n.sum()), device=dev),
           "stream_dropped": total(dropped), "served": total(serve.sum(1)),
           "serve_correct": total((serve & correct).sum(1)),
           "escalated": total(n_esc),
           "queue_depth": gather(q_valid.sum(1)).float()}
    return pool, (q_idx, q_valid), out


@_on_fleet
def run_events_fused(engine, state: EngineState, events: int, *,
                     async_cfg: Optional[AsyncConfig] = None,
                     aggregation: str = "fedavg_n", comms=None,
                     start_event: int = 0, faults=None, guards=None,
                     topology=None, stream=None, hetero=None, fleet=None):
    """``events`` fog aggregation events of the rounds-free loop.

    ``engine`` is an ``EdgeEngine``; ``state`` an ``EngineState`` whose
    param rows are identical (the dispatch protocol every caller follows).
    ``aggregation`` ∈ average | weighted | fedavg_n (``optimal`` has no
    Eq. 1 weights to decay).  Each event:

    0. churn (with ``faults``, always the birth/death process): a dead
       device parks its completion time at ``+inf`` and loses its
       dispatch; a reborn one is dispatched with staleness 0;
    1. dispatched devices take the fog model (excluded leaves keep each
       device's own value) and a fresh optimizer state; the candidate
       round runs over the whole fleet and commits on ``dispatch · (1 −
       crash)``; committed rows bank ``params − base`` in ``pending``
       (excluded leaves 0); dispatched rows complete at ``t_now +
       latency`` (a crash multiplies it by ``faults.restart_mult``);
    2. ``t_event = min(K-th smallest completion, t_now + timer)``;
       arrivals are the finite completions at or before it;
    3. the uploads ``pending (+ residual)`` go through the ``comms``
       codec (error feedback on arrivals only, from the clean payload),
       then wire corruption and the ``guards``; ``α =
       staleness_weights(raw, staleness, accepted)`` and ``fog ← fog +
       mix_rate · Σ αᵢ·sentᵢ`` through the fused-aggregation kernel.  An
       event that accepts nothing zeroes its weights and keeps the fog
       model;
    4. arrivals clear ``pending``, reset their staleness and are
       dispatched next; live devices still in flight age one version when
       something was accepted; an infinite ``t_event`` freezes the clock.

    ``topology`` (``core.topology.FogTopology``): each slot is dispatched
    its group's fog model; on a fog-local event the accepted deltas fold
    into their own group, ``F_g ← F_g + mix_rate · Σ_{i∈g} αᵢ·sentᵢ``
    (the kernel's segment form; a silent group keeps its model, and no
    launch when nothing is accepted); every ``local_steps``-th event
    (absolute index) is a sync that sets every group to ``Σ_g β_g F_g +
    mix_rate · Σ wᵢ·sentᵢ`` (the flat update at G = 1, bit for bit).
    Staleness ages by the versions of the model a device was dispatched
    from (its group's on a fog-local event), guards take per-group
    medians, and the latency and compute profiles scale the latency means
    and step budgets.  The returned fog model is the ``[G, ...]`` stack,
    and ``agg_acc`` that of its slot-share mix.

    A call starts the clock at 0 with every device dispatched and
    staleness 0 (chaining restarts it: work in flight at the end of a call
    is re-run, not delivered); pass ``start_event`` = events completed so
    far so the draws do not repeat.  The returned state carries the
    generator of event ``start_event + events``, as ``resume_state(
    next_round=start_event + events)`` would install it.  ``hetero`` contributes its compute
    profile (step limits) only; ``straggler_rate > 0`` is refused, the
    latency model being the straggler model.

    Returns ``(state, recs, fog_params)``: ``recs`` holds ``[events, ...]``
    rows ``weights``, ``upload_mask`` (the arrivals), ``n_labeled``,
    ``staleness`` (before aggregation), ``sim_time``, ``arrivals``,
    ``timer_fired``, and ``device_accs`` / ``agg_acc`` with a test set;
    ``live`` under churn, ``crashed`` / ``dropped`` / ``corrupted`` with
    faults, ``rejected`` / ``clipped`` / ``upload_norms`` / ``accepted``
    with guards; ``fog_sync``, ``beta`` and ``group_accept`` with a
    topology.  ``state.pending`` holds the deltas still in flight and
    ``state.staleness`` their ages.

    ``stream`` (``core.stream.StreamConfig``) runs live traffic, step 2b
    between the candidate round and step 3 (``_traffic``): requests
    arrive over the event's gap ``[t_now, t_event]`` (``t_now`` when
    ``t_event`` is infinite) into per-device queues that start empty each
    call, and the committed devices serve, escalate into their pool, or
    keep them.  This event's escalations count in step 3's labeled counts.
    The recs gain the fleet sums ``offered``, ``stream_dropped``,
    ``served``, ``serve_correct`` and ``escalated`` and the ``queue_depth
    [D]`` row (``core.stream.stream_telemetry`` summarizes them); the
    pool must hold ``escalate_k`` more slots an event.  With zero traffic
    the run equals the plain one bit for bit.

    ``fleet`` (``core.fleet.FleetConfig``) bundles ``comms``,
    ``async_cfg``, ``faults``, ``guards``, ``topology``, ``stream`` and
    ``hetero`` in one value; the per-feature options keep working, and
    mixing the two forms warns (the options win, field by field)."""
    fleet = fleet_mod.resolve_fleet(
        fleet, "run_events_fused",
        allowed=("comms", "async_cfg", "faults", "guards", "topology",
                 "stream", "hetero"),
        comms=comms, async_cfg=async_cfg, faults=faults, guards=guards,
        topology=topology, stream=stream, hetero=hetero)
    comms, async_cfg, faults = fleet.comms, fleet.async_cfg, fleet.faults
    guards, topology, stream = fleet.guards, fleet.topology, fleet.stream
    hetero = fleet.hetero
    if async_cfg is None:
        raise ValueError("run_events_fused needs an AsyncConfig "
                         "(async_cfg= or fleet.async_cfg)")
    if aggregation not in _ASYNC_AGGREGATIONS:
        raise ValueError(
            f"async aggregation must be one of "
            f"{' | '.join(_ASYNC_AGGREGATIONS)}, got {aggregation!r} "
            f"('optimal' has no Eq. 1 weights for staleness decay)")
    has_val = engine.test_images is not None
    if aggregation == "weighted" and not has_val:
        raise ValueError(
            "aggregation='weighted' scores devices on a validation set; "
            "construct EdgeEngine with test_set")
    if hetero is not None and hetero.straggler_rate > 0.0:
        raise ValueError(
            "hetero.straggler_rate has no event-time meaning: the async "
            "latency model IS the straggler model (AsyncConfig.dist / "
            "mean_latency / latency_skew / device_means).  Set "
            "straggler_rate=0 — only the compute profile (slow_fraction / "
            "step_limits) maps onto the event loop")
    if state.rng is None:
        raise ValueError("the state has no generator (a restored "
                         "checkpoint): call resume_state first")
    engine._check_capacity(
        state, rounds=events,
        extra_per_round=0 if stream is None else stream.escalate_k)
    if guards is not None and guards.policy == "off":
        guards = None
    D, dev, trainer = engine.num_devices, engine.device, engine.trainer
    # [D] vectors are global on every rank; [D, ...] trees hold the rank's
    # rows (``loc`` slices, ``gather`` assembles)
    fl = engine.fleet
    loc, gather = fl.local, fl.gather
    if topology is not None:
        topology.validate_for(D)
    limits = (None if hetero is None else hetero_mod.device_step_limits(
        hetero, D, engine.cfg.train_steps_per_acq))
    means = device_latency_means(async_cfg, D)
    if topology is not None:
        # a fog group's compute profile caps its slots' step budgets, and
        # its latency profile scales their latency means
        limits = topo_mod.topology_step_limits(
            topology, D, engine.cfg.train_steps_per_acq, base=limits)
        means = topo_mod.topology_latency_means(topology, means)
        G = topology.num_groups
        gid = topology.segment_ids(dev)
        gid_np = topology.ids
        syncs = topo_mod.sync_schedule(topology, events, start_event) > 0
        # the cloud-side estimate between syncs: the slot-share mix
        share = torch.as_tensor(topology.group_sizes(), dtype=torch.float32,
                                device=dev) / D
    step_limit = None if limits is None else loc(torch.as_tensor(
        limits, device=dev))
    codec = comms if comms is not None and comms.lossy else None
    guarded = faults is not None or guards is not None
    rates = faults_mod.rates_vector(faults)
    quorum = (None if async_cfg.quorum is None
              else min(max(async_cfg.quorum, 1), D))
    timer = None if async_cfg.timer is None else np.float32(async_cfg.timer)
    inf = np.float32(np.inf)

    # working buffers: the prologue dispatches every device at t = 0 with
    # staleness 0; pending starts at zeros unless carried, the residual
    # exists only with a lossy codec and error feedback, liveness only
    # with faults (updated in place, so never the caller's)
    zeros = lambda: tree_map(torch.zeros_like, state.params)
    residual = None
    if codec is not None and codec.error_feedback:
        residual = (tree_map(torch.clone, state.residual)
                    if tree_leaves(state.residual) else zeros())
    pending = state.pending if tree_leaves(state.pending) else zeros()
    live = None
    if faults is not None:
        live = (gather(state.live).detach().cpu().numpy().astype(np.float32)
                if tree_leaves(state.live) else np.ones((D,), np.float32))
    staleness = np.zeros((D,), np.int32)
    dispatch = np.ones((D,), np.float32)
    next_done = np.zeros((D,), np.float32)
    t_now = np.float32(0.0)
    if stream is not None:
        # the arrival rates, the whole fleet's shards (host, for the
        # draws) and this rank's queues, which start empty
        srates = stream_mod.device_arrival_rates(stream, D)
        shards = (gather(engine.labels).cpu().numpy(),
                  gather(engine.valid).cpu().numpy())
        queue = (torch.zeros((fl.local_rows, stream.queue_cap),
                             dtype=torch.int64, device=dev),
                 torch.zeros((fl.local_rows, stream.queue_cap),
                             dtype=torch.bool, device=dev))

    counters.count_dispatch()
    # a copy of the state's generator: two calls from one state draw alike
    params, opt_state, pool, gen = (state.params, state.opt_state,
                                    state.pool, copy_generator(state.rng))
    excl = frozenset(excluded_paths(trainer.adapter, params))
    if topology is None:
        # rows are identical by the dispatch protocol; the excluded leaves
        # are global device 0's
        first = _slot0(fl, params, excl)
        fog = tree_map_with_path(
            lambda path, a: first[path] if path in excl else a[0], params)
    else:
        # the [G, ...] fog stack: each group's first slot (rows within a
        # group are identical by the dispatch protocol); its excluded
        # leaves stay as they enter
        fog = fl.rows_at(dict(tree_items(params)),
                         topo_mod.first_slots(topology))
    recs: dict = {}       # device rows, one list a key
    host: dict = {}       # host rows, one list a key
    # a flat {path: leaf} dict → a tree shaped like the params
    unflat = lambda flat: tree_map_with_path(lambda path, _: flat[path],
                                             state.params)
    to_dev = lambda v: torch.as_tensor(v, device=dev)
    for t in range(events):
        e_abs = start_event + t
        if t > 0:
            gen = engine.device_generator(e_abs)
        row, hrow = {}, {}
        # ---- 0. churn and fault draws (numpy, absolute event index)
        labels = crash = None
        if faults is not None:
            draws = faults_mod.round_draws(
                faults, e_abs, D, engine.labels.shape[1],
                trainer.adapter.num_classes)
            live_prev = live
            live = faults_mod.update_liveness(
                live, draws.u_death, draws.u_birth,
                rates[faults_mod.RATE_DEATH],
                rates[faults_mod.RATE_BIRTH]).numpy()
            born = (live > 0) & (live_prev <= 0)
            dispatch = np.where(live > 0, np.where(born, 1.0, dispatch),
                                0.0).astype(np.float32)
            next_done = np.where(live > 0, next_done, inf)
            staleness = np.where(born, 0, staleness).astype(np.int32)
            crash, drop, corrupt, noise = (m.numpy() for m in
                                           faults_mod.draw_fault_masks(
                                               draws.u_faults, rates))
            crash = crash * live
            labels = torch.where(loc(to_dev(noise))[:, None] > 0,
                                 loc(to_dev(draws.noisy_labels)),
                                 engine.labels)
        commit = dispatch if crash is None else dispatch * (1.0 - crash)
        lat = scale_latency(async_cfg, latency_draws(async_cfg, e_abs, D),
                            means)
        if crash is not None:
            lat = lat * np.where(crash > 0, rates[faults_mod.RATE_RESTART],
                                 np.float32(1.0))
        next_done = np.where(dispatch > 0, t_now + lat, next_done)

        # ---- 2. the event: quorum of K or timer, whichever comes first
        t_quorum = inf if quorum is None else np.sort(next_done)[quorum - 1]
        t_timer = inf if timer is None else t_now + timer
        t_event = min(t_quorum, t_timer)
        # the finiteness test keeps parked (dead) slots out of an
        # all-dead quorum event, where t_event is inf
        arrived = ((next_done <= t_event)
                   & np.isfinite(next_done)).astype(np.float32)
        recv = arrived if faults is None else arrived * (1.0 - drop)
        dispatch_d, commit_d, arrived_d, recv_d = to_dev(
            np.stack([dispatch, commit, arrived, recv]))
        dispatch_l, commit_l, arrived_l = (loc(v) for v in (
            dispatch_d, commit_d, arrived_d))

        # ---- 1. dispatch and the candidate round (masked commit): with a
        # topology each slot reads its own group's fog model
        if topology is None:
            incoming = tree_map_with_path(
                lambda path, own, f: own if path in excl else f.unsqueeze(0),
                params, fog)
        else:
            rows = dict(tree_items(topo_mod.take_group_rows(
                {p: f for p, f in fog.items() if p not in excl}, loc(gid))))
            incoming = tree_map_with_path(
                lambda path, own: own if path in excl else rows[path], params)
            del rows
        params = _where_rows(dispatch_l, incoming, params)
        opt_state = _where_rows(dispatch_l, trainer.opt.init(params),
                                opt_state)
        base = params
        p2, o2, pool2, _ = engine._round(params, opt_state, pool, gen,
                                         record_curves=False, labels=labels,
                                         step_limit=step_limit)
        # a crashed device loses the round: nothing commits
        params = _where_rows(commit_l, p2, params)
        opt_state = _where_rows(commit_l, o2, opt_state)
        pool = vpool.VPool(*_where_rows(commit_l, tuple(pool2), tuple(pool)))
        del p2, o2, pool2, incoming

        with torch.no_grad():
            banked = tree_map_with_path(
                lambda path, p, b: (torch.zeros_like(p) if path in excl
                                    else p - b), params, base)
            pending = _where_rows(commit_l, banked, pending)
            del banked, base

            # ---- 2b. live traffic: arrivals over the event's gap, then
            # the cascade on the committed devices (before step 3, so this
            # event's escalations count in the labeled counts)
            if stream is not None:
                t_next = t_event if np.isfinite(t_event) else t_now
                rate = srates if live is None else srates * (live > 0)
                lam = rate * np.maximum(t_next - t_now, np.float32(0.0))
                pool, queue, traffic = _traffic(
                    engine, stream, e_abs, t_next, lam, shards,
                    queue, params, pool, commit_l)
                row.update(traffic)

            # ---- 3. staleness-decayed Eq. 1 over the arrivals
            counts = gather(vpool.n_labeled(pool).float())
            accs = (gather(agg_mod.stacked_accuracy(
                trainer.eval_logits, params, engine.test_images,
                engine.test_labels)) if has_val
                else torch.zeros_like(counts))
            raw = {"average": torch.ones_like(counts), "weighted": accs,
                   "fedavg_n": counts}[aggregation]
            # without faults or guards the reduce takes the codec's wire
            # payload leaf by leaf; the guards judge whole decoded uploads
            sent, scales = _event_uploads(
                codec, pending, residual, arrived_l, excl,
                engine.comms_generator(e_abs), wire=not guarded)
            if faults is not None:
                # wire corruption of received uploads, after the residual
                sent = faults_mod.corrupt_stacked(
                    faults.corrupt_mode, sent, loc(to_dev(corrupt * recv)),
                    rates[faults_mod.RATE_CORRUPT_SCALE])
            accept = recv_d
            if guards is not None:
                norms = gather(faults_mod.stacked_norms(sent))
                reject, clip, scale = faults_mod.guard_verdict(
                    norms, gather(faults_mod.stacked_finite(sent)), recv_d,
                    policy=guards.policy, factor=guards.norm_factor,
                    group_ids=None if topology is None else gid,
                    num_groups=None if topology is None else G)
                accept = recv_d * (1.0 - reject)
                if guards.policy == "clip":
                    scale_l = loc(scale)
                    sent = tree_map(lambda a: a * _rows(scale_l, a), sent)
                sent = _where_rows(loc(accept), sent,
                                   tree_map(torch.zeros_like, sent))
                row.update(rejected=reject, clipped=clip,
                           upload_norms=norms, accepted=accept)
            w = agg_mod.staleness_weights(
                raw, to_dev(staleness), accept, kind=async_cfg.decay,
                rate=async_cfg.decay_rate)
            accept_any = bool(accept.sum() > 0)
            eta = async_cfg.mix_rate
            red = dict(scales=scales, out_dtype=torch.float32)
            sync = topology is None or bool(syncs[t])
            if topology is not None:
                # both Eq. 1 levels' weights from the same decayed basis
                alpha, beta, group_any = topo_mod.two_tier_weights(
                    raw * agg_mod.staleness_decay(
                        to_dev(staleness), kind=async_cfg.decay,
                        rate=async_cfg.decay_rate), accept, gid, G)
                row.update(fog_sync=torch.tensor(float(sync), device=dev),
                           beta=beta,
                           group_accept=agg_mod.segment_sum(accept, gid, G))
            if accept_any and sync:
                # the flat Eq. 1 update (a sync event collapses the tier:
                # the β-mixed fog base plus the flat arrivals, β ≡ 1.0 at
                # G = 1 so the flat update bit for bit)
                delta = _reduce(fl, sent, w, **red)
                if topology is None:
                    fog = tree_map_with_path(
                        lambda path, f: (f if path in excl
                                         else f + eta * delta[path]), fog)
                else:
                    base = topo_mod.group_reduce_stacked(
                        {p: fog[p] for p in delta}, beta)
                    fog.update({p: (base[p] + eta * delta[p]).unsqueeze(
                        0).expand_as(fog[p]) for p in delta})
                    del base
                del delta
            elif accept_any:
                # a fog-local event: each accepted delta folds into its own
                # group with per-group alphas; a silent group keeps its
                # model (the where drops its uniform fallback)
                fold = _reduce(fl, sent, alpha, segments=(gid, G), **red)
                fog.update({p: torch.where(
                    _rows(group_any, fog[p]), fog[p] + eta * fold[p], fog[p])
                    for p in fold})
                del fold
            else:
                # nothing accepted: aggregate nothing (the uniform
                # fallback would fold in-flight deltas in early, and again
                # on their arrival)
                w = torch.zeros_like(w)
            del sent

            # ---- 4. bookkeeping: arrivals clear their banked delta and
            # are dispatched next; live devices in flight age one model
            # version when something was accepted
            pending = tree_map(
                lambda p: torch.where(_rows(arrived_l, p) > 0, 0.0, p),
                pending)
            row.update(weights=w, upload_mask=arrived_d, n_labeled=counts)
            hrow.update(staleness=staleness, sim_time=t_event,
                        arrivals=arrived.sum(dtype=np.float32),
                        timer_fired=bool(np.isfinite(t_timer)
                                         and t_timer <= t_quorum))
            if sync:
                aging = np.int32(accept_any)
            else:
                # staleness counts versions of the model a device was
                # dispatched from: its group's on a fog-local event
                aging = group_any.cpu().numpy()[gid_np].astype(np.int32)
            if live is not None:
                aging = aging * (live > 0).astype(np.int32)
                hrow["live"] = live
            if faults is not None:
                hrow.update(crashed=crash, dropped=drop * arrived,
                            corrupted=corrupt * recv)
            staleness = np.where(arrived > 0, 0,
                                 staleness + aging).astype(np.int32)
            dispatch = arrived
            # an all-dead fleet without a timer gives t_event = inf:
            # freeze the clock (reborn devices restart it)
            if np.isfinite(t_event):
                t_now = t_event
            if has_val:
                row["device_accs"] = accs
                # with a topology the cloud-side estimate, the slot-share
                # mix of the fog models (the fog model itself at G = 1)
                model = (fog if topology is None else unflat(
                    topo_mod.group_reduce_stacked(fog, share)))
                row["agg_acc"] = agg_mod.stacked_accuracy(
                    trainer.eval_logits,
                    tree_map(lambda a: a.unsqueeze(0), model),
                    engine.test_images, engine.test_labels)[0]
        for k, v in row.items():
            recs.setdefault(k, []).append(v)
        for k, v in hrow.items():
            host.setdefault(k, []).append(v)
    out = {k: torch.stack(v) for k, v in recs.items()}
    out.update({k: to_dev(np.stack(v)) for k, v in host.items()})
    if topology is not None:
        fog = unflat(fog)
    # the generator the next event draws from, as resume_state installs it:
    # a chained call then equals a restored one
    final = EngineState(
        params, opt_state, pool, engine.device_generator(start_event + events),
        () if residual is None else residual,
        pending, loc(to_dev(staleness)),
        () if live is None else loc(to_dev(live)))
    return final, out, fog


def async_telemetry(recs) -> dict:
    """Accuracy against simulated seconds from the event recs: the clock
    per event, arrival statistics, timer events and the staleness
    summary (``hetero.summarize_staleness``)."""
    host = faults_mod._host
    sim = host(recs["sim_time"]).astype(np.float64)
    arrivals = host(recs["arrivals"]).astype(np.float64)
    out = {
        "events": int(sim.shape[0]),
        "sim_seconds_total": float(sim[-1]) if sim.size else 0.0,
        "sim_time_per_event": [float(t) for t in sim],
        "mean_arrivals_per_event": float(arrivals.mean()),
        "timer_fired_events": int(host(recs["timer_fired"]).sum()),
        "staleness": hetero_mod.summarize_staleness(host(recs["staleness"])),
    }
    if "agg_acc" in recs:
        accs = host(recs["agg_acc"]).astype(np.float64)
        out["final_acc"] = float(accs[-1])
        out["accuracy_vs_sim_time"] = [
            {"event": t, "sim_seconds": float(sim[t]),
             "accuracy": float(accs[t])}
            for t in range(sim.shape[0])]
    return out


def report_telemetry(round_reports) -> dict:
    """``async_telemetry`` over the per-event reports
    ``run_federated_rounds(engine="async")`` returns (an async repeat's
    ``"async"`` entry)."""
    return async_telemetry({
        "sim_time": [r["sim_time"] for r in round_reports],
        "arrivals": [r["arrivals"] for r in round_reports],
        "timer_fired": [r["timer_fired"] for r in round_reports],
        "staleness": [r["staleness"] for r in round_reports],
        "agg_acc": [r["aggregated_acc"] for r in round_reports],
    })
