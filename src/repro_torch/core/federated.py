"""Fog-node / edge-device federated active-learning loop (paper Algorithm 1;
the port of ``repro.core.federated``).

Round structure (paper §III-B):
  1. FN trains an initial model on m seed images.
  2. FN dispatches the model to N edge devices.
  3. Each device runs R pool-based AL acquisitions locally (MC-dropout BNN +
     acquisition function, k new labels per acquisition, windowed pool).
  4. Devices upload parameters; FN aggregates (Eq. 1).

The port has the reference's four round-synchronous engines: ``vmap``
(``EdgeEngine.run_round``, host-side Eq. 1), ``legacy`` (the same step
one device and one acquisition per call), ``classic`` (the ``EdgeDevice``
loop over a numpy ``ActivePool``), and ``fused`` (``EdgeEngine
.run_rounds_fused``, Eq. 1 through the fused-aggregation kernel, with
optional compressed uploads, heterogeneous fleets, faults and guards).
``engine="async"`` drops the round barrier: the fog node aggregates on a
FedBuff quorum or a timer over simulated device latencies
(``core.async_engine``).  ``topology=`` (``core.topology``) makes the fog
tier explicit on both: fog groups aggregate their own slots and sync to
the cloud every ``local_steps``-th round.  ``stream=`` (``core.stream``)
makes unlabeled requests arrive on the async engine's simulated clock,
served or escalated to the fog by the selection cascade.  Every option can
come bundled as ``fleet=`` (``core.fleet.FleetConfig``).
``run_experiment`` runs the eight scenarios of the ``SCENARIOS`` registry
(``paper``, ``massive``, ``hetero``, ``async``, ``churn``, ``fog``,
``stream`` and ``lm``), and ``report_schema`` names the keys their
reports carry.  The ``lm`` fleet swaps LeNet for an LM adapter
(``core.model_adapter``) on token shards (``data.lm``).
Everything runs on ``device`` (default ``"cuda"``; see
``repro_torch.device``).  Reports carry the reference's keys, the byte
ledger's ``"comms"`` entry (``core.comms``) included.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import async_engine as async_mod
from repro_torch.core import comms as comms_mod
from repro_torch.core import counters
from repro_torch.core import faults as faults_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import hetero as hetero_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.aggregation import (fedavg, fedavg_n, opt_model,
                                          weighted_average)
from repro_torch.core.async_engine import AsyncConfig
from repro_torch.core.comms import CommsConfig
from repro_torch.core.engine import EdgeEngine, score_logprobs
from repro_torch.core.faults import FaultConfig, GuardConfig
from repro_torch.core.fleet import FleetConfig
from repro_torch.core.hetero import HeteroConfig
from repro_torch.core.mc_dropout import mc_logprobs
from repro_torch.core.model_adapter import (LeNetAdapter, ModelAdapter,
                                           SSMAdapter)
from repro_torch.core.pool import ActivePool
from repro_torch.core.stream import StreamConfig
from repro_torch.data.digits import SyntheticDigits
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.nn.lenet import LeNetConfig
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


@dataclass(frozen=True)
class FederatedALConfig:
    """The experiment's root config (paper Algorithm 1 hyperparameters).

    Defaults are the paper's non-massive setting: ``num_devices`` 4 edge
    devices each run ``acquisitions`` 10 AL steps, labeling
    ``k_per_acquisition`` 10 images from a ``pool_window`` of 200 scored
    with ``mc_samples`` 16 MC-dropout forwards.  The fog node seeds with
    ``initial_train`` 20 images trained ``initial_train_steps`` 60 Adam
    steps; each acquisition retrains ``train_steps_per_acq`` 30 full-batch
    steps at ``lr`` 1e-3.  ``acquisition_fn`` (entropy) and
    ``aggregation`` (average, Eq. 1) pick the scoring and fog strategies;
    ``seed`` drives every generator.  Training is full-batch with masking
    (the reference's ``batch_size`` field is not carried over: no ported
    path reads it).  ``adapter`` None = the paper's LeNet."""

    num_devices: int = 4
    initial_train: int = 20
    acquisitions: int = 10
    k_per_acquisition: int = 10
    pool_window: int = 200
    mc_samples: int = 16
    acquisition_fn: str = "entropy"  # entropy | bald | vr | random | margin | ...
    aggregation: str = "average"     # average | optimal | weighted | fedavg_n
    train_steps_per_acq: int = 30
    initial_train_steps: int = 60
    lr: float = 1e-3
    seed: int = 0
    adapter: Optional[ModelAdapter] = None  # None = LeNet (the paper)


class Trainer:
    """Train / score / eval bundle for one model family on one device.

    The model is a ``core.model_adapter.ModelAdapter`` (default: the
    paper's LeNet; ``cfg.adapter`` or ``adapter=`` for an LM).  Every
    method takes STACKED params ``[D, ...]`` except ``fit`` / ``accuracy``
    / ``init_params``, which work on one model.  Training differentiates
    the sum of the per-device masked losses with torch autograd, which
    gives each device its own gradient.  Samples keep their dtype (float32
    images, int32 tokens) and may have any rank (``adapter.sample_ndim``).
    """

    def __init__(self, cfg: FederatedALConfig,
                 model_cfg: LeNetConfig = LeNetConfig(),
                 adapter: Optional[ModelAdapter] = None, *, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        if adapter is None:
            adapter = cfg.adapter
        if adapter is None:
            adapter = LeNetAdapter(model_cfg)
        self.adapter = adapter
        self.opt = adam(cfg.lr)

    def init_params(self, generator: torch.Generator):
        return self.adapter.init(generator)

    def fit_steps(self, params, opt_state, x, y, mask, generator, steps: int,
                  step_limit: Optional[torch.Tensor] = None):
        """``steps`` full-batch Adam steps of every device at once on
        ``x [D, M, ...]``, ``y``/``mask [D, M]``; the step index restarts
        at 0 each call (the reference's ``fit_steps_raw``).

        ``step_limit`` (``[D]`` ints, optional) is the heterogeneous-fleet
        compute profile (``core.hetero``): device i keeps the updates of
        its first ``step_limit[i]`` steps only, on params and optimizer
        state alike, so its result equals a shorter fit while the fleet
        still trains in one batched pass."""
        for i in range(steps):
            p = tree_map(lambda a: a.detach().requires_grad_(True), params)
            loss = self.adapter.loss(p, x, y, mask, generator).sum()
            grads = torch.autograd.grad(loss, tree_leaves(p))
            new_p, new_o = self.opt.update(
                tree_unflatten_like(p, grads), opt_state, params, i)
            if step_limit is not None:
                keep = step_limit > i
                pick = lambda n, o: torch.where(
                    keep.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                new_p = tree_map(pick, new_p, params)
                new_o = tree_map(pick, new_o, opt_state)
            params, opt_state = new_p, new_o
        return params, opt_state

    @torch.no_grad()
    def score_logprobs(self, params, x, generator, T: int):
        """MC-dropout log-probs ``[D, T, W, C]`` of ``x [D, W, ...]``."""
        return mc_logprobs(self.adapter.stochastic_apply, params, x, T,
                           generator)

    @torch.no_grad()
    def eval_logits(self, params, x):
        """Deterministic logits ``[D, N, C]`` of samples shared by all
        devices ``x [N, *sample]`` (or per device ``[D, N, *sample]``), in
        chunks of at most ``adapter.eval_rows`` device-rows."""
        D = tree_leaves(params)[0].shape[0]
        axis = x.dim() - self.adapter.sample_ndim - 1      # the N axis
        N = x.shape[axis]
        step = max(1, self.adapter.eval_rows // D)
        outs = [self.adapter.apply(params, x.narrow(axis, s, min(step, N - s)))
                for s in range(0, N, step)]
        return torch.cat(outs, dim=1)

    def _as_tensor(self, a, dtype=None):
        """numpy-like ``a`` on the trainer's device; ``dtype`` None keeps
        the array's own (float32 images, int32 tokens)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def fit(self, params, images, labels, *, steps: int,
            generator: torch.Generator, opt_state=None):
        """Train ONE model on ``(images, labels)`` for ``steps`` full-batch
        Adam steps; returns ``(params, opt_state)``."""
        counters.count_dispatch()
        x = self._as_tensor(images)[None]
        y = self._as_tensor(labels, torch.int64)[None]
        mask = torch.ones(y.shape, device=self.device)
        stack = lambda t: tree_map(lambda a: a.unsqueeze(0), t)
        opt_state = (self.opt.init(stack(params)) if opt_state is None
                     else stack(opt_state))
        params, opt_state = self.fit_steps(stack(params), opt_state, x, y,
                                           mask, generator, steps)
        unstack = lambda t: tree_map(lambda a: a[0], t)
        return unstack(params), unstack(opt_state)

    def accuracy(self, params, images, labels) -> float:
        """Accuracy of ONE model on ``(images, labels)``."""
        logits = self.eval_logits(tree_map(lambda a: a.unsqueeze(0), params),
                                  self._as_tensor(images))
        y = self._as_tensor(labels, torch.int64)
        return float((logits[0].argmax(-1) == y).float().mean())


@dataclass
class EdgeDevice:
    """One edge device of the ``classic`` engine: a local shard, a numpy
    ``ActivePool`` (seeded ``cfg.seed + 101 · device_id``, the reference's
    windows draw for draw) and the AL loop, on the trainer's device.

    ``seed_data`` is the fog node's labeled seed set, dispatched with the
    model: each acquisition trains on seed ∪ acquired."""
    device_id: int
    data: SyntheticDigits
    trainer: Trainer
    cfg: FederatedALConfig
    seed_data: Optional[SyntheticDigits] = None
    pool: ActivePool = field(init=False)
    history: List[Dict] = field(default_factory=list)

    def __post_init__(self):
        self.pool = ActivePool.create(
            len(self.data), seed=self.cfg.seed + 101 * self.device_id)

    def _scores(self, params, window, generator: torch.Generator):
        """MC-dropout scores ``[W]`` of the window's samples: entropy, BALD
        and VR through the acquisition-score kernel on ``[T, W, C]``."""
        cfg, trainer = self.cfg, self.trainer
        x = trainer._as_tensor(self.data.images[window])[None]
        logp = trainer.score_logprobs(
            tree_map(lambda a: a.unsqueeze(0), params), x, generator,
            cfg.mc_samples)[0]
        return score_logprobs(cfg.acquisition_fn, logp)

    def run_active_learning(self, params, *,
                            eval_set: Optional[SyntheticDigits] = None,
                            generator: Optional[torch.Generator] = None,
                            acquisitions: Optional[int] = None):
        """Paper Algorithm 1's inner loop from ``params``: R acquisitions
        of window draw → MC scoring → top-k → fit on seed ∪ labeled (the
        Adam state carries over from one acquisition's fit to the next).
        Appends one history record an acquisition; returns the refined
        params."""
        cfg, trainer = self.cfg, self.trainer
        gen = generator if generator is not None else torch.Generator(
            device=trainer.device).manual_seed(cfg.seed + self.device_id)
        opt_state = None
        R = acquisitions if acquisitions is not None else cfg.acquisitions
        for r in range(R):
            window = self.pool.draw_window(cfg.pool_window)
            if len(window) == 0:
                break
            if cfg.acquisition_fn == "random":
                scores = torch.rand(len(window), generator=gen,
                                    device=trainer.device)
            else:
                scores = self._scores(params, window, gen)
            k_eff = min(cfg.k_per_acquisition, len(window))
            self.pool.acquire(window,
                              acq.select_topk(scores, k_eff).cpu().numpy())

            labeled = self.pool.labeled
            imgs = self.data.images[labeled]
            lbls = self.data.labels[labeled]
            if self.seed_data is not None and len(self.seed_data) > 0:
                imgs = np.concatenate([self.seed_data.images, imgs])
                lbls = np.concatenate([self.seed_data.labels, lbls])
            params, opt_state = trainer.fit(
                params, imgs, lbls, steps=cfg.train_steps_per_acq,
                generator=gen, opt_state=opt_state)

            rec = {"device": self.device_id, "acquisition": r + 1,
                   "n_labeled": int(len(labeled))}
            if eval_set is not None:
                rec["test_acc"] = trainer.accuracy(params, eval_set.images,
                                                   eval_set.labels)
            self.history.append(rec)
        return params


@dataclass
class FogNode:
    """Centralized fog node: seed training + dispatch + aggregation."""
    trainer: Trainer
    cfg: FederatedALConfig
    seed_data: SyntheticDigits
    device: Optional[str] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.trainer.device != self.device:
            raise ValueError(f"trainer on {self.trainer.device}, fog node on "
                             f"{self.device}")

    def initial_model(self, generator: Optional[torch.Generator] = None):
        """Init from ``generator`` (default: seeded with ``cfg.seed``), then
        ``initial_train_steps`` on the seed set."""
        gen = generator if generator is not None else torch.Generator(
            device=self.device).manual_seed(self.cfg.seed)
        params = self.trainer.init_params(gen)
        if len(self.seed_data) > 0:
            params, _ = self.trainer.fit(
                params, self.seed_data.images, self.seed_data.labels,
                steps=self.cfg.initial_train_steps, generator=gen)
        return params

    def aggregate(self, device_models: List, *, val_set: SyntheticDigits,
                  counts: Optional[List[int]] = None):
        """Eq. 1 over a list of uploaded models (the host fog-node path).
        ``counts`` (labeled counts per upload) are required for
        ``aggregation="fedavg_n"``."""
        cfg = self.cfg
        accs = [self.trainer.accuracy(m, val_set.images, val_set.labels)
                for m in device_models]
        if cfg.aggregation == "average":
            return fedavg(device_models), {"device_accs": accs,
                                           "strategy": "average"}
        if cfg.aggregation == "optimal":
            best_model, best = opt_model(device_models, accs)
            return best_model, {"device_accs": accs, "strategy": "optimal",
                                "best": best}
        if cfg.aggregation == "weighted":
            return weighted_average(device_models, accs), {
                "device_accs": accs, "strategy": "weighted"}
        if cfg.aggregation == "fedavg_n":
            if counts is None:
                raise ValueError("aggregation='fedavg_n' needs per-device "
                                 "labeled counts")
            return fedavg_n(device_models, counts), {
                "device_accs": accs, "strategy": "fedavg_n",
                "counts": [int(c) for c in counts]}
        raise ValueError(cfg.aggregation)


def _select_uploads(num_devices: int, upload_fraction: float, seed: int,
                    round_idx: int = 0):
    """Random upload subset for one round, seeded with the sequence
    ``[seed, round_idx]`` (the reference's draw, number for number)."""
    uploaded_ids = list(range(num_devices))
    if upload_fraction < 1.0:
        k = max(1, int(round(upload_fraction * num_devices)))
        rs = np.random.default_rng([seed, round_idx])
        uploaded_ids = sorted(rs.choice(num_devices, size=k,
                                        replace=False).tolist())
    return uploaded_ids


def upload_mask_schedule(num_devices: int, upload_fraction: float, seed: int,
                         rounds: int) -> np.ndarray:
    """``[rounds, D]`` float mask matching ``_select_uploads`` round by
    round — the host schedule the fused engine takes as ``upload_mask``."""
    mask = np.zeros((rounds, num_devices), np.float32)
    for t in range(rounds):
        mask[t, _select_uploads(num_devices, upload_fraction, seed, t)] = 1.0
    return mask


def _check_engine(engine: str, allowed) -> None:
    if engine not in allowed:
        raise ValueError(f"unknown engine {engine!r}: use "
                         + " | ".join(allowed))


# the engines that run each in-round feature (the reference's table)
_FEATURE_ENGINES = {
    "comms compression": ("fused",),
    "hetero": ("fused", "async"),
    "async_cfg": ("async",),
    "faults": ("fused", "async"),
    "guards": ("fused", "async"),
    "topology": ("fused", "async"),
    "stream": ("async",),
}


def _require_engine(feature: str, engine: str, why: str) -> None:
    allowed = _FEATURE_ENGINES[feature]
    if engine not in allowed:
        names = " or ".join(f"'{e}'" for e in allowed)
        raise ValueError(f"{feature} requires engine={names} "
                         f"(got engine={engine!r}); {why}")


def _check_comms_engine(comms: Optional[CommsConfig], engine: str) -> None:
    """Lossy upload codecs run only in the fused rounds; byte accounting
    (``compression="none"``) works on every engine."""
    if comms is not None and comms.compression != "none":
        _require_engine("comms compression", engine,
                        "host-side paths support byte accounting only")


def _check_hetero_engine(hetero: Optional[HeteroConfig], engine: str) -> None:
    """Straggler buffering, staleness and the compute profile live in the
    fused rounds (the async engine takes the compute profile only, see
    ``_check_async_engine``)."""
    if hetero is not None:
        _require_engine(
            "hetero", engine,
            "use run_federated_rounds(..., engine='fused'|'async', "
            "hetero=...)")


def _check_async_engine(async_cfg: Optional[AsyncConfig], engine: str,
                        hetero: Optional[HeteroConfig] = None) -> None:
    """An ``AsyncConfig`` runs on the async engine only; there a
    ``HeteroConfig`` contributes its compute profile, and its
    round-synchronous ``straggler_rate`` is refused (the latency model is
    the straggler model)."""
    if async_cfg is not None:
        _require_engine(
            "async_cfg", engine,
            "use run_federated_rounds(..., engine='async', async_cfg=...)")
    if engine == "async" and hetero is not None \
            and hetero.straggler_rate > 0.0:
        raise ValueError(
            "engine='async' does not compose with hetero.straggler_rate: "
            "the async latency model replaces the round-synchronous "
            "straggler model (use AsyncConfig's dist/latency_skew; the "
            "hetero compute profile DOES compose — set straggler_rate=0)")


def _check_faults_engine(faults: Optional[FaultConfig],
                         guards: Optional[GuardConfig], engine: str) -> None:
    """Churn, fault injection and the aggregation guards live in the fused
    rounds and the async event loop."""
    if faults is not None:
        _require_engine("faults", engine,
                        "fault injection runs inside the fused rounds")
    if guards is not None:
        _require_engine("guards", engine,
                        "aggregation guards run inside the fused rounds")


def _check_topology_engine(topology, engine: str) -> None:
    """Two-tier fog aggregation runs in the fused rounds and the async
    event loop."""
    if topology is not None:
        _require_engine("topology", engine,
                        "two-tier aggregation runs inside the fused rounds "
                        "and the async event loop")


def _check_stream_engine(stream: Optional[StreamConfig], engine: str) -> None:
    """Live traffic rides the async event loop's simulated clock: the
    round-synchronous engines have no time axis for arrivals."""
    if stream is not None:
        _require_engine(
            "stream", engine,
            "traffic arrives on the async event loop's virtual clock")


def _to_device(tree, device):
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


def _round_device(trainer: Optional[Trainer], device):
    """A given trainer fixes the device; ``device`` may only agree."""
    if trainer is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != trainer.device:
        raise ValueError(f"device={device!r} but the trainer is on "
                         f"{trainer.device}")
    return trainer.device


def _classic_generator(cfg: FederatedALConfig, device_id: int, device,
                       round_idx: int = 0) -> torch.Generator:
    """The generator device ``device_id`` of the classic engine draws from
    in round ``round_idx`` (the reference's key schedule, as a seed)."""
    return torch.Generator(device=device).manual_seed(
        cfg.seed + 7919 * (device_id + 1) + 104729 * round_idx)


def run_federated_round(cfg: FederatedALConfig,
                        device_data: List[SyntheticDigits],
                        seed_data: SyntheticDigits, test_set: SyntheticDigits,
                        *, trainer: Optional[Trainer] = None,
                        initial_params=None, record_curves: bool = True,
                        upload_fraction: float = 1.0, round_seed: int = 0,
                        engine: str = "vmap",
                        comms: Optional[CommsConfig] = None, hetero=None,
                        device=None):
    """One full paper round: FN init → dispatch → per-device AL → host-side
    Eq. 1 over the uploads.

    ``engine``: ``"vmap"`` (all devices batched), ``"legacy"`` (the same
    step, one device and one acquisition per call) or ``"classic"`` (the
    ``EdgeDevice`` loop over numpy pools).  ``upload_fraction < 1``
    uploads a random subset (``round_seed`` = the round index, so
    successive rounds draw fresh subsets).  Returns ``(aggregated_params,
    report)`` with ``initial_acc``, ``aggregated_acc``, ``aggregation``,
    ``device_histories`` and the byte ledger's ``comms`` entry (``comms``
    sets its accounting policy; compression itself needs the fused
    engine)."""
    _check_engine(engine, ("vmap", "legacy", "classic"))
    _check_comms_engine(comms, engine)
    _check_hetero_engine(hetero, engine)
    device = _round_device(trainer, device)
    trainer = trainer or Trainer(cfg, device=device)
    fog = FogNode(trainer, cfg, seed_data, device=device)
    params0 = (_to_device(initial_params, device)
               if initial_params is not None else fog.initial_model())

    if engine == "classic":
        devices = [EdgeDevice(i, d, trainer, cfg, seed_data=seed_data)
                   for i, d in enumerate(device_data)]
        refined = [dev.run_active_learning(
            params0, eval_set=test_set if record_curves else None,
            generator=_classic_generator(cfg, dev.device_id, device))
            for dev in devices]
        histories = [dev.history for dev in devices]
        counts = [len(dev.pool.labeled) for dev in devices]
    else:
        eng = EdgeEngine(trainer, cfg, device_data, seed_data,
                         test_set if record_curves else None, device=device)
        run = eng.run_round if engine == "vmap" else eng.run_round_legacy
        state, recs = run(eng.init_state(params0),
                          record_curves=record_curves)
        refined = eng.device_params_list(state)
        histories = eng.histories(recs)
        counts = eng.labeled_counts(state)
    uploaded_ids = _select_uploads(len(device_data), upload_fraction,
                                   cfg.seed, round_seed)
    agg_params, agg_info = fog.aggregate(
        [refined[i] for i in uploaded_ids], val_set=test_set,
        counts=[counts[i] for i in uploaded_ids])
    agg_info["uploaded_devices"] = uploaded_ids
    report = {
        "initial_acc": trainer.accuracy(params0, test_set.images,
                                        test_set.labels),
        "aggregated_acc": trainer.accuracy(agg_params, test_set.images,
                                           test_set.labels),
        "aggregation": agg_info,
        "device_histories": histories,
        "comms": comms_mod.single_round_report(
            comms, params0, uploaded_ids, len(device_data),
            new_labels=int(sum(counts)),
            image_shape=device_data[0].images.shape[1:]),
    }
    return agg_params, report


def run_federated_rounds(cfg: FederatedALConfig,
                         device_data: List[SyntheticDigits],
                         seed_data: SyntheticDigits, test_set: SyntheticDigits,
                         *, rounds: int = 2, trainer: Optional[Trainer] = None,
                         upload_fraction: float = 1.0, engine: str = "vmap",
                         mesh=None, comms: Optional[CommsConfig] = None,
                         hetero=None, async_cfg=None, faults=None,
                         guards=None, topology=None, stream=None, fleet=None,
                         device=None):
    """Iterated rounds: each round re-dispatches the aggregated model;
    devices keep their pools (labels accumulate across rounds).

    ``engine``: ``"vmap"``, ``"legacy"`` and ``"classic"`` aggregate on the
    host each round; ``"fused"`` runs the fog node inside
    ``EdgeEngine.run_rounds_fused`` (Eq. 1 through the fused-aggregation
    kernel), where ``comms=CommsConfig(compression="int8" | "topk")`` or a
    bfloat16 ``compute_dtype`` also compresses the uploads.  Returns
    ``(params, reports)``, one report per round (``round``,
    ``aggregated_acc``, ``aggregation``, and the byte ledger's ``comms``
    entry).  On ``"fused"``, ``hetero=HeteroConfig(...)`` runs
    straggler-tolerant rounds and adds each round's per-device
    ``staleness``; ``faults=FaultConfig(...)`` / ``guards=GuardConfig(...)``
    add churn, fault injection and the fog node's guards, and the rows
    ``live`` / ``crashed`` / ``dropped`` / ``corrupted`` / ``rejected`` /
    ``clipped`` of the features on (``EdgeEngine.run_rounds_fused``).

    ``engine="async"`` drops the round barrier: ``rounds`` counts fog
    aggregation events of ``EdgeEngine.run_async`` (``async_cfg``, default
    ``default_async(D)``), with the same ``comms`` / ``faults`` /
    ``guards`` and the compute profile of ``hetero``.  Each report adds
    ``sim_time`` (simulated seconds), ``arrivals``, ``timer_fired`` and
    the per-device ``staleness``.  Arrivals come from the latency model,
    so ``upload_fraction < 1`` is refused.

    ``topology=FogTopology(...)`` (``"fused"`` and ``"async"``) runs the
    two-tier hierarchy; each report adds ``fog_sync``, ``beta`` and
    ``group_accept`` and a ``"tiers"`` entry (``comms.tier_report``: the
    edge→fog and fog→cloud bytes of the round).  The async engine's
    ``[G, ...]`` fog stack is returned as its slot-share mix.

    ``stream=StreamConfig(...)`` (``"async"`` only) runs live traffic;
    each report adds the event's ``offered``, ``stream_dropped``,
    ``served``, ``serve_correct`` and ``escalated`` and the per-device
    ``queue_depth``, and the pool is sized for ``rounds · escalate_k``
    more acquisitions of ``k`` slots (the reference's sizing).  ``fleet=
    FleetConfig(...)`` bundles ``comms``, ``hetero``, ``async_cfg``,
    ``faults``, ``guards``, ``topology`` and ``stream``; the per-feature
    options keep working, and mixing the forms warns (the options win).

    ``mesh`` (``launch.mesh.make_device_mesh`` / ``make_fog_mesh``) splits
    the fleet of the ``vmap``, ``legacy``, ``fused`` and ``async``
    engines over the ranks of its process group (``EdgeEngine(mesh=)``):
    every rank calls this with the same arguments and gets the same model
    and reports.  The host-aggregation engines gather every device's model
    to each rank; under ``legacy`` each rank walks its own devices.  The
    ``classic`` engine does not read ``mesh``: every rank runs the whole
    fleet."""
    _check_engine(engine, ("vmap", "legacy", "classic", "fused", "async"))
    fleet = fleet_mod.resolve_fleet(
        fleet, "run_federated_rounds",
        allowed=("comms", "hetero", "async_cfg", "faults", "guards",
                 "topology", "stream"),
        comms=comms, hetero=hetero, async_cfg=async_cfg, faults=faults,
        guards=guards, topology=topology, stream=stream)
    comms, hetero, async_cfg = fleet.comms, fleet.hetero, fleet.async_cfg
    faults, guards = fleet.faults, fleet.guards
    topology, stream = fleet.topology, fleet.stream
    _check_comms_engine(comms, "fused" if engine == "async" else engine)
    _check_async_engine(async_cfg, engine, hetero)
    _check_hetero_engine(hetero, engine)
    _check_faults_engine(faults, guards, engine)
    _check_topology_engine(topology, engine)
    _check_stream_engine(stream, engine)
    if engine == "async" and upload_fraction < 1.0:
        raise ValueError(
            "engine='async' decides arrivals from the latency model; "
            "upload_fraction has no meaning there (tune AsyncConfig's "
            "quorum/timer/latency instead)")
    device = _round_device(trainer, device)
    trainer = trainer or Trainer(cfg, device=device)
    fog = FogNode(trainer, cfg, seed_data, device=device)
    params = fog.initial_model()
    image_shape = device_data[0].images.shape[1:]
    reports = []
    mask_rows: List[np.ndarray] = []    # [D] participation a round
    count_rows: List[List[int]] = []    # [D] cumulative labeled a round

    def attach_comms(mask, n_labeled):
        summary = comms_mod.comms_report(
            comms, params, mask, n_labeled=n_labeled,
            agg_accs=[r["aggregated_acc"] for r in reports],
            image_shape=image_shape)
        comms_mod.attach_round_comms(reports, summary)
        return params, reports

    if engine in ("fused", "async"):
        # a stream labels up to escalate_k more samples a device an event:
        # the reference sizes the pool for that many more acquisitions
        extra = 0 if stream is None else rounds * stream.escalate_k
        eng = EdgeEngine(trainer, cfg, device_data, seed_data, test_set,
                         total_acquisitions=cfg.acquisitions * rounds + extra,
                         device=device, mesh=mesh)
        if engine == "async":
            _, recs, params = eng.run_async(
                eng.init_state(params), rounds,
                async_cfg=(async_cfg if async_cfg is not None
                           else default_async(len(device_data))),
                aggregation=cfg.aggregation, comms=comms, faults=faults,
                guards=guards, hetero=hetero, topology=topology,
                stream=stream)
            if topology is not None:
                # the event loop returns the [G, ...] fog stack: report its
                # slot-share mix (the flat model at G = 1)
                share = torch.as_tensor(topology.group_sizes(),
                                        dtype=torch.float32,
                                        device=trainer.device)
                params = topo_mod.group_reduce_stacked(
                    params, share / float(len(device_data)))
        else:
            mask = None
            if upload_fraction < 1.0:
                mask = upload_mask_schedule(len(device_data),
                                            upload_fraction, cfg.seed,
                                            rounds)
            _, recs, params = eng.run_rounds_fused(
                eng.init_state(params), rounds, upload_mask=mask,
                aggregation=cfg.aggregation, comms=comms, hetero=hetero,
                faults=faults, guards=guards, topology=topology)
        rows = {k: v.cpu().numpy() for k, v in recs.items()}
        extra = [k for k in ("staleness",) + faults_mod.REPORT_KEYS
                 if k in rows]
        for t in range(rounds):
            uploaded = np.nonzero(rows["upload_mask"][t])[0]
            report = {"round": t}
            if engine == "async":
                report.update(sim_time=float(rows["sim_time"][t]),
                              arrivals=int(rows["upload_mask"][t].sum()),
                              timer_fired=bool(rows["timer_fired"][t]))
            report.update({
                "aggregated_acc": float(rows["agg_acc"][t]),
                "aggregation": {
                    "strategy": cfg.aggregation,
                    "device_accs": rows["device_accs"][t][uploaded].tolist(),
                    "weights": rows["weights"][t].tolist(),
                    "uploaded_devices": uploaded.tolist(),
                },
                **{k: rows[k][t].tolist() for k in extra},
            })
            if topology is not None:
                report.update(fog_sync=bool(rows["fog_sync"][t]),
                              beta=rows["beta"][t].tolist(),
                              group_accept=rows["group_accept"][t].tolist())
            if stream is not None:
                report.update({k: (rows[k][t].tolist() if k == "queue_depth"
                                   else float(rows[k][t]))
                               for k in stream_mod.STREAM_REPORT_KEYS})
            reports.append(report)
        attach_comms(rows["upload_mask"], rows["n_labeled"])
        if topology is not None:
            comms_mod.attach_round_tiers(reports, comms_mod.tier_report(
                comms, params, rows["upload_mask"], topology))
        return params, reports

    def aggregate_round(t, refined, counts):
        nonlocal params
        uploaded_ids = _select_uploads(len(device_data), upload_fraction,
                                       cfg.seed, t)
        params, agg_info = fog.aggregate(
            [refined[i] for i in uploaded_ids], val_set=test_set,
            counts=[counts[i] for i in uploaded_ids])
        agg_info["uploaded_devices"] = uploaded_ids
        mask = np.zeros((len(device_data),), np.float32)
        mask[uploaded_ids] = 1.0
        mask_rows.append(mask)
        count_rows.append(counts)
        reports.append({
            "round": t,
            "aggregated_acc": trainer.accuracy(params, test_set.images,
                                               test_set.labels),
            "aggregation": agg_info,
        })

    if engine == "classic":
        devices = [EdgeDevice(i, d, trainer, cfg, seed_data=seed_data)
                   for i, d in enumerate(device_data)]
        for t in range(rounds):
            refined = [dev.run_active_learning(
                params, eval_set=test_set,
                generator=_classic_generator(cfg, dev.device_id, device, t))
                for dev in devices]
            aggregate_round(t, refined, [len(dev.pool.labeled)
                                         for dev in devices])
        return attach_comms(np.stack(mask_rows), np.asarray(count_rows))

    # reports carry aggregate metrics only, so the rounds record no curves
    eng = EdgeEngine(trainer, cfg, device_data, seed_data,
                     total_acquisitions=cfg.acquisitions * rounds,
                     device=device, mesh=mesh)
    run = eng.run_round if engine == "vmap" else eng.run_round_legacy
    state = eng.init_state(params)
    for t in range(rounds):
        if t > 0:
            state = eng.set_params(state, params, round_idx=t)
        state, _ = run(state, record_curves=False)
        aggregate_round(t, eng.device_params_list(state),
                        eng.labeled_counts(state))
    return attach_comms(np.stack(mask_rows), np.asarray(count_rows))


# Paper §IV's "massively distributed" regime: many devices, few labels each.
MASSIVE_DEVICE_COUNTS = (64, 256, 1024)
MASSIVE_SAMPLES_PER_DEVICE = 40


def massive_config(num_devices: int = 256, *, seed: int = 0,
                   **overrides) -> FederatedALConfig:
    """Preset for the massively-distributed regime (~40 samples/device:
    small windows, few acquisitions, size-aware ``fedavg_n`` Eq. 1), the
    reference's shared small-budget preset."""
    base = dict(num_devices=num_devices, initial_train=20, acquisitions=2,
                k_per_acquisition=5, pool_window=32, mc_samples=4,
                train_steps_per_acq=10, initial_train_steps=20,
                aggregation="fedavg_n", seed=seed)
    base.update(overrides)
    return FederatedALConfig(**base)


# Non-IID shard concentration of the hetero and churn scenarios.
HETERO_DIRICHLET_ALPHA = 0.5

# Heterogeneous-fleet scenario defaults (scenario="hetero"): 30% of uploads
# miss their round (buffered and staleness-decayed, not discarded) and a
# quarter of the fleet is limited to half the local fit steps.
DEFAULT_HETERO = HeteroConfig(
    straggler_rate=0.3, decay="exp", decay_rate=0.5, buffer_stale=True,
    slow_fraction=0.25, slow_steps_fraction=0.5)

# Fault-tolerant-fleet scenario defaults (scenario="churn"): devices churn
# (death 0.1 / birth 0.4 a round, ~20% of slots dark in steady state), 5%
# of device rounds crash, 5% of uploads drop on the wire, 5% arrive
# corrupted (x50 norm), 5% of device rounds train on scrambled labels; the
# fog node's norm and finiteness guards drop what they reject.
DEFAULT_FAULTS = FaultConfig(
    death_rate=0.1, birth_rate=0.4, crash_rate=0.05, drop_rate=0.05,
    corrupt_rate=0.05, corrupt_mode="scale", corrupt_scale=50.0,
    label_noise_rate=0.05)
DEFAULT_GUARDS = GuardConfig(policy="drop", norm_factor=8.0)

# Rounds-free async scenario (scenario="async"): the fog node aggregates
# on a FedBuff quorum or a safety timer over simulated latencies whose
# per-device means span this slowest / fastest ratio.
ASYNC_LATENCY_SKEW = 10.0


def hetero_config(num_devices: int = 64, *, seed: int = 0,
                  **overrides) -> FederatedALConfig:
    """Preset for the heterogeneous-fleet regime: the small-budget fleet
    of ``massive_config`` on ``dirichlet_split`` shards; pair with a
    ``HeteroConfig`` (``DEFAULT_HETERO`` in ``scenario="hetero"``)."""
    return massive_config(num_devices, seed=seed, **overrides)


def async_config(num_devices: int = 64, *, seed: int = 0,
                 **overrides) -> FederatedALConfig:
    """Preset for the async event-loop regime: the small-budget fleet on
    ``dirichlet_split`` shards; pair with an ``AsyncConfig``
    (``default_async(D)`` in ``scenario="async"``)."""
    return massive_config(num_devices, seed=seed, **overrides)


def default_async(num_devices: int) -> AsyncConfig:
    """The FedBuff ``AsyncConfig`` of ``scenario="async"``, sized to the
    fleet: quorum a quarter of the devices (at least 1), a 4-simulated-
    second safety timer, exponential latencies of mean 1 with a
    ``ASYNC_LATENCY_SKEW`` slow / fast spread, and FedAsync's polynomial
    staleness decay (rate 0.5)."""
    return AsyncConfig(quorum=max(1, num_devices // 4), timer=4.0,
                       dist="exp", mean_latency=1.0,
                       latency_skew=ASYNC_LATENCY_SKEW,
                       decay="poly", decay_rate=0.5)


def churn_config(num_devices: int = 64, *, seed: int = 0,
                 **overrides) -> FederatedALConfig:
    """Preset for the fault-tolerant-fleet regime: the small-budget fleet
    on ``dirichlet_split`` shards; pair with ``FaultConfig`` /
    ``GuardConfig`` (``DEFAULT_FAULTS`` / ``DEFAULT_GUARDS`` in
    ``scenario="churn"``)."""
    return massive_config(num_devices, seed=seed, **overrides)


# Hierarchical fog scenario (scenario="fog"): the non-IID small-budget
# fleet in fog groups that sync to the cloud every DEFAULT_FOG_LOCAL_STEPS-th
# round.
DEFAULT_FOG_LOCAL_STEPS = 4


def fog_config(num_devices: int = 64, *, seed: int = 0,
               **overrides) -> FederatedALConfig:
    """Preset for the hierarchical fog-topology regime: the small-budget
    fleet on ``dirichlet_split`` shards; pair with a ``FogTopology``
    (``default_topology(D)`` in ``scenario="fog"``)."""
    return massive_config(num_devices, seed=seed, **overrides)


def default_topology(num_devices: int,
                     num_groups: Optional[int] = None) -> topo_mod.FogTopology:
    """The ``FogTopology`` of ``scenario="fog"``: balanced contiguous
    groups (G = D/16 clamped to [2, 16] unless given, at most D) syncing
    to the cloud every ``DEFAULT_FOG_LOCAL_STEPS``-th round."""
    if num_groups is None:
        num_groups = max(2, min(16, num_devices // 16))
    num_groups = min(num_groups, num_devices)
    return topo_mod.uniform_topology(num_devices, num_groups,
                                     local_steps=DEFAULT_FOG_LOCAL_STEPS)


def stream_config(num_devices: int = 64, *, seed: int = 0,
                  **overrides) -> FederatedALConfig:
    """Preset for the live-traffic regime: the small-budget fleet on
    ``dirichlet_split`` shards on the async event loop, with requests
    arriving on the simulated clock; pair with a ``StreamConfig``
    (``default_stream(D)`` in ``scenario="stream"``)."""
    return massive_config(num_devices, seed=seed, **overrides)


def default_stream(num_devices: int) -> StreamConfig:
    """The ``StreamConfig`` of ``scenario="stream"`` (the reference's):
    about 2 requests a device a simulated second with a 4x hot / cold
    skew, queues of 16, at most 8 arrivals an event, entropy thresholds
    serving at most 0.6 nats and escalating the top 2 from 1.0 nats, and
    a label drift of concentration 2 rotating once in 8 simulated
    seconds.  The same for every fleet size."""
    return StreamConfig(arrival_rate=2.0, rate_skew=4.0, queue_cap=16,
                        max_arrivals=8, serve_threshold=0.6,
                        escalate_threshold=1.0, escalate_k=2,
                        drift_kappa=2.0, drift_period=8.0)


# LM scenario defaults (scenario="lm"): token geometry of the synthetic
# Markov source (data.lm) and of the reduced SSM adapter the preset builds.
LM_VOCAB = 256
LM_SEQ_LEN = 32


def lm_model_config(*, vocab: int = LM_VOCAB, seq_len: int = LM_SEQ_LEN,
                    dropout_rate: float = 0.1) -> ModelConfig:
    """Reduced single-block SSM ``ModelConfig`` for the LM scenario (d_model
    64, one Mamba-2 block) with MC-dropout on: ``dropout_rate > 0`` gives
    the Eq. 13 posterior samples their variance."""
    base = ModelConfig(family="ssm", attn_pattern=("M",)).reduced(
        n_layers=1, d_model=64, vocab_size=vocab, max_seq_len=seq_len)
    return replace(base, dropout_rate=dropout_rate)


def lm_config(num_devices: int = 8, *, seed: int = 0,
              **overrides) -> FederatedALConfig:
    """Preset for the LM regime: the massive preset's small budget with an
    ``SSMAdapter`` in place of LeNet — token shards from
    ``data.lm.lm_federated_split``, next-token "labels", and a carried
    per-device recurrent state the engine keeps out of Eq. 1."""
    overrides.setdefault("adapter", SSMAdapter(lm_model_config()))
    return massive_config(num_devices, seed=seed, **overrides)


@dataclass(frozen=True)
class Scenario:
    """One registered regime: ``description``; ``split`` ``"uniform"``
    (``federated_split``), ``"dirichlet"`` (non-IID, alpha
    ``HETERO_DIRICHLET_ALPHA``) or ``"lm"`` (``data.lm`` token shards);
    ``engine`` the native engine an explicit ``engine=`` overrides;
    ``config`` the preset maker of D (None: the caller passes ``cfg``);
    ``dynamics(cfg)`` the default ``FleetConfig``, whose fields
    ``run_experiment`` uses where the caller left them None."""

    description: str
    split: str
    engine: str
    config: Optional[Callable[..., FederatedALConfig]] = None
    dynamics: Callable[[FederatedALConfig], FleetConfig] = \
        lambda cfg: FleetConfig()


SCENARIOS: Dict[str, Scenario] = {
    "paper": Scenario(
        description="paper Algorithm 1 on uniform shards (explicit cfg)",
        split="uniform", engine="vmap"),
    "massive": Scenario(
        description="massively-distributed fleet, aggregation in-compile",
        split="uniform", engine="fused", config=massive_config),
    "hetero": Scenario(
        description="straggler/staleness-aware heterogeneous fleet",
        split="dirichlet", engine="fused", config=hetero_config,
        dynamics=lambda cfg: FleetConfig(hetero=DEFAULT_HETERO)),
    "async": Scenario(
        description="rounds-free FedAsync/FedBuff event loop",
        split="dirichlet", engine="async", config=async_config,
        dynamics=lambda cfg: FleetConfig(
            async_cfg=default_async(cfg.num_devices))),
    "churn": Scenario(
        description="device churn + fault injection + aggregation guards",
        split="dirichlet", engine="fused", config=churn_config,
        dynamics=lambda cfg: FleetConfig(faults=DEFAULT_FAULTS,
                                         guards=DEFAULT_GUARDS)),
    "fog": Scenario(
        description="hierarchical two-tier edge×fog aggregation",
        split="dirichlet", engine="fused", config=fog_config,
        dynamics=lambda cfg: FleetConfig(
            topology=default_topology(cfg.num_devices))),
    "stream": Scenario(
        description="live-traffic AL: serve/escalate cascade on the "
                    "async event loop",
        split="dirichlet", engine="async", config=stream_config,
        dynamics=lambda cfg: FleetConfig(
            async_cfg=default_async(cfg.num_devices),
            stream=default_stream(cfg.num_devices))),
    "lm": Scenario(
        description="language-model fleet: SSM adapter, token shards, "
                    "recurrent state excluded from Eq. 1",
        split="lm", engine="fused", config=lm_config),
}


def report_schema(scenario: str) -> Dict[str, frozenset]:
    """The keys the reports of ``run_experiment(scenario=...)`` carry at
    least (the reference's schema): ``{"round": ..., "repeat": ...}``,
    frozensets for each round's (or event's) report and for a repeat's.
    ``"paper"`` runs one round on the host, whose repeat report is its
    round report."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}: use "
                         + " | ".join(SCENARIOS))
    scn = SCENARIOS[scenario]
    if scn.config is None:
        keys = frozenset({"initial_acc", "aggregated_acc", "aggregation",
                          "device_histories", "comms"})
        return {"round": keys, "repeat": keys}
    fleet = scn.dynamics(scn.config(8))
    round_keys = {"round", "aggregated_acc", "aggregation", "comms"}
    repeat_keys = {"rounds", "comms"}
    if scn.engine == "async":
        round_keys |= {"sim_time", "arrivals", "timer_fired", "staleness"}
        repeat_keys |= {"async"}
    if fleet.hetero is not None:
        round_keys |= {"staleness"}
        repeat_keys |= {"staleness"}
    if fleet.faults is not None:
        round_keys |= {"live", "crashed", "dropped", "corrupted"}
        repeat_keys |= {"faults"}
    if fleet.guards is not None:
        round_keys |= {"rejected", "clipped"}
        repeat_keys |= {"faults"}
    if fleet.topology is not None:
        round_keys |= {"fog_sync", "beta", "group_accept", "tiers"}
        repeat_keys |= {"tiers"}
    if fleet.stream is not None:
        round_keys |= set(stream_mod.STREAM_REPORT_KEYS)
        repeat_keys |= {"stream"}
    return {"round": frozenset(round_keys),
            "repeat": frozenset(repeat_keys)}


def run_experiment(cfg: Optional[FederatedALConfig] = None, *,
                   n_train: int = 4000, n_test: int = 1000, repeats: int = 1,
                   scenario: Optional[str] = None, num_devices: int = 256,
                   rounds: int = 1, engine: Optional[str] = None, mesh=None,
                   comms: Optional[CommsConfig] = None,
                   hetero: Optional[HeteroConfig] = None, async_cfg=None,
                   faults: Optional[FaultConfig] = None,
                   guards: Optional[GuardConfig] = None, topology=None,
                   stream: Optional[StreamConfig] = None,
                   fleet: Optional[FleetConfig] = None, device=None):
    """End-to-end experiment: data from seeds → federated split → rounds.

    ``scenario="paper"`` runs Algorithm 1 with an explicit ``cfg`` on
    uniform shards (``n_train`` samples, the ``vmap`` engine; one round
    unless ``rounds > 1``); ``scenario="massive"`` builds
    ``massive_config(num_devices)`` (an explicit ``cfg`` wins) at ~40
    samples/device on the fused engine; ``scenario="lm"`` does the same
    with ``lm_config`` on token shards of one Markov chain, sized by the
    adapter's vocabulary and at most ``LM_SEQ_LEN`` tokens.  ``repeats``
    reruns with seeds shifted by 1000.  Multi-round repeats return
    ``{"rounds": [...], "comms": telemetry}``
    (``comms.experiment_telemetry``); single-round repeats return the
    round report, which carries its own ``"comms"`` entry.  ``comms=
    CommsConfig(...)`` sets the byte ledger's policy and, on the fused
    engine, compresses the uploads.

    ``scenario="hetero"`` runs ``hetero_config(num_devices)`` on non-IID
    ``dirichlet_split`` shards (alpha ``HETERO_DIRICHLET_ALPHA``) on the
    fused engine with ``DEFAULT_HETERO``; each repeat adds a
    ``"staleness"`` summary (``hetero.summarize_staleness``).
    ``scenario="churn"`` runs ``churn_config(num_devices)`` on the same
    shards with ``DEFAULT_FAULTS`` and ``DEFAULT_GUARDS``
    (``guards=GuardConfig(policy="off")`` is the unguarded control); each
    repeat adds a ``"faults"`` summary (``faults.report_summary``).
    ``scenario="async"`` runs ``async_config(num_devices)`` on the same
    shards on the async engine with ``default_async(num_devices)``;
    ``rounds`` counts fog aggregation events, and each repeat adds an
    ``"async"`` summary (``async_engine.report_telemetry``: simulated
    seconds, arrivals, timer events, staleness).  ``scenario="fog"`` runs
    ``fog_config(num_devices)`` on the same shards on the fused engine
    with ``default_topology(num_devices)`` (G = D/16 in [2, 16], a cloud
    sync every ``DEFAULT_FOG_LOCAL_STEPS``-th round); each repeat adds a
    ``"tiers"`` summary (``comms.tier_telemetry``: per-tier bytes and
    ``cross_tier_reduction``).  ``scenario="stream"`` runs
    ``stream_config(num_devices)`` on the same shards on the async engine
    with ``default_async(num_devices)`` and ``default_stream(num_devices)``
    live traffic; each repeat adds the ``"async"`` summary and a
    ``"stream"`` one (``stream.report_stream_telemetry``: offered load,
    drops, serve accuracy, escalations, queue depths and the escalation
    uplink bytes).  The scenarios are the ``SCENARIOS`` registry's, and
    every option may come as its per-feature argument or bundled in
    ``fleet=FleetConfig(...)``; the scenario's dynamics fill in only the
    fields the caller left None.  ``mesh`` (``launch.mesh``) splits the
    fleet over the ranks of a process group, every rank calling with the
    same arguments; a meshed run takes the multi-round drivers
    (``run_federated_rounds``), as the reference's does."""
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import (dirichlet_split,
                                                  federated_split)
    from repro_torch.data.lm import lm_federated_split, make_lm_dataset

    fleet = fleet_mod.resolve_fleet(
        fleet, "run_experiment",
        allowed=("comms", "hetero", "async_cfg", "faults", "guards",
                 "topology", "stream"),
        comms=comms, hetero=hetero, async_cfg=async_cfg, faults=faults,
        guards=guards, topology=topology, stream=stream)
    split = "uniform"
    if scenario is not None:
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}: use "
                             + " | ".join(SCENARIOS))
        scn = SCENARIOS[scenario]
        split = scn.split
        if scn.config is not None:
            cfg = scn.config(num_devices) if cfg is None else cfg
            n_train = MASSIVE_SAMPLES_PER_DEVICE * cfg.num_devices
        engine = scn.engine if engine is None else engine
    if cfg is None:
        presets = " | ".join(k for k, v in SCENARIOS.items()
                             if v.config is not None)
        raise ValueError(f"pass cfg or a preset scenario ({presets})")
    if scenario is not None:
        # the scenario's dynamics fill in only what the caller left None
        fleet = scn.dynamics(cfg).merged(
            **{f: getattr(fleet, f) for f in fleet_mod.FLEET_FIELDS})
    comms, hetero, async_cfg = fleet.comms, fleet.hetero, fleet.async_cfg
    faults, guards = fleet.faults, fleet.guards
    topology, stream = fleet.topology, fleet.stream
    engine = "vmap" if engine is None else engine
    device = resolve_device(device)

    reports = []
    for rep in range(repeats):
        seed = cfg.seed + 1000 * rep
        if split == "lm":
            # every split comes from ONE Markov chain (stream_seed=seed)
            acfg = getattr(cfg.adapter, "config", None)
            vocab = getattr(acfg, "vocab_size", LM_VOCAB)
            seq_len = min(LM_SEQ_LEN, getattr(acfg, "max_seq_len",
                                              LM_SEQ_LEN))
            test = make_lm_dataset(n_test, seq_len=seq_len, vocab=vocab,
                                   seed=seed + 5, stream_seed=seed)
            seed_set = make_lm_dataset(cfg.initial_train, seq_len=seq_len,
                                       vocab=vocab, seed=seed + 11,
                                       stream_seed=seed)
            shards = lm_federated_split(
                cfg.num_devices, max(1, n_train // cfg.num_devices),
                seq_len=seq_len, vocab=vocab, seed=seed)
        else:
            full = make_digit_dataset(n_train, seed=seed)
            test = make_digit_dataset(n_test, seed=seed + 5)
            seed_set = make_digit_dataset(cfg.initial_train, seed=seed + 11)
            if split == "dirichlet":
                shards = dirichlet_split(full, cfg.num_devices,
                                         alpha=HETERO_DIRICHLET_ALPHA,
                                         seed=seed)
            else:
                shards = federated_split(full, cfg.num_devices, seed=seed)
        cfg_rep = replace(cfg, seed=seed)
        if engine in ("fused", "async") or rounds > 1 or mesh is not None:
            _, round_reports = run_federated_rounds(
                cfg_rep, shards, seed_set, test, rounds=rounds,
                engine=engine, mesh=mesh, fleet=fleet, device=device)
            rep_report = {
                "rounds": round_reports,
                "comms": comms_mod.experiment_telemetry(round_reports)}
            if hetero is not None:
                rep_report["staleness"] = hetero_mod.summarize_staleness(
                    [r["staleness"] for r in round_reports])
            if engine == "async":
                rep_report["async"] = async_mod.report_telemetry(
                    round_reports)
            if stream is not None:
                rep_report["stream"] = stream_mod.report_stream_telemetry(
                    round_reports, image_shape=shards[0].images.shape[1:])
            if faults is not None or guards is not None:
                rep_report["faults"] = faults_mod.report_summary(
                    round_reports)
            if topology is not None:
                rep_report["tiers"] = comms_mod.tier_telemetry(round_reports)
            reports.append(rep_report)
        else:
            _check_faults_engine(faults, guards, engine)
            _check_topology_engine(topology, engine)
            _check_stream_engine(stream, engine)
            _check_async_engine(async_cfg, engine, hetero)
            _, rep_report = run_federated_round(cfg_rep, shards, seed_set,
                                                test, engine=engine,
                                                comms=comms, hetero=hetero,
                                                device=device)
            reports.append(rep_report)
    return reports
