"""Vectorized federated-AL engine (paper Algorithm 1, batched; the port of
``repro.core.engine``).

The reference compiles one round — R acquisitions × D devices — into one
XLA program: a ``vmap`` over devices of a ``scan`` over acquisitions.  The
port writes both out: every tensor of the fleet carries a leading device
axis ``[D, ...]`` and the acquisitions are a Python loop, so each
acquisition is one batched pass over all devices:

  window draw → MC-dropout log-probs ``[D, T, W, C]`` → acquisition scores
  (the fused acquisition-score kernel for entropy / BALD / VR) → top-k →
  ``vpool.acquire`` → masked full-batch fit on seed ∪ acquired.

``run_round_legacy`` runs the same acquisition step one device and one
acquisition per call (the reference's per-device dispatch loop).

``run_rounds_fused`` adds the fog node (the reference's in-compile fog):
per round, the per-device validation accuracy, the Eq. 1 weights over the
participants, the stacked reduce through the fused-aggregation kernel
(``aggregation.aggregate_stacked``), and re-dispatch.  With a lossy
``comms`` codec (``core.comms``) it aggregates in delta form: each
device's delta from the dispatched model, plus its error-feedback
residual, crosses the wire compressed, and the kernel reduces the wire
payload itself (int8 codes with scales, bfloat16 or float32 values).
Leaves the adapter keeps per device (``model_adapter.excluded_paths``: the
SSM adapter's recurrent state) stay out of Eq. 1: they carry no mass into
the reduce, each device keeps its own value at re-dispatch, and the fog
model reports device 0's.  ``hetero=`` (``core.hetero``) turns the
participation mask into an arrival mask with straggler buffering,
staleness-decayed weights and per-device step budgets; ``faults=`` /
``guards=`` / ``live_mask=`` (``core.faults``) add churn, crashes, lost
and corrupted uploads, label noise and the fog node's guards;
``topology=`` (``core.topology``) splits the fleet into fog groups that
aggregate their own slots every round (the kernel's segment form) and
sync to a global model every ``local_steps``-th round.  ``fleet=``
(``core.fleet.FleetConfig``) bundles these options in one value.
``run_async`` drops the round barrier (``core.async_engine``), with live
traffic as an option (``core.stream``).

``EdgeEngine(mesh=...)`` splits the device axis over a ``torch.distributed``
group (``launch.mesh``), one process a shard: every rank calls the same
methods with the same arguments, holds the rows ``launch.sharding
.FleetShard`` gives it of every ``[D, ...]`` tree, and runs the kernels on
those rows.  Fleet-wide ``[D]`` vectors (Eq. 1 weights, the topology's
α/β, guard verdicts, staleness, liveness, the records) are computed on
every rank from gathered vectors, and each Eq. 1 reduce is the rank's
partial reduce of its rows by its slice of the global weights, summed over
the ranks; so every rank holds the same fog model and the same records,
gathered to ``[D, ...]``.  Where the reference differs on purpose: every
draw inside a round is made at the GLOBAL shape from the one generator and
sliced (``launch.sharding.rand_rows``), so a sharded run draws what the
unsharded one does; rows at global slots (slot 0's excluded leaves, each
fog group's first slot) are broadcast by their owner, where the reference
weights a one-hot row and psums; and the model ``init_state`` /
``set_params`` take is rank 0's, broadcast.

Samples keep their dtype and rank end to end: float32 images ``[28, 28,
1]`` for LeNet, int32 token sequences ``[S]`` for the LM adapters.

Randomness comes from one ``torch.Generator`` per round on the engine's
device (``EngineState.rng``), seeded from ``cfg.seed`` and the absolute
round index, never from global state.  The fused rounds draw from a copy
of the state's generator and return the generator of the round after
their last, as ``resume_state`` installs it, so a chained call, a
restored one and the uninterrupted run draw alike.  Its bits are not the
reference's
threefry bits, so parity tests run the RNG-free configuration (dropout
off, the window covering the whole pool).  The legacy loop draws from the
same one generator, device after device, so it equals the vmap round on
that configuration only.  The int8 codec draws its rounding uniforms from
a generator of its own a round (``comms_generator``); the participation,
straggler and fault draws and the int8 fog codec's uniforms
(``fog_uniforms``) are numpy's, seeded with the absolute round index, so
the card and the CPU see the same masks.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import aggregation as agg_mod
from repro_torch.core import comms as comms_mod
from repro_torch.core import counters, vpool
from repro_torch.core import faults as faults_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import hetero as hetero_mod
from repro_torch.core import stream as stream_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.model_adapter import excluded_paths
from repro_torch.device import resolve_device
from repro_torch.kernels.acquisition_scores import acquisition_scores
from repro_torch.launch import sharding
from repro_torch.launch.mesh import DEVICE_AXIS
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_map_with_path)

_AGGREGATIONS = ("average", "weighted", "optimal", "fedavg_n")

_FUSED_SCORES = ("entropy", "bald", "vr")

# profiler span around the comms codec of a fused round (encode, decode
# and the error-feedback update, without the Eq. 1 reduce)
CODEC_SPAN = "comms_codec"

# offset of the fog codec's seed from ``cfg.seed``
FOG_STREAM = 0x666F67


class EngineState(NamedTuple):
    """Per-device state, stacked along a leading device axis D.  ``rng`` is
    the generator the next round draws from (None in a state restored
    from a checkpoint until ``EdgeEngine.resume_state``).  The extension
    buffers default to ``()`` and exist only while their feature runs:
    ``residual`` the comms error-feedback buffer and ``pending`` the
    stragglers' undelivered deltas (``[D, ...]`` trees like ``params``),
    ``staleness`` their ages in rounds (``[D]`` int32), ``live`` the churn
    liveness (``[D]`` float32, 1 = live)."""
    params: Any           # [D, ...] tree
    opt_state: Any        # [D, ...] tree
    pool: vpool.VPool     # [D, ...] fields
    rng: Optional[torch.Generator]
    residual: Any = ()    # [D, ...] tree or ()
    pending: Any = ()     # [D, ...] tree or ()
    staleness: Any = ()   # [D] int32 or ()
    live: Any = ()        # [D] float32 or ()


def stack_device_data(device_data: Sequence, device,
                      n_pad: Optional[int] = None):
    """Pad ragged device shards to a common length (``n_pad``, default
    the longest) and stack.

    Returns ``(images [D, n_pad, ...], labels [D, n_pad] int64, valid [D,
    n_pad] bool)`` on ``device``; the images keep their dtype (float32
    pixels, int32 tokens).  Padding slots are invalid and are born
    "labeled" in the pool, so the window draw never selects them."""
    D = len(device_data)
    if n_pad is None:
        n_pad = max(len(d) for d in device_data)
    img_shape = device_data[0].images.shape[1:]
    images = np.zeros((D, n_pad) + img_shape,
                      np.asarray(device_data[0].images).dtype)
    labels = np.zeros((D, n_pad), np.int64)
    valid = np.zeros((D, n_pad), bool)
    for i, d in enumerate(device_data):
        n = len(d)
        images[i, :n] = d.images
        labels[i, :n] = d.labels
        valid[i, :n] = True
    as_t = lambda a: torch.from_numpy(a).to(device)
    return as_t(images), as_t(labels), as_t(valid)


def copy_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device in ``gen``'s state."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def broadcast_params(params0, D: int):
    """One model → the same model on every one of D devices ``[D, ...]``."""
    return tree_map(lambda a: a.unsqueeze(0).expand(D, *a.shape).clone(),
                    params0)


def _slot0(fleet, params, excl) -> Dict[str, torch.Tensor]:
    """Global device 0's row of each excluded leaf (on every rank)."""
    rows = fleet.rows_at({path: leaf for path, leaf in tree_items(params)
                          if path in excl}, [0])
    return {path: row[0] for path, row in rows.items()}


def _aggregate_shared(fleet, params, w, excl):
    """Eq. 1 over the leaves outside ``excl`` (through the fused-aggregation
    kernel, each rank's rows by its slice of ``w [D]``, summed over the
    ranks); the excluded leaves, which carry no Eq. 1 mass, take global
    device 0's row."""
    flat = {path: leaf for path, leaf in tree_items(params)
            if path not in excl}
    reduced = _reduce(fleet, flat, w)
    first = _slot0(fleet, params, excl)
    return tree_map_with_path(
        lambda path, leaf: first[path] if path in excl else reduced[path],
        params)


def score_logprobs(name: str, logp: torch.Tensor) -> torch.Tensor:
    """Acquisition scores ``[..., W]`` (higher = more informative) of MC
    log-probs ``[..., T, W, C]``: entropy, BALD and VR through the
    acquisition-score kernel, the other functions in plain PyTorch."""
    if name in _FUSED_SCORES:
        ent, bald, vr = acquisition_scores(logp)
        return {"entropy": ent, "bald": bald, "vr": vr}[name]
    return acq.acquisition_scores(name, logp)


def _rows(vec: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``vec [D]`` shaped to broadcast over the rows of ``x [D, ...]``."""
    return vec.reshape((-1,) + (1,) * (x.dim() - 1))


def _where_rows(vec, on_true, on_false):
    """Per-device select over stacked trees: rows where ``vec [D] > 0``
    take ``on_true``'s."""
    return tree_map(lambda a, b: torch.where(_rows(vec, a) > 0, a, b),
                    on_true, on_false)


def _backlog(leaf, prev, pend, up):
    """A device's upload ``b = leaf − prev (+ pend)``, rows ``[D, ...]``;
    the stragglers' buffer ``pend`` (or None) is updated IN PLACE to 0
    where the device uploaded (``up``) and to ``b`` where it did not."""
    b = leaf - prev
    if pend is not None:
        b += pend
        pend.copy_(torch.where(up, 0.0, b))
    return b


def _encode_uploads(cfg, params, params_prev, residual, upload, excl,
                    generator, pending=None):
    """The wire payload of a round over a lossy wire: ``(payload,
    scales)``, dicts over the leaves outside ``excl`` of each device's
    ``C(b_i + e_i)`` with the backlog ``b = params − params_prev (+
    pending)`` (``scales`` None but for int8 codes).  ``residual`` (the
    error-feedback tree, or None without it) is updated IN PLACE to ``(b
    + e) − C(b + e)`` on the rows of devices that uploaded (``upload [D] >
    0``); the others keep theirs.  ``pending`` (the stragglers' buffer, or
    None) is updated IN PLACE to 0 where the device uploaded and to ``b``
    elsewhere.  Excluded leaves carry no delta (their buffers stay 0).
    Works leaf by leaf, so one leaf's temporaries are alive at a time."""
    prev = dict(tree_items(params_prev))
    res = None if residual is None else dict(tree_items(residual))
    pend = None if pending is None else dict(tree_items(pending))
    payload, scales = {}, {}
    # the profiler's span for the codec's own device work (not the reduce)
    with torch.profiler.record_function(CODEC_SPAN):
        for path, leaf in tree_items(params):
            if path in excl:
                continue
            up = _rows(upload, leaf) > 0
            to_send = _backlog(leaf, prev[path],
                               None if pend is None else pend[path], up)
            if res is not None:
                to_send += res[path]
            payload[path], scales[path] = comms_mod.encode_rows(
                cfg, to_send, generator)
            if res is not None:
                sent = comms_mod.decode_rows(payload[path], scales[path])
                res[path].copy_(torch.where(up, to_send.sub_(sent),
                                            res[path]))
                del sent
            del to_send
    return payload, (scales if cfg.compression == "int8" else None)


def _delta_aggregate(cfg, params, params_prev, residual, w, upload, excl,
                     generator, pending=None):
    """Eq. 1 in delta form over a lossy wire, the flat fused round's comms
    step: ``params_prev[0] + Σ_i w_i · C(b_i + e_i)``, reduced by the
    fused-aggregation kernel from the wire payload of ``_encode_uploads``
    (which updates ``residual`` and ``pending`` in place).  Excluded
    leaves report device 0's value."""
    payload, scales = _encode_uploads(cfg, params, params_prev, residual,
                                      upload, excl, generator, pending)
    reduced = _reduce(sharding.FleetShard(None, w.shape[0]), payload, w,
                      scales, out_dtype=torch.float32)
    del payload
    prev = dict(tree_items(params_prev))
    return tree_map_with_path(
        lambda path, leaf: (leaf[0] if path in excl
                            else prev[path][0] + reduced[path]), params)


def _reduce(fleet, rows, w, scales=None, *, segments=None, out_dtype=None):
    """Eq. 1 of the upload ``rows`` (a dict of ``[D_local, ...]``
    payloads, int8 codes with ``scales``) by the global ``w [D]`` through
    the fused-aggregation kernel: flat, or per fog group with ``segments =
    (ids [D] int64, G)`` (``[G, ...]`` leaves).  Under a mesh each rank
    reduces its rows by its slice of ``w`` (and of the ids), and the
    partial sums are summed over the ranks."""
    if not rows:
        return {}
    seg = {} if segments is None else dict(
        segment_ids=fleet.local(segments[0]), num_segments=segments[1])
    return fleet.psum(agg_mod.aggregate_stacked(
        rows, fleet.local(w), scales=scales, out_dtype=out_dtype, **seg))


def fog_uniforms(seed: int, round_idx: int, group: int, shapes,
                 device) -> List[torch.Tensor]:
    """The int8 fog→cloud codec's rounding uniforms for fog group
    ``group`` in round ``round_idx`` (absolute index): one float32 tensor
    a leaf of ``shapes``, with numpy from the seed ``(seed + FOG_STREAM,
    round_idx, group)``."""
    rng = np.random.default_rng([seed + FOG_STREAM, round_idx, group])
    return [torch.from_numpy(rng.random(tuple(shape), dtype=np.float32)).to(
        device) for shape in shapes]


def _fog_codec(cfg, fog_delta, seed: int, round_idx: int):
    """The fog→cloud codec ``cfg`` over each fog group's delta sum
    (``fog_delta``: a dict of ``[G, ...]`` float32 leaves, one upload a
    row): what the cloud reconstructs, float32.  int8 draws its rounding
    uniforms from ``fog_uniforms``."""
    leaves = list(fog_delta.items())
    if not leaves:
        return {}
    G, dev = leaves[0][1].shape[0], leaves[0][1].device
    with torch.profiler.record_function(CODEC_SPAN):
        if cfg.compression == "int8":
            shapes = [x.shape[1:] for _, x in leaves]
            draws = [fog_uniforms(seed, round_idx, g, shapes, dev)
                     for g in range(G)]
            out = {}
            for i, (path, x) in enumerate(leaves):
                u = torch.stack([draws[g][i] for g in range(G)])
                out[path] = comms_mod.dequantize_int8(
                    *comms_mod.quantize_int8_rows(x, u))
            return out
        return {path: comms_mod.decode_rows(*comms_mod.encode_rows(cfg, x))
                for path, x in leaves}


def _upload_rows(cfg, params, params_prev, residual, upload, excl,
                 generator, pending=None):
    """The received uploads of a round with faults or guards, as float32
    rows ``{path: [D, ...]}`` over the leaves outside ``excl``: each
    device's backlog ``b`` (as in ``_delta_aggregate``), through the codec
    ``cfg`` when one is set (encoded, then decoded as the fog node
    reconstructs it).  Updates ``residual`` from the clean payload and
    ``pending`` IN PLACE, as ``_delta_aggregate`` does.  The guards need
    every leaf's rows before any weight exists, so the whole tree is kept."""
    prev = dict(tree_items(params_prev))
    res = None if residual is None else dict(tree_items(residual))
    pend = None if pending is None else dict(tree_items(pending))
    sent = {}
    for path, leaf in tree_items(params):
        if path in excl:
            continue
        up = _rows(upload, leaf) > 0
        backlog = _backlog(leaf, prev[path],
                           None if pend is None else pend[path], up)
        if cfg is None:
            sent[path] = backlog
            continue
        with torch.profiler.record_function(CODEC_SPAN):
            to_send = backlog + res[path] if res is not None else backlog
            dec = comms_mod.decode_rows(*comms_mod.encode_rows(
                cfg, to_send, generator))
            if res is not None:
                res[path].copy_(torch.where(up, to_send - dec, res[path]))
        sent[path] = dec
    return sent


def _on_fleet(method):
    """Run an engine call with its fleet-stacked draws at the global
    shape of the engine's fleet (``launch.sharding.fleet_draws``)."""
    @functools.wraps(method)
    def call(engine, *args, **kwargs):
        with sharding.fleet_draws(engine.fleet):
            return method(engine, *args, **kwargs)
    return call


class EdgeEngine:
    """Vectorized round executor over a fixed device fleet.

    ``mesh`` (``launch.mesh.make_device_mesh`` / ``make_fog_mesh``) splits
    the fleet over the ranks of its process group: ``num_devices`` stays
    the global D, D must divide over the mesh, and the engine stacks only
    this rank's rows of ``device_data`` (every rank passes all of it).
    States the engine makes and returns hold this rank's rows;
    ``gather_state`` assembles the unsharded layout (for reports and
    checkpoints) and ``resume_state`` shards a global one."""

    def __init__(self, trainer, cfg, device_data: Sequence, seed_data,
                 test_set=None, *, total_acquisitions: Optional[int] = None,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        if trainer.device != self.device:
            raise ValueError(f"trainer on {trainer.device}, engine on "
                             f"{self.device}")
        self.trainer = trainer
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if DEVICE_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"mesh must carry a {DEVICE_AXIS!r} axis "
                    f"(launch.mesh.make_device_mesh / make_fog_mesh); "
                    f"got {mesh.axis_names}")
            if mesh.device != self.device:
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}")
        self.num_devices = len(device_data)
        # raises on every rank alike when D does not divide over the mesh
        self.fleet = sharding.FleetShard(mesh, self.num_devices)
        self.images, self.labels, self.valid = stack_device_data(
            device_data[self.fleet.start:self.fleet.stop], self.device,
            n_pad=max(len(d) for d in device_data))
        n_pad = self.images.shape[1]
        self.window = min(cfg.pool_window, n_pad)
        self.k = min(cfg.k_per_acquisition, self.window)
        self.capacity = (total_acquisitions or cfg.acquisitions) * self.k
        to_dev = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                               device=self.device)
        if seed_data is not None and len(seed_data) > 0:
            self.seed_images = to_dev(seed_data.images, self.images.dtype)
            self.seed_labels = to_dev(seed_data.labels, torch.int64)
        else:
            self.seed_images = self.images.new_zeros(
                (0,) + tuple(self.images.shape[2:]))
            self.seed_labels = self.labels.new_zeros((0,))
        if test_set is not None and len(test_set) > 0:
            self.test_images = to_dev(test_set.images, self.images.dtype)
            self.test_labels = to_dev(test_set.labels, torch.int64)
        else:
            self.test_images = self.test_labels = None

    # ------------------------------------------------------------ state
    def device_generator(self, round_idx: int = 0) -> torch.Generator:
        """The generator round ``round_idx`` draws from (absolute index, so
        chained calls and re-dispatches never replay a round's draws)."""
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 7919 + 104729 * round_idx)

    def _dispatch(self, params0):
        """One model → this rank's ``[D_local, ...]`` rows of it (rank 0's
        model under a mesh, so the ranks cannot start apart)."""
        return broadcast_params(self.fleet.broadcast_tree(params0),
                                self.fleet.local_rows)

    def init_state(self, params0, *, round_idx: int = 0) -> EngineState:
        params = self._dispatch(params0)
        return EngineState(params, self.trainer.opt.init(params),
                           vpool.vpool_init(self.valid, self.capacity),
                           self.device_generator(round_idx))

    def set_params(self, state: EngineState, params0, *,
                   round_idx: int = 0) -> EngineState:
        """Re-dispatch an aggregated model to the fleet (pools and the
        extension buffers persist, optimizer state and generator reset)."""
        params = self._dispatch(params0)
        return state._replace(params=params,
                              opt_state=self.trainer.opt.init(params),
                              rng=self.device_generator(round_idx))

    def resume_state(self, state: EngineState, *,
                     next_round: int) -> EngineState:
        """Ready a restored checkpoint for continuation: install the
        generator the uninterrupted run would draw from in round
        ``next_round`` (= rounds completed so far) and, under a mesh, take
        a global state (a checkpoint's) to this rank's rows.  Pass the
        same value as ``start_round`` on the continuation call; the resumed
        run then equals the uninterrupted one."""
        if (self.fleet.sharded and int(state.pool.n_filled.shape[0])
                == self.num_devices):
            state = sharding.shard_engine_state(self.mesh, state)
        return state._replace(rng=self.device_generator(next_round))

    def gather_state(self, state: EngineState) -> EngineState:
        """The unsharded layout of a sharded state, on every rank (a
        collective; the identity off-mesh).  Save a sharded run with
        ``save_engine_state(path, engine.gather_state(state))`` (the bytes
        are the unsharded run's) and resume it with ``resume_state``."""
        if self.mesh is None:
            return state
        return sharding.gather_engine_state(self.mesh, state)

    def comms_generator(self, round_idx: int = 0) -> torch.Generator:
        """The generator the int8 codec of round ``round_idx`` (absolute
        index) draws its rounding uniforms from."""
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + 0x636F6D + 104729 * round_idx)

    def device_params_list(self, state: EngineState) -> List:
        """Every device's model (all D of them, on every rank)."""
        return agg_mod.unstack_models(tree_map(self.fleet.gather,
                                               state.params))

    def labeled_counts(self, state: EngineState) -> List[int]:
        """Per-device labeled-sample counts n_i (the fedavg_n weights)."""
        return [int(n) for n in self.fleet.gather(
            vpool.n_labeled(state.pool)).tolist()]

    def stream_generator(self, stream, event_idx: int) -> torch.Generator:
        """The generator the live-traffic queue's MC-dropout masks of event
        ``event_idx`` (absolute index) draw from: seeded from the stream's
        own seed (``StreamConfig.seed + stream.STREAM_SEED``), never the
        round's, so zero traffic replays the plain event loop."""
        return torch.Generator(device=self.device).manual_seed(
            stream.seed + stream_mod.STREAM_SEED + 104729 * event_idx)

    def _check_capacity(self, state: EngineState, *, rounds: int = 1,
                        extra_per_round: int = 0):
        """A round appends R·k slots per device, plus ``extra_per_round``
        (a stream's escalations); the slot write clamps past capacity (as
        ``dynamic_update_slice`` does), so fail loudly (on every rank: the
        fill is the whole fleet's)."""
        need = int(self.fleet.gather(state.pool.n_filled).max()) \
            + rounds * (self.cfg.acquisitions * self.k + extra_per_round)
        if need > self.capacity:
            raise ValueError(
                f"pool capacity {self.capacity} cannot absorb {rounds} "
                f"round(s) (would need {need} slots); construct EdgeEngine "
                f"with total_acquisitions covering all rounds")

    # ------------------------------------------------------------ the step
    def _scores(self, params, x_win, gen):
        """MC-dropout scores ``[D, W]`` of the window images ``[D, W, ...]``;
        higher = more informative."""
        cfg = self.cfg
        return score_logprobs(cfg.acquisition_fn, self.trainer.score_logprobs(
            params, x_win, gen, cfg.mc_samples))

    def _acquisition(self, params, opt_state, pool, gen, *,
                     record_curves: bool, devices: slice = slice(None),
                     labels=None, step_limit=None):
        """One acquisition for the ``devices`` of the fleet at once (all of
        them by default; the state trees hold just those rows).  ``labels``
        (default the shards' own) are the labels the fit trains on;
        ``step_limit`` ``[D]`` caps each device's fit steps."""
        images = self.images[devices]
        labels = self.labels[devices] if labels is None else labels
        D = images.shape[0]
        rows = torch.arange(D, device=self.device)[:, None]
        win_idx, win_valid = vpool.draw_window(pool, gen, self.window)
        if self.cfg.acquisition_fn == "random":
            scores = sharding.rand_rows(win_idx.shape, generator=gen,
                                        device=self.device)
        else:
            scores = self._scores(params, images[rows, win_idx], gen)
        scores = torch.where(win_valid, scores,
                             torch.full_like(scores, -float("inf")))
        sel = acq.select_topk(scores, self.k)
        sel_valid = torch.gather(win_valid, 1, sel)
        pool = vpool.acquire(pool, win_idx, sel, sel_valid)

        # fixed-capacity masked training set: seed ∪ acquired
        gidx = pool.labeled_idx.long().clamp(min=0)
        m0 = self.seed_images.shape[0]
        x = torch.cat([self.seed_images.unsqueeze(0).expand(
            D, *self.seed_images.shape), images[rows, gidx]], dim=1)
        y = torch.cat([self.seed_labels.unsqueeze(0).expand(D, m0),
                       labels[rows, gidx]], dim=1)
        m = torch.cat([torch.ones((D, m0), device=self.device),
                       pool.labeled_valid.float()], dim=1)
        params, opt_state = self.trainer.fit_steps(
            params, opt_state, x, y, m, gen, self.cfg.train_steps_per_acq,
            step_limit=step_limit)

        rec = {"n_labeled": vpool.n_labeled(pool),
               "selected": torch.where(sel_valid,
                                       torch.gather(win_idx, 1, sel), -1)}
        if record_curves:
            rec["test_acc"] = agg_mod.stacked_accuracy(
                self.trainer.eval_logits, params, self.test_images,
                self.test_labels)
        return params, opt_state, pool, rec

    def _round(self, params, opt_state, pool, gen, *, record_curves: bool,
               labels=None, step_limit=None):
        recs = []
        for _ in range(self.cfg.acquisitions):
            params, opt_state, pool, rec = self._acquisition(
                params, opt_state, pool, gen, record_curves=record_curves,
                labels=labels, step_limit=step_limit)
            recs.append(rec)
        stacked = {k: torch.stack([r[k] for r in recs], dim=1)
                   for k in recs[0]}                       # [D, R, ...]
        return params, opt_state, pool, stacked

    # ------------------------------------------------------------ rounds
    @_on_fleet
    def run_round(self, state: EngineState, *, record_curves: bool = True):
        """R acquisitions × D devices.  Returns ``(state, recs)`` with
        ``recs`` ``[D, R, ...]`` (gathered from every rank under a mesh):
        ``n_labeled``, ``selected`` and (with a test set and
        ``record_curves``) ``test_acc``."""
        record = record_curves and self.test_images is not None
        self._check_capacity(state)
        counters.count_dispatch()
        params, opt_state, pool, recs = self._round(
            state.params, state.opt_state, state.pool, state.rng,
            record_curves=record)
        recs = {k: self.fleet.gather(v) for k, v in recs.items()}
        return state._replace(params=params, opt_state=opt_state,
                              pool=pool), recs

    def run_round_legacy(self, state: EngineState, *,
                         record_curves: bool = True):
        """The same acquisition step as ``run_round``, one device and one
        acquisition per call (D·R calls, each counted as a dispatch, as
        the reference counts its per-device loop).  Every device draws
        from ``state.rng`` in turn, device 0's R acquisitions first, so
        the result equals ``run_round``'s on the RNG-free configuration
        (dropout 0, the window covering the pool) and not otherwise.
        Under a mesh each rank walks its own devices (its draws are then
        not the unsharded loop's) and the records are gathered."""
        record = record_curves and self.test_images is not None
        self._check_capacity(state)
        R = self.cfg.acquisitions
        rows = lambda t, d: tree_map(lambda a: a[d:d + 1], t)
        carries, recs = [], []
        for d in range(self.fleet.local_rows):
            params, opt_state = rows(state.params, d), rows(state.opt_state, d)
            pool = vpool.VPool(*(f[d:d + 1] for f in state.pool))
            dev_recs = []
            for _ in range(R):
                counters.count_dispatch()
                params, opt_state, pool, rec = self._acquisition(
                    params, opt_state, pool, state.rng, record_curves=record,
                    devices=slice(d, d + 1))
                dev_recs.append(rec)
            carries.append((params, opt_state, pool))
            recs.append({k: torch.stack([r[k] for r in dev_recs], dim=1)
                         for k in dev_recs[0]})            # [1, R, ...]
        cat = lambda *xs: torch.cat(xs)
        params = tree_map(cat, *[c[0] for c in carries])
        opt_state = tree_map(cat, *[c[1] for c in carries])
        pool = vpool.VPool(*map(cat, *[c[2] for c in carries]))
        recs = {k: self.fleet.gather(torch.cat([r[k] for r in recs]))
                for k in recs[0]}
        return state._replace(params=params, opt_state=opt_state,
                              pool=pool), recs

    @_on_fleet
    def run_rounds_fused(self, state: EngineState, rounds: int, *,
                         upload_mask=None, upload_fraction: float = 1.0,
                         aggregation: str = "fedavg_n", start_round: int = 0,
                         comms=None, hetero=None, faults=None, guards=None,
                         live_mask=None, topology=None, fleet=None):
        """T federated rounds: device AL, per-device validation accuracy,
        Eq. 1 over the participants through the fused-aggregation kernel,
        re-dispatch.

        ``aggregation`` ∈ average | weighted | optimal | fedavg_n (default:
        α_i ∝ labeled counts n_i).  ``upload_mask`` (``[rounds, D]`` or
        ``[D]``, truthy = uploaded) models partial participation;
        ``upload_fraction < 1`` instead draws a Bernoulli mask per round
        with numpy from a seed of ``(cfg.seed, absolute round)``: another
        draw stream than the reference's in-trace ``jax.random`` one, so
        the same fraction gives other masks.  Weights normalize over the
        participants; everyone receives the aggregated model.  Pass
        ``start_round`` = rounds completed so far when chaining calls.

        ``comms`` (``core.comms.CommsConfig``) with a lossy wire (int8,
        top-k or a bfloat16 ``compute_dtype``) uploads each device's delta
        from the model it started the round from, plus its error-feedback
        residual (``state.residual``, created as zeros when empty and
        dropped when the codec or error feedback is off), through the
        codec; the fog node adds the Eq. 1 sum of the decoded deltas to
        that model.  The delta form assumes the rows of ``state.params``
        start the call identical (the dispatch protocol every driver
        follows).  Byte accounting stays on the host
        (``comms.comms_report`` over the returned ``recs``).

        ``hetero`` (``core.hetero.HeteroConfig``) makes the mask an
        ARRIVAL mask: from ``hetero.straggler_rate > 0`` (the
        ``upload_fraction`` draw at ``1 − rate``; passing a mask or a
        fraction as well is an error) or from an explicit ``upload_mask``
        host schedule (e.g. ``hetero.straggler_schedule``).  With
        ``buffer_stale`` a missing device's delta waits in
        ``state.pending`` and folds in on arrival; arrivals are weighted
        ``α_i ∝ raw_i · decay(staleness_i)`` (ages in ``state.staleness``
        and ``recs["staleness"]``); the compute profile caps per-device
        fit steps.  Without a codec, faults or guards, a buffering round
        reduces ``params`` and ``pending`` directly (two kernel launches),
        which equals the synchronous round when nothing is pending.
        ``aggregation="optimal"`` has no weights to decay and is refused.

        ``faults`` (``core.faults.FaultConfig``) injects churn, crashes,
        lost uploads, wire corruption and label-noise bursts; ``guards``
        (``core.faults.GuardConfig``) rejects non-finite and norm-outlier
        uploads (``"drop"``) or clips outliers back to the threshold
        (``"clip"``); ``policy="off"`` is no guards.  ``live_mask``
        (``[rounds, D]`` or ``[D]``, truthy = live) drives churn from a
        host schedule (``core.faults.liveness_schedule``); passing it with
        ``faults.death_rate`` / ``birth_rate`` > 0 is an error.  Faults or
        guards aggregate in delta form over the whole tree: the uploads
        of live, uncrashed devices go through the codec, the
        error-feedback residual updates from the clean payload, the
        received rows are corrupted, judged, clipped or zeroed, and Eq. 1
        normalizes over the accepted arrivals.  A round that accepts
        nothing keeps the previous fog model.  Dead and crashed devices
        keep their params, optimizer state and pool rows; the fleet's
        generator is one a round for all devices, so it has no rows to
        freeze.  The fault draws come from ``faults.round_draws``
        (numpy, at the absolute round index).

        ``topology`` (``core.topology.FogTopology``) runs the rounds as
        a two-tier edge × fog hierarchy: every round each fog group
        reduces its own accepted slots (intra-fog Eq. 1, the kernel's
        segment form; a group that accepts nothing keeps its model), and
        every ``local_steps``-th round (absolute index) the fog models
        sync to the global Eq. 1 model (inter-fog β ∝ group arrival
        mass), which is the flat round's; each slot is dispatched its
        group's model.  The flat reduce still runs every round, as the
        global candidate the ``agg_acc`` record reads.  With a lossy
        codec, faults, guards or ``comms.fog_compression`` the rounds take
        the delta form: the global model is ``Σ_g β_g F_g`` plus the flat
        reduce of the uploads, or, under the fog codec, plus the β-mix of
        each group's coded delta sum (int8 uniforms from
        ``fog_uniforms``).  Guards take per-group medians.  A call
        rebuilds the ``[G, ...]`` fog models from each group's first slot,
        so a call that starts between syncs continues the groups' models.
        ``uniform_topology(D, 1)`` is the flat run bit for bit;
        ``aggregation="optimal"`` is refused.

        Returns ``(state, recs, aggregated_params)``: ``recs`` holds
        ``[rounds, ...]`` rows ``weights``, ``upload_mask``, ``n_labeled``
        (and ``device_accs`` / ``agg_acc`` with a validation set;
        ``staleness`` with hetero; ``live`` under churn; ``crashed`` /
        ``dropped`` / ``corrupted`` with faults; ``rejected`` /
        ``clipped`` / ``upload_norms`` / ``accepted`` with guards;
        ``fog_sync``, ``beta`` and ``group_accept`` with a topology);
        ``aggregated_params`` is the last round's fog model (with a
        topology the slot-share mix of the fog models; its excluded leaves
        are device 0's).  The returned state carries the generator of
        round ``start_round + rounds``.

        Under a mesh (``EdgeEngine(mesh=...)``) the masks, draws and
        schedules are the whole fleet's on every rank, the ``[D]`` vectors
        are gathered, each reduce sums the ranks' partial reduces, and
        every rank returns the same records and fog model; the state holds
        the rank's rows.

        ``fleet`` (``core.fleet.FleetConfig``) bundles ``comms``,
        ``hetero``, ``faults``, ``guards``, ``live_mask`` and ``topology``
        in one value; the per-feature options keep working, and mixing
        the two forms warns (the options win, field by field).  Its
        ``async_cfg`` and ``stream`` belong to ``run_async`` and raise
        here."""
        fleet = fleet_mod.resolve_fleet(
            fleet, "run_rounds_fused",
            allowed=("comms", "hetero", "faults", "guards", "live_mask",
                     "topology"),
            comms=comms, hetero=hetero, faults=faults, guards=guards,
            live_mask=live_mask, topology=topology)
        comms, hetero, faults = fleet.comms, fleet.hetero, fleet.faults
        guards, live_mask = fleet.guards, fleet.live_mask
        topology = fleet.topology
        if aggregation not in _AGGREGATIONS:
            raise ValueError(f"unknown aggregation {aggregation!r}: "
                             f"use {' | '.join(_AGGREGATIONS)}")
        has_val = self.test_images is not None
        if aggregation in ("weighted", "optimal") and not has_val:
            raise ValueError(
                f"aggregation={aggregation!r} scores devices on a validation "
                "set; construct EdgeEngine with test_set")
        if hetero is not None and aggregation == "optimal":
            raise ValueError(
                "aggregation='optimal' picks one argmax model and has no "
                "Eq. 1 weights for staleness decay to act on; use "
                "average | weighted | fedavg_n with hetero")
        if guards is not None and guards.policy == "off":
            guards = None
        if aggregation == "optimal" and (
                faults is not None or guards is not None
                or live_mask is not None):
            raise ValueError(
                "aggregation='optimal' picks one argmax model, not Eq. 1 "
                "weights, so liveness masking and guard rejection have "
                "nothing to renormalize; use average | weighted | fedavg_n "
                "with faults/guards/live_mask")
        if live_mask is not None and faults is not None and faults.has_churn:
            raise ValueError(
                "pass either an explicit live_mask host schedule or "
                "faults.death_rate/birth_rate for the churn process, not "
                "both (set the rates to 0 to drive churn from the schedule)")
        if topology is not None:
            topology.validate_for(self.num_devices)
            if aggregation == "optimal":
                raise ValueError(
                    "aggregation='optimal' picks one argmax model — there "
                    "is no two-level Eq. 1 decomposition to run per fog "
                    "group; use average | weighted | fedavg_n with a "
                    "topology")
        if state.rng is None:
            raise ValueError("the state has no generator (a restored "
                             "checkpoint): call resume_state first")
        self._check_capacity(state, rounds=rounds)
        D = self.num_devices
        dev = self.device
        # [D] vectors are global on every rank; [D, ...] trees hold the
        # rank's rows (``loc`` slices, ``gather`` assembles)
        fl = self.fleet
        loc, gather = fl.local, fl.gather
        limits = None
        if hetero is not None:
            limits = hetero_mod.device_step_limits(
                hetero, D, self.cfg.train_steps_per_acq)
            if hetero.straggler_rate > 0.0:
                if upload_mask is not None or upload_fraction < 1.0:
                    raise ValueError(
                        "pass either hetero.straggler_rate or an explicit "
                        "upload_mask/upload_fraction participation model, "
                        "not both (set straggler_rate=0 to drive hetero "
                        "rounds from a host schedule)")
                upload_fraction = 1.0 - hetero.straggler_rate
        if topology is not None:
            # a fog group's compute profile caps its slots' step budgets
            limits = topo_mod.topology_step_limits(
                topology, D, self.cfg.train_steps_per_acq, base=limits)
        step_limit = (None if limits is None
                      else loc(torch.as_tensor(limits, device=dev)))
        if upload_mask is not None:
            m = np.asarray(upload_mask, np.float32)
            if m.ndim == 1:
                m = np.broadcast_to(m, (rounds, D))
            if m.shape != (rounds, D):
                raise ValueError(f"upload_mask shape {m.shape} != "
                                 f"{(rounds, D)}")
        elif upload_fraction < 1.0:
            m = np.stack([
                np.random.default_rng([self.cfg.seed + 0x6D61, t]).random(D)
                < upload_fraction
                for t in range(start_round, start_round + rounds)])
        else:
            m = np.ones((rounds, D), np.float32)
        masks = torch.as_tensor(np.asarray(m, np.float32), device=dev)
        live_rows = None
        if live_mask is not None:
            lm = np.asarray(live_mask, np.float32)
            if lm.ndim == 1:
                lm = np.broadcast_to(lm, (rounds, D))
            if lm.shape != (rounds, D):
                raise ValueError(f"live_mask shape {lm.shape} != "
                                 f"{(rounds, D)}")
            live_rows = torch.as_tensor(np.array(lm), device=dev)

        # extension buffers: created as zeros when their feature turns on,
        # dropped when it is off; the loop updates residual and pending in
        # place, so never the caller's
        fresh = lambda buf, make: (tree_map(torch.clone, buf)
                                   if tree_leaves(buf) else make())
        # the state's [D] vectors hold the rank's rows
        fresh_vec = lambda buf, make: (gather(buf).clone()
                                       if tree_leaves(buf) else make())
        codec = comms if comms is not None and comms.lossy else None
        residual = pending = staleness = live = None
        if codec is not None and codec.error_feedback:
            residual = fresh(state.residual,
                             lambda: tree_map(torch.zeros_like, state.params))
        buffering = hetero is not None and hetero.buffer_stale
        if buffering:
            pending = fresh(state.pending,
                            lambda: tree_map(torch.zeros_like, state.params))
        if hetero is not None:
            staleness = fresh_vec(state.staleness, lambda: torch.zeros(
                (D,), dtype=torch.int32, device=dev))
        churn = live_mask is not None or faults is not None
        if churn:
            live = fresh_vec(state.live, lambda: torch.ones((D,), device=dev))
        guarded = faults is not None or guards is not None
        keeps_model = hetero is not None or churn or guards is not None
        rates = faults_mod.rates_vector(faults)
        fog_codec = None
        if topology is not None:
            G = topology.num_groups
            gid = topology.segment_ids(dev)
            segments = (gid, G)
            syncs = topo_mod.sync_schedule(topology, rounds, start_round) > 0
            fog_comp = "none" if comms is None else comms.fog_compression
            if fog_comp != "none":
                # the reference's fog-tier codec: the config's defaults
                # but for the compression
                fog_codec = comms_mod.CommsConfig(compression=fog_comp)
        # the fog codec compresses per-group DELTA sums, so it takes the
        # delta form as faults and guards do
        rows_form = guarded or (fog_codec is not None and codec is None)

        counters.count_dispatch()
        trainer = self.trainer
        # a copy of the state's generator: a state is a value, and two
        # calls from it draw alike
        params, opt_state, pool, gen = (state.params, state.opt_state,
                                        state.pool, copy_generator(state.rng))
        excl = frozenset(excluded_paths(trainer.adapter, params))
        fog = None
        if topology is not None:
            # the [G, ...] fog models: each group's first slot (rows within
            # a group are identical by the dispatch protocol, which also
            # covers a call that starts between syncs)
            fog = fl.rows_at({path: leaf for path, leaf in tree_items(params)
                              if path not in excl},
                             topo_mod.first_slots(topology))
        recs: Dict[str, list] = {}
        agg = None
        for t in range(rounds):
            r_abs = start_round + t
            if t > 0:
                gen = self.device_generator(r_abs)
            mask = masks[t]
            row = {}
            # ---- liveness and fault draws (numpy, absolute round index)
            if faults is not None:
                draws = faults_mod.round_draws(
                    faults, r_abs, D, self.labels.shape[1],
                    trainer.adapter.num_classes)
            if live_rows is not None:
                live = live_rows[t]
            elif faults is not None:
                live = faults_mod.update_liveness(
                    live, draws.u_death, draws.u_birth,
                    rates[faults_mod.RATE_DEATH],
                    rates[faults_mod.RATE_BIRTH])
            # active = survived the round's local work
            active = live
            labels = None
            if faults is not None:
                crash, drop, corrupt, noise = faults_mod.draw_fault_masks(
                    torch.as_tensor(draws.u_faults, device=dev), rates)
                row["crashed"] = crash if live is None else crash * live
                active = (1.0 - crash) if active is None \
                    else active * (1.0 - crash)
                labels = torch.where(
                    loc(noise)[:, None] > 0,
                    torch.as_tensor(loc(draws.noisy_labels), device=dev),
                    self.labels)
            params_prev = params
            params2, opt2, pool2, _ = self._round(
                params, opt_state, pool, gen, record_curves=False,
                labels=labels, step_limit=step_limit)
            if active is not None:
                # dead or crashed devices lose the round
                active_l = loc(active)
                params = _where_rows(active_l, params2, params)
                opt_state = _where_rows(active_l, opt2, opt_state)
                pool = vpool.VPool(*_where_rows(active_l, tuple(pool2),
                                                tuple(pool)))
            else:
                params, opt_state, pool = params2, opt2, pool2
            del params2, opt2, pool2
            # upload: the device transmitted; recv: the fog node received
            upload = mask if active is None else mask * active
            recv = upload if faults is None else upload * (1.0 - drop)

            counts = gather(vpool.n_labeled(pool).float())
            accs = (gather(agg_mod.stacked_accuracy(
                trainer.eval_logits, params, self.test_images,
                self.test_labels)) if has_val else torch.zeros_like(counts))
            upload_l = loc(upload)
            if aggregation == "average":
                raw = torch.ones_like(counts)
            elif aggregation == "weighted":
                raw = accs
            elif aggregation == "fedavg_n":
                raw = counts
            else:  # optimal: one-hot at the best participant
                masked = torch.where(mask > 0, accs,
                                     torch.full_like(accs, -float("inf")))
                raw = torch.nn.functional.one_hot(
                    torch.argmax(masked), D).float()
            with torch.no_grad():
                sync = topology is None or bool(syncs[t])
                sent = scales = None
                if rows_form:
                    # the guards judge whole uploads: build every leaf's
                    # received rows before any weight exists
                    sent = _upload_rows(
                        codec, params, params_prev, residual, upload_l, excl,
                        self.comms_generator(r_abs), pending)
                    if faults is not None:
                        sent = faults_mod.corrupt_stacked(
                            faults.corrupt_mode, sent, loc(corrupt * recv),
                            rates[faults_mod.RATE_CORRUPT_SCALE])
                elif codec is not None:
                    sent, scales = _encode_uploads(
                        codec, params, params_prev, residual, upload_l, excl,
                        self.comms_generator(r_abs), pending)
                # the wire payload (bfloat16 values, int8 codes) reduces to
                # float32; decoded rows keep their dtype
                red = dict(scales=scales, out_dtype=(
                    None if rows_form else torch.float32))
                accept = recv
                if guards is not None:
                    norms = gather(faults_mod.stacked_norms(sent))
                    reject, clip, scale = faults_mod.guard_verdict(
                        norms, gather(faults_mod.stacked_finite(sent)), recv,
                        policy=guards.policy, factor=guards.norm_factor,
                        group_ids=None if topology is None else gid,
                        num_groups=None if topology is None else G)
                    accept = recv * (1.0 - reject)
                    if guards.policy == "clip":
                        scale_l = loc(scale)
                        sent = tree_map(lambda a: a * _rows(scale_l, a), sent)
                    sent = _where_rows(loc(accept), sent,
                                       tree_map(torch.zeros_like, sent))
                    row.update(rejected=reject, clipped=clip,
                               upload_norms=norms, accepted=accept)
                decayed = raw
                if hetero is not None:
                    row["staleness"] = staleness
                    decayed = raw * agg_mod.staleness_decay(
                        staleness, kind=hetero.decay,
                        rate=hetero.decay_rate)
                w = agg_mod.masked_normalize(decayed, accept)
                accept_any = bool(accept.sum() > 0)
                if keeps_model and not accept_any:
                    # nothing accepted: aggregate nothing (the uniform
                    # fallback would fold in unweighted work, and every
                    # banked backlog twice)
                    w = torch.zeros_like(w)
                if topology is not None:
                    # intra-fog alpha (per-group normalization of the same
                    # basis) and inter-fog beta (group arrival-mass shares:
                    # alpha·beta is the flat weight)
                    alpha, beta, group_any = topo_mod.two_tier_weights(
                        decayed, accept, gid, G)
                    row.update(fog_sync=torch.tensor(float(sync), device=dev),
                               beta=beta, group_accept=agg_mod.segment_sum(
                                   accept, gid, G))

                prev = dict(tree_items(params_prev))
                fog_cand = None
                if sent is not None:
                    # delta form: BASE + Σ w_i · sent_i, the base the
                    # dispatched model (flat) or Σ_g β_g F_g (topology: the
                    # dispatched model bit for bit at G = 1)
                    if topology is None:
                        base = {path: prev[path][0] for path in sent}
                    else:
                        base = topo_mod.group_reduce_stacked(fog, beta)
                        if fog_codec is not None or not sync:
                            fog_delta = _reduce(fl, sent, alpha,
                                                segments=segments, **red)
                            fog_cand = {path: fog[path] + fog_delta[path]
                                        for path in fog}
                    if fog_codec is not None:
                        # the fog→cloud link carries each group's
                        # compressed delta sum
                        reduced = topo_mod.group_reduce_stacked(
                            _fog_codec(fog_codec, fog_delta, self.cfg.seed,
                                       r_abs), beta)
                        del fog_delta
                    else:
                        reduced = _reduce(fl, sent, w, **red)
                    del sent
                    first = _slot0(fl, params, excl)
                    agg = tree_map_with_path(
                        lambda path, leaf: (
                            first[path] if path in excl
                            else base[path] + reduced[path]), params)
                    del reduced, base
                else:
                    # direct Eq. 1, plus Σ w_i · pending_i for buffering
                    # hetero: equal to the delta form since Σw = 1, and
                    # the synchronous round itself when nothing is pending
                    agg = _aggregate_shared(fl, params, w, excl)
                    held = None
                    if pending is not None:
                        held = {path: leaf for path, leaf
                                in tree_items(pending) if path not in excl}
                        late = _reduce(fl, held, w)
                        agg = tree_map_with_path(
                            lambda path, leaf: (leaf if path in excl
                                                else leaf + late[path]), agg)
                        del late
                    if topology is not None and not sync:
                        # each fog group's own Eq. 1 (a fog-local round)
                        shared = {path: leaf for path, leaf
                                  in tree_items(params) if path not in excl}
                        fog_cand = _reduce(fl, shared, alpha,
                                           segments=segments)
                        if held is not None:
                            late = _reduce(fl, held, alpha, segments=segments)
                            fog_cand = {path: fog_cand[path] + late[path]
                                        for path in fog_cand}
                            del late
                    if held is not None:
                        # transmitted backlogs clear, missed rounds bank
                        # this round's work
                        for path, leaf in tree_items(params):
                            if path in held:
                                _backlog(leaf, prev[path], held[path],
                                         _rows(upload_l, leaf) > 0)
                if keeps_model and not accept_any:
                    # the fog node re-dispatches its previous model
                    first = _slot0(fl, params, excl)
                    agg = tree_map_with_path(
                        lambda path, leaf: (
                            first[path] if path in excl
                            else (prev[path][0] if topology is None
                                  else fog[path][0])), params)
                if topology is not None:
                    # sync rounds broadcast the global model to every fog
                    # group; fog-local rounds advance each group's own
                    # model, and a group that accepted nothing keeps its
                    aggs = dict(tree_items(agg))
                    if sync:
                        if accept_any:
                            fog = {path: aggs[path].unsqueeze(0).expand(
                                (G,) + tuple(aggs[path].shape))
                                for path in fog}
                    else:
                        fog = {path: torch.where(
                            _rows(group_any, fog[path]), fog_cand[path],
                            fog[path]) for path in fog}
                    del aggs
                del fog_cand, prev
            del params_prev
            if hetero is not None:
                # dead devices do not age: their backlog gets no staler
                aging = 1 if live is None else live.to(torch.int32)
                staleness = torch.where(upload > 0, 0, staleness + aging)
            if churn:
                row["live"] = live
            if faults is not None:
                row["dropped"] = drop * upload
                row["corrupted"] = corrupt * recv
            row.update(weights=w, upload_mask=mask, n_labeled=counts)
            if has_val:
                row["device_accs"] = accs
                row["agg_acc"] = agg_mod.stacked_accuracy(
                    trainer.eval_logits, broadcast_params(agg, 1),
                    self.test_images, self.test_labels)[0]
            for k, v in row.items():
                recs.setdefault(k, []).append(v)
            # re-dispatch: fresh optimizer, pools persist; excluded leaves
            # keep each device's own trained value; with a topology each
            # slot reads its own group's fog model
            dispatched = dict(tree_items(
                broadcast_params(agg, fl.local_rows) if topology is None
                else topo_mod.take_group_rows(fog, loc(gid))))
            params = tree_map_with_path(
                lambda path, trained: (trained if path in excl
                                       else dispatched[path]), params)
            del dispatched
            opt_state = trainer.opt.init(params)
        out = {k: torch.stack(v) for k, v in recs.items()}
        if topology is not None:
            # one returned model: the slot-share mix of the fog models
            # (1.0 at G = 1; exact after a sync round), excluded leaves
            # device 0's
            share = torch.as_tensor(topology.group_sizes(),
                                    dtype=torch.float32, device=dev) / D
            mixed = topo_mod.group_reduce_stacked(fog, share)
            first = _slot0(fl, params, excl)
            agg = tree_map_with_path(
                lambda path, leaf: first[path] if path in excl
                else mixed[path], params)
        # the generator the next round draws from, as resume_state installs
        # it: a chained call then equals the uninterrupted run
        none = lambda b: () if b is None else b
        rows = lambda v: () if v is None else loc(v)
        return (EngineState(params, opt_state, pool,
                            self.device_generator(start_round + rounds),
                            none(residual), none(pending), rows(staleness),
                            rows(live)),
                out, agg)

    def run_async(self, state: EngineState, events: int, *, async_cfg=None,
                  aggregation: str = "fedavg_n", comms=None,
                  start_event: int = 0, faults=None, guards=None,
                  topology=None, stream=None, hetero=None, fleet=None):
        """Rounds-free FedAsync / FedBuff aggregation: ``events`` quorum-
        or timer-triggered fog events over simulated device latencies,
        with live traffic under ``stream`` and the options bundled in
        ``fleet`` (``core.async_engine.run_events_fused``, of which this is
        a thin delegate)."""
        from repro_torch.core.async_engine import run_events_fused
        return run_events_fused(self, state, events, async_cfg=async_cfg,
                                aggregation=aggregation, comms=comms,
                                start_event=start_event, faults=faults,
                                guards=guards, topology=topology,
                                stream=stream, hetero=hetero, fleet=fleet)

    # ------------------------------------------------------------ reporting
    def histories(self, recs) -> List[List[dict]]:
        """Stacked records ``[D, R, ...]`` → per-device history dicts."""
        n_lab = recs["n_labeled"].cpu().numpy()
        sel = recs["selected"].cpu().numpy()
        acc = recs["test_acc"].cpu().numpy() if "test_acc" in recs else None
        out = []
        for d in range(n_lab.shape[0]):
            hist = []
            for r in range(n_lab.shape[1]):
                rec = {"device": d, "acquisition": r + 1,
                       "n_labeled": int(n_lab[d, r]),
                       "selected": sel[d, r][sel[d, r] >= 0].tolist()}
                if acc is not None:
                    rec["test_acc"] = float(acc[d, r])
                hist.append(rec)
            out.append(hist)
        return out
