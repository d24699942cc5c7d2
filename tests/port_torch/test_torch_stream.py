"""Live traffic (``core.stream``, ``core.cascade``), the fleet bundle
(``core.fleet``) and the scenario registry in the port, against the JAX
package on the CPU and against the port's own async loop.

Parity runs: the RNG-free D = 8 LeNet fleet of ``test_torch_async.py``
(dropout 0, a window over every shard), three events, two reference
programs shared through a module fixture: (a) score selection, Poisson
arrivals with burst 0.5 and drift κ 2 / period 8, a FedBuff quorum with a
timer; (b) random selection, ``"det"`` arrivals, churn and crashes with
guards ``"drop"``.  The port's draw functions are replaced by the
reference's draws for the same absolute event: ``stream.stream_draws`` by
the keys folded as the reference folds them (``fold_in(key(seed +
0x737472), event)``, then per device ``fold_in(·, gid)`` → ``(k_cnt,
k_pick)`` and ``fold_in(·, D + gid)`` → ``(k_score, k_rank)``), besides
``async_engine.latency_draws`` and ``faults.round_draws``.  Each case
serves, escalates, keeps and drops at least once, and no queued score lies
within 1e-4 of a threshold.  Tolerances: the stream rows, queue depths,
labeled masks, arrivals, staleness and the fault rows exact; params and
the fog model 1e-4 by the per-device-delta rule of ``test_torch_hetero.py``.

Against the port itself: a zero-rate stream equals the plain async run
bit for bit.  Units against the reference functions: ``cascade_decide``
(its edges, a duplicate slot, a labeled slot), ``queue_append``,
``drift_logits``, ``device_arrival_rates``, the cascade schedule,
``StreamConfig`` validation, ``report_schema`` for all eight scenarios and
``stream_telemetry``; the reports of three scenarios conform to their
schema, and ``fleet=`` equals the per-feature options bit for bit.
"""
import warnings
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import async_engine as jasync  # noqa: E402
from repro.core import cascade as jcascade  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.core import stream as jstream  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import async_engine, cascade, comms, faults  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.core import fleet as fleet_mod  # noqa: E402
from repro_torch.core import stream  # noqa: E402
from repro_torch.core.async_engine import AsyncConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.core.stream import StreamConfig  # noqa: E402
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
D, EVENTS, ESC_K = 8, 3, 2
TOTAL = (SLICE["acquisitions"] + ESC_K) * EVENTS

QUORUM = dict(quorum=2, timer=0.3, dist="exp", mean_latency=1.0,
              latency_skew=10.0)
TRAFFIC = dict(rate_skew=4.0, queue_cap=4, max_arrivals=4, escalate_k=ESC_K)
CASES = {
    "a-score-poisson": dict(
        async_cfg=QUORUM,
        stream=StreamConfig(arrival_rate=20.0, burst=0.5, drift_kappa=2.0,
                            drift_period=8.0, serve_threshold=1.0,
                            escalate_threshold=2.0, **TRAFFIC)),
    "b-random-det-churn": dict(
        async_cfg=dict(QUORUM, timer=0.25),
        stream=StreamConfig(arrival_rate=12.0, process="det",
                            selection="random", serve_threshold=1.8,
                            escalate_threshold=2.0, seed=3, **TRAFFIC),
        faults=FaultConfig(death_rate=0.3, birth_rate=0.5, crash_rate=0.3,
                           seed=4),
        guards=GuardConfig(policy="drop", norm_factor=3.0)),
}


# ------------------------------------------------- the reference's draws
def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32))


def _jfault(cfg: FaultConfig):
    return jfaults.FaultConfig(**{f: getattr(cfg, f) for f in (
        "death_rate", "birth_rate", "crash_rate", "restart_mult",
        "drop_rate", "corrupt_rate", "corrupt_mode", "corrupt_scale",
        "label_noise_rate", "seed")})


def _jstream(cfg: StreamConfig):
    return jstream.StreamConfig(**vars(cfg))


def reference_fault_draws(cfg: FaultConfig, count: int):
    """``faults.round_draws`` with the reference's draws (event e's fault
    key split as the reference's event body splits it)."""
    keys = jfaults.fault_keys(_jfault(cfg), 0, count)

    def draws(c, idx, num_devices, n_pad, num_classes):
        assert c == cfg
        k_live, k_flt, k_labels = jax.random.split(keys[idx], 3)
        k_death, k_birth = jax.random.split(k_live)
        u = np.stack([_uniform(k, (num_devices,))
                      for k in jax.random.split(k_flt, 4)])
        labels = jax.random.randint(k_labels, (num_devices, n_pad), 0,
                                    num_classes, dtype=jnp.int32)
        return faults.FaultDraws(_uniform(k_death, (num_devices,)),
                                 _uniform(k_birth, (num_devices,)), u,
                                 np.asarray(labels).astype(np.int64))

    return draws


def reference_latency_draws(acfg: AsyncConfig):
    base = jax.random.key(acfg.seed + async_engine.LATENCY_STREAM)

    def draws(c, event_idx, num_devices):
        assert c == acfg
        return np.asarray(jax.random.exponential(
            jax.random.fold_in(base, event_idx), (num_devices,)))

    return draws


def reference_stream_draws(scfg: StreamConfig):
    """``stream.stream_draws`` with the reference's draws: the event's key
    folded from the stream's base key, then per global device ``gid``
    ``fold_in(gid)`` → ``(k_cnt, k_pick)`` with ``k_cnt`` → ``(k_b,
    k_n)``, and ``fold_in(D + gid)`` → ``(k_score, k_rank)``.  The count is
    the reference's ``draw_arrival_count`` at rate λ over a gap of 1 s
    (``λ·1·boost`` is ``λ·boost`` exactly), before its cap."""
    base = jax.random.key(scfg.seed + stream.STREAM_SEED)
    A, Q = scfg.max_arrivals, scfg.queue_cap

    @jax.jit
    def fleet_draws(skey, lam, logits):
        n_dev = lam.shape[0]

        def one(gid, lam_d, logits_d):
            k_cnt, k_pick = jax.random.split(jax.random.fold_in(skey, gid))
            k_b, _ = jax.random.split(k_cnt)
            boost = 1.0 + scfg.burst * (jax.random.exponential(k_b) - 1.0)
            n = jstream.draw_arrival_count(scfg.process, k_cnt, lam_d, 1.0,
                                           scfg.burst, 1 << 20)
            picks = jax.random.categorical(k_pick, logits_d, shape=(A,))
            k_score, k_rank = jax.random.split(
                jax.random.fold_in(skey, n_dev + gid))
            return (boost, n, picks, jax.random.uniform(k_rank, (Q,)),
                    jax.random.uniform(k_score, (Q,)))

        return jax.vmap(one)(jnp.arange(n_dev, dtype=jnp.int32), lam, logits)

    def draws(c, event_idx, lam, logits):
        assert c == scfg
        b, n, p, r, u = (np.asarray(x) for x in fleet_draws(
            jax.random.fold_in(base, event_idx), jnp.asarray(lam),
            jnp.asarray(logits)))
        return stream.StreamDraws(b, n.astype(np.int64), p.astype(np.int64),
                                  r, u)

    return draws


# ------------------------------------------------------------ parity runs
@pytest.fixture(scope="module")
def fleet():
    full, test = j_digits(160, seed=0), j_digits(40, seed=5)
    shards, seed_set = j_split(full, D, seed=0), j_digits(6, seed=11)
    cfg_j = JConfig(num_devices=D, **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    p0 = tr_j.init_params(jax.random.key(1))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=TOTAL, scorer="jnp",
                    aggregate_impl="ref", unroll=False)
    cfg = fed.FederatedALConfig(num_devices=D, **SLICE)
    tr = fed.Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                     device="cpu")
    eng = EdgeEngine(tr, cfg, shards, seed_set, test,
                     total_acquisitions=TOTAL, device="cpu")
    p0_t = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu")
    return (shards, seed_set, test), (eng_j, p0), (eng, p0_t)


@pytest.fixture(scope="module", params=sorted(CASES))
def stream_pair(request, fleet):
    case = CASES[request.param]
    _, (eng_j, p0), (eng, p0_t) = fleet
    acfg, scfg = AsyncConfig(**case["async_cfg"]), case["stream"]
    jkw = dict(async_cfg=jasync.AsyncConfig(**case["async_cfg"]),
               stream=_jstream(scfg))
    kw = dict(async_cfg=acfg, stream=scfg)
    if "faults" in case:
        kw.update(faults=case["faults"], guards=case["guards"])
        jkw.update(faults=_jfault(case["faults"]),
                   guards=jfaults.GuardConfig(
                       policy=case["guards"].policy,
                       norm_factor=case["guards"].norm_factor))
    out_j = eng_j.run_async(eng_j.init_state(p0), EVENTS, **jkw)
    queued = []
    decide = async_engine.cascade_decide

    def keep(scores, rank, idx, labeled, valid, *args):
        queued.append(scores[valid].clone())
        return decide(scores, rank, idx, labeled, valid, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(async_engine, "latency_draws",
                   reference_latency_draws(acfg))
        mp.setattr(stream, "stream_draws", reference_stream_draws(scfg))
        mp.setattr(async_engine, "cascade_decide", keep)
        if "faults" in case:
            mp.setattr(faults, "round_draws",
                       reference_fault_draws(case["faults"], EVENTS))
        out_t = eng.run_async(eng.init_state(p0_t), EVENTS, **kw)
    return request.param, case, out_j, out_t, torch.cat(queued)


# the most one event's fit can move an entry: each Adam step moves it by
# about the learning rate (1e-3) at most
FIT_REACH = SLICE["acquisitions"] * SLICE["train_steps_per_acq"] * 1e-3


def _close(tree_j, tree_t):
    """Trees within 1e-4, but for at most ``comms.split_budget`` entries
    of a leaf, each within ``FIT_REACH``."""
    lj = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree_j)]
    lt = tree_leaves(interop.params_to_jax(tree_t))
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        gap = np.abs(b - a)
        assert gap.max() <= FIT_REACH, gap.max()
        assert (gap > 1e-4).sum() <= comms.split_budget(gap.size)


def test_stream_matches_reference(stream_pair):
    name, case, (st_j, recs_j, fog_j), (st_t, recs_t, fog_t), scores = \
        stream_pair
    exact = stream.STREAM_REPORT_KEYS + (
        "upload_mask", "arrivals", "timer_fired", "staleness", "n_labeled",
        "sim_time")
    if "faults" in case:
        exact += faults.REPORT_KEYS + ("accepted",)
    for key in exact:
        np.testing.assert_array_equal(recs_t[key].numpy(),
                                      np.asarray(recs_j[key]), err_msg=key)
    np.testing.assert_array_equal(st_t.pool.labeled_mask.numpy(),
                                  np.asarray(st_j.pool.labeled_mask))
    np.testing.assert_array_equal(st_t.pool.labeled_valid.numpy(),
                                  np.asarray(st_j.pool.labeled_valid))
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    _close(fog_j, fog_t)
    _close(st_j.params, st_t.params)
    # the case serves, escalates, keeps and drops, and every queued
    # score is clear of the thresholds in use
    got = {k: recs_t[k].sum().item() for k in stream.STREAM_REPORT_KEYS}
    assert all(got[k] > 0 for k in ("served", "escalated", "queue_depth",
                                     "stream_dropped")), got
    scfg = case["stream"]
    thresholds = [scfg.serve_threshold] + (
        [scfg.escalate_threshold] if scfg.selection == "score" else [])
    for thr in thresholds:
        assert float((scores - thr).abs().min()) > 1e-4, thr
    if "faults" in case:
        assert (recs_t["live"] == 0).any() and recs_t["crashed"].any()
    # every request offered to a non-empty shard was dropped, served,
    # escalated or is still queued
    assert got["offered"] == got["stream_dropped"] + got["served"] + \
        got["escalated"] + recs_t["queue_depth"][-1].sum().item()


def test_zero_rate_reduces_bit_for_bit(fleet):
    """A stream with no traffic equals the plain async run bit for bit:
    empty queues escalate nothing, and the queue's scoring draws from its
    own generator, never the round's."""
    _, _, (eng, p0) = fleet
    acfg = AsyncConfig(**QUORUM)
    zero = replace(CASES["a-score-poisson"]["stream"], arrival_rate=0.0)
    plain = eng.run_async(eng.init_state(p0), EVENTS, async_cfg=acfg)
    still = eng.run_async(eng.init_state(p0), EVENTS, async_cfg=acfg,
                          stream=zero)
    (s0, r0, f0), (s1, r1, f1) = plain, still
    assert set(r1) - set(r0) == set(stream.STREAM_REPORT_KEYS)
    for key in r0:
        assert torch.equal(r0[key], r1[key]), key
    assert not any(r1[k].any() for k in stream.STREAM_REPORT_KEYS)
    for a, b in zip(tree_leaves(tuple(s0._replace(rng=())) + (f0,)),
                    tree_leaves(tuple(s1._replace(rng=())) + (f1,))):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ units
def _t(x):
    return torch.as_tensor(np.asarray(x))


CASCADE = {
    "mixed": ([0.1, 2.2, 1.5, 0.4, 2.2, 1.9], [5, 2, 7, 1, 3, 4],
              [0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 0], 0.5, 1.4, 2),
    "all-serve": ([0.1, 0.5, 2.0, 0.3], [0, 1, 2, 3], [0, 0, 0, 0],
                  [1, 1, 1, 0], 0.6, np.inf, 2),
    "all-escalate": ([0.1, 0.5, 2.0, 0.3], [0, 1, 2, 3], [0, 0, 0, 0],
                     [1, 1, 1, 1], -np.inf, -np.inf, 2),
    "duplicate-slot": ([2.0, 1.9, 1.8], [5, 5, 7], [0, 0, 0], [1, 1, 1],
                       0.5, 1.0, 3),
    "labeled-slot": ([2.0, 1.9, 0.2], [5, 6, 7], [1, 0, 0], [1, 1, 1],
                     0.5, 1.0, 2),
    "ties": ([1.5, 1.5, 1.5, 1.5], [3, 1, 2, 0], [0, 0, 0, 0], [0, 1, 1, 1],
             0.5, 1.0, 2),
}


# one compile a shape, cheaper than eager JAX's one a primitive
_j_decide = jax.jit(jcascade.cascade_decide, static_argnums=7)


@pytest.mark.parametrize("name", sorted(CASCADE))
def test_cascade_decide_matches_reference(name):
    scores, idx, labeled, valid, serve_t, esc_t, k = CASCADE[name]
    scores = np.asarray(scores, np.float32)
    args = (np.asarray(idx, np.int32), np.asarray(labeled, bool),
            np.asarray(valid, bool))
    want = _j_decide(jnp.asarray(scores), jnp.asarray(scores),
                     *(jnp.asarray(a) for a in args), jnp.float32(serve_t),
                     jnp.float32(esc_t), k)
    # the port decides a batch of devices at once: the row twice
    batch = lambda a: _t(np.stack([a, a]))
    got = cascade.cascade_decide(batch(scores), batch(scores),
                                 *(batch(a) for a in args), serve_t, esc_t,
                                 k)
    for g, w in zip(got, want):
        for row in g:
            np.testing.assert_array_equal(row.numpy(), np.asarray(w))


def test_queue_append_matches_reference():
    """FIFO order, overflow and holes, several devices in one call."""
    rng = np.random.default_rng(0)
    Q, A, n = 5, 4, 10
    q_idx = rng.integers(0, 40, (n, Q)).astype(np.int32)
    q_valid = rng.random((n, Q)) < 0.5
    new_idx = rng.integers(0, 40, (n, A)).astype(np.int32)
    new_valid = rng.random((n, A)) < 0.6
    q_valid[0], new_valid[0] = True, True               # all overflow
    q_valid[1], new_valid[1] = False, False             # nothing at all
    got = stream.queue_append(_t(q_idx).long(), _t(q_valid),
                              _t(new_idx).long(), _t(new_valid))
    for i in range(n):
        want = jstream.queue_append(*(jnp.asarray(a[i]) for a in (
            q_idx, q_valid, new_idx, new_valid)))
        ok = np.asarray(want[1])
        np.testing.assert_array_equal(got[1][i].numpy(), ok)
        np.testing.assert_array_equal(got[0][i].numpy()[ok],
                                      np.asarray(want[0])[ok])
        assert int(got[2][i]) == int(want[2])
    assert int(got[2][0]) == A and not got[1][1].any()


def test_drift_and_rates_match_reference():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 10, (4, 30))
    valid = rng.random((4, 30)) < 0.8
    for kappa, period, t in ((2.0, 8.0, 0.3), (0.0, 0.0, 5.0),
                             (1.5, 3.0, 7.25)):
        got = stream.drift_logits(labels, valid, kappa, period,
                                  np.float32(t), 10)
        want = np.stack([np.asarray(jstream.drift_logits(
            jnp.asarray(labels[d]), jnp.asarray(valid[d]),
            jnp.float32(kappa), jnp.float32(period), jnp.float32(t), 10))
            for d in range(4)])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.array_equal(np.isinf(got), ~valid)
    for kw, n in ((dict(arrival_rate=2.0, rate_skew=4.0), 8),
                  (dict(arrival_rate=3.0), 4), (dict(rate_skew=9.0), 1),
                  (dict(device_rates=(1.0, 0.0, 2.5)), 3)):
        np.testing.assert_array_equal(
            stream.device_arrival_rates(StreamConfig(**kw), n),
            jstream.device_arrival_rates(jstream.StreamConfig(**kw), n))
    for bad in ((1.0,), (1.0, -1.0)):
        for mod in (stream, jstream):
            with pytest.raises(ValueError, match="device_rates"):
                mod.device_arrival_rates(
                    mod.StreamConfig(device_rates=bad), 2)


def test_stream_draws_own_stream():
    """The port's numpy draws: repeatable per event, ``det`` rounds the
    burst-scaled mean, and a pick never lands on a ``-inf`` slot."""
    cfg = StreamConfig(arrival_rate=3.0, burst=0.5, max_arrivals=6,
                       queue_cap=5, seed=2)
    lam = np.asarray([0.0, 1.0, 4.0, 9.0], np.float32)
    logits = np.where(np.arange(12) < 7, 0.5, -np.inf)[None].repeat(4, 0)
    a, b = (stream.stream_draws(cfg, e, lam, logits) for e in (5, 6))
    again = stream.stream_draws(cfg, 5, lam, logits)
    for x, y in zip(a, again):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.rank_u, b.rank_u)
    assert a.counts[0] == 0 and a.picks.max() < 7 and a.picks.shape == (4, 6)
    assert a.rank_u.shape == a.score_u.shape == (4, 5)
    det = stream.stream_draws(replace(cfg, process="det"), 5, lam, logits)
    np.testing.assert_array_equal(
        det.counts, np.round(np.maximum(lam * det.boost, 0)))


STREAM_BAD = [dict(arrival_rate=-1.0), dict(rate_skew=0.5),
              dict(burst=-0.1), dict(process="bursty"), dict(queue_cap=0),
              dict(max_arrivals=0), dict(escalate_k=0),
              dict(queue_cap=2, escalate_k=3), dict(selection="greedy"),
              dict(drift_kappa=-1.0), dict(drift_kappa=1.0)]


@pytest.mark.parametrize("bad", STREAM_BAD, ids=range(len(STREAM_BAD)))
def test_stream_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jstream.StreamConfig(**bad)
    with pytest.raises(ValueError) as got:
        StreamConfig(**bad)
    assert str(got.value) == str(want.value)


def test_schedule_and_presets_match_reference():
    for chain, micro in ((1, 1), (2, 3), (4, 2), (3, 5)):
        got = cascade.pipelined_cascade_schedule(chain, micro)
        want = jcascade.pipelined_cascade_schedule(chain, micro)
        assert [[vars(s) for s in step] for step in got] == \
            [[vars(s) for s in step] for step in want]
        assert cascade.pipelined_cascade_speedup(chain, micro) == \
            jcascade.pipelined_cascade_speedup(chain, micro)
    for n in (2, 8, 256):
        assert vars(fed.default_stream(n)) == vars(jfed.default_stream(n))
        assert fed.stream_config(n) == fed.massive_config(n)
    assert stream.STREAM_REPORT_KEYS == jstream.STREAM_REPORT_KEYS
    assert stream.PROCESSES == jstream.PROCESSES
    assert stream.SELECTIONS == jstream.SELECTIONS


def test_cascade_train_chains_links(fleet):
    """Link g starts from link g−1's model and draws from ``rng_seed +
    31·(g + 1)``."""
    (shards, seed_set, _), _, (eng, p0) = fleet
    cfg = replace(eng.cfg, acquisitions=1)
    make = lambda i: fed.EdgeDevice(i, shards[i], eng.trainer, cfg,
                                    seed_data=seed_set)
    final, links = cascade.cascade_train(p0, [make(0), make(1)],
                                         acquisitions_per_link=1)
    assert len(links) == 2 and final is links[-1]
    want = p0
    for g in range(2):
        want = make(g).run_active_learning(
            want, generator=torch.Generator().manual_seed(31 * (g + 1)),
            acquisitions=1)
        for a, b in zip(tree_leaves(want), tree_leaves(links[g])):
            assert torch.equal(a, b)


def test_report_schema_matches_reference():
    assert list(fed.SCENARIOS) == list(jfed.SCENARIOS)
    for name in jfed.SCENARIOS:
        assert fed.report_schema(name) == jfed.report_schema(name), name
        got, want = fed.SCENARIOS[name], jfed.SCENARIOS[name]
        assert (got.split, got.engine, got.description) == (
            want.split, want.engine, want.description)
    for mod in (fed, jfed):
        with pytest.raises(ValueError, match="unknown scenario"):
            mod.report_schema("nope")


def test_stream_telemetry_matches_reference():
    rng = np.random.default_rng(2)
    recs = {k: rng.integers(0, 5, (3,)).astype(np.float32)
            for k in stream.STREAM_REPORT_KEYS[:-1]}
    recs["queue_depth"] = rng.integers(0, 4, (3, 8)).astype(np.float32)
    got = stream.stream_telemetry({k: _t(v) for k, v in recs.items()},
                                  image_shape=(28, 28, 1))
    assert got == jstream.stream_telemetry(recs, image_shape=(28, 28, 1))
    # one 28 x 28 float32 image and its int32 label an escalation
    assert got["escalation_uplink_bytes"] == \
        (3136 + 4) * got["escalated_total"]


@pytest.mark.parametrize("scenario", ["stream", "async", "massive"])
def test_reports_conform_to_schema(scenario):
    cfg = replace(fed.SCENARIOS[scenario].config(4), acquisitions=1,
                  k_per_acquisition=2, pool_window=8, mc_samples=2,
                  train_steps_per_acq=2, initial_train=8,
                  initial_train_steps=2)
    rep = fed.run_experiment(cfg, scenario=scenario, num_devices=4,
                             rounds=2, n_test=32, device="cpu")[0]
    schema = fed.report_schema(scenario)
    assert not schema["repeat"] - set(rep)
    for r in rep["rounds"]:
        assert not schema["round"] - set(r), schema["round"] - set(r)
    if scenario == "stream":
        tel = rep["stream"]
        assert tel["events"] == 2 and tel["offered_total"] > 0
        assert tel["escalation_uplink_bytes"] == \
            comms.sample_bytes((28, 28, 1)) * tel["escalated_total"]


# ---------------------------------------------------------- fleet bundle
def _bits(run):
    state, recs, fog = run
    return (tree_leaves(tuple(state._replace(rng=()))) + tree_leaves(fog)
            + [recs[k] for k in sorted(recs)])


def test_fleet_bundle_equals_options(fleet):
    """``fleet=`` equals the per-feature options bit for bit on the fused
    and async engines; mixing the forms warns and the options win."""
    _, _, (eng, p0) = fleet
    topo = fed.default_topology(D, 2)
    scfg = CASES["a-score-poisson"]["stream"]
    acfg = AsyncConfig(**QUORUM)
    pairs = [
        (lambda **kw: eng.run_rounds_fused(eng.init_state(p0), 2, **kw),
         dict(hetero=fed.DEFAULT_HETERO, topology=topo)),
        (lambda **kw: eng.run_async(eng.init_state(p0), 2, **kw),
         dict(async_cfg=acfg, stream=scfg, topology=topo))]
    for run, opts in pairs:
        legacy, bundled = run(**opts), run(fleet=FleetConfig(**opts))
        for a, b in zip(_bits(legacy), _bits(bundled), strict=True):
            assert torch.equal(a, b)
    with pytest.warns(UserWarning, match="legacy values take precedence"):
        _, recs, _ = eng.run_async(
            eng.init_state(p0), 1, async_cfg=acfg,
            fleet=FleetConfig(async_cfg=AsyncConfig(quorum=D, dist="det",
                                                    mean_latency=0.0)))
    assert recs["arrivals"].tolist() != [float(D)]      # the option won
    with pytest.raises(ValueError, match="run_rounds_fused does not "
                                         "support fleet field"):
        eng.run_rounds_fused(eng.init_state(p0), 1,
                             fleet=FleetConfig(stream=scfg))
    with pytest.raises(ValueError, match="run_events_fused does not "
                                         "support fleet field"):
        eng.run_async(eng.init_state(p0), 1, async_cfg=acfg,
                      fleet=FleetConfig(live_mask=np.ones(D)))


def test_fleet_units_match_reference():
    for mod in (fleet_mod, jfleet):
        assert mod.FleetConfig().set_fields() == ()
        f = mod.FleetConfig(comms="c", stream="s")
        assert f.set_fields() == ("comms", "stream")
        assert f.merged(comms=None, hetero="h").hetero == "h"
        assert f.merged() is f
        with pytest.raises(ValueError, match="unknown fleet knob"):
            mod.resolve_fleet(None, "ctx", bogus=1)
        with pytest.raises(ValueError, match="ctx does not support"):
            mod.resolve_fleet(None, "ctx", allowed=("comms",), stream="s")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert mod.resolve_fleet(None, "ctx", comms="c").comms == "c"
    assert fleet_mod.FLEET_FIELDS == jfleet.FLEET_FIELDS
