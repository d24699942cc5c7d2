"""The rounds-free event loop (``core.async_engine``) in the port against
the JAX package on the CPU, and against the port's own fused rounds.

Parity runs use the RNG-free configuration of ``test_torch_faults.py``
(dropout 0, the window covering every shard) on a D = 8 LeNet fleet, four
events.  The port's two draw functions are replaced by the reference's
draws for the same absolute event: ``async_engine.latency_draws`` by the
exponential or normal draws folded from ``jax.random.key(seed +
0x6C6174)``, and ``faults.round_draws`` by the uniforms and labels split
from ``fault_keys``.  Three reference programs: a FedBuff quorum of 2
with a timer over exponential latencies with a 10x skew; the same with a
shorter timer (events that receive nothing), churn, crashes, drops,
NaN corruption, label noise and guards ``"drop"``;
lognormal latencies with a top-k 0.05 codec and error feedback.
Tolerances: arrival masks, arrivals, timer events, staleness, labeled
counts and the fault and guard rows exact; ``sim_time`` exact, 1e-6
relative with lognormal latencies (XLA's and numpy's float32 ``exp`` may
differ by an ulp); Eq. 1 weights 1e-6; upload norms 1e-4 relative;
params, the fog model and the banked deltas 1e-4 by the per-device-delta
rule of ``test_torch_hetero.py``; the error-feedback residual by
``comms.residual_gaps`` on the last event's codec inputs, as in
``test_torch_comms.py``.  The faults case corrupts with NaN, which the
guards reject at any arrival count: a lone x50-scaled arrival is its own
median, passes the guards in both packages, and multiplies the float32
gaps between them by 50 (``test_torch_faults.py`` holds the scaled mode
and the norm outliers).  Against the port's own ``run_rounds_fused``:
the synchronous limit (zero latency, quorum D) within 1e-5 for LeNet and
a tiny SSM LM fleet.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import async_engine as jasync  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import federated as jfed  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation, async_engine, comms, faults  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.core.async_engine import AsyncConfig  # noqa: E402
from repro_torch.core.comms import CommsConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.core.hetero import HeteroConfig  # noqa: E402
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
D, EVENTS = 8, 4

QUORUM = dict(quorum=2, timer=0.3, dist="exp", mean_latency=1.0,
              latency_skew=10.0)
CASES = {
    "quorum-timer": dict(async_cfg=QUORUM),
    "faults-guards": dict(
        async_cfg=dict(QUORUM, timer=0.25),
        faults=FaultConfig(death_rate=0.3, birth_rate=0.5, crash_rate=0.2,
                           drop_rate=0.2, corrupt_rate=0.5,
                           corrupt_mode="nan", label_noise_rate=0.3,
                           seed=4),
        guards=GuardConfig(policy="drop", norm_factor=3.0)),
    "lognormal-topk": dict(
        async_cfg=dict(QUORUM, dist="lognormal", sigma=0.8),
        comms=CommsConfig(compression="topk", topk_fraction=0.05)),
}


def _fleet():
    full, test = j_digits(160, seed=0), j_digits(40, seed=5)
    return j_split(full, D, seed=0), j_digits(6, seed=11), test


def _port_engine(shards, seed_set, test, events=EVENTS, **cfg_kw):
    cfg = fed.FederatedALConfig(num_devices=D, **dict(SLICE, **cfg_kw))
    tr = fed.Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                     device="cpu")
    return EdgeEngine(tr, cfg, shards, seed_set, test,
                      total_acquisitions=cfg.acquisitions * events,
                      device="cpu")


def _jfault(cfg: FaultConfig):
    return jfaults.FaultConfig(**{f: getattr(cfg, f) for f in (
        "death_rate", "birth_rate", "crash_rate", "restart_mult",
        "drop_rate", "corrupt_rate", "corrupt_mode", "corrupt_scale",
        "label_noise_rate", "seed")})


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32))


def reference_fault_draws(cfg: FaultConfig, events: int):
    """``faults.round_draws`` with the reference's draws: event e's fault
    key split as the reference's event body splits it."""
    keys = jfaults.fault_keys(_jfault(cfg), 0, events)

    def draws(c, event_idx, num_devices, n_pad, num_classes):
        assert c == cfg
        k_live, k_flt, k_labels = jax.random.split(keys[event_idx], 3)
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
    """``async_engine.latency_draws`` with the reference's draws: event
    e's key folded from the latency stream's base key."""
    base = jax.random.key(acfg.seed + async_engine.LATENCY_STREAM)

    def draws(c, event_idx, num_devices):
        assert c == acfg
        if c.dist == "det":
            return None
        key = jax.random.fold_in(base, event_idx)
        fn = jax.random.exponential if c.dist == "exp" else jax.random.normal
        return np.asarray(fn(key, (num_devices,)))

    return draws


@pytest.fixture(scope="module")
def fleet():
    shards, seed_set, test = _fleet()
    cfg_j = JConfig(num_devices=D, **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    p0 = tr_j.init_params(jax.random.key(1))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * EVENTS,
                    scorer="jnp", aggregate_impl="ref", unroll=False)
    eng_t = _port_engine(shards, seed_set, test)
    p0_t = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu")
    return (shards, seed_set, test), (eng_j, p0), (eng_t, p0_t)


@pytest.fixture(scope="module", params=sorted(CASES))
def event_pair(request, fleet):
    case = CASES[request.param]
    _, (eng_j, p0), (eng_t, p0_t) = fleet
    acfg = AsyncConfig(**case["async_cfg"])
    jkw = dict(async_cfg=jasync.AsyncConfig(**case["async_cfg"]))
    kw = dict(async_cfg=acfg)
    if "faults" in case:
        kw.update(faults=case["faults"], guards=case["guards"])
        jkw.update(faults=_jfault(case["faults"]),
                   guards=jfaults.GuardConfig(
                       policy=case["guards"].policy,
                       norm_factor=case["guards"].norm_factor))
    if "comms" in case:
        kw["comms"] = case["comms"]
        jkw["comms"] = jcomms.CommsConfig(
            compression=case["comms"].compression,
            topk_fraction=case["comms"].topk_fraction)
    out_j = eng_j.run_async(eng_j.init_state(p0), EVENTS, **jkw)
    inputs = []
    encode = comms.encode_rows

    def keep(cfg, x, generator=None):
        inputs.append(x.detach().clone())
        return encode(cfg, x, generator)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(async_engine, "latency_draws",
                   reference_latency_draws(acfg))
        mp.setattr(comms, "encode_rows", keep)
        if "faults" in case:
            mp.setattr(faults, "round_draws",
                       reference_fault_draws(case["faults"], EVENTS))
        out_t = eng_t.run_async(eng_t.init_state(p0_t), EVENTS, **kw)
    return request.param, case, out_j, out_t, inputs


# the most one event's fit can move an entry: each Adam step moves it by
# about the learning rate (1e-3) at most
FIT_REACH = SLICE["acquisitions"] * SLICE["train_steps_per_acq"] * 1e-3

# the most the two packages' codec inputs differ by (test_torch_comms.py)
INPUT_EPS = 2e-4


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


def test_events_match_reference(event_pair):
    name, case, (st_j, recs_j, fog_j), (st_t, recs_t, fog_t), inputs = \
        event_pair
    exact = ("upload_mask", "arrivals", "timer_fired", "staleness",
             "n_labeled")
    if "faults" in case:
        exact += faults.REPORT_KEYS + ("accepted",)
    for key in exact:
        np.testing.assert_array_equal(recs_t[key].numpy(),
                                      np.asarray(recs_j[key]), err_msg=key)
    sim_t, sim_j = recs_t["sim_time"].numpy(), np.asarray(recs_j["sim_time"])
    if case["async_cfg"]["dist"] == "lognormal":
        np.testing.assert_allclose(sim_t, sim_j, rtol=1e-6)
    else:
        np.testing.assert_array_equal(sim_t, sim_j)
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    # the trace has quorum events and timer events, and stale arrivals
    fired = recs_t["timer_fired"].numpy()
    assert fired.any() and not fired.all(), fired
    assert (recs_t["staleness"] * recs_t["upload_mask"]).sum() > 0
    if "faults" in case:
        got = {k: recs_t[k].sum().item() for k in faults.REPORT_KEYS}
        assert got["crashed"] and got["dropped"] and got["corrupted"], got
        assert got["rejected"] and (recs_t["live"] == 0).any(), got
        np.testing.assert_allclose(recs_t["upload_norms"].numpy(),
                                   np.asarray(recs_j["upload_norms"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(st_t.live.numpy(),
                                      np.asarray(st_j.live))
    _close(fog_j, fog_t)
    _close(st_j.params, st_t.params)
    _close(st_j.pending, st_t.pending)
    np.testing.assert_array_equal(st_t.staleness.numpy(),
                                  np.asarray(st_j.staleness))
    if "comms" in case:
        cc = case["comms"]
        last = inputs[-len(tree_leaves(st_t.residual)):]
        as_t = lambda t: [torch.from_numpy(np.array(a))
                          for a in jax.tree_util.tree_leaves(t)]
        for x, rt, rj in zip(last, tree_leaves(st_t.residual),
                             as_t(st_j.residual), strict=True):
            _, far, _, bad = comms.residual_gaps(cc, x, rt, rj, tol=1e-4,
                                                 eps=INPUT_EPS)
            assert bad == 0 and far <= comms.split_budget(x.numel()), (
                far, bad)
    else:
        assert st_t.residual == () and st_j.residual == ()


# ------------------------------------------------- the port's own contracts
SYNC_LIMIT = AsyncConfig(quorum=D, dist="det", mean_latency=0.0)


def _fog_gap(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_sync_limit_matches_fused_rounds(fleet):
    """Zero latency and a quorum of D: every event is a full barrier, and
    the loop equals ``run_rounds_fused`` (the delta form against the
    direct reduce, 1e-5)."""
    _, _, (eng, p0) = fleet
    _, rs, fs = eng.run_rounds_fused(eng.init_state(p0), 2)
    _, ra, fa = eng.run_async(eng.init_state(p0), 2, async_cfg=SYNC_LIMIT)
    assert _fog_gap(fs, fa) <= 1e-5
    for key in ("weights", "agg_acc", "device_accs"):
        np.testing.assert_allclose(rs[key].numpy(), ra[key].numpy(),
                                   atol=1e-6, err_msg=key)
    assert not ra["staleness"].any() and not ra["sim_time"].any()
    assert ra["arrivals"].tolist() == [D, D]


def test_sync_limit_matches_fused_rounds_lm():
    """The same on a tiny SSM LM fleet: the fog model's shared leaves and
    each device's own recurrent state (kept out of Eq. 1 and never
    overwritten by a dispatch) within 1e-5."""
    from repro_torch.core.model_adapter import SSMAdapter, excluded_paths
    from repro_torch.data.lm import lm_federated_split, make_lm_dataset
    vocab, seq = 64, 8
    cfg = fed.FederatedALConfig(
        num_devices=2, initial_train=4, acquisitions=2, k_per_acquisition=2,
        pool_window=32, mc_samples=2, train_steps_per_acq=2,
        initial_train_steps=2, aggregation="fedavg_n",
        adapter=SSMAdapter(fed.lm_model_config(vocab=vocab, seq_len=seq,
                                               dropout_rate=0.0)))
    shards = lm_federated_split(2, 10, seq_len=seq, vocab=vocab, seed=0)
    test = make_lm_dataset(16, seq_len=seq, vocab=vocab, seed=5,
                           stream_seed=0)
    seed_set = make_lm_dataset(4, seq_len=seq, vocab=vocab, seed=11,
                               stream_seed=0)
    tr = fed.Trainer(cfg, device="cpu")
    eng = EdgeEngine(tr, cfg, shards, seed_set, test,
                     total_acquisitions=2 * cfg.acquisitions, device="cpu")
    p0 = tr.init_params(torch.Generator().manual_seed(0))
    st_s, _, fs = eng.run_rounds_fused(eng.init_state(p0), 2)
    st_a, ra, fa = eng.run_async(eng.init_state(p0), 2,
                                 async_cfg=replace(SYNC_LIMIT, quorum=2))
    excl = excluded_paths(tr.adapter, st_s.params)
    assert excl and ra["arrivals"].tolist() == [2, 2]
    fog_s, fog_a = dict(tree_items(fs)), dict(tree_items(fa))
    own_s, own_a = dict(tree_items(st_s.params)), dict(tree_items(st_a.params))
    for path in fog_s:
        a, b = (own_s[path], own_a[path]) if path in excl else (
            fog_s[path], fog_a[path])
        assert float((a - b).abs().max()) <= 1e-5, path


def test_mix_rate_damps_the_update(fleet):
    """η = 0.5 moves the fog model half as far as η = 1 from the same
    arrivals."""
    _, _, (eng, p0) = fleet
    start = tree_leaves(p0)
    moved = {}
    for eta in (1.0, 0.5):
        _, _, fog = eng.run_async(eng.init_state(p0), 1,
                                  async_cfg=replace(SYNC_LIMIT, mix_rate=eta))
        moved[eta] = sum(float((a - b).abs().sum())
                         for a, b in zip(tree_leaves(fog), start))
    assert 0 < moved[0.5] < moved[1.0]
    np.testing.assert_allclose(moved[0.5], 0.5 * moved[1.0], rtol=1e-3)


def test_zero_accept_timer_event_keeps_the_fog_model(fleet, monkeypatch):
    """A timer that fires before any device completes: no arrival, no
    reduce, zero weights, the fog model bit for bit the start model, and
    nobody ages (no model version was committed)."""
    _, _, (eng, p0) = fleet
    calls = []
    reduce = aggregation.aggregate_stacked
    monkeypatch.setattr(aggregation, "aggregate_stacked",
                        lambda *a, **k: calls.append(1) or reduce(*a, **k))
    st, recs, fog = eng.run_async(
        eng.init_state(p0), 2,
        async_cfg=AsyncConfig(quorum=D, timer=0.5, dist="det",
                              mean_latency=2.0))
    assert not calls
    assert recs["timer_fired"].all() and not recs["arrivals"].any()
    assert recs["sim_time"].tolist() == [0.5, 1.0]
    assert not recs["weights"].any() and not recs["staleness"].any()
    assert not st.staleness.any()
    for a, b in zip(tree_leaves(fog), tree_leaves(p0)):
        assert torch.equal(a, b)
    # the work is banked, waiting for its arrival
    assert any(bool(leaf.abs().sum() > 0) for leaf in tree_leaves(st.pending))


# ------------------------------------------------------------------ units
BAD = [dict(), dict(quorum=0), dict(timer=0.0), dict(quorum=1, dist="unif"),
       dict(quorum=1, mean_latency=-1.0), dict(quorum=1, latency_skew=0.5),
       dict(quorum=1, sigma=0.0), dict(quorum=1, decay="linear"),
       dict(quorum=1, decay_rate=0.0),
       dict(quorum=1, decay="exp", decay_rate=2.0),
       dict(quorum=1, mix_rate=0.0)]


@pytest.mark.parametrize("bad", BAD, ids=[
    "-".join(f"{k}={v}" for k, v in b.items()) or "no-trigger" for b in BAD])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jasync.AsyncConfig(**bad)
    with pytest.raises(ValueError) as got:
        AsyncConfig(**bad)
    assert str(got.value) == str(want.value)


def test_latency_means_and_scaling_match_reference():
    for kw, n in ((dict(mean_latency=2.0, latency_skew=16.0), 8),
                  (dict(mean_latency=3.0), 4), (dict(latency_skew=10.0), 1),
                  (dict(device_means=(1.0, 0.0, 2.5)), 3)):
        np.testing.assert_array_equal(
            async_engine.device_latency_means(AsyncConfig(quorum=1, **kw), n),
            jasync.device_latency_means(jasync.AsyncConfig(quorum=1, **kw),
                                        n))
    for bad in ((1.0,), (1.0, -1.0)):
        for mod in (async_engine, jasync):
            with pytest.raises(ValueError, match="device_means"):
                mod.device_latency_means(
                    mod.AsyncConfig(quorum=1, device_means=bad), 2)
    means = async_engine.device_latency_means(
        AsyncConfig(quorum=1, latency_skew=10.0), 8)
    key = jax.random.key(3)
    for dist in ("det", "exp", "lognormal"):
        acfg = AsyncConfig(quorum=1, dist=dist, sigma=0.7)
        want = np.asarray(jasync._draw_latency((dist, 0.7), key,
                                               jnp.asarray(means)))
        fn = jax.random.exponential if dist == "exp" else jax.random.normal
        got = async_engine.scale_latency(
            acfg, None if dist == "det" else np.asarray(fn(key, (8,))), means)
        assert got.dtype == np.float32
        if dist == "lognormal":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    # the port's own numpy stream: per event, repeatable, det draws nothing
    acfg = AsyncConfig(quorum=1, seed=2)
    a, b = (async_engine.latency_draws(acfg, e, 8) for e in (5, 6))
    assert a.dtype == np.float32 and (a > 0).all() and not np.array_equal(a, b)
    np.testing.assert_array_equal(a, async_engine.latency_draws(acfg, 5, 8))
    assert async_engine.latency_draws(replace(acfg, dist="det"), 5, 8) is None


def test_presets_match_reference():
    for n in (2, 8, 256):
        assert fed.default_async(n) == AsyncConfig(
            **vars(jfed.default_async(n)))
        assert fed.async_config(n) == fed.massive_config(n)
    assert fed.ASYNC_LATENCY_SKEW == jfed.ASYNC_LATENCY_SKEW


def test_rejections(fleet):
    (shards, seed_set, test), _, (eng, p0) = fleet
    st = eng.init_state(p0)
    run = lambda **kw: eng.run_async(st, 1, **{"async_cfg": SYNC_LIMIT,
                                               **kw})
    with pytest.raises(ValueError, match="needs an AsyncConfig"):
        eng.run_async(st, 1)
    with pytest.raises(ValueError, match="optimal"):
        run(aggregation="optimal")
    with pytest.raises(ValueError, match="straggler_rate"):
        run(hetero=HeteroConfig(straggler_rate=0.2))
    with pytest.raises(ValueError, match="capacity"):
        eng.run_async(st, EVENTS + 1, async_cfg=SYNC_LIMIT)
    no_test = EdgeEngine(eng.trainer, eng.cfg, shards, seed_set, None,
                         total_acquisitions=4, device="cpu")
    with pytest.raises(ValueError, match="validation set"):
        no_test.run_async(no_test.init_state(p0), 1, async_cfg=SYNC_LIMIT,
                          aggregation="weighted")
    # live traffic and the fleet bundle run (test_torch_stream.py); a
    # stream needs the async engine, as in the reference
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.stream import StreamConfig
    _, recs, _ = run(stream=StreamConfig(arrival_rate=0.0))
    assert not recs["offered"].any() and recs["queue_depth"].shape == (1, D)
    _, recs, _ = eng.run_async(st, 1, fleet=FleetConfig(async_cfg=SYNC_LIMIT))
    assert recs["arrivals"].tolist() == [D]
    # the fog topology runs (tests/port_torch/test_torch_topology.py)
    from repro_torch.core.topology import uniform_topology
    _, recs, fog = run(topology=uniform_topology(D, 2))
    assert recs["fog_sync"].tolist() == [1.0]
    assert tree_leaves(fog)[0].shape[0] == 2
    cfg = eng.cfg
    with pytest.raises(ValueError, match="engine='async'"):
        fed.run_federated_rounds(cfg, shards, seed_set, test, rounds=1,
                                 engine="fused", async_cfg=SYNC_LIMIT,
                                 device="cpu")
    with pytest.raises(ValueError, match="requires engine='async'"):
        fed.run_federated_rounds(cfg, shards, seed_set, test, rounds=1,
                                 engine="fused", device="cpu",
                                 stream=StreamConfig())
    with pytest.raises(ValueError, match="hetero"):
        fed.run_federated_rounds(cfg, shards, seed_set, test, rounds=1,
                                 engine="async", device="cpu",
                                 hetero=HeteroConfig(straggler_rate=0.2))
    with pytest.raises(ValueError, match="upload_fraction"):
        fed.run_federated_rounds(cfg, shards, seed_set, test, rounds=1,
                                 engine="async", upload_fraction=0.5,
                                 device="cpu")
    # the sharded device axis is ported: a one-rank mesh runs the async
    # engine as the unsharded run does, bit for bit
    from torch import distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    drive = lambda **kw: fed.run_federated_rounds(
        cfg, shards, seed_set, test, rounds=1, engine="async", device="cpu",
        **kw)
    try:
        (p_mesh, r_mesh), (p_one, r_one) = (
            drive(mesh=make_device_mesh(device="cpu")), drive())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert r_mesh == r_one
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_mesh),
                                                 tree_leaves(p_one)))


def test_async_telemetry_shapes(fleet):
    _, _, (eng, p0) = fleet
    _, recs, _ = eng.run_async(
        eng.init_state(p0), 2,
        async_cfg=AsyncConfig(quorum=3, dist="exp", latency_skew=4.0))
    tel = async_engine.async_telemetry(recs)
    assert tel == jasync.async_telemetry(
        {k: v.numpy() for k, v in recs.items()})
    assert tel["events"] == 2 and tel["mean_arrivals_per_event"] >= 3
    assert tel["sim_seconds_total"] == tel["sim_time_per_event"][-1] > 0
    assert len(tel["accuracy_vs_sim_time"]) == 2
    reports = [{"sim_time": float(recs["sim_time"][t]),
                "arrivals": int(recs["arrivals"][t]),
                "timer_fired": bool(recs["timer_fired"][t]),
                "staleness": recs["staleness"][t].tolist(),
                "aggregated_acc": float(recs["agg_acc"][t])}
               for t in range(2)]
    assert async_engine.report_telemetry(reports) == \
        jasync.report_telemetry(reports)
