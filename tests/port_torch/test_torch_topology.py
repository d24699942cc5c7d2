"""The fog topology (``core.topology``) in the port against the JAX package
on the CPU: the host helpers, the two-tier weights, the per-group guards
and churn, the per-tier byte ledger, and fused rounds and async events
over fog groups.

Parity runs use the RNG-free configuration of ``test_torch_faults.py``
(dropout 0, the window covering every shard) on a D = 8 LeNet fleet in
G = 2 groups syncing every 2nd round (or event).  The fused reference
program runs 3 rounds (fog-local, sync, fog-local) once with a top-k fog
codec, churn, crashes, drops, NaN corruption and guards ``"drop"`` (the
port's ``faults.round_draws`` replaced by the reference's draws), and
once with an int8 fog codec whose rounding uniforms are the reference's
(``engine.fog_uniforms`` replaced by them).  The async program runs 4
events with the reference's latency and fault draws and guards.
Tolerances: the numpy helpers, masks, ``fog_sync``, ``group_accept``,
the fault and guard rows, staleness and labeled counts exact; the
two-tier weights and β 1e-6; params, fog models and banked deltas 1e-4
by the per-device-delta rule of ``test_torch_faults.py`` (at most
``comms.split_budget`` entries of a leaf beyond it, each within one
round's fit reach).  Against the port's own flat runs:
``uniform_topology(8, 1)`` bit for bit on both engines, and a fog run
chained across a non-sync boundary bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import async_engine as jasync  # noqa: E402
from repro.core import comms as jcomms  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.federated import default_topology as j_default  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import aggregation, async_engine, comms  # noqa: E402
from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core import faults, topology  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.core.async_engine import AsyncConfig  # noqa: E402
from repro_torch.core.comms import CommsConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
D, G, ROUNDS, EVENTS = 8, 2, 3, 4
TOPO = topology.uniform_topology(D, G, local_steps=2)
J_TOPO = jtopo.uniform_topology(D, G, local_steps=2)


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32))


def _jfault(cfg: FaultConfig):
    return jfaults.FaultConfig(**{f: getattr(cfg, f) for f in (
        "death_rate", "birth_rate", "crash_rate", "restart_mult",
        "drop_rate", "corrupt_rate", "corrupt_mode", "corrupt_scale",
        "label_noise_rate", "seed")})


def _jguards(cfg: GuardConfig):
    return jfaults.GuardConfig(policy=cfg.policy, norm_factor=cfg.norm_factor)


def reference_fault_draws(cfg: FaultConfig, count: int):
    """``faults.round_draws`` with the reference's draws: round (or event)
    r's fault key split as the reference's loop body splits it."""
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


@functools.partial(jax.jit, static_argnums=(0, 3))
def _fog_draws(seed, round_idx, group, shapes):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.key(seed + engine_mod.FOG_STREAM), round_idx), group)
    return [jax.random.uniform(k, s, jnp.float32)
            for k, s in zip(jax.random.split(key, len(shapes)), shapes)]


def reference_fog_uniforms(seed, round_idx, group, shapes, device):
    """``engine.fog_uniforms`` with the reference's draws: the round's fog
    key folded with the group, split over the leaves as ``compress_tree``
    splits it, one ``uniform`` a leaf (``bernoulli`` is ``uniform < p``)."""
    draws = _fog_draws(seed, round_idx, group,
                       tuple(tuple(s) for s in shapes))
    return [torch.from_numpy(np.array(u)).to(device) for u in draws]


def reference_latency_draws(acfg: AsyncConfig):
    base = jax.random.key(acfg.seed + async_engine.LATENCY_STREAM)

    def draws(c, event_idx, num_devices):
        assert c == acfg
        key = jax.random.fold_in(base, event_idx)
        return np.asarray(jax.random.exponential(key, (num_devices,)))

    return draws


# ---------------------------------------------------------------- helpers
BAD = [dict(group_ids=(0, 1), num_groups=0),
       dict(group_ids=(0, 1), num_groups=2, local_steps=0),
       dict(group_ids=(), num_groups=1),
       dict(group_ids=(0, 2), num_groups=2),
       dict(group_ids=(0, 0, 2), num_groups=3),
       dict(group_ids=(0, 1), num_groups=2, latency_scale=(1.0,)),
       dict(group_ids=(0, 1), num_groups=2, compute_scale=(1.0, 0.0))]


@pytest.mark.parametrize("bad", BAD, ids=range(len(BAD)))
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jtopo.FogTopology(**bad)
    with pytest.raises(ValueError) as got:
        topology.FogTopology(**bad)
    assert str(got.value) == str(want.value)


def test_host_helpers_match_reference():
    for n, g, kw in ((10, 3, dict(local_steps=3)), (8, 1, {}),
                     (256, 16, dict(local_steps=4)),
                     (7, 2, dict(latency_scale=(1.0, 4.0),
                                 compute_scale=(1.0, 0.35)))):
        t, j = topology.uniform_topology(n, g, **kw), \
            jtopo.uniform_topology(n, g, **kw)
        assert t.group_ids == j.group_ids and t.num_groups == j.num_groups
        np.testing.assert_array_equal(t.ids, j.ids)
        np.testing.assert_array_equal(t.group_sizes(), j.group_sizes())
        np.testing.assert_array_equal(topology.group_representatives(t),
                                      jtopo.group_representatives(j))
        for start in (0, 5):
            np.testing.assert_array_equal(
                topology.sync_schedule(t, 9, start),
                jtopo.sync_schedule(j, 9, start))
        base = np.arange(n, dtype=np.int32) % 7 + 1
        for b in (None, base):
            want = jtopo.topology_step_limits(j, n, 10, base=b)
            got = topology.topology_step_limits(t, n, 10, base=b)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype
        means = np.linspace(0.5, 3.0, n).astype(np.float32)
        np.testing.assert_array_equal(
            topology.topology_latency_means(t, means),
            jtopo.topology_latency_means(j, means))
        assert t.ids[topology.first_slots(t)].tolist() == list(range(g))
        with pytest.raises(ValueError, match="device slots"):
            t.validate_for(n + 1)
    for n in (3, 40, 256, 4096):
        assert fed.default_topology(n) == topology.FogTopology(
            **vars(j_default(n)))
    assert fed.DEFAULT_FOG_LOCAL_STEPS == 4
    assert fed.fog_config(64) == fed.massive_config(64)


def test_tensor_helpers_match_reference():
    rng = np.random.default_rng(3)
    ids = np.array([0, 2, 1, 1, 0, 2, 2, 0], np.int32)
    tree = {"a": rng.normal(size=(8, 3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(8, 5)).astype(np.float32)}}
    coeff = rng.uniform(0, 1, 8).astype(np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = interop.params_from_jax(tree, "cpu")
    idx = torch.from_numpy(ids).long()
    pairs = [(topology.segment_sum_stacked(ttree, torch.from_numpy(coeff),
                                           idx, 3),
              jtopo.segment_sum_stacked(jtree, jnp.asarray(coeff),
                                        jnp.asarray(ids), 3))]
    fog = {"a": tree["a"][:3], "b": {"c": tree["b"]["c"][:3]}}
    beta = np.array([0.25, 0.5, 0.25], np.float32)
    tfog = interop.params_from_jax(fog, "cpu")
    jfog = jax.tree_util.tree_map(jnp.asarray, fog)
    pairs.append((topology.group_reduce_stacked(tfog,
                                                torch.from_numpy(beta)),
                  jtopo.group_reduce_stacked(jfog, jnp.asarray(beta))))
    pairs.append((topology.take_group_rows(tfog, idx),
                  jtopo.take_group_rows(jfog, jnp.asarray(ids))))
    for got, want in pairs:
        for a, b in zip(tree_leaves(interop.params_to_jax(got)),
                        jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    # the kernel's plain version in segment form is the same reduce
    seg = aggregation.aggregate_stacked(ttree, torch.from_numpy(coeff),
                                        segment_ids=idx, num_segments=3)
    for a, b in zip(tree_leaves(seg), tree_leaves(pairs[0][0])):
        assert torch.equal(a, b)


WEIGHTS = {
    "mixed": ([0.5, 1.5, 2.0, 0.1, 0.4, 3.0, 1.0, 2.0],
              [1, 1, 1, 0, 1, 1, 0, 1], [0, 0, 1, 1, 1, 2, 2, 2]),
    "silent-group": ([1.0, 3.0, 2.0, 2.0, 1.0, 1.0, 5.0, 1.0],
                     [1, 1, 0, 0, 0, 1, 1, 0], [0, 0, 1, 1, 1, 2, 2, 2]),
    "zero-mass": ([0.0, 0.0, 2.0, 2.0, 0.0, 0.0, 1.0, 1.0],
                  [1, 1, 1, 0, 0, 0, 0, 0], [0, 0, 1, 1, 2, 2, 2, 2]),
    "nothing": ([1.0] * 8, [0] * 8, [0, 1, 2, 0, 1, 2, 0, 1]),
}


@pytest.mark.parametrize("case", sorted(WEIGHTS))
def test_two_tier_weights_match_reference(case):
    w, a, ids = (np.asarray(v) for v in WEIGHTS[case])
    w, a, ids = w.astype(np.float32), a.astype(np.float32), ids.astype(
        np.int32)
    want = jax.jit(jtopo.two_tier_weights, static_argnums=3)(
        jnp.asarray(w), jnp.asarray(a), jnp.asarray(ids), 3)
    got = topology.two_tier_weights(torch.from_numpy(w), torch.from_numpy(a),
                                    torch.from_numpy(ids), 3)
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    flat = aggregation.masked_normalize(torch.from_numpy(w),
                                        torch.from_numpy(a))
    if a.sum() > 0:
        # alpha·beta telescopes to the flat weights over the arrivals
        alpha, beta, _ = got
        np.testing.assert_allclose(
            (alpha * beta[torch.from_numpy(ids).long()]
             * torch.from_numpy(a)).numpy(), flat.numpy(), atol=1e-6)


def test_per_group_guards_and_churn_match_reference():
    norms = np.array([1.0, 1.1, 0.9, 9.0, 100.0, 110.0, 90.0, np.inf],
                     np.float32)
    finite = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 1], np.float32)
    ids = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    verdict = jax.jit(jfaults.guard_verdict,
                      static_argnames=("policy", "num_groups"))
    t = lambda v: torch.from_numpy(v)
    for policy in ("drop", "clip"):
        for gkw in (dict(group_ids=ids, num_groups=2),
                    dict(group_ids=np.zeros(8, np.int32), num_groups=1),
                    {}):
            want = verdict(jnp.asarray(norms), jnp.asarray(finite),
                           jnp.asarray(mask), policy=policy,
                           factor=jnp.float32(3.0), **gkw)
            got = faults.guard_verdict(
                t(norms), t(finite), t(mask), policy=policy, factor=3.0,
                **{k: t(v) if k == "group_ids" else v
                   for k, v in gkw.items()})
            for a, b in zip(got, want, strict=True):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{policy} {gkw}")
        flat = faults.guard_verdict(t(norms), t(finite), t(mask),
                                    policy=policy, factor=3.0)
        one = faults.guard_verdict(t(norms), t(finite), t(mask),
                                   policy=policy, factor=3.0,
                                   group_ids=t(np.zeros(8, np.int32)),
                                   num_groups=1)
        for a, b in zip(flat, one):
            assert torch.equal(a, b)
    # group 1's scale is 100x group 0's: per-group medians reject only
    # group 0's outlier (9.0) and the non-finite upload
    rejected = faults.guard_verdict(t(norms), t(finite), t(mask),
                                    policy="drop", factor=3.0,
                                    group_ids=t(ids), num_groups=2)[0]
    assert rejected.tolist() == [0, 0, 0, 1, 0, 0, 0, 1]
    gids = TOPO.ids
    for kw in (dict(death_rate=0.3, birth_rate=0.5, seed=2),
               dict(death_rate=0.6, birth_rate=0.2, seed=0,
                    init=[1, 0] * 4)):
        got = faults.liveness_schedule(D, 6, group_ids=gids, **kw)
        np.testing.assert_array_equal(
            got, jfaults.liveness_schedule(D, 6, group_ids=gids, **kw))
        for g in range(G):      # a fog node takes its group with it
            assert (got[:, gids == g] == got[:, gids == g][:, :1]).all() \
                or "init" in kw


def _lenet():
    return fed.Trainer(fed.FederatedALConfig(), device="cpu").init_params(
        torch.Generator().manual_seed(0))


def test_tier_report_matches_reference():
    t = _lenet()
    j = interop.params_to_jax(t)
    mask = np.array([[1] * 8, [1, 0] * 4, [0] * 8, [1] * 8], np.float32)
    for cfg, topo_kw, start in (
            (None, dict(local_steps=2), 0),
            (CommsConfig(compression="int8", fog_compression="int8"),
             dict(local_steps=1, uplink_scale=(1.0, 3.0)), 0),
            (CommsConfig(compression="topk", topk_fraction=0.1,
                         fog_compression="topk"), dict(local_steps=3), 1),
            (CommsConfig(compute_dtype="bfloat16"), dict(local_steps=5), 0)):
        tt = topology.uniform_topology(D, G, **topo_kw)
        jt = jtopo.uniform_topology(D, G, **topo_kw)
        jc = None if cfg is None else jcomms.CommsConfig(**vars(cfg))
        got = comms.tier_report(cfg, t, mask, tt, start_round=start)
        assert got == jcomms.tier_report(jc, j, mask, jt, start_round=start)
        reps_t = [{"round": r} for r in range(4)]
        reps_j = [{"round": r} for r in range(4)]
        comms.attach_round_tiers(reps_t, got)
        jcomms.attach_round_tiers(reps_j, got)
        assert reps_t == reps_j
        assert comms.tier_telemetry(reps_t) == jcomms.tier_telemetry(reps_j)
    assert comms.tier_telemetry([{"round": 0}]) is None
    with pytest.raises(ValueError, match="length 8"):
        comms.tier_report(None, t, np.ones((2, 6)), TOPO)


# ------------------------------------------------------ parity runs
def _fleet():
    full, test = j_digits(160, seed=0), j_digits(40, seed=5)
    return j_split(full, D, seed=0), j_digits(6, seed=11), test


@pytest.fixture(scope="module")
def fleet():
    shards, seed_set, test = _fleet()
    cfg_j = JConfig(num_devices=D, **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    p0 = tr_j.init_params(jax.random.key(1))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * EVENTS,
                    scorer="jnp", aggregate_impl="ref", unroll=False)
    cfg = fed.FederatedALConfig(num_devices=D, **SLICE)
    tr = fed.Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                     device="cpu")
    eng_t = EdgeEngine(tr, cfg, shards, seed_set, test,
                       total_acquisitions=SLICE["acquisitions"] * 2 * EVENTS,
                       device="cpu")
    p0_t = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu")
    return (eng_j, p0), (eng_t, p0_t)


FAULTS = FaultConfig(death_rate=0.3, birth_rate=0.6, crash_rate=0.2,
                     drop_rate=0.2, corrupt_rate=0.4, corrupt_mode="nan",
                     label_noise_rate=0.3, seed=4)
GUARDS = GuardConfig(policy="drop", norm_factor=3.0)
FUSED = {
    "plain": {},
    "topk-fog-faults": dict(comms=CommsConfig(fog_compression="topk"),
                            faults=FAULTS, guards=GUARDS),
    "int8-fog": dict(comms=CommsConfig(fog_compression="int8")),
}


@pytest.fixture(scope="module", params=sorted(FUSED))
def fused_pair(request, fleet):
    case = FUSED[request.param]
    (eng_j, p0), (eng_t, p0_t) = fleet
    jkw = {}
    if "comms" in case:
        jkw["comms"] = jcomms.CommsConfig(**vars(case["comms"]))
    if "faults" in case:
        jkw.update(faults=_jfault(case["faults"]),
                   guards=_jguards(case["guards"]))
    out_j = eng_j.run_rounds_fused(eng_j.init_state(p0), ROUNDS,
                                   topology=J_TOPO, **jkw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine_mod, "fog_uniforms", reference_fog_uniforms)
        if "faults" in case:
            mp.setattr(faults, "round_draws",
                       reference_fault_draws(case["faults"], ROUNDS))
        out_t = eng_t.run_rounds_fused(eng_t.init_state(p0_t), ROUNDS,
                                       topology=TOPO, **case)
    return request.param, out_j, out_t


# the most one round's fit can move an entry: each Adam step moves it by
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


def _check_records(recs_t, recs_j, exact):
    for key in exact + ("fog_sync", "group_accept", "upload_mask",
                        "n_labeled"):
        np.testing.assert_array_equal(recs_t[key].numpy(),
                                      np.asarray(recs_j[key]), err_msg=key)
    for key in ("weights", "beta"):
        np.testing.assert_allclose(recs_t[key].numpy(),
                                   np.asarray(recs_j[key]), atol=1e-6,
                                   err_msg=key)


def test_fused_fog_rounds_match_reference(fused_pair):
    name, (st_j, recs_j, fin_j), (st_t, recs_t, fin_t) = fused_pair
    exact = ()
    if "faults" in FUSED[name]:
        exact = faults.REPORT_KEYS + ("accepted",)
        got = {k: recs_t[k].sum().item() for k in exact}
        assert got["rejected"] and got["dropped"], got
    _check_records(recs_t, recs_j, exact)
    assert recs_t["fog_sync"].tolist() == [0.0, 1.0, 0.0]
    np.testing.assert_allclose(recs_t["agg_acc"].numpy(),
                               np.asarray(recs_j["agg_acc"]), atol=1e-6)
    _close(fin_j, fin_t)
    _close(st_j.params, st_t.params)


@pytest.fixture(scope="module")
def event_pair(fleet):
    (eng_j, p0), (eng_t, p0_t) = fleet
    acfg = AsyncConfig(quorum=2, timer=0.25, dist="exp", mean_latency=1.0,
                       latency_skew=10.0)
    out_j = eng_j.run_async(
        eng_j.init_state(p0), EVENTS,
        async_cfg=jasync.AsyncConfig(**vars(acfg)), faults=_jfault(FAULTS),
        guards=_jguards(GUARDS), topology=J_TOPO)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(async_engine, "latency_draws",
                   reference_latency_draws(acfg))
        mp.setattr(faults, "round_draws",
                   reference_fault_draws(FAULTS, EVENTS))
        out_t = eng_t.run_async(eng_t.init_state(p0_t), EVENTS,
                                async_cfg=acfg, faults=FAULTS,
                                guards=GUARDS, topology=TOPO)
    return out_j, out_t


def test_async_fog_events_match_reference(event_pair):
    (st_j, recs_j, fog_j), (st_t, recs_t, fog_t) = event_pair
    exact = faults.REPORT_KEYS + ("accepted", "arrivals", "timer_fired",
                                  "staleness", "sim_time")
    _check_records(recs_t, recs_j, exact)
    assert recs_t["fog_sync"].tolist() == [0.0, 1.0, 0.0, 1.0]
    assert recs_t["group_accept"].sum() > 0
    _close(fog_j, fog_t)
    _close(st_j.params, st_t.params)
    _close(st_j.pending, st_t.pending)
    np.testing.assert_array_equal(st_t.staleness.numpy(),
                                  np.asarray(st_j.staleness))


# ------------------------------------------------- the port's own contracts
def _equal_runs(a, b):
    (sa, ra, fa), (sb, rb, fb) = a, b
    for x, y in zip(tree_leaves(fa), tree_leaves(fb), strict=True):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(tuple(sa._replace(rng=()))),
                    tree_leaves(tuple(sb._replace(rng=()))), strict=True):
        assert torch.equal(x, y)
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k


@pytest.mark.parametrize("engine", ["fused", "async"])
def test_one_group_is_the_flat_run_bit_for_bit(fleet, engine):
    """``uniform_topology(D, 1)`` (β ≡ 1.0, every round a sync) equals the
    flat run bit for bit; the fused case with a top-k edge codec (the
    delta form), the async one over a FedBuff quorum and a timer."""
    _, (eng, p0) = fleet
    one = topology.uniform_topology(D, 1)
    if engine == "fused":
        kw = dict(comms=CommsConfig(compression="topk", topk_fraction=0.1))
        run = lambda **t: eng.run_rounds_fused(eng.init_state(p0), 2, **kw,
                                               **t)
    else:
        kw = dict(async_cfg=AsyncConfig(quorum=3, timer=0.4,
                                        latency_skew=10.0))
        run = lambda **t: eng.run_async(eng.init_state(p0), 3, **kw, **t)
    flat, fog = run(), run(topology=one)
    s, r, f = fog
    if engine == "async":
        f = tree_map_rows(f)               # the [1, ...] fog stack
    for k in ("fog_sync", "beta", "group_accept"):
        r.pop(k)
    _equal_runs(flat, (s, r, f))


def tree_map_rows(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a[0], tree)


def test_fog_run_chained_across_a_local_round(fleet):
    """2 + 2 rounds with ``local_steps=4`` (the first call ends between
    syncs, its groups apart) equal the uninterrupted 4 rounds bit for bit;
    the segment form reduces every fog-local round."""
    _, (eng, p0) = fleet
    topo = topology.uniform_topology(D, G, local_steps=4)
    kw = dict(topology=topo, comms=CommsConfig(fog_compression="topk"))
    full = eng.run_rounds_fused(eng.init_state(p0), 4, **kw)
    s2, r2, _ = eng.run_rounds_fused(eng.init_state(p0), 2, **kw)
    leaf = tree_leaves(s2.params)[0]
    assert not torch.equal(leaf[0], leaf[D - 1])   # the groups apart
    s4, r4, f4 = eng.run_rounds_fused(s2, 2, start_round=2, **kw)
    tail = {k: v[2:] for k, v in full[1].items()}
    _equal_runs((full[0], tail, full[2]), (s4, r4, f4))
    assert full[1]["fog_sync"].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_rejections(fleet):
    _, (eng, p0) = fleet
    st = eng.init_state(p0)
    with pytest.raises(ValueError, match="length 3"):
        eng.run_rounds_fused(st, 1, topology=topology.uniform_topology(3, 1))
    with pytest.raises(ValueError, match="optimal"):
        eng.run_rounds_fused(st, 1, topology=TOPO, aggregation="optimal")
    shards, seed_set, test = _fleet()
    with pytest.raises(ValueError, match="topology requires"):
        fed.run_federated_rounds(eng.cfg, shards, seed_set, test, rounds=1,
                                 engine="vmap", topology=TOPO, device="cpu")
    # the sharded device axis is ported: a one-rank fog mesh runs the fog
    # scenario as the unsharded run does, bit for bit
    from torch import distributed as dist
    from repro_torch.launch.mesh import make_fog_mesh
    small = fed.fog_config(8, acquisitions=1, train_steps_per_acq=1,
                           initial_train_steps=1, mc_samples=2)
    run = lambda **kw: fed.run_experiment(small, scenario="fog", rounds=1,
                                          n_test=20, device="cpu", **kw)[0]
    try:
        assert run(mesh=make_fog_mesh(1, 1, device="cpu")) == run()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_fog_scenario_carries_the_reference_report_keys():
    """``run_experiment(scenario="fog")`` reports hold at least the keys of
    the reference's ``report_schema("fog")`` per round and per repeat (4
    devices in ``default_topology(4)``'s 2 groups, one step a fit), and
    the tiers summary equals the reference's over the same reports."""
    from repro.core.federated import report_schema
    cfg = fed.fog_config(4, acquisitions=1, train_steps_per_acq=1,
                         initial_train_steps=1, mc_samples=2)
    rep = fed.run_experiment(cfg, scenario="fog", rounds=2, n_test=20,
                             device="cpu")[0]
    want = report_schema("fog")
    assert want["repeat"] <= set(rep), want["repeat"] - set(rep)
    for r in rep["rounds"]:
        assert want["round"] <= set(r), want["round"] - set(r)
        assert r["tiers"]["num_groups"] == 2 and not r["fog_sync"]
    assert rep["tiers"] == jcomms.tier_telemetry(rep["rounds"])
    assert rep["tiers"]["cross_tier_reduction"] == float("inf")
