"""Faults, churn and guards in the port against the JAX package on the
CPU: ``core.faults`` and fused rounds with ``faults=`` / ``guards=`` /
``live_mask=``.

The draw functions take their uniforms as arguments, so each unit test
feeds the reference's own draws (JAX's ``bernoulli`` is ``uniform < p``)
and expects its masks bit for bit.  Fused rounds run the RNG-free
configuration (dropout 0, the window covering every shard) with the
port's one draw function, ``faults.round_draws``, replaced by one that
returns the reference's draws for the same absolute round, split from
``fault_keys`` as the reference's round body splits them.  Tolerances:
masks, liveness, the fault and guard rows (``REPORT_KEYS``, ``accepted``)
and staleness exact; norms of the same inputs 1e-6 relative (a whole
tree's squares summed in another order); Eq. 1 weights 1e-6; params 1e-4
absolute by the per-device-delta rule of ``test_torch_hetero.py`` (at
most ``comms.split_budget`` entries of a leaf beyond it, each within
``FIT_REACH``); the fused rounds' upload norms 1e-4 relative, since each is the
norm of one device's own delta, whose entries differ as the params do;
summaries exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core import hetero as jhetero  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.federated import \
    run_federated_rounds as j_rounds  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import comms, faults, hetero  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.core.federated import (FederatedALConfig, Trainer,  # noqa: E402
                                        run_federated_rounds)
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
D, ROUNDS = 4, 4


def _fleet():
    full, test = j_digits(80, seed=0), j_digits(40, seed=5)
    return j_split(full, D, seed=0), j_digits(6, seed=11), test


def _jfault(cfg: FaultConfig):
    return jfaults.FaultConfig(**{f: getattr(cfg, f) for f in (
        "death_rate", "birth_rate", "crash_rate", "restart_mult",
        "drop_rate", "corrupt_rate", "corrupt_mode", "corrupt_scale",
        "label_noise_rate", "seed")})


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32))


def reference_draws(cfg: FaultConfig, rounds: int):
    """``faults.round_draws`` with the reference's draws: round r's fault
    key split as the reference's round body splits it."""
    keys = jfaults.fault_keys(_jfault(cfg), 0, rounds)

    def draws(c, round_idx, num_devices, n_pad, num_classes):
        assert c == cfg
        k_live, k_flt, k_labels = jax.random.split(keys[round_idx], 3)
        k_death, k_birth = jax.random.split(k_live)
        u = np.stack([_uniform(k, (num_devices,))
                      for k in jax.random.split(k_flt, 4)])
        labels = jax.random.randint(k_labels, (num_devices, n_pad), 0,
                                    num_classes, dtype=jnp.int32)
        return faults.FaultDraws(_uniform(k_death, (num_devices,)),
                                 _uniform(k_birth, (num_devices,)), u,
                                 np.asarray(labels).astype(np.int64))

    return draws


# (A) the churn process, faults and drop guards, over buffering hetero
# (decay none) from a host straggler schedule; (B) a host liveness
# schedule with crashes, drops and corruption under clip guards
CASES = {
    "churn-drop-hetero": dict(
        faults=FaultConfig(death_rate=0.3, birth_rate=0.5, crash_rate=0.2,
                           drop_rate=0.2, corrupt_rate=0.5,
                           label_noise_rate=0.3, seed=4),
        guards=GuardConfig(policy="drop", norm_factor=3.0),
        hetero=dict(decay="none")),
    "schedule-clip": dict(
        faults=FaultConfig(crash_rate=0.2, drop_rate=0.2, corrupt_rate=0.4,
                           corrupt_scale=20.0, seed=2),
        guards=GuardConfig(policy="clip", norm_factor=2.0),
        live_mask=faults.liveness_schedule(D, ROUNDS, death_rate=0.3,
                                           birth_rate=0.5, seed=1)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fused_pair(request):
    case = CASES[request.param]
    kw = dict(faults=case["faults"], guards=case["guards"])
    jkw = dict(faults=_jfault(case["faults"]),
               guards=jfaults.GuardConfig(policy=case["guards"].policy,
                                          norm_factor=case["guards"]
                                          .norm_factor))
    if "hetero" in case:
        mask = hetero.straggler_schedule(D, 0.3, 5, ROUNDS)
        kw.update(hetero=hetero.HeteroConfig(**case["hetero"]),
                  upload_mask=mask)
        jkw.update(hetero=jhetero.HeteroConfig(**case["hetero"]),
                   upload_mask=mask)
    if "live_mask" in case:
        kw["live_mask"] = jkw["live_mask"] = case["live_mask"]
    shards, seed_set, test = _fleet()
    cfg_j = JConfig(num_devices=D, **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    p0 = tr_j.init_params(jax.random.key(1))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                    scorer="jnp", aggregate_impl="ref", unroll=False)
    out_j = eng_j.run_rounds_fused(eng_j.init_state(p0), ROUNDS, **jkw)
    cfg_t = FederatedALConfig(num_devices=D, **SLICE)
    eng_t = EdgeEngine(Trainer(cfg_t, model_cfg=LeNetConfig(p_conv=0.0,
                                                            p_fc=0.0),
                               device="cpu"),
                       cfg_t, shards, seed_set, test,
                       total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                       device="cpu")
    st = eng_t.init_state(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(faults, "round_draws",
                   reference_draws(case["faults"], ROUNDS))
        out_t = eng_t.run_rounds_fused(st, ROUNDS, **kw)
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


def test_fused_fault_rounds_match_reference(fused_pair):
    name, (st_j, recs_j, fin_j), (st_t, recs_t, fin_t) = fused_pair
    rows = faults.REPORT_KEYS + ("accepted", "upload_mask", "n_labeled")
    if name == "churn-drop-hetero":
        rows += ("staleness",)
    for key in rows:
        np.testing.assert_array_equal(recs_t[key].numpy(),
                                      np.asarray(recs_j[key]), err_msg=key)
    # the trace exercises every fault and both guard outcomes
    got = {k: recs_t[k].sum().item() for k in faults.REPORT_KEYS}
    assert got["crashed"] and got["dropped"] and got["corrupted"], got
    assert (recs_t["live"] == 0).any()
    assert got["clipped" if name == "schedule-clip" else "rejected"], got
    np.testing.assert_allclose(recs_t["upload_norms"].numpy(),
                               np.asarray(recs_j["upload_norms"]),
                               rtol=1e-4)
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    _close(fin_j, fin_t)
    np.testing.assert_array_equal(st_t.live.numpy(), np.asarray(st_j.live))


# ------------------------------------------------------------ unit parity
def test_update_liveness_and_fault_masks_match_reference():
    key = jax.random.key(7)
    live = jnp.asarray([1, 1, 0, 0, 1, 0, 1, 1], jnp.float32)
    for death, birth in ((0.3, 0.5), (0.0, 0.0), (1.0, 1.0)):
        want = jfaults.update_liveness(key, live, jnp.float32(death),
                                       jnp.float32(birth))
        k_death, k_birth = jax.random.split(key)
        got = faults.update_liveness(
            torch.from_numpy(np.array(live)), _uniform(k_death, (8,)),
            _uniform(k_birth, (8,)), np.float32(death), np.float32(birth))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rates = faults.rates_vector(FaultConfig(crash_rate=0.3, drop_rate=0.5,
                                            corrupt_rate=0.1,
                                            label_noise_rate=0.7))
    want = jfaults.draw_fault_masks(key, jnp.asarray(rates), 8)
    u = np.stack([_uniform(k, (8,)) for k in jax.random.split(key, 4)])
    got = faults.draw_fault_masks(u, rates)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for cfg in (None, FaultConfig(death_rate=0.1, restart_mult=2.0,
                                  corrupt_scale=3.0)):
        np.testing.assert_array_equal(
            faults.rates_vector(cfg),
            jfaults.rates_vector(None if cfg is None else _jfault(cfg)))


def test_liveness_schedule_matches_reference():
    for kw in (dict(death_rate=0.2, birth_rate=0.4, seed=3),
               dict(death_rate=0.5, birth_rate=0.1, seed=0,
                    init=[1, 0, 1, 0, 1, 0])):
        np.testing.assert_array_equal(
            faults.liveness_schedule(6, 5, **kw),
            jfaults.liveness_schedule(6, 5, **kw))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5, 7)).astype(np.float32)}}


@pytest.mark.parametrize("mode", ["scale", "nan"])
def test_corrupt_norms_and_finite_match_reference(mode):
    tree = _tree(0)
    flags = np.array([0, 1, 0, 1, 0], np.float32)
    want = jfaults.corrupt_stacked(mode, jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(flags), jnp.float32(50.0))
    got = faults.corrupt_stacked(mode, interop.params_from_jax(tree, "cpu"),
                                 torch.from_numpy(flags), np.float32(50.0))
    for a, b in zip(tree_leaves(interop.params_to_jax(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(faults.stacked_finite(got).numpy(),
                                  np.asarray(jfaults.stacked_finite(want)))
    np.testing.assert_allclose(faults.stacked_norms(got).numpy(),
                               np.asarray(jfaults.stacked_norms(want)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="corrupt_mode"):
        faults.corrupt_stacked("zero", got, torch.from_numpy(flags), 1.0)


# (norms, finite, received) over 6 devices; padding slots receive nothing
VERDICTS = {
    "odd": ([1.0, 2.0, 30.0, 4.0, 5.0, 0.0], [1] * 6, [1, 1, 1, 1, 1, 0]),
    "even": ([1.0, 2.0, 30.0, 4.0, 3.0, 9.0], [1] * 6, [1, 1, 1, 1, 0, 1]),
    "nonfinite": ([1.0, np.inf, 2.0, np.nan, 40.0, 3.0], [1, 0, 1, 1, 1, 0],
                  [1, 1, 1, 1, 1, 1]),
    "empty": ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], [1] * 6, [0] * 6),
    "zero-median": ([0.0, 0.0, 0.0, 5.0, 0.0, 0.0], [1] * 6,
                    [1, 1, 1, 1, 0, 0]),
    "one-arrival": ([7.0, 2.0, 3.0, 0.0, 0.0, 0.0], [1] * 6,
                    [0, 1, 0, 0, 0, 0]),
}


@jax.jit
def _reference_verdicts(norms, finite, mask):
    """Both policies' verdicts, in one compiled call."""
    return [jfaults.guard_verdict(norms, finite, mask, policy=policy,
                                  factor=jnp.float32(3.0))
            for policy in ("drop", "clip")]


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_guard_verdict_matches_reference(case):
    norms, finite, mask = (np.asarray(v) for v in VERDICTS[case])
    norms, finite = norms.astype(np.float32), finite.astype(bool)
    mask = mask.astype(np.float32)
    for policy, want in zip(("drop", "clip"),
                            _reference_verdicts(norms, finite, mask)):
        got = faults.guard_verdict(
            torch.from_numpy(norms), torch.from_numpy(finite),
            torch.from_numpy(mask), policy=policy, factor=3.0)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=policy)
    with pytest.raises(ValueError, match="drop' or 'clip"):
        faults.guard_verdict(torch.from_numpy(norms),
                             torch.from_numpy(finite),
                             torch.from_numpy(mask), policy="off",
                             factor=3.0)


def test_summaries_match_reference():
    recs = {"live": np.array([[1, 0, 1], [1, 1, 0]], np.float32),
            "crashed": np.array([[0, 1, 0], [0, 0, 0]], np.float32),
            "rejected": np.array([[1, 0, 0], [0, 1, 1]], np.float32)}
    assert faults.summarize_faults(recs) == jfaults.summarize_faults(recs)
    assert faults.summarize_faults(
        {k: torch.from_numpy(v) for k, v in recs.items()}) == \
        jfaults.summarize_faults(recs)
    reports = [{k: v[t].tolist() for k, v in recs.items()} | {"round": t}
               for t in range(2)]
    assert faults.report_summary(reports) == jfaults.report_summary(reports)
    assert faults.report_summary([]) == jfaults.report_summary([]) == {}
    assert faults.REPORT_KEYS == jfaults.REPORT_KEYS


BAD = [dict(death_rate=1.5), dict(crash_rate=-0.1), dict(corrupt_mode="zero"),
       dict(corrupt_scale=0.0), dict(restart_mult=0.5)]
BAD_GUARDS = [dict(policy="median"), dict(norm_factor=1.0)]


@pytest.mark.parametrize("bad", BAD + BAD_GUARDS,
                         ids=[next(iter(b)) for b in BAD + BAD_GUARDS])
def test_config_validation_matches_reference(bad):
    j_cls, t_cls = ((jfaults.GuardConfig, GuardConfig) if bad in BAD_GUARDS
                    else (jfaults.FaultConfig, FaultConfig))
    with pytest.raises(ValueError) as want:
        j_cls(**bad)
    with pytest.raises(ValueError) as got:
        t_cls(**bad)
    assert str(got.value) == str(want.value)


def test_validation_errors():
    shards, seed_set, test = _fleet()
    cfg = FederatedALConfig(num_devices=D, **SLICE)
    eng = EdgeEngine(Trainer(cfg, device="cpu"), cfg, shards, seed_set,
                     test, total_acquisitions=4, device="cpu")
    st = eng.init_state(eng.trainer.init_params(
        torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="not both"):
        eng.run_rounds_fused(st, 1, live_mask=np.ones(D),
                             faults=FaultConfig(death_rate=0.1))
    for kw in (dict(faults=FaultConfig()), dict(guards=GuardConfig()),
               dict(live_mask=np.ones(D))):
        with pytest.raises(ValueError, match="optimal"):
            eng.run_rounds_fused(st, 1, aggregation="optimal", **kw)
    with pytest.raises(ValueError, match="live_mask shape"):
        eng.run_rounds_fused(st, 1, live_mask=np.ones((2, D)))
    # guards "off" is no guards at all
    _, recs, _ = eng.run_rounds_fused(st, 1,
                                      guards=GuardConfig(policy="off"))
    assert "rejected" not in recs and "live" not in recs
    with pytest.raises(ValueError) as want:
        j_rounds(JConfig(num_devices=D, **SLICE), shards, seed_set, test,
                 engine="classic", faults=jfaults.FaultConfig())
    for name, kw in (("faults", dict(faults=FaultConfig())),
                     ("guards", dict(guards=GuardConfig()))):
        with pytest.raises(ValueError) as got:
            run_federated_rounds(cfg, shards, seed_set, test,
                                 engine="classic", device="cpu", **kw)
        assert str(got.value).split(";")[0] == \
            str(want.value).split(";")[0].replace("faults", name)
