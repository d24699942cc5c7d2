"""Heterogeneous fleets in the port against the JAX package on the CPU:
``core.hetero``, the step budget of ``Trainer.fit_steps`` and fused
rounds with ``hetero=``.

Fused rounds run the RNG-free configuration of ``test_torch_slice.py``
(dropout 0, the window covering every shard) with arrivals from the host
``straggler_schedule``, so both packages see the same arrival masks.
Tolerances: staleness rows, arrivals and labeled counts exact; Eq. 1
weights 1e-6; params and the pending backlog 1e-4 absolute (float32
rounding through a few Adam steps, as in ``test_torch_slice.py``), but
for at most ``comms.split_budget`` entries of a leaf (the share
``test_torch_comms.py`` allows the error-feedback residual), each within
``FIT_REACH``, the most one round's fit can move an entry.  Where a
gradient is near 0, Adam turns the packages' different conv gradient sums
into steps of either sign; the backlog holds each device's own delta,
and a round with few arrivals makes the fog model a few devices' params,
so the Eq. 1 average does not smooth those entries away.  Host
arrays and summaries (step limits, schedules, staleness summaries) are
exact.  A hetero round with no stragglers equals the synchronous fused
round bit for bit: both reduce the same rows with the same weights, and
the buffered term adds zeros.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

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
from repro_torch.core import comms, hetero  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.federated import (FederatedALConfig, Trainer,  # noqa: E402
                                        run_federated_round,
                                        run_federated_rounds)
from repro_torch.core.hetero import HeteroConfig  # noqa: E402
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# RNG-free fleet: the window covers every shard of 20 samples; one
# acquisition a round keeps the reference's compiled program short
SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
D, ROUNDS = 3, 4


def _fleet():
    full, test = j_digits(60, seed=0), j_digits(40, seed=5)
    return j_split(full, D, seed=0), j_digits(6, seed=11), test


def _arrivals(rate=0.5, seed=3):
    """Host straggler schedule with round 1 forced empty (a zero-arrival
    round)."""
    mask = hetero.straggler_schedule(D, rate, seed, ROUNDS)
    mask[1] = 0.0
    return mask


def _port_engine(shards, seed_set, test):
    cfg = FederatedALConfig(num_devices=D, **SLICE)
    tr = Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                 device="cpu")
    return EdgeEngine(tr, cfg, shards, seed_set, test,
                      total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                      device="cpu")


def _run_both(hkw, mask):
    """The same fused hetero rounds in both packages from the same start
    weights: ``((state, recs, fog) JAX, (state, recs, fog) port)``."""
    shards, seed_set, test = _fleet()
    cfg_j = JConfig(num_devices=D, **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    p0 = tr_j.init_params(jax.random.key(1))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                    scorer="jnp", aggregate_impl="ref", unroll=False)
    out_j = eng_j.run_rounds_fused(eng_j.init_state(p0), ROUNDS,
                                   upload_mask=mask,
                                   hetero=jhetero.HeteroConfig(**hkw))
    eng_t = _port_engine(shards, seed_set, test)
    st = eng_t.init_state(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    out_t = eng_t.run_rounds_fused(st, ROUNDS, upload_mask=mask,
                                   hetero=HeteroConfig(**hkw))
    return out_j, out_t


# how far two runs' per-device deltas may lie apart at an entry whose
# gradient is near 0: the most one round's fit can move an entry, each
# Adam step moving it by about the learning rate (1e-3) at most
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


# decay × buffering × compute profile, one reference program each
# (decay "none" with buffering runs under faults in test_torch_faults.py)
CASES = {
    "exp-buffer-limits": dict(decay="exp", decay_rate=0.5,
                              step_limits=(1, 3, 2)),
    "poly-no-buffer": dict(decay="poly", decay_rate=1.0, buffer_stale=False,
                           slow_fraction=0.5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def fused_pair(request):
    mask = _arrivals()
    return request.param, mask, _run_both(CASES[request.param], mask)


def test_fused_hetero_rounds_match_reference(fused_pair):
    name, mask, ((st_j, recs_j, fin_j), (st_t, recs_t, fin_t)) = fused_pair
    stale = recs_t["staleness"].numpy()
    np.testing.assert_array_equal(stale, np.asarray(recs_j["staleness"]))
    assert stale.max() >= 1, "the schedule leaves no device stale"
    for key in ("upload_mask", "n_labeled"):
        np.testing.assert_array_equal(recs_t[key].numpy(),
                                      np.asarray(recs_j[key]), err_msg=key)
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    _close(fin_j, fin_t)
    if CASES[name].get("buffer_stale", True):
        assert tree_leaves(st_t.pending)
        _close(st_j.pending, st_t.pending)
    else:
        assert st_t.pending == () and st_j.pending == ()
    np.testing.assert_array_equal(st_t.staleness.numpy(),
                                  np.asarray(st_j.staleness))


def test_zero_arrival_round_keeps_the_previous_model(fused_pair):
    """Round 1 of the schedule has no arrival: its weights are all 0 and
    the fog model it dispatches is round 0's, bit for bit."""
    _, mask, (_, (_, recs_t, _)) = fused_pair
    assert mask[1].sum() == 0
    assert not recs_t["weights"][1].any()
    assert torch.equal(recs_t["agg_acc"][1], recs_t["agg_acc"][0])


def test_zero_arrival_round_dispatches_the_previous_model():
    shards, seed_set, test = _fleet()
    eng = _port_engine(shards, seed_set, test)
    p0 = eng.trainer.init_params(torch.Generator().manual_seed(0))
    st, _, fog0 = eng.run_rounds_fused(eng.init_state(p0), 1,
                                       hetero=HeteroConfig())
    st2, recs, fog1 = eng.run_rounds_fused(
        st, 1, upload_mask=np.zeros((1, D)), hetero=HeteroConfig(),
        start_round=1)
    for a, b in zip(tree_leaves(fog0), tree_leaves(fog1)):
        assert torch.equal(a, b)
    assert recs["staleness"][0].tolist() == [0] * D
    assert st2.staleness.tolist() == [1] * D
    assert any(bool(leaf.abs().sum() > 0) for leaf in tree_leaves(st2.pending))


def test_zero_stragglers_equal_the_synchronous_round():
    shards, seed_set, test = _fleet()
    eng = _port_engine(shards, seed_set, test)
    p0 = eng.trainer.init_params(torch.Generator().manual_seed(0))
    _, recs_s, fog_s = eng.run_rounds_fused(eng.init_state(p0), 2)
    _, recs_h, fog_h = eng.run_rounds_fused(
        eng.init_state(p0), 2, hetero=HeteroConfig(decay="exp"))
    assert not recs_h["staleness"].any()
    assert torch.equal(recs_s["weights"], recs_h["weights"])
    for a, b in zip(tree_leaves(fog_s), tree_leaves(fog_h)):
        assert torch.equal(a, b)


def test_step_limited_fit_equals_a_shorter_fit():
    """Device i's rows after a fit capped at ``limit[i]`` steps equal a
    plain fit of ``limit[i]`` steps on the same batch, params and Adam
    state alike (dropout on: the kept steps draw the same masks)."""
    cfg = FederatedALConfig(num_devices=3, **SLICE)
    tr = Trainer(cfg, device="cpu")
    params = tr.init_params(torch.Generator().manual_seed(0))
    from repro_torch.core.engine import broadcast_params
    from repro_torch.data.digits import make_digit_dataset
    ds = make_digit_dataset(12, seed=0)
    x = torch.from_numpy(ds.images)[None].expand(3, -1, -1, -1, -1)
    y = torch.from_numpy(ds.labels).long()[None].expand(3, -1)
    m = torch.ones(y.shape)
    p = broadcast_params(params, 3)
    limit = torch.tensor([1, 4, 2])
    got = tr.fit_steps(p, tr.opt.init(p), x, y, m,
                       torch.Generator().manual_seed(5), 4, step_limit=limit)
    for d, steps in enumerate(limit.tolist()):
        want = tr.fit_steps(p, tr.opt.init(p), x, y, m,
                            torch.Generator().manual_seed(5), steps)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a[d], b[d])


def test_host_arrays_and_summaries_match_reference():
    for kw in (dict(slow_fraction=0.4, seed=3), dict(slow_fraction=1.0),
               dict(step_limits=(1, 9, 5, 2)), dict()):
        got = hetero.device_step_limits(HeteroConfig(**kw), 4, 6)
        want = jhetero.device_step_limits(jhetero.HeteroConfig(**kw), 4, 6)
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    wide = HeteroConfig(slow_fraction=0.25)
    np.testing.assert_array_equal(
        hetero.device_step_limits(wide, 256, 10),
        jhetero.device_step_limits(jhetero.HeteroConfig(slow_fraction=0.25),
                                   256, 10))
    for args in ((8, 0.3, 0, 5), (256, 0.3, 7, 3), (3, 0.0, 1, 2)):
        np.testing.assert_array_equal(hetero.straggler_schedule(*args),
                                      jhetero.straggler_schedule(*args))
    recs = np.array([[0, 1, 0, 3], [2, 0, 0, 0]], np.int32)
    assert hetero.summarize_staleness(recs) == \
        jhetero.summarize_staleness(recs)
    for p in (0.0, 0.3, 0.9):
        assert hetero.expected_staleness(p) == jhetero.expected_staleness(p)
    assert hetero.expected_staleness(0.3) == pytest.approx(0.428571, 1e-5)


BAD = [dict(straggler_rate=1.0), dict(straggler_rate=-0.1),
       dict(decay="linear"), dict(decay_rate=0.0), dict(decay_rate=1.5),
       dict(slow_fraction=1.5), dict(slow_steps_fraction=0.0),
       dict(step_limits=(0, 2))]


@pytest.mark.parametrize("bad", BAD, ids=[next(iter(b)) for b in BAD])
def test_config_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        jhetero.HeteroConfig(**bad)
    with pytest.raises(ValueError) as got:
        HeteroConfig(**bad)
    assert str(got.value) == str(want.value)
    assert HeteroConfig(step_limits=(1,)).has_compute_profile
    assert not HeteroConfig().has_compute_profile


def test_validation_errors_match_reference():
    shards, seed_set, test = _fleet()
    eng = _port_engine(shards, seed_set, test)
    st = eng.init_state(eng.trainer.init_params(
        torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="optimal"):
        eng.run_rounds_fused(st, 1, aggregation="optimal",
                             hetero=HeteroConfig())
    with pytest.raises(ValueError, match="not both"):
        eng.run_rounds_fused(st, 1, upload_mask=np.ones((1, D)),
                             hetero=HeteroConfig(straggler_rate=0.3))
    with pytest.raises(ValueError, match="not both"):
        eng.run_rounds_fused(st, 1, upload_fraction=0.5,
                             hetero=HeteroConfig(straggler_rate=0.3))
    with pytest.raises(ValueError) as want:
        j_rounds(JConfig(num_devices=D, **SLICE), shards, seed_set, test,
                 engine="vmap", hetero=jhetero.HeteroConfig())
    for engine in ("vmap", "legacy", "classic"):
        with pytest.raises(ValueError) as got:
            run_federated_rounds(FederatedALConfig(num_devices=D, **SLICE),
                                 shards, seed_set, test, engine=engine,
                                 hetero=HeteroConfig(), device="cpu")
        # the same words up to the advice, which names no unported engine
        head = str(want.value).split(";")[0]
        assert str(got.value).split(";")[0] == head.replace("'vmap'",
                                                            repr(engine))
        with pytest.raises(ValueError, match="hetero requires engine="):
            run_federated_round(FederatedALConfig(num_devices=D, **SLICE),
                                shards, seed_set, test, engine=engine,
                                hetero=HeteroConfig(), device="cpu")


def test_straggler_rate_draws_the_arrival_mask():
    """``straggler_rate`` is the ``upload_fraction`` draw at ``1 − rate``
    (the port's numpy stream): the same masks, buffered."""
    shards, seed_set, test = _fleet()
    eng = _port_engine(shards, seed_set, test)
    p0 = eng.trainer.init_params(torch.Generator().manual_seed(0))
    _, recs_h, _ = eng.run_rounds_fused(
        eng.init_state(p0), 2, hetero=HeteroConfig(straggler_rate=0.5),
        start_round=3)
    _, recs_f, _ = eng.run_rounds_fused(eng.init_state(p0), 2,
                                        upload_fraction=0.5, start_round=3)
    assert torch.equal(recs_h["upload_mask"], recs_f["upload_mask"])


@pytest.mark.parametrize("scenario", ["hetero", "churn", "async"])
def test_scenarios_carry_the_reference_report_keys(scenario):
    """``run_experiment(scenario=...)`` reports hold at least the keys of
    the reference's ``report_schema`` for the scenario, per round and per
    repeat (a small fleet: 4 devices, 8 for async's quorum of 2, one step
    a fit)."""
    from repro.core.federated import report_schema
    from repro_torch.core import federated
    preset = getattr(federated, f"{scenario}_config")
    cfg = preset(8 if scenario == "async" else 4, acquisitions=1,
                 train_steps_per_acq=1, initial_train_steps=1, mc_samples=2)
    rep = federated.run_experiment(cfg, scenario=scenario, rounds=2,
                                   n_test=20, device="cpu")[0]
    want = report_schema(scenario)
    assert want["repeat"] <= set(rep), want["repeat"] - set(rep)
    for r in rep["rounds"]:
        assert want["round"] <= set(r), want["round"] - set(r)
    key = {"hetero": "staleness", "churn": "faults", "async": "async"}
    assert rep[key[scenario]]
