"""The LM fleet (``scenario="lm"``) end to end against the JAX package:
fused rounds of the SSM and decoder adapters, the excluded-leaf contract
of the carried recurrent state, and the scenario entry point.

The parity runs use the RNG-free configuration, as the LeNet slice does:
dropout 0 (MC samples and training draw nothing) and a pool window that
covers every shard (the window is the whole unlabeled pool).  Both sides
start from the same weights, carried across with ``repro_torch.interop``;
the port runs its kernel routes (``impl="pallas"``, the plain versions on
the CPU), the JAX side its reference cores.  Tolerances: labeled sets,
participation and counts exact; Eq. 1 weights 1e-6; parameters 1e-4
absolute (float32 rounding through a few dozen Adam steps, as for LeNet);
accuracies within one test sample.
"""
from dataclasses import fields, replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.federated import lm_config as j_lm_config  # noqa: E402
from repro.core.federated import lm_model_config as j_lm_model_config  # noqa: E402
from repro.core.model_adapter import DecoderLMAdapter as JDecoderAdapter  # noqa: E402
from repro.core.model_adapter import SSMAdapter as JSSMAdapter  # noqa: E402
from repro.data.lm import lm_federated_split, make_lm_dataset  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import counters  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.federated import (Trainer, lm_config,  # noqa: E402
                                        lm_model_config, run_experiment)
from repro_torch.core.model_adapter import (DecoderLMAdapter,  # noqa: E402
                                            SSMAdapter)
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

VOCAB, SEQ, D, ROUNDS = 64, 8, 2, 2
BUDGET = dict(initial_train=4, acquisitions=2, k_per_acquisition=2,
              pool_window=32, mc_samples=2, train_steps_per_acq=2,
              initial_train_steps=2)


def _torch_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in fields(jcfg)
                          if f.name not in ("param_dtype", "dtype")})


def _models(kind):
    """(JAX adapter, port adapter), both with dropout 0."""
    if kind == "ssm":
        jm = j_lm_model_config(vocab=VOCAB, seq_len=SEQ, dropout_rate=0.0)
        return JSSMAdapter(jm), SSMAdapter(_torch_cfg(jm), impl="pallas")
    jm = replace(JModelConfig(family="decoder").reduced(
        n_layers=1, d_model=64, vocab_size=VOCAB, max_seq_len=SEQ),
        dropout_rate=0.0)
    return JDecoderAdapter(jm, impl="naive"), DecoderLMAdapter(
        _torch_cfg(jm), impl="pallas")


def _data():
    shards = lm_federated_split(D, 10, seq_len=SEQ, vocab=VOCAB, seed=0)
    test = make_lm_dataset(16, seq_len=SEQ, vocab=VOCAB, seed=5,
                           stream_seed=0)
    seed_set = make_lm_dataset(BUDGET["initial_train"], seq_len=SEQ,
                               vocab=VOCAB, seed=11, stream_seed=0)
    return shards, seed_set, test


@pytest.mark.parametrize("kind", ["ssm", "decoder"])
def test_fused_lm_rounds_match_reference(kind):
    ja, ta = _models(kind)
    shards, seed_set, test = _data()
    assert max(len(s) for s in shards) <= BUDGET["pool_window"]
    total = BUDGET["acquisitions"] * ROUNDS

    cfg_j = j_lm_config(D, adapter=ja, **BUDGET)
    tr_j = JTrainer(cfg_j)
    p0 = jax.jit(tr_j.init_params)(jax.random.key(0))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=total, unroll=False)
    st_j, recs_j, fin_j = eng_j.run_rounds_fused(eng_j.init_state(p0),
                                                 ROUNDS)

    cfg_t = lm_config(D, adapter=ta, **BUDGET)
    eng_t = EdgeEngine(Trainer(cfg_t, device="cpu"), cfg_t, shards, seed_set,
                       test, total_acquisitions=total, device="cpu")
    p0_t = interop.params_from_jax(jax.tree_util.tree_map(np.asarray, p0),
                                   "cpu")
    st_t, recs_t, fin_t = eng_t.run_rounds_fused(eng_t.init_state(p0_t),
                                                 ROUNDS)

    np.testing.assert_array_equal(recs_t["n_labeled"].numpy(),
                                  np.asarray(recs_j["n_labeled"]))
    np.testing.assert_array_equal(
        interop.vpool_to_jax(st_t.pool)["labeled_mask"],
        np.asarray(st_j.pool.labeled_mask))
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    for key in ("device_accs", "agg_acc"):
        np.testing.assert_allclose(recs_t[key].numpy(),
                                   np.asarray(recs_j[key]),
                                   atol=1 / len(test) + 1e-6)
    for got, want in ((fin_t, fin_j), (st_t.params, st_j.params)):
        got = jax.tree_util.tree_leaves(interop.params_to_jax(got))
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                                want))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.fixture(scope="module")
def ssm_rounds():
    """The port's own fused SSM rounds with dropout on, and distinct
    per-device recurrent states seeded before the call."""
    adapter = SSMAdapter(lm_model_config(vocab=VOCAB, seq_len=SEQ),
                         impl="pallas")
    cfg = lm_config(D + 1, adapter=adapter, seed=3, **BUDGET)
    shards = lm_federated_split(D + 1, 10, seq_len=SEQ, vocab=VOCAB, seed=0)
    _, seed_set, test = _data()
    eng = EdgeEngine(Trainer(cfg, device="cpu"), cfg, shards, seed_set, test,
                     total_acquisitions=BUDGET["acquisitions"] * ROUNDS,
                     device="cpu")
    state = eng.init_state(adapter.init(torch.Generator().manual_seed(0)))
    bump = torch.arange(1, D + 2, dtype=torch.float32)[:, None, None, None]
    params = dict(state.params)
    params["recurrent"] = {"state": state.params["recurrent"]["state"] + bump}
    state = state._replace(params=params)
    k4.launches = 0
    counters.reset_dispatches()
    out = eng.run_rounds_fused(state, ROUNDS)
    return state, out


def test_recurrent_state_is_per_device_and_out_of_eq1(ssm_rounds):
    """The excluded-leaf contract (the reference's
    tests/test_lm_engine.py): each device keeps its OWN recurrent state
    (never averaged, never overwritten at re-dispatch), every aggregated
    leaf is dispatched identically, and the returned fog model carries
    device 0's copy."""
    _, (state, recs, final) = ssm_rounds
    assert counters.dispatch_count() == 1
    assert k4.launches == 0          # the CPU takes the plain version
    rec = state.params["recurrent"]["state"]
    assert not torch.allclose(rec[0], rec[1])
    emb = state.params["embed"]["embedding"]
    assert torch.equal(emb[0], emb[1]) and torch.equal(emb[0], emb[2])
    torch.testing.assert_close(final["recurrent"]["state"], rec[0], atol=0,
                               rtol=0)
    assert not torch.allclose(final["recurrent"]["state"], rec.mean(dim=0))
    accs = recs["agg_acc"]
    assert accs.shape == (ROUNDS,) and torch.all(torch.isfinite(accs))


def test_excluded_leaf_keeps_each_devices_trajectory(ssm_rounds):
    """Device i entered with state + (i + 1): the offsets survive both
    re-dispatches (an averaged state would have lost them), moved only by
    each device's own training."""
    start, (state, _, final) = ssm_rounds
    rec = state.params["recurrent"]["state"]
    for i in range(1, D + 1):
        gap = (rec[i] - rec[0]).mean()
        assert abs(float(gap) - i) < 0.05, (i, float(gap))
    assert not torch.equal(final["recurrent"]["state"],
                           start.params["recurrent"]["state"][0])


def test_lm_scenario_runs_on_cpu_and_needs_a_card_by_default():
    cfg = lm_config(3, adapter=SSMAdapter(lm_model_config(vocab=VOCAB,
                                                          seq_len=SEQ),
                                          impl="pallas"), **BUDGET)
    rep = run_experiment(cfg, scenario="lm", rounds=2, n_test=12,
                         device="cpu")[0]
    assert [r["round"] for r in rep["rounds"]] == [0, 1]
    for r in rep["rounds"]:
        assert 0.0 <= r["aggregated_acc"] <= 1.0
        assert abs(sum(r["aggregation"]["weights"]) - 1.0) < 1e-5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_experiment(cfg, scenario="lm", rounds=1, n_test=12)


def test_decoder_fleet_launches_no_kernel_on_cpu():
    """The decoder's kernel route runs the plain K3 version on the CPU and
    the default preset's token geometry holds."""
    ja, ta = _models("decoder")
    cfg = lm_config(2, adapter=ta, **BUDGET)
    k3.launches = 0
    rep = run_experiment(cfg, scenario="lm", rounds=1, n_test=8,
                         device="cpu")[0]
    assert k3.launches == 0 and len(rep["rounds"]) == 1
    assert lm_config().adapter == SSMAdapter(lm_model_config())
