"""The slice end to end against the JAX package: a paper round on the vmap
engine and fused massive rounds, plus the port's invariants (no JAX
imported, no silent CPU, unported options raise).

Both sides run the RNG-free configuration: dropout 0 (so MC samples and
training use no randomness) and a pool window at least the largest shard
(so the window is the whole unlabeled pool and the chosen set depends only
on the scores).  The two start from the same weights, carried across with
``repro_torch.interop``.  Tolerances: labeled sets and participation
exact; Eq. 1 weights 1e-6; parameters 1e-4 absolute (float32 rounding
through a few dozen Adam steps); accuracies within one test sample.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import vpool as jvpool  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.federated import run_federated_round as j_round  # noqa: E402
from repro.core.federated import upload_mask_schedule as j_sched  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import counters  # noqa: E402
from repro_torch.core import vpool as tvpool  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.federated import (FederatedALConfig, Trainer,  # noqa: E402
                                        massive_config, run_experiment,
                                        run_federated_round,
                                        run_federated_rounds,
                                        upload_mask_schedule)
from repro_torch.data.digits import make_digit_dataset  # noqa: E402
from repro_torch.data.federated_split import federated_split  # noqa: E402
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
REPO = Path(__file__).resolve().parents[2]

# RNG-free slice: window 64 covers every shard of 60 samples over D ≤ 3
SLICE = dict(initial_train=6, acquisitions=2, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)


def _data(D):
    full, test = j_digits(60, seed=0), j_digits(40, seed=5)
    seed_set = j_digits(6, seed=11)
    return j_split(full, D, seed=0), seed_set, test


def _jtrainer(cfg):
    return JTrainer(cfg, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))


def _ttrainer(cfg):
    return Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                   device="cpu")


def _close_params(pj, pt, atol=1e-4):
    back = interop.params_to_jax(pt)
    for kp, leaf in jax.tree_util.tree_leaves_with_path(pj):
        ref = back
        for k in kp:
            ref = ref[k.key]
        np.testing.assert_allclose(ref, np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(kp))


def test_vmap_round_matches_reference():
    shards, seed_set, test = _data(2)
    cfg_j = JConfig(num_devices=2, scorer="pallas_interpret", **SLICE)
    tr_j = _jtrainer(cfg_j)
    p0 = tr_j.init_params(jax.random.key(0))
    agg_j, rep_j = j_round(cfg_j, shards, seed_set, test, trainer=tr_j,
                           initial_params=p0)

    cfg_t = FederatedALConfig(num_devices=2, **SLICE)
    agg_t, rep_t = run_federated_round(
        cfg_t, shards, seed_set, test, trainer=_ttrainer(cfg_t),
        initial_params=interop.params_from_jax(
            jax.tree_util.tree_map(np.asarray, p0), "cpu"))

    assert set(rep_t) == set(rep_j)
    assert rep_t["comms"] == rep_j["comms"]
    for hj, ht in zip(rep_j["device_histories"], rep_t["device_histories"],
                      strict=True):
        for rj, rt in zip(hj, ht, strict=True):
            assert rj["n_labeled"] == rt["n_labeled"]
            assert set(rj["selected"]) == set(rt["selected"])
            assert abs(rj["test_acc"] - rt["test_acc"]) <= 1 / len(test)
    assert rep_j["aggregation"]["uploaded_devices"] == \
        rep_t["aggregation"]["uploaded_devices"]
    assert rep_j["initial_acc"] == rep_t["initial_acc"]
    assert abs(rep_j["aggregated_acc"] - rep_t["aggregated_acc"]) \
        <= 1 / len(test)
    _close_params(jax.tree_util.tree_map(np.asarray, agg_j), agg_t)


def test_fused_rounds_match_reference():
    D, rounds = 3, 2
    shards, seed_set, test = _data(D)
    cfg_j = JConfig(num_devices=D, scorer="pallas_interpret", **SLICE)
    tr_j = _jtrainer(cfg_j)
    p0 = tr_j.init_params(jax.random.key(1))
    mask = j_sched(D, 0.67, cfg_j.seed, rounds)
    np.testing.assert_array_equal(mask, upload_mask_schedule(D, 0.67, 0,
                                                             rounds))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * rounds,
                    scorer="pallas_interpret",
                    aggregate_impl="pallas_interpret", unroll=False)
    st_j = eng_j.init_state(p0)
    st_j, recs_j, fin_j = eng_j.run_rounds_fused(st_j, rounds,
                                                 upload_mask=mask,
                                                 aggregation="fedavg_n")

    cfg_t = FederatedALConfig(num_devices=D, **SLICE)
    eng_t = EdgeEngine(_ttrainer(cfg_t), cfg_t, shards, seed_set, test,
                       total_acquisitions=SLICE["acquisitions"] * rounds,
                       device="cpu")
    st_t = eng_t.init_state(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    st_t, recs_t, fin_t = eng_t.run_rounds_fused(st_t, rounds,
                                                 upload_mask=mask,
                                                 aggregation="fedavg_n")

    np.testing.assert_array_equal(recs_t["upload_mask"].numpy(),
                                  np.asarray(recs_j["upload_mask"]))
    np.testing.assert_array_equal(recs_t["n_labeled"].numpy(),
                                  np.asarray(recs_j["n_labeled"]))
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    np.testing.assert_allclose(recs_t["device_accs"].numpy(),
                               np.asarray(recs_j["device_accs"]),
                               atol=1 / len(test) + 1e-6)
    np.testing.assert_allclose(recs_t["agg_acc"].numpy(),
                               np.asarray(recs_j["agg_acc"]),
                               atol=1 / len(test) + 1e-6)
    pool_j = jax.tree_util.tree_map(np.asarray, st_j.pool)
    pool_t = interop.vpool_to_jax(st_t.pool)
    np.testing.assert_array_equal(pool_t["labeled_mask"], pool_j.labeled_mask)
    np.testing.assert_array_equal(pool_t["n_filled"], pool_j.n_filled)
    _close_params(jax.tree_util.tree_map(np.asarray, fin_j), fin_t)


def test_init_state_carries_across():
    shards, seed_set, _ = _data(2)
    cfg_j = JConfig(num_devices=2, **SLICE)
    tr_j = _jtrainer(cfg_j)
    p0 = tr_j.init_params(jax.random.key(2))
    st_j = JEngine(tr_j, cfg_j, shards, seed_set).init_state(p0)
    cfg_t = FederatedALConfig(num_devices=2, **SLICE)
    st_t = EdgeEngine(_ttrainer(cfg_t), cfg_t, shards, seed_set,
                      device="cpu").init_state(interop.params_from_jax(
                          jax.tree_util.tree_map(np.asarray, p0), "cpu"))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    for a, b in ((as_np(st_j.params), interop.params_to_jax(st_t.params)),
                 (as_np(st_j.opt_state), interop.params_to_jax(st_t.opt_state))):
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b), strict=True):
            np.testing.assert_array_equal(x, y)
    pool_back = interop.vpool_from_jax(as_np(st_j.pool), "cpu")
    for f in tvpool.VPool._fields:
        assert torch.equal(getattr(pool_back, f), getattr(st_t.pool, f)), f


def test_acquire_drops_invalid_picks_like_reference():
    """vpool.acquire drops invalid picks (``mode="drop"``) and clamps the
    slot write at capacity; torch indexing would raise or wrap instead."""
    valid = np.ones((2, 6), bool)
    valid[1, 4:] = False
    win = np.array([[5, 0, 3, 1], [2, 3, 5, 4]], np.int32)
    sel = np.array([[0, 2, 3], [1, 3, 2]], np.int32)
    sel_valid = np.array([[True, False, True], [True, True, False]])
    jp = jax.vmap(lambda v: jvpool.vpool_init(v, 4))(jnp.asarray(valid))
    tp = tvpool.vpool_init(torch.from_numpy(valid), 4)
    for _ in range(2):                     # the second call clamps at cap 4
        jp = jax.vmap(jvpool.acquire)(jp, jnp.asarray(win), jnp.asarray(sel),
                                      jnp.asarray(sel_valid))
        tp = tvpool.acquire(tp, torch.from_numpy(win).long(),
                            torch.from_numpy(sel).long(),
                            torch.from_numpy(sel_valid))
        got = interop.vpool_to_jax(tp)
        for f in tvpool.VPool._fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jp, f)),
                                          err_msg=f)


def test_draw_window_marks_short_pools_invalid():
    valid = torch.tensor([[True, True, False, True, False]])
    pool = tvpool.vpool_init(valid, 4)
    idx, ok = tvpool.draw_window(pool, torch.Generator().manual_seed(0), 7)
    assert idx.shape == (1, 7) and int(ok.sum()) == 3
    assert set(idx[0][ok[0]].tolist()) == {0, 1, 3}


def test_paper_and_massive_scenarios_run_on_cpu():
    cfg = FederatedALConfig(num_devices=2, **SLICE)
    rep = run_experiment(cfg, scenario="paper", n_train=60, n_test=20,
                         device="cpu")[0]
    assert set(rep) == {"initial_acc", "aggregated_acc", "aggregation",
                        "device_histories", "comms"}
    rep = run_experiment(massive_config(6, train_steps_per_acq=2,
                                        initial_train_steps=3),
                         scenario="massive", num_devices=6, rounds=2,
                         n_test=20, device="cpu")[0]
    assert [r["round"] for r in rep["rounds"]] == [0, 1]
    for r in rep["rounds"]:
        assert 0.0 <= r["aggregated_acc"] <= 1.0
        assert abs(sum(r["aggregation"]["weights"]) - 1.0) < 1e-5


def test_vmap_rounds_and_partial_participation():
    shards = federated_split(make_digit_dataset(60, seed=0), 3, seed=0)
    cfg = FederatedALConfig(num_devices=3, aggregation="fedavg_n", **SLICE)
    counters.reset_dispatches()
    _, reports = run_federated_rounds(
        cfg, shards, make_digit_dataset(6, seed=11),
        make_digit_dataset(20, seed=5), rounds=2, upload_fraction=0.67,
        device="cpu")
    # the seed fit, then one dispatch per round (the reference's count)
    assert counters.dispatch_count() == 3
    assert [r["aggregation"]["uploaded_devices"] for r in reports] == [
        np.nonzero(m)[0].tolist() for m in upload_mask_schedule(3, 0.67, 0, 2)]


def test_no_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = FederatedALConfig(num_devices=2, **SLICE)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment(cfg, scenario="paper", n_train=60, n_test=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)


@pytest.mark.parametrize("call", ["comms", "engine", "scenario", "adapter"])
def test_unported_options_raise(call):
    """The options ported since they raised run (the fleet bundle, live
    traffic, every scenario, the blockwise attention core and a decode
    call, item 16b), or raise the reference's ``ValueError`` where the
    reference refuses them."""
    from repro_torch.core.comms import CommsConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.stream import StreamConfig
    cfg = FederatedALConfig(num_devices=2, **SLICE)
    shards = federated_split(make_digit_dataset(20, seed=0), 2, seed=0)
    seed_set, test = make_digit_dataset(6, seed=1), make_digit_dataset(5)
    rounds = lambda **kw: run_federated_rounds(cfg, shards, seed_set, test,
                                               rounds=1, device="cpu", **kw)
    if call == "comms":   # the fleet bundle carries the options
        _, reps = rounds(engine="fused", fleet=FleetConfig(
            comms=CommsConfig(compression="int8")))
        assert reps[0]["comms"]["compression"] == "int8"
        with pytest.raises(ValueError, match="does not support fleet"):
            rounds(engine="fused", fleet=FleetConfig(live_mask=np.ones(2)))
    elif call == "engine":  # live traffic runs on the async engine only
        with pytest.raises(ValueError, match="requires engine='async'"):
            rounds(engine="fused", stream=StreamConfig())
        _, reps = rounds(engine="async", stream=StreamConfig())
        assert len(reps[0]["queue_depth"]) == 2
    elif call == "scenario":  # every scenario of the reference is ported
        rep = run_experiment(cfg, scenario="stream", num_devices=2,
                             n_test=10, device="cpu")[0]
        assert rep["stream"]["events"] == 1 and "async" in rep
    else:  # the MoE decoder runs, on the blockwise core and in decode too
        from repro_torch.core.model_adapter import DecoderLMAdapter
        from repro_torch.models.config import ModelConfig
        from repro_torch.models.decoder import decoder_forward
        from repro_torch.tree import tree_map
        moe = ModelConfig(n_layers=1, d_model=64, n_heads=1, n_kv_heads=1,
                          vocab_size=32, n_experts=4)
        adapter = DecoderLMAdapter(moe)
        Trainer(cfg, adapter=adapter, device="cpu")
        params = tree_map(lambda a: a[None],
                          adapter.init(torch.Generator().manual_seed(0)))
        toks = torch.arange(8, dtype=torch.int32).reshape(1, 2, 4)
        blockwise = DecoderLMAdapter(moe, impl="blockwise")
        assert torch.allclose(blockwise.apply(params, toks[0]),
                              adapter.apply(params, toks[0]), atol=1e-5)
        _, caches, _ = decoder_forward(params, toks[..., :3], cfg=moe,
                                       collect_prefill_caches=True,
                                       max_cache_len=4)
        logits, _, _ = decoder_forward(params, toks[..., 3:], cfg=moe,
                                       positions=3, caches=caches,
                                       decode=True)
        assert logits.shape == (1, 2, 1, 32)
        assert bool(torch.isfinite(logits).all())
        with pytest.raises(ValueError, match="unknown attention impl"):
            DecoderLMAdapter(moe, impl="flash")


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads no
    ``jax``, nothing of ``repro`` and no ``msgpack`` (the card's machine
    has none: the checkpoints use the port's own codec)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')\n"
        "       or m == 'msgpack' or m.startswith('msgpack.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
