"""msgpack checkpoints in the port against the JAX package on the CPU.

The port writes its files with its own msgpack codec (``checkpoint
._msgpack``); they must be the bytes the ``msgpack`` package writes, and
each package must read the other's engine-state files with every leaf
equal.  The port writes ``rng_key_data`` as zeros, so a reference state
whose keys hold zero data saves to the very same bytes.  A resume on the
CPU (2 rounds, save, load, ``resume_state``, 1 round) must equal the 3
uninterrupted rounds bit for bit, with hetero buffering, faults, guards
and int8 uploads with error feedback all on, and so must a chained call
(2 rounds, then 1 on the returned state).  An async restore (2 events,
save, load, ``resume_state``, 2 events) must equal the chained
continuation bit for bit, with faults, guards and int8 uploads (the
reference's ``test_async_resume_exact``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import msgpack_ckpt as jckpt  # noqa: E402
from repro.core.engine import EngineState as JState  # noqa: E402
from repro.core.vpool import VPool as JPool  # noqa: E402
from repro_torch.checkpoint import (_msgpack, latest_round,  # noqa: E402
                                    load_engine_state, load_pytree,
                                    load_round, save_engine_state,
                                    save_pytree, save_round)
from repro_torch.core.async_engine import AsyncConfig  # noqa: E402
from repro_torch.core.comms import CommsConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine, EngineState  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.core.federated import Trainer, massive_config  # noqa: E402
from repro_torch.core.hetero import HeteroConfig  # noqa: E402
from repro_torch.core.vpool import VPool  # noqa: E402
from repro_torch.data.digits import make_digit_dataset  # noqa: E402
from repro_torch.data.federated_split import dirichlet_split  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
D = 3


def _mixed_trees():
    """The mixed tree of ``tests/test_checkpoint.py`` in both packages."""
    j = {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                    "b": jnp.ones((4,), jnp.bfloat16)},
         "step": 123,
         "nested": {"list": [jnp.zeros((2,)), "tag", 7],
                    "tup": (1.5, jnp.asarray([True, False]))}}
    t = {"params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                    "b": torch.ones((4,), dtype=torch.bfloat16)},
         "step": 123,
         "nested": {"list": [torch.zeros((2,)), "tag", 7],
                    "tup": (1.5, torch.tensor([True, False]))}}
    return j, t


def _states(kind):
    """The engine state of ``tests/test_checkpoint.py`` in both packages:
    ``kind`` "buffers" (every extension buffer populated), "empty" (none)
    or "bf16" (bfloat16 params and residual).  The reference's keys hold
    zero data, as the port writes them."""
    f32 = np.float32
    params = {"w": np.arange(6, dtype=f32).reshape(D, 2)}
    opt = {"m": np.zeros((D, 2), f32), "v": np.ones((D, 2), f32),
           "step": np.zeros((D,), np.int32)}
    pool = dict(labeled_mask=np.asarray([[True, False]] * D),
                labeled_idx=np.zeros((D, 4), np.int32),
                labeled_valid=np.zeros((D, 4), bool),
                n_filled=np.ones((D,), np.int32))
    ext = {}
    if kind != "empty":
        ext = dict(residual={"w": np.full((D, 2), 0.25, f32)},
                   pending={"w": np.full((D, 2), -1.5, f32)},
                   staleness=np.asarray([0, 2, 5], np.int32),
                   live=np.asarray([1.0, 0.0, 1.0], f32))
    jx = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)
    tt = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)
    rng = jax.random.wrap_key_data(jnp.zeros((D, 2), jnp.uint32))
    js = JState(jx(params), jx(opt), JPool(**jx(pool)), rng,
                **{k: jx(v) for k, v in ext.items()})
    ts = EngineState(tt(params), tt(opt), VPool(**tt(pool)), None,
                     **{k: tt(v) for k, v in ext.items()})
    if kind == "bf16":
        js = js._replace(
            params=jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16), js.params),
            residual={"w": jnp.full((D, 2), 0.125, jnp.bfloat16)})
        ts = ts._replace(
            params={"w": ts.params["w"].to(torch.bfloat16)},
            residual={"w": torch.full((D, 2), 0.125, dtype=torch.bfloat16)})
    return js, ts


def _equal_leaves(j_leaves, t_leaves):
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          b.float().numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _state_leaves(state):
    return tree_leaves(tuple(state._replace(rng=())))


def test_codec_writes_the_msgpack_package_bytes(tmp_path):
    msgpack = pytest.importorskip("msgpack")
    j, t = _mixed_trees()
    jckpt.save_pytree(str(tmp_path / "j.msgpack"), j)
    save_pytree(str(tmp_path / "t.msgpack"), t)
    raw = (tmp_path / "j.msgpack").read_bytes()
    assert (tmp_path / "t.msgpack").read_bytes() == raw
    payload = msgpack.unpackb(raw, raw=False)
    assert _msgpack.packb(payload) == msgpack.packb(payload,
                                                    use_bin_type=True)
    assert _msgpack.unpackb(raw) == payload
    odd = {"ints": [0, 127, 128, -32, -33, -129, 2**16, -2**31 - 1, 2**63,
                    -2**63], "s": "é" * 40, "long": "x" * 300,
           "bin": b"\x00" * 70000, "f": -0.0, "n": None, "b": [True, False],
           "wide": {str(i): i for i in range(20)}, "arr": list(range(20))}
    assert _msgpack.packb(odd) == msgpack.packb(odd, use_bin_type=True)
    assert _msgpack.unpackb(_msgpack.packb(odd)) == odd


def test_mixed_tree_round_trips(tmp_path):
    _, t = _mixed_trees()
    path = str(tmp_path / "ck.msgpack")
    save_pytree(path, t)
    back = load_pytree(path, device="cpu")
    assert torch.equal(back["params"]["w"], t["params"]["w"])
    assert back["params"]["b"].dtype == torch.bfloat16
    assert back["step"] == 123 and back["nested"]["list"][1] == "tag"
    assert isinstance(back["nested"]["tup"], tuple)
    assert back["nested"]["tup"][0] == 1.5
    assert back["nested"]["tup"][1].tolist() == [True, False]
    j = jckpt.load_pytree(path)
    assert j["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(j["params"]["w"]),
                                  t["params"]["w"].numpy())


@pytest.mark.parametrize("kind", ["buffers", "empty", "bf16"])
def test_engine_states_cross_read(tmp_path, kind):
    js, ts = _states(kind)
    meta = {"next_round": 7} if kind != "empty" else None
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jckpt.save_engine_state(jpath, js, metadata=meta)
    save_engine_state(tpath, ts, metadata=meta)
    # zero key data: the same bytes
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # the reference's file in the port
    back, got_meta = load_engine_state(jpath, device="cpu")
    assert got_meta == (meta or {}) and back.rng is None
    assert type(back.pool) is VPool
    _equal_leaves(jax.tree_util.tree_leaves(js._replace(rng=())),
                  _state_leaves(back))
    if kind == "empty":
        assert back.residual == () and back.pending == ()
        assert back.staleness == () and back.live == ()
    # the port's file in the reference
    jback, got_meta = jckpt.load_engine_state(tpath)
    assert got_meta == (meta or {})
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jback.rng)), np.zeros((D, 2)))
    _equal_leaves(jax.tree_util.tree_leaves(jback._replace(rng=())),
                  _state_leaves(ts))


def test_atomic_overwrite_snapshots_and_refusal(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    save_pytree(path, {"v": torch.tensor([1.0])})
    save_pytree(path, {"v": torch.tensor([2.0])})
    assert float(load_pytree(path, device="cpu")["v"][0]) == 2.0
    assert not os.path.exists(path + ".tmp")
    d = str(tmp_path / "rounds")
    fog = {"w": torch.ones((2, 2))}
    devs = [{"w": torch.full((2, 2), float(i))} for i in range(3)]
    save_round(d, 0, fog_model=fog, device_models=devs, metadata={"acc": 0.5})
    save_round(d, 3, fog_model=fog, metadata={"acc": 0.7})
    assert latest_round(d) == 3
    back = load_round(d, 0, device="cpu")
    assert len(back["device_models"]) == 3
    assert torch.equal(back["device_models"][2]["w"], torch.full((2, 2), 2.0))
    assert back["metadata"]["acc"] == 0.5
    assert latest_round(str(tmp_path / "missing")) is None
    assert jckpt.load_round(d, 3)["metadata"]["acc"] == 0.7
    with pytest.raises(ValueError, match="engine-state"):
        load_engine_state(path, device="cpu")


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """2 rounds, save, load, ``resume_state``, 1 round with
    ``start_round=2``: bit-equal to 3 uninterrupted rounds (the fog
    model, every rec row of round 2 and the whole state), with hetero
    buffering, faults, guards and int8 uploads with error feedback."""
    n = 5
    cfg = massive_config(n, acquisitions=1, train_steps_per_acq=2,
                         initial_train_steps=2, pool_window=16, mc_samples=2)
    shards = dirichlet_split(make_digit_dataset(120, seed=0), n, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        20, seed=5)
    kw = dict(hetero=HeteroConfig(straggler_rate=0.3, slow_fraction=0.5),
              faults=FaultConfig(death_rate=0.2, birth_rate=0.5,
                                 crash_rate=0.1, drop_rate=0.1,
                                 corrupt_rate=0.2, label_noise_rate=0.1),
              guards=GuardConfig(norm_factor=4.0),
              comms=CommsConfig(compression="int8"))

    def engine():
        return EdgeEngine(Trainer(cfg, device="cpu"), cfg, shards, seed_set,
                          test, total_acquisitions=3, device="cpu")

    eng = engine()
    p0 = eng.trainer.init_params(torch.Generator().manual_seed(0))
    s3, r3, f3 = eng.run_rounds_fused(eng.init_state(p0), 3, **kw)
    s2, _, _ = eng.run_rounds_fused(eng.init_state(p0), 2, **kw)
    path = str(tmp_path / "es.msgpack")
    save_engine_state(path, s2, metadata={"next_round": 2})
    state, meta = load_engine_state(path, device="cpu")
    eng = engine()
    with pytest.raises(ValueError, match="resume_state"):
        eng.run_rounds_fused(state, 1, start_round=2, **kw)
    state = eng.resume_state(state, next_round=meta["next_round"])
    s1, r1, f1 = eng.run_rounds_fused(state, 1, start_round=2, **kw)
    for a, b in zip(tree_leaves(f3), tree_leaves(f1), strict=True):
        assert torch.equal(a, b)
    assert set(r1) == set(r3)
    for k in r3:
        assert torch.equal(r3[k][2], r1[k][0]), k
    for a, b in zip(_state_leaves(s3), _state_leaves(s1), strict=True):
        assert torch.equal(a, b)
    assert tree_leaves(s1.residual) and tree_leaves(s1.pending)
    assert r3["live"].min() == 0 or r3["crashed"].any()


def _fleet(n, **cfg_kw):
    cfg = massive_config(n, acquisitions=1, train_steps_per_acq=2,
                         initial_train_steps=2, pool_window=16, mc_samples=2,
                         **cfg_kw)
    shards = dirichlet_split(make_digit_dataset(120, seed=0), n, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        20, seed=5)
    eng = EdgeEngine(Trainer(cfg, device="cpu"), cfg, shards, seed_set,
                     test, total_acquisitions=4, device="cpu")
    return eng, eng.trainer.init_params(torch.Generator().manual_seed(0))


def _equal_runs(a, b):
    (sa, ra, fa), (sb, rb, fb) = a, b
    for x, y in zip(tree_leaves(fa), tree_leaves(fb), strict=True):
        assert torch.equal(x, y)
    assert set(ra) == set(rb)
    for k in ra:
        assert torch.equal(ra[k], rb[k]), k
    for x, y in zip(_state_leaves(sa), _state_leaves(sb), strict=True):
        assert torch.equal(x, y)


def test_chained_rounds_equal_the_uninterrupted_run():
    """2 rounds, then 1 with ``start_round=2`` on the returned state (no
    checkpoint): bit-equal to 3 uninterrupted rounds with MC dropout on
    (the generator the first call returns is the one round 2 draws
    from), with faults and int8 uploads."""
    eng, p0 = _fleet(4)
    kw = dict(faults=FaultConfig(crash_rate=0.2, drop_rate=0.2,
                                 label_noise_rate=0.2),
              comms=CommsConfig(compression="int8"))
    s3, r3, f3 = eng.run_rounds_fused(eng.init_state(p0), 3, **kw)
    s2, _, _ = eng.run_rounds_fused(eng.init_state(p0), 2, **kw)
    s1, r1, f1 = eng.run_rounds_fused(s2, 1, start_round=2, **kw)
    _equal_runs((s3, {k: v[2:] for k, v in r3.items()}, f3), (s1, r1, f1))


def test_async_resume_equals_the_chained_continuation(tmp_path):
    """The reference's ``test_async_resume_exact`` (D = 6): 2 events with
    churn, crashes, drops, corruption, label noise, guards ``"drop"`` and
    int8 uploads with error feedback; save, load, ``resume_state(2)``, 2
    events with ``start_event=2``, bit-equal to 2 events chained on the
    in-memory state."""
    eng, p0 = _fleet(6)
    kw = dict(async_cfg=AsyncConfig(quorum=3, timer=4.0, dist="exp",
                                    mean_latency=1.0, latency_skew=4.0),
              faults=FaultConfig(death_rate=0.2, birth_rate=0.5,
                                 crash_rate=0.1, drop_rate=0.1,
                                 corrupt_rate=0.2, label_noise_rate=0.1),
              guards=GuardConfig(policy="drop"),
              comms=CommsConfig(compression="int8"))
    st, r2, _ = eng.run_async(eng.init_state(p0), 2, **kw)
    path = str(tmp_path / "async.msgpack")
    save_engine_state(path, st, metadata={"next_event": 2})
    chained = eng.run_async(st, 2, start_event=2, **kw)
    # a call draws from a copy of the state's generator: a second call
    # from the same state draws alike
    _equal_runs(chained, eng.run_async(st, 2, start_event=2, **kw))
    loaded, meta = load_engine_state(path, device="cpu")
    for a, b in zip(_state_leaves(st), _state_leaves(loaded), strict=True):
        assert torch.equal(a, b)
    loaded = eng.resume_state(loaded, next_round=meta["next_event"])
    restored = eng.run_async(loaded, 2, start_event=2, **kw)
    _equal_runs(chained, restored)
    assert tree_leaves(st.residual) and r2["arrivals"].sum() > 0
