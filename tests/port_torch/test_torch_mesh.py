"""The sharded device axis (``EdgeEngine(mesh=...)``) against the unsharded
port, on gloo process groups of this CPU.

One 2-rank group (``make_device_mesh``) and one 4-rank group (a 2 × 2
``make_fog_mesh``) are spawned once for the module; each rank runs every
case of its group and saves what it got, and the parent runs the same
cases unsharded meanwhile.  The cases mirror the reference's mesh tests at
their sizes (D = 8, ``tests/test_shard_engine.py``): a round and fused
rounds with dropout on, the int8 codec with error feedback, buffering
hetero, faults with guards, a chained and a checkpointed continuation,
the async sync limit, a faulted async run and an async run with live
traffic, the drivers, and fog topologies on the 2-D mesh.  The children import no JAX.

Bars: parameters, fog models and float records within 1e-5, the
reference's own mesh bar.  A split's partial sums add in another order
than one reduce over the fleet, and Adam turns that order noise at
near-zero gradients into lr-sized steps, so of the trained trees (params,
optimizer moments, residuals, banked deltas, the fog model) at most
``comms.split_budget`` entries a leaf may lie beyond 1e-5, each within
``FIT_REACH``, the rule ``test_torch_async.py`` uses.  Integer records,
the pools, staleness and liveness are exactly equal, and every rank holds
the same records and fog model bit for bit.  One case runs the RNG-free
configuration of ``test_torch_slice.py`` against ``repro``'s
``EdgeEngine(mesh=make_device_mesh())`` at that file's bars.

Every ``init_process_group`` and ``join`` has a timeout, and a rank that
fails exits at once, so its peers' collectives fail: a broken group fails
the tests, it never hangs them.
"""
import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint import (load_engine_state,  # noqa: E402
                                    save_engine_state)
from repro_torch.core import comms  # noqa: E402
from repro_torch.core import federated as fed  # noqa: E402
from repro_torch.core.async_engine import AsyncConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.faults import FaultConfig, GuardConfig  # noqa: E402
from repro_torch.core.stream import StreamConfig  # noqa: E402
from repro_torch.core.topology import uniform_topology  # noqa: E402
from repro_torch.data.digits import make_digit_dataset  # noqa: E402
from repro_torch.data.federated_split import federated_split  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import (make_device_mesh,  # noqa: E402
                                     make_fog_mesh)
from repro_torch.nn.lenet import LeNetConfig  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

D, ROUNDS = 8, 2
CFG = fed.FederatedALConfig(num_devices=D, acquisitions=2, mc_samples=4,
                            k_per_acquisition=3, pool_window=16,
                            train_steps_per_acq=3, initial_train=10,
                            initial_train_steps=5, seed=5)
# the most a call's fits can move an entry: each Adam step moves it by
# about the learning rate at most
FIT_REACH = ROUNDS * CFG.acquisitions * CFG.train_steps_per_acq * CFG.lr
TOL = 1e-5

MESSY = FaultConfig(death_rate=0.2, birth_rate=0.5, crash_rate=0.2,
                    drop_rate=0.2, corrupt_rate=0.3, corrupt_mode="nan",
                    label_noise_rate=0.3, seed=5)
GUARDS = GuardConfig(policy="drop")
SYNC_LIMIT = AsyncConfig(quorum=D, dist="det", mean_latency=0.0)
SKEWED = AsyncConfig(quorum=3, timer=4.0, dist="exp", mean_latency=1.0,
                     latency_skew=10.0)
# the traffic of test_torch_stream.py's case (a)
TRAFFIC = StreamConfig(arrival_rate=20.0, rate_skew=4.0, burst=0.5,
                       queue_cap=4, max_arrivals=4, serve_threshold=1.0,
                       escalate_threshold=2.0, escalate_k=2, drift_kappa=2.0,
                       drift_period=8.0)

# test_torch_slice.py's RNG-free configuration (dropout 0, a window over
# every shard), on 2 devices for the reference check
SLICE = dict(initial_train=6, acquisitions=2, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)

# seconds: a collective's wait for a missing rank, and the whole groups'
GROUP_TIMEOUT_S, JOIN_TIMEOUT_S = 120, 300


# ------------------------------------------------------------------ cases
def _fleet(n=D, cfg=CFG):
    full = make_digit_dataset(20 * n, seed=1)
    test = make_digit_dataset(40, seed=2)
    seed_set = make_digit_dataset(cfg.initial_train, seed=3)
    return federated_split(full, n, seed=4), seed_set, test


def _engine(mesh, *, cfg=CFG, rounds=ROUNDS, model_cfg=LeNetConfig(),
            data=None):
    shards, seed_set, test = data or _fleet()
    trainer = fed.Trainer(cfg, model_cfg=model_cfg, device="cpu")
    p0 = trainer.init_params(torch.Generator().manual_seed(0))
    eng = EdgeEngine(trainer, cfg, shards, seed_set, test,
                     total_acquisitions=cfg.acquisitions * rounds,
                     device="cpu", mesh=mesh)
    return eng, p0


def _state_items(state):
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if f == "rng":
            continue
        if f == "pool":
            v = v._asdict()
        out.update({f"state/{f}/{p}".rstrip("/"): x
                    for p, x in tree_items(v)})
    return out


def _run_items(eng, run):
    """A run ``(state, recs, fog)`` as flat named tensors, the state in
    the unsharded layout."""
    state, recs, fog = run
    out = _state_items(eng.gather_state(state))
    out.update({f"recs/{k}": v for k, v in recs.items()})
    out.update({f"fog/{p}": x for p, x in tree_items(fog)})
    return out


def case_round(mesh):
    eng, p0 = _engine(mesh)
    state, recs = eng.run_round(eng.init_state(p0))
    return _run_items(eng, (state, recs, {}))


def _fused(mesh, **kw):
    eng, p0 = _engine(mesh)
    return _run_items(eng, eng.run_rounds_fused(eng.init_state(p0), ROUNDS,
                                                **kw))


def case_fused(mesh):
    mask = np.ones((ROUNDS, D), np.float32)
    mask[0, ::2] = 0.0                      # partial participation round 0
    return _fused(mesh, upload_mask=mask, aggregation="weighted")


def case_int8(mesh):
    return _fused(mesh, comms=comms.CommsConfig(compression="int8"))


def case_hetero(mesh):
    return _fused(mesh, hetero=fed.DEFAULT_HETERO)


def case_faults(mesh):
    return _fused(mesh, faults=MESSY, guards=GUARDS)


def case_flat(mesh):
    return _fused(mesh)


def case_fog_g1(mesh):
    return _fused(mesh, topology=uniform_topology(D, 1))


def case_fog_g2(mesh):
    return _fused(mesh, topology=uniform_topology(D, 2, local_steps=2),
                  faults=MESSY, guards=GUARDS)


def _async(mesh, events, **kw):
    eng, p0 = _engine(mesh, rounds=events)
    return _run_items(eng, eng.run_async(eng.init_state(p0), events, **kw))


def case_async_sync(mesh):
    return _async(mesh, 2, async_cfg=SYNC_LIMIT)


def case_async_faults(mesh):
    return _async(mesh, 2, async_cfg=SKEWED, faults=MESSY, guards=GUARDS)


def case_async_stream(mesh):
    """3 events with live traffic; the pool holds the escalations too:
    3 · (R·k + 2) = 24 slots, 4 rounds' worth."""
    eng, p0 = _engine(mesh, rounds=4)
    return _run_items(eng, eng.run_async(eng.init_state(p0), 3,
                                         async_cfg=SKEWED, stream=TRAFFIC))


def case_async_fog(mesh):
    return _async(mesh, 3, async_cfg=SKEWED,
                  topology=uniform_topology(D, 2, local_steps=2))


def case_chained(mesh):
    """1 + 1 chained hetero rounds (the base side runs 2 in one call); a
    sharded run also saves its state after round 1, loads it and resumes,
    which must equal the chained continuation bit for bit, and its
    state round-trips through ``gather`` / ``shard`` bit for bit."""
    eng, p0 = _engine(mesh)
    if mesh is None:
        return _run_items(eng, eng.run_rounds_fused(
            eng.init_state(p0), ROUNDS, hetero=fed.DEFAULT_HETERO))
    s1, r1, _ = eng.run_rounds_fused(eng.init_state(p0), 1,
                                     hetero=fed.DEFAULT_HETERO)
    s2, r2, f2 = eng.run_rounds_fused(s1, 1, start_round=1,
                                      hetero=fed.DEFAULT_HETERO)
    out = _run_items(eng, (s2, {k: torch.cat([r1[k], r2[k]]) for k in r1},
                           f2))
    whole = eng.gather_state(s1)
    path = os.path.join(os.environ["MESH_TEST_DIR"], "chained.msgpack")
    if mesh.rank == 0:
        save_engine_state(path, whole, metadata={"next_round": 1})
    dist.barrier()
    loaded, meta = load_engine_state(path, device="cpu")
    resumed = eng.run_rounds_fused(
        eng.resume_state(loaded, next_round=meta["next_round"]), 1,
        start_round=1, hetero=fed.DEFAULT_HETERO)
    again = _run_items(eng, resumed)
    chained = _run_items(eng, (s2, r2, f2))
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)
    back = sharding.gather_engine_state(
        mesh, sharding.shard_engine_state(mesh, whole))
    out["check/resumed_equals_chained"] = torch.tensor(same(chained, again))
    out["check/gather_shard_round_trip"] = torch.tensor(
        same(_state_items(whole), _state_items(back))
        and same(_state_items(s1), _state_items(
            sharding.shard_engine_state(mesh, whole))))
    return out


def case_drivers(mesh):
    """``run_federated_rounds(engine="vmap")`` (host Eq. 1 over gathered
    models) and ``run_experiment(scenario="massive")``, as reports."""
    shards, seed_set, test = _fleet()
    params, reps = fed.run_federated_rounds(
        CFG, shards, seed_set, test, rounds=ROUNDS, engine="vmap",
        device="cpu", mesh=mesh)
    small = fed.massive_config(D, acquisitions=1, train_steps_per_acq=1,
                               initial_train_steps=1, mc_samples=2)
    rep = fed.run_experiment(small, scenario="massive", num_devices=D,
                             rounds=ROUNDS, n_test=40, device="cpu",
                             mesh=mesh)[0]
    out = {f"fog/{p}": x for p, x in tree_items(params)}
    out["report/vmap"] = reps
    out["report/massive"] = rep
    return out


def case_refusals(mesh):
    """Checks decided on global values raise alike on every rank."""
    msgs = {}
    shards, seed_set, test = _fleet(7)
    try:
        _engine(mesh, data=(shards, seed_set, test))
    except ValueError as e:
        msgs["divide"] = str(e)
    try:
        make_device_mesh(3, device="cpu")
    except ValueError as e:
        msgs["ranks"] = str(e)
    eng, p0 = _engine(mesh, rounds=1)
    try:
        eng.run_rounds_fused(eng.init_state(p0), 2)
    except ValueError as e:
        msgs["capacity"] = str(e)
    return {"messages": msgs}


def _slice_data():
    full, test = make_digit_dataset(60, seed=0), make_digit_dataset(40, seed=5)
    return (federated_split(full, 2, seed=0), make_digit_dataset(6, seed=11),
            test)


def case_legacy(mesh):
    """The legacy loop on the RNG-free slice: each rank walks its own
    devices, which equals the unsharded loop only without draws."""
    cfg = fed.FederatedALConfig(num_devices=2, **SLICE)
    trainer = fed.Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                          device="cpu")
    params, reps = fed.run_federated_rounds(
        cfg, *_slice_data(), rounds=1, engine="legacy", trainer=trainer,
        mesh=mesh)
    out = {f"fog/{p}": x for p, x in tree_items(params)}
    out["report/legacy"] = reps
    return out


def case_reference(mesh):
    """The RNG-free 2-device fused rounds of the JAX-package check."""
    cfg = fed.FederatedALConfig(num_devices=2, **SLICE)
    eng, p0 = _engine(mesh, cfg=cfg, model_cfg=LeNetConfig(p_conv=0.0,
                                                          p_fc=0.0),
                      data=_slice_data())
    mask = fed.upload_mask_schedule(2, 0.67, 0, ROUNDS)
    out = _run_items(eng, eng.run_rounds_fused(
        eng.init_state(p0), ROUNDS, upload_mask=mask, aggregation="fedavg_n"))
    out["p0"] = p0
    return out


# group → ranks, mesh shape, {case: (sharded run, unsharded run)}
GROUPS = {
    "device2": (2, (2,), {
        "round": (case_round, case_round),
        "fused": (case_fused, case_fused),
        "int8": (case_int8, case_int8),
        "hetero": (case_hetero, case_hetero),
        "faults": (case_faults, case_faults),
        "chained": (case_chained, case_chained),
        "async_sync": (case_async_sync, case_async_sync),
        "async_faults": (case_async_faults, case_async_faults),
        "async_stream": (case_async_stream, case_async_stream),
        "drivers": (case_drivers, case_drivers),
        "legacy": (case_legacy, case_legacy),
        "refusals": (case_refusals, None),
        "reference": (case_reference, None),
    }),
    "fog2x2": (4, (2, 2), {
        "fog_g1": (case_fog_g1, case_flat),
        "fog_g2": (case_fog_g2, case_fog_g2),
        "async_fog": (case_async_fog, case_async_fog),
    }),
}


def _worker(group, rank, out_dir):
    """One rank: join the group, run its cases, save what it got."""
    world, shape, cases = GROUPS[group]
    torch.set_num_threads(1)
    os.environ["MESH_TEST_DIR"] = out_dir
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"),
                                         world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        mesh = (make_device_mesh(device="cpu") if len(shape) == 1
                else make_fog_mesh(*shape, device="cpu"))
        got = {name: run(mesh) for name, (run, _) in cases.items()}
        got["_jax_free"] = not any(m == "jax" or m.startswith("jax.")
                                   for m in sys.modules)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
        if group == "device2":
            # a rank that dies: its peer's next collective must fail
            # at once, not wait out the group's timeout
            if rank == 1:
                os._exit(0)
            t0 = time.monotonic()
            try:
                sharding.FleetShard(mesh, D).gather(torch.zeros(D // 2))
                dead = {"raised": False}
            except RuntimeError as e:
                dead = {"raised": True, "error": str(e)[:200]}
            dead["seconds"] = time.monotonic() - t0
            torch.save(dead, os.path.join(out_dir, "dead_peer.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn both groups, run the unsharded cases meanwhile, then collect:
    ``(unsharded results, {group: [each rank's results]})``."""
    ctx = torch.multiprocessing.get_context("spawn")
    started = {}
    for group, (world, _, _) in GROUPS.items():
        out = str(tmp_path_factory.mktemp(group))
        procs = [ctx.Process(target=_worker, args=(group, r, out),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        started[group] = (out, procs)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        base = {name: run(None) for _, _, cases in GROUPS.values()
                for name, (_, run) in cases.items() if run is not None}
    finally:
        torch.set_num_threads(threads)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    results = {}
    for group, (out, procs) in started.items():
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        errs = [open(os.path.join(out, f)).read()
                for f in sorted(os.listdir(out)) if f.endswith(".err")]
        if hung or errs or any(p.exitcode for p in procs):
            results[group] = (f"group {group}: ranks {hung} hung past "
                              f"{JOIN_TIMEOUT_S} s; exit codes "
                              f"{[p.exitcode for p in procs]}\n"
                              + "\n".join(errs))
        else:
            results[group] = [torch.load(os.path.join(out, f"rank{r}.pt"),
                                         weights_only=False)
                              for r in range(len(procs))]
            dead = os.path.join(out, "dead_peer.pt")
            if os.path.exists(dead):
                results[group][0]["_dead_peer"] = torch.load(dead)
    return base, results


def _ranks(runs, group, case):
    got = runs[1][group]
    if isinstance(got, str):
        pytest.fail(got)
    return [r[case] for r in got]


EXACT_RECS = {"selected", "n_labeled", "upload_mask", "live", "crashed",
              "dropped", "corrupted", "rejected", "clipped", "accepted",
              "staleness", "fog_sync", "group_accept", "arrivals",
              "sim_time", "timer_fired", "offered", "stream_dropped",
              "served", "serve_correct", "escalated", "queue_depth"}
FIT_TREES = ("state/params", "state/opt_state", "state/residual",
             "state/pending", "fog/")


def _exact(key, x):
    return (key.startswith(("state/pool", "state/staleness", "state/live"))
            or key.split("/", 1)[-1] in EXACT_RECS and key.startswith("recs/")
            or not x.is_floating_point())


def _check_run(base, got):
    """One sharded run against the unsharded one, by the bars above."""
    assert set(got) == set(base), set(got) ^ set(base)
    for key in sorted(base):
        a, b = base[key], got[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if _exact(key, a):
            torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True,
                                       msg=key)
        elif key.startswith(FIT_TREES):
            gap = (b.double() - a.double()).abs()
            assert float(gap.max()) <= FIT_REACH, (key, float(gap.max()))
            assert int((gap > TOL).sum()) <= comms.split_budget(gap.numel()), \
                (key, int((gap > TOL).sum()))
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=TOL,
                                       equal_nan=True, msg=key)


def _same_on_every_rank(ranks):
    for other in ranks[1:]:
        for key, x in ranks[0].items():
            torch.testing.assert_close(other[key], x, rtol=0, atol=0,
                                       equal_nan=True, msg=key)


@pytest.mark.parametrize("group,case", [
    ("device2", "round"), ("device2", "fused"), ("device2", "int8"),
    ("device2", "hetero"), ("device2", "faults"), ("device2", "chained"),
    ("device2", "async_sync"), ("device2", "async_faults"),
    ("device2", "async_stream"),
    ("fog2x2", "fog_g1"), ("fog2x2", "fog_g2"), ("fog2x2", "async_fog")])
def test_sharded_run_matches_unsharded(runs, group, case):
    """Every rank holds the same run, and it is the unsharded run's (for
    ``fog_g1``: the flat run's) by the module's bars."""
    ranks = _ranks(runs, group, case)
    checks = {k: ranks[0].pop(k) for k in list(ranks[0])
              if k.startswith("check/")}
    for r in ranks[1:]:
        for k in checks:
            r.pop(k)
    assert all(bool(v) for v in checks.values()), checks
    _same_on_every_rank(ranks)
    got = ranks[0]
    if case == "fog_g1":
        # the flat run has no tier rows; G = 1 syncs every round
        assert got.pop("recs/fog_sync").tolist() == [1.0] * ROUNDS
        assert got.pop("recs/beta").tolist() == [[1.0]] * ROUNDS
        got.pop("recs/group_accept")
    _check_run(runs[0][case], got)


def _close_reports(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close_reports(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close_reports(x, y, f"{where}/{i}")
    elif isinstance(a, float):
        assert abs(a - b) <= TOL or (a != a and b != b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def test_drivers_match_unsharded(runs):
    """``run_federated_rounds(engine="vmap", mesh=)`` and
    ``run_experiment(scenario="massive", mesh=)`` report what the
    unsharded drivers do, on every rank."""
    ranks = _ranks(runs, "device2", "drivers")
    base = runs[0]["drivers"]
    for got in ranks:
        _close_reports(base["report/vmap"], got["report/vmap"])
        _close_reports(base["report/massive"], got["report/massive"])
        _check_run({k: v for k, v in base.items() if k.startswith("fog/")},
                   {k: v for k, v in got.items() if k.startswith("fog/")})


def test_legacy_loop_matches_unsharded(runs):
    """``run_federated_rounds(engine="legacy", mesh=)`` on the RNG-free
    slice: each rank's loop over its own devices gives the unsharded
    loop's model and report."""
    base = runs[0]["legacy"]
    for got in _ranks(runs, "device2", "legacy"):
        _close_reports(base["report/legacy"], got["report/legacy"])
        _check_run({k: v for k, v in base.items() if k.startswith("fog/")},
                   {k: v for k, v in got.items() if k.startswith("fog/")})


def test_refusals_raise_on_every_rank(runs):
    """``test_mesh_requires_divisible_fleet``: D = 7 over 2 ranks, a mesh
    asking for more ranks than the group has, and a pool too small for
    the rounds asked raise on every rank, before any collective hangs."""
    for got in _ranks(runs, "device2", "refusals"):
        msgs = got["messages"]
        assert "num_devices=7 must divide evenly over the 2-way fleet mesh" \
            in msgs["divide"]
        assert "needs 3 ranks" in msgs["ranks"]
        assert "pool capacity" in msgs["capacity"]


def test_a_dead_rank_fails_its_peer_at_once(runs):
    """After its cases, rank 1 of the 2-rank group exits; rank 0's next
    collective raises well inside the group's timeout."""
    got = runs[1]["device2"]
    if isinstance(got, str):
        pytest.fail(got)
    dead = got[0]["_dead_peer"]
    assert dead["raised"], dead
    assert dead["seconds"] < GROUP_TIMEOUT_S / 4, dead


def test_children_import_no_jax(runs):
    for group in GROUPS:
        got = runs[1][group]
        if isinstance(got, str):
            pytest.fail(got)
        assert all(r["_jax_free"] for r in got)


def test_two_rank_fused_rounds_match_the_reference(runs):
    """The 2-rank RNG-free fused rounds against the JAX package's
    ``EdgeEngine(mesh=make_device_mesh())`` over its one host device, at
    ``test_torch_slice.py``'s bars."""
    jax = pytest.importorskip("jax")
    from repro.core.engine import EdgeEngine as JEngine
    from repro.core.federated import FederatedALConfig as JConfig
    from repro.core.federated import Trainer as JTrainer
    from repro.data.digits import make_digit_dataset as j_digits
    from repro.data.federated_split import federated_split as j_split
    from repro.launch.mesh import make_device_mesh as j_mesh
    from repro.nn.lenet import LeNetConfig as JLeNetConfig
    from repro_torch import interop

    jax.config.update("jax_platform_name", "cpu")
    got = _ranks(runs, "device2", "reference")[0]
    cfg = JConfig(num_devices=2, scorer="pallas_interpret", **SLICE)
    trainer = JTrainer(cfg, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    full, test = j_digits(60, seed=0), j_digits(40, seed=5)
    eng = JEngine(trainer, cfg, j_split(full, 2, seed=0), j_digits(6, seed=11),
                  test, total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                  scorer="pallas_interpret", aggregate_impl="pallas_interpret",
                  unroll=False, mesh=j_mesh())
    p0 = jax.tree_util.tree_map(jax.numpy.asarray,
                                interop.params_to_jax(got["p0"]))
    st, recs, fin = eng.run_rounds_fused(
        eng.init_state(p0), ROUNDS,
        upload_mask=fed.upload_mask_schedule(2, 0.67, 0, ROUNDS),
        aggregation="fedavg_n")
    np.testing.assert_array_equal(got["recs/upload_mask"].numpy(),
                                  np.asarray(recs["upload_mask"]))
    np.testing.assert_array_equal(got["recs/n_labeled"].numpy(),
                                  np.asarray(recs["n_labeled"]))
    np.testing.assert_allclose(got["recs/weights"].numpy(),
                               np.asarray(recs["weights"]), atol=1e-6)
    for key in ("device_accs", "agg_acc"):
        np.testing.assert_allclose(got[f"recs/{key}"].numpy(),
                                   np.asarray(recs[key]),
                                   atol=1 / len(test) + 1e-6)
    np.testing.assert_array_equal(got["state/pool/labeled_mask"].numpy(),
                                  np.asarray(st.pool.labeled_mask))
    np.testing.assert_array_equal(got["state/pool/n_filled"].numpy(),
                                  np.asarray(st.pool.n_filled))
    want = dict(tree_items(interop.params_from_jax(
        jax.tree_util.tree_map(np.asarray, fin), "cpu")))
    for path, leaf in want.items():
        np.testing.assert_allclose(got[f"fog/{path}"].numpy(), leaf.numpy(),
                                   atol=1e-4, err_msg=path)


def test_one_rank_mesh_equals_unsharded_and_checkpoints_alike(tmp_path):
    """A one-rank group in this process (``make_device_mesh`` starts it
    over a ``FileStore``): fused rounds with faults bit-equal to the
    unsharded run, and the checkpoints of both byte-equal."""
    assert not dist.is_initialized()
    try:
        mesh = make_device_mesh(device="cpu")
        assert (mesh.world, mesh.rank, mesh.shape) == (1, 0, (1,))
        files = []
        for m in (None, mesh):
            eng, p0 = _engine(m, rounds=1)
            state, recs, fog = eng.run_rounds_fused(
                eng.init_state(p0), 1, faults=MESSY, guards=GUARDS)
            files.append(tmp_path / f"{m is None}.msgpack")
            save_engine_state(str(files[-1]), eng.gather_state(state),
                              metadata={"next_round": 1})
        assert files[0].read_bytes() == files[1].read_bytes()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_mesh_layout_helpers():
    """Fleet axes and row ranges of the reference's fog-major layout, and
    the mesh's validation messages, without a group."""
    from types import SimpleNamespace
    m2 = SimpleNamespace(axis_names=("fog", "device"), shape=(2, 2), rank=3,
                         world=4, group=None)
    assert sharding.fleet_axes(m2) == ("fog", "device")
    assert sharding.fleet_axes(None) == ("device",)
    assert sharding.fleet_shards(m2) == 4
    assert sharding.device_axis_spec(m2, 8) == slice(6, 8)
    assert sharding.device_axis_spec(None, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="must be positive"):
        make_fog_mesh(0, 2, device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_device_mesh()
    assert not dist.is_initialized()
