"""The model-parallel launch tools (``repro_torch.launch.mesh``,
``launch.sharding``, ``nn.shard_hints``, ``launch.op_analysis`` and
``launch.dryrun``) against the JAX package's and against the unsharded
port.

* The rule tables: for each of the ten published configs at
  ``reduced()``, every leaf's spec equals the reference's
  (``jax.eval_shape`` of its init), and so for the adafactor state
  (``vr`` / ``vc``) and for both cache modes over each family's caches.
* The analysis: ``op_analysis`` FLOPs of a reduced gemma2 forward and
  train step equal ``repro.launch.hlo_analysis.analyze`` of the
  reference's compiled step EXACTLY (see the tests' docstrings for the
  one op-level gap, the reference's rematerialisation).
* In child processes (no group ever starts in the pytest process; each
  child has a timeout): a 2-rank gloo group on a 1 × 2 ``("data",
  "model")`` mesh runs a reduced gemma2 forward with params placed by
  the rule tables, on the ``"naive"`` and ``"pallas"`` routes, with the
  heads split, with one kv head (``model`` does not divide it) and with
  three heads (``model`` divides neither), each within 1e-5 of the
  unsharded forward in float32; on the same group a reduced gemma2 train
  step (the tied table, two microbatches) on 1 × 2 and 2 × 1 meshes, and
  reduced deepseek-v2 (MLA, MoE) and minicpm3 (MLA) forwards and decode
  steps, all within 1e-5 of the unsharded runs; the hints there; a
  row-parallel product's collectives.  A one-rank gloo group drives
  ``serve``'s greedy loop through the steps with a mesh and hints, bit
  for bit against ``serve()``.  A fake 2 × 2 × 2 group classifies the
  axes' collectives as the reference's cross-pod cases do.  A fake 2 × 4
  group dry-runs gemma2-2b at ``reduced()`` at the four shapes,
  ``argument_gb`` against the closed form.

The children import no JAX: the case functions live here and import JAX
only inside the reference tests.
"""
import contextlib
import functools
import os
import sys
import time
import traceback
from dataclasses import replace
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, sharding  # noqa: E402
from repro_torch.launch.mesh import (active_mesh, batch_axes,  # noqa: E402
                                     make_auto_mesh, make_debug_mesh,
                                     use_mesh)
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.nn.shard_hints import hint, hint_heads  # noqa: E402
from repro_torch.optim import adafactor, adamw, sgd  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

JOIN_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 120
TOL = 1e-5
B, S = 2, 16
# the forward variants of the 2-rank split: config changes and routes
FORWARDS = {
    "heads_split-naive": ({}, "naive"),
    "heads_split-pallas": ({}, "pallas"),
    "heads_split-hints": ({"shard_hints": True}, "naive"),
    "kv1-pallas": ({"n_kv_heads": 1}, "pallas"),
    "kv1-naive": ({"n_kv_heads": 1}, "naive"),
    "h3-pallas": ({"n_heads": 3, "n_kv_heads": 3}, "pallas"),
}
# the train step's meshes: the model axis split (vocabulary-parallel
# target logit, the tied table's gradient, the heads' merge backward),
# and the data axis split (microbatches cut on each rank's rows)
TRAIN_MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
# the MLA and MoE families: a forward and a prefill + one decode step,
# with and without the hints
ZOO = [f"{arch}-{mode}" for arch in ("deepseek-v2-236b", "minicpm3-4b")
       for mode in ("plain", "hints")]
DRY_SHAPES = list(dryrun.SHAPES)


def _gemma(**changes):
    return replace(get_config("gemma2-2b").reduced(), **changes)


def _params(cfg):
    return build_model(cfg).init(torch.Generator().manual_seed(0))


def _tokens(cfg):
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int64)).to(torch.int32)


def _dry_config(arch):
    """The dry runs' config: ``reduced()`` widths and depth (the closed
    form of the argument bytes holds at any width)."""
    return get_config(arch).reduced()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _train_run(mesh=None):
    """One reduced gemma2 train step (the tied table, two microbatches,
    batch 4), placed on ``mesh`` when one is given: the loss, the grad
    norm and the updated params.  ``sgd`` at rate 1 makes a param's gap
    its clipped gradient's gap; adam's first step divides a gradient by
    its own magnitude and turns round-off on near-zero entries into gaps
    of up to its rate."""
    cfg = _gemma()
    assert cfg.tie_embeddings
    model = build_model(cfg)
    params = _params(cfg)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, S), dtype=np.int64)).to(torch.int32)
        for k in ("tokens", "targets")}
    opt = sgd(1.0)
    step = make_train_step(model, opt, num_microbatches=2)
    scope = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    if mesh is not None:
        params = sharding.distribute_params(mesh, params)
        batch = {k: sharding.distribute(mesh, v, sharding.batch_spec(mesh, 2))
                 for k, v in batch.items()}
    with scope:
        new, _, metrics = step(params, opt.init(params), batch, 0)
    return {"loss": float(_whole(metrics["loss"])),
            "grad_norm": float(_whole(metrics["grad_norm"])),
            "params": {p: _whole(x).numpy() for p, x in tree_items(new)}}


def _zoo_run(name, mesh=None):
    """A reduced MLA / MoE config's forward logits and the logits of a
    prefill then one decode step, placed on ``mesh`` when one is given."""
    arch, mode = name.rsplit("-", 1)
    cfg = replace(get_config(arch).reduced(), shard_hints=mode == "hints")
    model = build_model(cfg)
    params, tok = _params(cfg), _tokens(cfg)
    nxt = tok[:, :1]
    prefill = make_prefill_step(model, max_cache_len=S + 2)
    decode = make_decode_step(model)
    scope = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    if mesh is not None:
        params = sharding.distribute_params(mesh, params)
        tok, nxt = (sharding.distribute(mesh, t, sharding.batch_spec(mesh, 2))
                    for t in (tok, nxt))
    with scope:
        logits, _ = model.apply(params, tok)
        _, caches = prefill(params, {"tokens": tok})
        step_logits, _ = decode(params, nxt, caches, S)
    return {"forward": _whole(logits).numpy(),
            "decode": _whole(step_logits).numpy()}


def _greedy(mesh, cfg, params, prompts, max_new, impl):
    """``serve``'s greedy loop through the steps themselves, over
    ``mesh`` with the hints on: the last position's logits of the
    prefill and of each decode step, and the tokens."""
    model = build_model(replace(cfg, shard_hints=True))
    P = prompts.shape[1]
    prefill = make_prefill_step(model, max_cache_len=P + max_new + 1,
                                impl=impl)
    decode = make_decode_step(model, impl=impl)
    place = lambda t: sharding.distribute(mesh, t,
                                          sharding.batch_spec(mesh, 2))
    params = sharding.distribute_params(mesh, params)
    kept, toks = [], []
    with use_mesh(mesh):
        logits, caches = prefill(params, {"tokens": place(prompts)})
        for i in range(max_new):
            kept.append(logits[:, -1].full_tensor())
            toks.append(kept[-1].float().argmax(dim=-1, keepdim=True))
            if i < max_new - 1:
                logits, caches = decode(params, place(toks[-1]), caches,
                                        P + i)
    return torch.stack(kept, dim=1), torch.cat(toks, dim=1)


# ------------------------------------------------------------ child cases
def _forward_cases(mesh):
    out = {}
    for name, (changes, impl) in FORWARDS.items():
        cfg = _gemma(**changes)
        model = build_model(cfg)
        params = sharding.distribute_params(mesh, _params(cfg))
        tok = sharding.distribute(mesh, _tokens(cfg),
                                  sharding.batch_spec(mesh, 2))
        with use_mesh(mesh):
            logits, _ = model.apply(params, tok, impl=impl)
        out[name] = logits.full_tensor().numpy()
    return out


def _row_parallel(mesh):
    """x ``[4, 8]`` split on its columns, w ``[8, 6]`` on its rows: the
    product is a partial sum, one all-reduce of the ``[4, 6]`` result."""
    from torch.distributed.tensor import Replicate
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, generator=gen)
    w = torch.randn(8, 6, generator=gen)
    xd = sharding.distribute(mesh, x, (None, "model"))
    wd = sharding.distribute(mesh, w, ("model", None))
    y, stats, _ = op_analysis.analyze(
        lambda a, b: (a @ b).redistribute(mesh, (Replicate(), Replicate())),
        xd, wd)
    return {"y": y.to_local().numpy(), "want": (x @ w).numpy(),
            "counts": stats.collective_counts,
            "bytes": stats.collective_bytes, "flops": stats.flops}


def _hint_cases(mesh):
    x = sharding.distribute(mesh, torch.arange(24.0).reshape(4, 6),
                            (None, None))
    odd = sharding.distribute(mesh, torch.arange(20.0).reshape(4, 5),
                              (None, None))
    heads = sharding.distribute(mesh, torch.ones(1, 2, 3, 4, 8),
                                (None, None, None, None, None))
    with use_mesh(mesh):
        y = hint(x, "data", "model")
        z = hint(odd, None, "model")           # 5 heads on 2: dropped
        a = hint(odd, "absent_axis", None)     # no such axis: dropped
        h = hint_heads(heads)                  # [D, B, S, H, hd], H = 4
    off = hint(x, "data", "model")             # no mesh active
    return {"values": bool(torch.equal(y.full_tensor(), x.full_tensor())),
            "placements": [repr(p) for p in y.placements],
            "dropped_same": z is odd and a is odd, "off_same": off is x,
            "heads_placements": [repr(p) for p in h.placements],
            "heads_values": bool(torch.equal(h.full_tensor(),
                                             heads.full_tensor()))}


def _serve_bits(mesh):
    """One rank: ``serve``'s greedy decoding driven through the steps over
    a mesh with hints equals ``serve`` without either, bit for bit, on
    the kernel route and on ``"auto"``."""
    from repro_torch.launch.serve import serve
    P, new = 24, 5
    cfg = get_config("gemma2-2b").reduced(max_seq_len=P + new + 8)
    out = {}
    for impl in ("pallas", "auto"):
        a = serve("gemma2-2b", device="cpu", impl=impl, keep_logits=True,
                  prompt_len=P, max_new_tokens=new)
        logits, tokens = _greedy(mesh, cfg, _params(cfg), a.prompts, new,
                                 impl)
        out[impl] = (bool(torch.equal(a.logits, logits))
                     and bool(torch.equal(a.tokens, tokens)))
    return out


def _cross_pod_cases(mesh):
    """All-reduces over each axis of a fake 2 × 2 × 2 ``(pod, data,
    model)`` mesh at a pod size of 4 ranks, and one loop of 5."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def reduce_over(axis, reps=1):
        i = mesh.mesh_dim_names.index(axis)
        pl = [Replicate()] * mesh.ndim
        pl[i] = Partial()
        x = DTensor.from_local(torch.ones(256, device="meta"), mesh, pl,
                               run_check=False)
        done = [Replicate()] * mesh.ndim

        def fn(t):
            for _ in range(reps):
                t = DTensor.from_local(t.redistribute(mesh, done).to_local(),
                                       mesh, pl, run_check=False)
            return t
        _, st, _ = op_analysis.analyze(fn, x, pod_size=4)
        return {"counts": st.collective_counts,
                "bytes": st.collective_bytes,
                "cross": st.cross_pod_bytes}

    out = {axis: reduce_over(axis) for axis in mesh.mesh_dim_names}
    out["loop5"] = reduce_over("model", reps=5)
    out["summary"] = op_analysis.summarize_collectives(
        lambda t: t.redistribute(mesh, [Replicate()] * 3),
        DTensor.from_local(torch.ones(256, device="meta"), mesh,
                           [Partial(), Replicate(), Replicate()],
                           run_check=False))
    out["groups"] = {axis: dist.get_process_group_ranks(
        mesh.get_group(axis)) for axis in mesh.mesh_dim_names}
    return out


def _dry_runs(mesh):
    dryrun.get_config = _dry_config          # this child only
    out = {}
    for shape in DRY_SHAPES:
        rec = dryrun.run_one("gemma2-2b", shape, mesh_override="2x4")
        out[shape] = {"per_device_bytes": rec.per_device_bytes,
                      "flops": rec.hlo_flops, "traffic": rec.hlo_traffic,
                      "counts": rec.collective_counts,
                      "roofline": rec.roofline, "mesh": rec.mesh,
                      "default_group": dist.get_backend()}
    return out


# (world, start, cases) of each child group
def _start_gloo(world):
    def start(out_dir, rank):
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"),
                                         world),
            rank=rank, world_size=world,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        return make_debug_mesh(world, device="cpu")
    return start


def _start_fake(shape, axes):
    def start(out_dir, rank):
        return make_auto_mesh(shape, axes, backend="fake")
    return start


CHILDREN = {
    "gloo2": (2, _start_gloo(2), {
        "forward": _forward_cases,
        "train": lambda mesh: {name: _train_run(make_auto_mesh(
            shape, ("data", "model"), device="cpu"))
            for name, shape in TRAIN_MESHES.items()},
        "zoo": lambda mesh: {name: _zoo_run(name, mesh) for name in ZOO},
        "row_parallel": _row_parallel,
        "hints": _hint_cases}),
    "gloo1": (1, _start_gloo(1), {"serve": _serve_bits}),
    "fake8": (1, _start_fake((2, 2, 2), ("pod", "data", "model")),
              {"cross_pod": _cross_pod_cases}),
    "dry": (1, _start_fake((2, 4), ("data", "model")), {"dry": _dry_runs}),
}


def _child(name, rank, out_dir):
    """One rank of a child group: start it, run its cases, save them."""
    world, start, cases = CHILDREN[name]
    torch.set_num_threads(1)
    try:
        mesh = start(out_dir, rank)
        got = {case: run(mesh) for case, run in cases.items()}
        got["_jax_free"] = not any(m == "jax" or m.startswith("jax.")
                                   for m in sys.modules)
        torch.save(got, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child group, started at once; ``{name: [rank results]}``, or
    the failure text of a group that failed or hung."""
    ctx = torch.multiprocessing.get_context("spawn")
    started = {}
    for name, (world, _, _) in CHILDREN.items():
        out = str(tmp_path_factory.mktemp(name))
        procs = [ctx.Process(target=_child, args=(name, r, out), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        started[name] = (out, procs)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    results = {}
    for name, (out, procs) in started.items():
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
            results[name] = (f"child {name}: ranks {hung} hung past "
                             f"{JOIN_TIMEOUT_S} s; exit codes "
                             f"{[p.exitcode for p in procs]}\n"
                             + "\n".join(errs))
        else:
            results[name] = [torch.load(os.path.join(out, f"rank{r}.pt"),
                                        weights_only=False)
                             for r in range(len(procs))]
    return results


def _ranks(children, name):
    got = children[name]
    if isinstance(got, str):
        pytest.fail(got)
    return got


# ============================================================ rule tables
def _port_specs(tree, spec_fn):
    return {path: spec_fn(path, leaf.dim()) for path, leaf in
            tree_items(tree)}


def _ref_specs(tree, pspecs):
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.launch import sharding as RS
    flat = jax.tree_util.tree_flatten_with_path(
        pspecs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = dict((RS._path_str(p), s) for p, s in
                  jax.tree_util.tree_flatten_with_path(tree)[0])
    out = {}
    for path, spec in flat:
        key = RS._path_str(path)
        assert len(spec) == len(shapes[key].shape) or not len(spec), key
        out[key] = tuple(spec)
    return out


def _ref_model(arch):
    from repro.configs import get_config as rget
    from repro.models import build_model as rbuild
    return rbuild(rget(arch).reduced())


def _port_meta(arch):
    model = build_model(get_config(arch).reduced())
    return model, dryrun.on_meta(model.init, torch.Generator())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """Every parameter leaf's spec equals the reference's, path for path
    (the reference's rule order, first match, right alignment)."""
    pytest.importorskip("jax")
    import jax

    from repro.launch import sharding as RS
    rp = jax.eval_shape(_ref_model(arch).init, jax.random.key(0))
    want = _ref_specs(rp, RS.param_pspecs(rp))
    _, pp = _port_meta(arch)
    assert _port_specs(pp, sharding.spec_for_path) == want
    # param_pspecs is the same table as a tree
    got = sharding.param_pspecs(pp)
    assert {p: got_leaf for p, got_leaf in _walk_specs(got)} == want


def _walk_specs(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk_specs(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _walk_specs(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adafactor_specs_match_reference(arch):
    """The adafactor state's specs (the factored ``vr`` / ``vc`` take their
    param's rule less the dim they average away) equal the reference's."""
    pytest.importorskip("jax")
    import jax

    from repro.launch import sharding as RS
    from repro.optim import adafactor as radafactor
    rp = jax.eval_shape(_ref_model(arch).init, jax.random.key(0))
    ro = jax.eval_shape(radafactor(1e-3).init, rp)
    want = _ref_specs(ro, RS.param_pspecs(ro))
    _, pp = _port_meta(arch)
    po = adafactor(1e-3).init(pp)
    assert _port_specs(po, sharding.spec_for_path) == want
    assert any(p.endswith("/vr") for p in want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    """Both cache modes (batch-sharded decode_32k, sequence-sharded
    long_500k) over each family's caches, with one and two batch axes."""
    pytest.importorskip("jax")
    import jax

    from repro.launch import sharding as RS
    rmodel = _ref_model(arch)
    pmodel, _ = _port_meta(arch)
    ex = rmodel.extra_input_shapes(2, 64) or None
    rc = jax.eval_shape(lambda: rmodel.caches_init(2, 64, extras_shape=ex))
    pc = pmodel.caches_init(2, 64, extras_shape=ex, device="meta")
    for mode in (True, False):
        for axes in (("data",), ("pod", "data")):
            want = _ref_specs(rc, RS.cache_pspecs(
                rc, batch_sharded=mode, batch_axes=axes))
            got = _port_specs(pc, lambda p, n: sharding.cache_pspec(
                p, n, batch_sharded=mode, batch_axes=axes))
            assert got == want, (mode, axes)


def test_spec_rules_basic():
    """The reference's own rule cases (tests/test_sharding_and_launch.py),
    and the port's leading fleet axis replicated by the right alignment."""
    assert sharding.spec_for_path("units/0/attn/wq/kernel", 3) == \
        (None, None, "model")
    assert sharding.spec_for_path("units/0/moe/experts/wi_gate", 4) == \
        (None, "model", None, "data")
    assert sharding.spec_for_path("embed/embedding", 2) == ("model", None)
    assert sharding.spec_for_path("units/0/attn_norm/scale", 2) == \
        (None, None)
    assert sharding.spec_for_path("v/units/0/mlp/wi_gate/kernel/vr", 2) == \
        (None, None)
    assert sharding.spec_for_path("v/units/0/mlp/wi_gate/kernel/vc", 2) == \
        (None, "model")
    # [D, U, d, H·hd] stacked over a fleet: D and U replicate
    assert sharding.spec_for_path("units/0/attn/wq/kernel", 4) == \
        (None, None, None, "model")
    assert sharding.cache_pspec("units/0/k", 5, batch_sharded=False) == \
        (None, None, "data", None, "model")


def test_placements_follow_specs():
    """A spec's placements over a mesh's named dims (no group needed)."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    got = sharding.placements_for(Mesh, (("pod", "data"), None, "model"))
    assert got == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements_for(Mesh, (None, None)) == (Replicate(),) * 3
    assert sharding.batch_spec(type("M", (), {"mesh_dim_names": (
        "pod", "data", "model")}), 3) == (("pod", "data"), None, None)


# ============================================================ hints, meshes
def test_hint_noop_without_mesh():
    x = torch.ones(4, 8)
    assert hint(x, "data", "model") is x
    h = torch.ones(2, 4, 8, 16)
    assert hint_heads(h) is h
    with use_mesh(object()):       # a mesh, but a plain tensor: nothing
        assert hint(x, "data", "model") is x
        assert hint_heads(h) is h


def test_use_mesh_nests_and_restores():
    assert active_mesh() is None
    with use_mesh("outer"):
        assert active_mesh() == "outer"
        with use_mesh("inner"):
            assert active_mesh() == "inner"
        assert active_mesh() == "outer"
    assert active_mesh() is None
    with pytest.raises(RuntimeError):
        with use_mesh("gone"):
            raise RuntimeError("exits restore the mesh too")
    assert active_mesh() is None


def test_hints_under_a_mesh(children):
    """Values kept, the spec's placements taken, a non-dividing or absent
    axis dropped (the same object back), no-ops off the mesh; a head hint
    aligns to the trailing dims of a ``[D, ...]`` activation."""
    for got in _ranks(children, "gloo2"):
        h = got["hints"]
        assert h["values"] and h["heads_values"]
        assert h["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert h["heads_placements"] == ["Shard(dim=1)", "Shard(dim=3)"]
        assert h["dropped_same"] and h["off_same"]


def test_batch_axes():
    for names, want in ((("data", "model"), ("data",)),
                        (("pod", "data", "model"), ("pod", "data"))):
        assert batch_axes(type("M", (), {"mesh_dim_names": names})) == want


# ============================================================ sharded runs
@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for name, (changes, impl) in FORWARDS.items():
        cfg = _gemma(**changes)
        logits, _ = build_model(cfg).apply(_params(cfg), _tokens(cfg),
                                           impl=impl)
        out[name] = logits.numpy()
    out["train"] = _train_run()
    out["zoo"] = {name: _zoo_run(name) for name in ZOO}
    return out


@pytest.mark.parametrize("case", list(FORWARDS))
def test_sharded_forward_matches(children, unsharded, case):
    """A reduced gemma2 forward on a 2-rank 1 × 2 mesh, params placed by
    the rule tables, within 1e-5 of the unsharded forward (float32), on
    both ranks.  ``kv1``: one kv head, which ``model`` does not divide
    (kv stays whole; the kernel route takes each rank's kv slice);
    ``h3``: three heads, which it divides neither (the merged head dim
    is gathered before the split)."""
    for got in _ranks(children, "gloo2"):
        np.testing.assert_allclose(got["forward"][case], unsharded[case],
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_sharded_train_step_matches(children, unsharded, mesh_name):
    """A reduced gemma2 train step (the tied table, two microbatches) on
    the 2-rank group, params placed by the rule tables: the loss, the grad
    norm and every updated param within 1e-5 of the unsharded step, on
    both ranks.  ``1x2`` splits the vocabulary (the target logit's masked
    sum), the tied table's two gradients and the heads' merge backward;
    ``2x1`` splits the batch, so each microbatch takes other rows than
    the unsharded cut and only the sum over microbatches agrees."""
    want = unsharded["train"]
    for got in _ranks(children, "gloo2"):
        got = got["train"][mesh_name]
        assert got["loss"] == pytest.approx(want["loss"], abs=TOL, rel=0)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], abs=TOL,
                                                 rel=0)
        assert got["params"].keys() == want["params"].keys()
        for path, value in want["params"].items():
            np.testing.assert_allclose(got["params"][path], value, atol=TOL,
                                       rtol=0, err_msg=path)


@pytest.mark.parametrize("name", ZOO)
def test_sharded_mla_moe_match(children, unsharded, name):
    """Reduced deepseek-v2 (MLA and MoE: the dispatch and combine on each
    rank's groups, the experts over ``model``) and minicpm3 (MLA) on the
    1 × 2 mesh, with and without the hints: the forward's logits and a
    prefill then one decode step's (the latent cache built and written on
    local shards) within 1e-5 of the unsharded run, on both ranks."""
    want = unsharded["zoo"][name]
    for got in _ranks(children, "gloo2"):
        for part in ("forward", "decode"):
            np.testing.assert_allclose(got["zoo"][name][part], want[part],
                                       atol=TOL, rtol=0, err_msg=part)


def test_row_parallel_collectives(children):
    """One all-reduce of the result's bytes, and the product's per-device
    FLOPs (half the contraction each)."""
    for got in _ranks(children, "gloo2"):
        r = got["row_parallel"]
        np.testing.assert_allclose(r["y"], r["want"], atol=TOL, rtol=0)
        assert r["counts"] == {"all-reduce": 1}
        assert r["bytes"] == 4 * 6 * 4
        assert r["flops"] == 2 * 4 * 4 * 6


def test_serve_over_mesh_bit_equal(children):
    """``serve``'s greedy loop driven through ``make_prefill_step`` and
    ``make_decode_step`` with ``shard_hints=True`` under a one-rank mesh
    gives the logits and tokens of ``serve()`` bit for bit (the card's
    phase 26 (c) at ``reduced()``)."""
    (got,) = _ranks(children, "gloo1")
    assert got["serve"] == {"pallas": True, "auto": True}


def test_children_import_no_jax(children):
    for name in CHILDREN:
        for got in _ranks(children, name):
            assert got["_jax_free"], name


# ============================================================ cross-pod
def test_is_cross_pod():
    """The reference's explicit-group cases (tests/test_hints_and_
    analysis.py) on global ranks; an unknown group counts as crossing."""
    assert not op_analysis.is_cross_pod([0, 1, 2], 256)
    assert not op_analysis.is_cross_pod([256, 257, 258], 256)
    assert op_analysis.is_cross_pod([0, 256], 256)
    assert op_analysis.is_cross_pod(None, 256)
    # the reference's iota cases: contiguous groups of 16 and of 256 stay
    # inside a pod; pairs (i, i + 256) cross
    assert not any(op_analysis.is_cross_pod(range(g * 16, g * 16 + 16), 256)
                   for g in range(32))
    assert not any(op_analysis.is_cross_pod(range(g * 256, g * 256 + 256),
                                            256) for g in range(2))
    assert all(op_analysis.is_cross_pod([i, i + 256], 256)
               for i in range(256))


def test_cross_pod_on_a_fake_mesh(children):
    """A fake 2 × 2 × 2 ``(pod, data, model)`` mesh with pods of 4 ranks:
    the pod axis's all-reduce crosses pods, the data and model axes' do
    not; every reduce is one all-reduce of its result's bytes."""
    (got,) = _ranks(children, "fake8")
    c = got["cross_pod"]
    assert c["groups"] == {"pod": [0, 4], "data": [0, 2], "model": [0, 1]}
    for axis in ("pod", "data", "model"):
        assert c[axis]["counts"] == {"all-reduce": 1}
        assert c[axis]["bytes"] == 256 * 4
    assert c["pod"]["cross"] == 256 * 4
    assert c["data"]["cross"] == 0 and c["model"]["cross"] == 0


def test_loop_collectives_counted_each(children):
    """The reference's loop case: five all-reduces of 1 KiB in a loop are
    five, 5 KiB (an eager trace runs the loop; nothing to multiply)."""
    (got,) = _ranks(children, "fake8")
    c = got["cross_pod"]
    assert c["loop5"]["counts"] == {"all-reduce": 5}
    assert c["loop5"]["bytes"] == 5 * 256 * 4
    assert c["summary"] == {"all-gather": 0, "all-reduce": 1,
                            "reduce-scatter": 0, "all-to-all": 0,
                            "collective-permute": 0}


# ============================================================ dry run
def _closed_form_gb(shape_name):
    """Rank 0's argument bytes on the 2 × 4 mesh: each leaf's bytes over
    the product of its sharded axes (ceil where a dim does not divide)."""
    sizes = {"data": 2, "model": 4}
    cfg = _dry_config("gemma2-2b")
    model = build_model(cfg)
    info = dryrun.SHAPES[shape_name]
    Sq, Bq = info["seq_len"], info["batch"]
    params = dryrun.on_meta(model.init, torch.Generator())
    leaves = [(spec, leaf) for spec, leaf in
              ((sharding.spec_for_path(p, x.dim()), x)
               for p, x in tree_items(params))]
    if info["kind"] == "train":
        opt = adamw(3e-4).init(params)
        leaves += [(sharding.spec_for_path(p, x.dim()), x)
                   for p, x in tree_items(opt)]
        tok = torch.zeros((Bq, Sq), dtype=torch.int32, device="meta")
        leaves += [(("data", None), tok)] * 2
    elif info["kind"] == "prefill":
        leaves.append((("data", None), torch.zeros(
            (Bq, Sq), dtype=torch.int32, device="meta")))
    else:
        caches = model.caches_init(Bq, Sq, device="meta")
        leaves += [(sharding.cache_pspec(p, x.dim(), batch_sharded=Bq > 1),
                    x) for p, x in tree_items(caches)]
        leaves.append((("data", None) if Bq > 1 else (None, None),
                       torch.zeros((Bq, 1), dtype=torch.int32,
                                   device="meta")))
    total = 0
    for spec, x in leaves:
        n = 1
        for dim, e in zip(x.shape, spec):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            split = int(np.prod([sizes[a] for a in axes])) if axes else 1
            n *= -(-dim // split)
        total += n * x.element_size()
    return total / 1e9


@pytest.mark.parametrize("shape_name", DRY_SHAPES)
def test_dry_run_records(children, shape_name):
    """``run_one("gemma2-2b", shape, mesh_override="2x4")`` (at
    ``reduced()``) on a fake group: a record with ``argument_gb``
    equal to the closed form, per-device FLOPs and traffic, a decode
    step's caches aliased to its arguments, and the roofline's terms."""
    (got,) = _ranks(children, "dry")
    rec = got["dry"][shape_name]
    mem = rec["per_device_bytes"]
    assert rec["default_group"] == "fake" and rec["mesh"] == "2x4"
    assert mem["argument_gb"] == pytest.approx(_closed_form_gb(shape_name),
                                               rel=1e-12)
    assert rec["flops"] > 0 and rec["traffic"] > 0
    assert mem["temp_gb"] > 0 and mem["output_gb"] > 0
    decode = dryrun.SHAPES[shape_name]["kind"] == "decode"
    assert (mem["alias_gb"] > 0) == decode
    roof = rec["roofline"]
    assert roof["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    assert roof["compute_s"] == rec["flops"] / 989e12


# ============================================================ analysis
@functools.lru_cache(maxsize=None)
def _ref_flops(remat: bool, train: bool):
    """``hlo_analysis`` FLOPs of the reference's compiled forward or
    train step (the forward does not depend on ``remat``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as rget
    from repro.launch import hlo_analysis
    from repro.launch.steps import make_train_step as rstep
    from repro.models import build_model as rbuild
    from repro.optim import adamw as radamw
    rm = rbuild(replace(rget("gemma2-2b").reduced(), remat=remat))
    rp = jax.eval_shape(rm.init, jax.random.key(0))
    tok = jnp.zeros((B, 32), jnp.int32)
    if not train:
        low = jax.jit(lambda p, t: rm.apply(p, t)[0]).lower(rp, tok)
    else:
        opt = radamw(3e-4)
        low = jax.jit(rstep(rm, opt)).lower(
            rp, jax.eval_shape(opt.init, rp),
            {"tokens": tok, "targets": tok}, jnp.zeros((), jnp.int32))
    return hlo_analysis.analyze(low.compile().as_text()).flops


@functools.lru_cache(maxsize=None)
def _port_flops():
    from repro_torch.launch.steps import make_train_step
    cfg = get_config("gemma2-2b").reduced()
    model = build_model(cfg)
    params = _params(cfg)
    tok = torch.zeros((B, 32), dtype=torch.int32)
    _, fwd, _ = op_analysis.analyze(lambda p, t: model.apply(p, t)[0],
                                    params, tok)
    opt = adamw(3e-4)
    _, train, _ = op_analysis.analyze(
        make_train_step(model, opt), params, opt.init(params),
        {"tokens": tok, "targets": tok}, 0)
    unembed = 2 * B * 32 * cfg.d_model * cfg.vocab_size
    return fwd.flops, train.flops, unembed


def test_flops_match_reference_exactly():
    """``op_analysis`` against ``hlo_analysis`` of the reference's compiled
    program, reduced gemma2 at batch 2 × 32: the forward and, with the
    reference's rematerialisation off, the train step agree EXACTLY
    (tolerance 0).  Op by op: the projections, the MLP, the two attention
    einsums and the tied unembedding are matmuls in both (2·M·N·K each);
    the backward's are the same products' transposes (the embedding
    table's gradient is a scatter-add in both, no FLOPs); norms, RoPE,
    softcaps, softmax and the optimiser do no matmul in either."""
    pytest.importorskip("jax")
    fwd, train, _ = _port_flops()
    assert fwd == _ref_flops(remat=True, train=False)
    assert train == _ref_flops(remat=False, train=True)


def test_flops_gap_is_the_references_remat():
    """With the reference's default ``remat=True`` its train step also
    recomputes the scanned units' forward in the backward; the port
    keeps activations (``remat`` unused).  The gap is exactly that
    forward: the port's forward less the unembedding."""
    pytest.importorskip("jax")
    fwd, train, unembed = _port_flops()
    assert _ref_flops(remat=True, train=True) - train == fwd - unembed


def test_memory_peak_tracks_live_temporaries():
    """``peak_temp_bytes``: the most bytes the traced ops held at once,
    the arguments' storage not counted, views free."""
    x = torch.ones(1000)                     # 4,000 bytes, an argument

    def fn(v):
        a = v * 2.0                          # +4,000
        b = a.view(10, 100)                  # a view: nothing new
        c = b + 1.0                          # +4,000: 8,000 live
        del a, b
        d = c * 3.0                          # c and d: 8,000 live
        del c
        e = d.reshape(-1)[:500] * 1.0        # d and e: 6,000
        return e
    out, st, _ = op_analysis.analyze(fn, x)
    assert st.peak_temp_bytes == 8000
    assert out.shape == (500,)
    assert (st.argument_bytes, st.output_bytes) == (4000, 2000)
    assert st.alias_bytes == 0
    # an in-place write into the argument: its output aliases it
    _, st, _ = op_analysis.analyze(lambda v: v.mul_(2.0), x)
    assert st.alias_bytes == 4000 and st.peak_temp_bytes == 0
