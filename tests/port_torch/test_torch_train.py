"""The training half of the port against the JAX package on the CPU:
``softmax_cross_entropy``, the train step (one batch and microbatched,
adamw and adafactor, the clip biting), the federated step and syncs,
``core.selection`` and the score step, the trainer ``launch.train`` and
its checkpoints, at ``reduced()`` in float32.

Weights come from the port's inits, crossed to the reference as numpy,
with the leaves that start at zero weight drawn from the seed (MLA's
norms), as ``test_torch_zoo.py`` does; the trainer's parity run starts
both packages from the reference's own inits (``init_params=``).
Tolerances: cross entropy 1e-6; train-step losses and ``grad_norm`` 1e-5
relative, params 1e-5 absolute over 3 steps; scores 1e-5; the trainer's
losses 1e-4 relative at every step, and its params 1e-4 absolute.  Every
reference program is compiled once (``_jit``, ``_jit_step``).
"""
import io
from contextlib import redirect_stdout
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data.lm import SyntheticLMStream as JStream  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.checkpoint import load_round  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.data.lm import SyntheticLMStream  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.tree import (tree_items, tree_leaves,  # noqa: E402
                              tree_map, tree_map_with_path)

jax.config.update("jax_platform_name", "cpu")

ZERO_START = ("q_norm", "kv_norm", "norm", "gate_attn", "gate_ffn")
ARCHS = ("gemma2-2b", "deepseek-v2-236b", "whisper-small")
B, S = 4, 32
CLIP = 0.05           # below every arch's first grad norm: the clip bites


@lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(partial(fn, **dict(static)))


def _jit(fn, **static):
    """``fn`` compiled with ``static`` bound, one program per module."""
    return _jitted(fn, tuple(sorted(static.items())))


def _jit_step(factory, **kw):
    """The step ``factory(**kw)`` builds, compiled."""
    return jax.jit(factory(**kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _leaves_close(port_tree, ref_tree, atol):
    ours, theirs = tree_leaves(port_tree), jax.tree_util.tree_leaves(ref_tree)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), atol=atol,
                                   rtol=0)


@lru_cache(maxsize=None)
def _models(arch):
    """(port model, reference model) of ``arch`` at ``reduced()``."""
    tcfg = tconfigs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    return build_model(tcfg), jbuild_model(jcfg)


def _params(arch, seed):
    """The port's init at ``seed`` as numpy leaves, the zero-start leaves
    drawn uniform in [0.5, 1.5]."""
    tmodel, _ = _models(arch)
    r = np.random.default_rng(seed + 1)

    def draw(path, a):
        a = a.detach().numpy()
        keys = path.split("/")
        if keys[-1] in ZERO_START or (keys[-1] == "scale"
                                      and keys[-2] in ZERO_START):
            return r.uniform(0.5, 1.5, size=a.shape).astype(a.dtype)
        return a

    return tree_map_with_path(draw, tmodel.init(
        torch.Generator().manual_seed(seed)))


def _batch(arch, seed, batch=B):
    """Numpy tokens, targets and (whisper) frames from ``seed``."""
    tmodel, _ = _models(arch)
    r = np.random.default_rng(seed)
    V = tmodel.cfg.vocab_size
    out = {"tokens": r.integers(0, V, (batch, S)).astype(np.int32),
           "targets": r.integers(0, V, (batch, S)).astype(np.int32)}
    for k, shp in tmodel.extra_input_shapes(batch, S).items():
        out[k] = r.standard_normal(shp).astype(np.float32)
    return out


def _both(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree), tree_map(_t, tree)


def _optimizers(arch):
    """(port, reference) optimiser: adafactor for deepseek-v2 as in the
    trainer, adamw otherwise; a constant lr, so every step moves."""
    if arch == "deepseek-v2-236b":
        return toptim.adafactor(1e-2), joptim.adafactor(1e-2)
    return toptim.adamw(1e-3), joptim.adamw(1e-3)


# ----------------------------------------------------------- cross entropy
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_cross_entropy_matches_reference(lowp, z_loss):
    """Both branches, with and without ``z_loss``; the ``lowp`` branch on
    bfloat16 logits."""
    r = np.random.default_rng(3)
    logits = (4 * r.standard_normal((3, 5, 300))).astype(np.float32)
    targets = r.integers(0, 300, (3, 5)).astype(np.int32)
    jl, tl = jnp.asarray(logits), _t(logits)
    if lowp:
        jl, tl = jl.astype(jnp.bfloat16), tl.to(torch.bfloat16)
    want = jsteps.softmax_cross_entropy(jl, jnp.asarray(targets),
                                        z_loss=z_loss, lowp=lowp)
    got = tsteps.softmax_cross_entropy(tl, _t(targets), z_loss=z_loss,
                                       lowp=lowp)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    """3 steps from the same weights on the same batches: losses,
    ``grad_norm`` and params (and the MoE aux of deepseek-v2 in its
    loss), the clip biting on every step."""
    tmodel, jmodel = _models(arch)
    topt, jopt = _optimizers(arch)
    jp, tp = _both(_params(arch, 0))
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = _jit_step(jsteps.make_train_step, model=jmodel,
                      optimizer=jopt, clip_norm=CLIP,
                      num_microbatches=microbatches)
    tstep = tsteps.make_train_step(tmodel, topt, clip_norm=CLIP,
                                   num_microbatches=microbatches)
    for i in range(3):
        jb, tb = _both(_batch(arch, 10 + i))
        jp, js, jm = jstep(jp, js, jb, jnp.int32(i))
        tp, ts, tm = tstep(tp, ts, tb, i)
        assert float(tm["grad_norm"]) > CLIP
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert tm[k].dtype == torch.float32
            if k == "aux" and float(jm[k]) == 0.0:
                assert float(tm[k]) == 0.0
                continue
            assert _rel(tm[k], jm[k]) <= 1e-5, (i, k, float(tm[k]),
                                                 float(jm[k]))
        _leaves_close(tp, jp, 1e-5)
    if arch == "deepseek-v2-236b" and microbatches == 1:
        assert float(tm["aux"]) > 0.0
    _leaves_close(ts, js, 1e-5)


class _Recording:
    """An optimiser that records the gradient dtypes it is handed."""

    def __init__(self, opt):
        self.opt, self.seen = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, step):
        self.seen.append(sorted({str(g.dtype).split(".")[-1]
                                 for g in tree_leaves(grads)}))
        return self.opt.update(grads, state, params, step)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_microbatched_gradients_reach_the_optimizer_in_float32(
        microbatches):
    """bfloat16 params (the published dtype): one batch hands the
    optimiser each gradient in its param's dtype, two microbatches
    float32 ones, in both packages (the reference's by ``jax.eval_shape``
    of its init and step)."""
    from dataclasses import replace
    arch = "gemma2-2b"
    tcfg = replace(tconfigs.get_config(arch).reduced(),
                   param_dtype=torch.bfloat16, dtype=torch.bfloat16)
    jcfg = replace(jconfigs.get_config(arch).reduced(),
                   param_dtype=jnp.bfloat16, dtype=jnp.bfloat16)
    tmodel, jmodel = build_model(tcfg), jbuild_model(jcfg)
    trec = _Recording(toptim.adamw(1e-3))
    jrec = _Recording(joptim.adamw(1e-3))
    tp = tmodel.init(torch.Generator().manual_seed(0))
    jp = jax.eval_shape(jmodel.init, jax.random.key(0))
    assert [str(a.dtype).split(".")[-1] for a in tree_leaves(tp)] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(jp)]
    jb, tb = _both(_batch(arch, 1))
    jax.eval_shape(jsteps.make_train_step(
        jmodel, jrec, num_microbatches=microbatches),
        jp, jax.eval_shape(jrec.init, jp), jb, jnp.int32(0))
    tp2, _, m = tsteps.make_train_step(
        tmodel, trec, num_microbatches=microbatches)(tp, trec.init(tp), tb,
                                                      0)
    assert trec.seen == jrec.seen
    if microbatches > 1:
        assert trec.seen == [["float32"]]
    else:
        assert "bfloat16" in trec.seen[0]
    assert [a.dtype for a in tree_leaves(tp2)] == \
        [a.dtype for a in tree_leaves(tp)]
    assert torch.isfinite(m["loss"])


# --------------------------------------------------------------- federated
def test_federated_step_keeps_each_groups_norm_and_optimizer():
    """Two groups of gemma2-2b on adafactor whose gradients differ in
    scale by about 75x (group 1's final norm at gain 0.01: its zero-
    centred scale set to -0.99), so the clip bites on group 0 alone:
    each group against the reference's vmapped step, the norms apart."""
    arch = "gemma2-2b"
    tmodel, jmodel = _models(arch)
    topt, jopt = toptim.adafactor(1e-2), joptim.adafactor(1e-2)
    p0 = _params(arch, 0)
    p1 = tree_map_with_path(
        lambda path, a: np.full_like(a, -0.99)
        if path.startswith("final_norm") else a, p0)
    stacked = tree_map(lambda a, b: np.stack([a, b]), p0, p1)
    jp, tp = _both(stacked)
    js = jax.vmap(jopt.init)(jp)
    ts = tree_map(lambda a, b: torch.stack([a, b]),
                  topt.init(tree_map(_t, p0)), topt.init(tree_map(_t, p1)))
    jstep = _jit_step(jsteps.make_federated_train_step, model=jmodel,
                      optimizer=jopt, clip_norm=CLIP)
    tstep = tsteps.make_federated_train_step(tmodel, topt, clip_norm=CLIP)
    for i in range(2):
        b = [_batch(arch, 20 + 2 * i), _batch(arch, 21 + 2 * i)]
        jb, tb = _both(tree_map(lambda a, c: np.stack([a, c]), *b))
        jp, js, jm = jstep(jp, js, jb, jnp.int32(i))
        tp, ts, tm = tstep(tp, ts, tb, i)
        norms = tm["grad_norm"].numpy()
        assert norms.shape == (2,) and norms[0] > 30 * norms[1] > 0, norms
        assert norms[0] > CLIP > norms[1]
        for k in ("loss", "grad_norm"):
            for g in range(2):
                assert _rel(tm[k][g], jm[k][g]) <= 1e-5, (i, k, g)
        _leaves_close(tp, jp, 1e-5)
    _leaves_close(ts, js, 1e-5)
    jsync = jsteps.federated_sync(jp)
    tsync = tsteps.federated_sync(tp)
    _leaves_close(tsync, jsync, 1e-5)


def _group_tree(G, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal((G,) + s).astype(np.float32)
    return {"embed": {"embedding": f(7, 3)},
            "units": [{"attn": {"q": f(2, 3, 4)}, "norm": {"scale": f(5)}}],
            "head": f(6)}


@pytest.mark.parametrize("G", [2, 3, 4])
def test_federated_sync_and_cascade_match_reference_exactly(G):
    """``federated_sync`` with and without an ``exclude`` predicate on
    the reference's path strings, ``federated_sync_weighted`` and
    ``cascade_shift``: equal bits; bfloat16 leaves cast back."""
    tree = _group_tree(G, G)
    jt, tt = _both(tree)
    excl = lambda path: "norm" in path or path.startswith("units/0/attn")
    w = np.arange(1, G + 1, dtype=np.float32)
    pairs = [(jsteps.federated_sync(jt), tsteps.federated_sync(tt)),
             (jsteps.federated_sync(jt, exclude=excl),
              tsteps.federated_sync(tt, exclude=excl)),
             (jsteps.federated_sync_weighted(jt, jnp.asarray(w)),
              tsteps.federated_sync_weighted(tt, _t(w))),
             (jsteps.cascade_shift(jt), tsteps.cascade_shift(tt))]
    for want, got in pairs:
        for (path, a), b in zip(tree_items(got),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=path)
    got = tsteps.federated_sync(tt, exclude=excl)
    assert torch.equal(got["units"][0]["norm"]["scale"],
                       tt["units"][0]["norm"]["scale"])
    synced = got["head"]
    assert all(torch.equal(synced[0], synced[g]) for g in range(G))
    bf = tsteps.federated_sync(tree_map(lambda a: a.to(torch.bfloat16), tt))
    jbf = jsteps.federated_sync(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), jt))
    for a, b in zip(tree_leaves(bf), jax.tree_util.tree_leaves(jbf)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


# --------------------------------------------------------------- selection
def _logprobs(shape, seed):
    r = np.random.default_rng(seed)
    x = 3 * r.standard_normal(shape).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


@pytest.mark.parametrize("reduce", ["mean", "max", "sum"])
@pytest.mark.parametrize("fn", ["entropy", "bald", "vr", "margin"])
def test_sequence_scores_match_reference(fn, reduce):
    lp = _logprobs((4, 3, 5, 97), 7)
    want = _jit(jsel.sequence_scores, acquisition_fn=fn,
                reduce=reduce)(jnp.asarray(lp))
    got = tsel.sequence_scores(_t(lp), acquisition_fn=fn, reduce=reduce)
    assert tuple(got.shape) == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_sequence_scores_reject_an_unknown_reduction():
    lp = _logprobs((2, 2, 3, 5), 1)
    with pytest.raises(ValueError):
        jsel.sequence_scores(jnp.asarray(lp), reduce="median")
    with pytest.raises(ValueError):
        tsel.sequence_scores(_t(lp), reduce="median")


def test_select_batch_takes_ties_in_the_reference_order():
    scores = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 0.5, 2.0], np.float32)
    r = np.random.default_rng(0)
    toks = r.integers(0, 50, (7, 6)).astype(np.int32)
    tgts = r.integers(0, 50, (7, 6)).astype(np.int32)
    for keep in (1, 3, 4, 7):
        jt, jg, ji = jsel.select_batch(jnp.asarray(scores),
                                       jnp.asarray(toks), jnp.asarray(tgts),
                                       keep)
        tt, tg, ti = tsel.select_batch(_t(scores), _t(toks), _t(tgts), keep)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert ti[:4].tolist() == [1, 2, 4, 3]


def test_router_entropy_scores_match_reference():
    x = 2 * np.random.default_rng(4).standard_normal((3, 9, 8))
    x = x.astype(np.float32)
    np.testing.assert_allclose(
        tsel.router_entropy_scores(_t(x)).numpy(),
        np.asarray(jsel.router_entropy_scores(jnp.asarray(x))), atol=1e-6,
        rtol=0)


def test_mc_sequence_logprobs_draws_from_one_generator():
    """T calls of ``apply_fn`` on the one generator, in turn: the same
    block as the T draws made by hand."""
    logits = lambda p, tok, g: torch.randn(tok.shape + (11,), generator=g)
    tok = torch.zeros((2, 3), dtype=torch.int32)
    got = tsel.mc_sequence_logprobs(logits, None, tok,
                                    torch.Generator().manual_seed(5), 3)
    g = torch.Generator().manual_seed(5)
    want = torch.stack([torch.log_softmax(logits(None, tok, g), dim=-1)
                        for _ in range(3)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["gemma2-2b", "whisper-small"])
def test_score_step_matches_reference_and_calls_k1_once(arch, monkeypatch):
    """T = 4 passes at dropout 0 (every published config), then entropy
    scores through the acquisition-score wrapper, reached once a call."""
    tmodel, jmodel = _models(arch)
    jp, tp = _both(_params(arch, 2))
    jb, tb = _both(_batch(arch, 3, batch=6))
    calls = []
    wrapped = tengine.acquisition_scores

    def counting(lp):
        calls.append(tuple(lp.shape))
        return wrapped(lp)

    monkeypatch.setattr(tengine, "acquisition_scores", counting)
    want = _jit_step(jsteps.make_score_step, model=jmodel, mc_samples=4)(
        jp, jb, jax.random.key(0))
    got = tsteps.make_score_step(tmodel, mc_samples=4)(
        tp, tb, torch.Generator().manual_seed(0))
    V = tmodel.cfg.vocab_size
    assert calls == [(4, 6 * S, V)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    _, _, idx = tsel.select_batch(got, tb["tokens"], tb["targets"], 3)
    _, _, jidx = jsel.select_batch(want, jb["tokens"], jb["targets"], 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ----------------------------------------------------- optimiser state trees
def test_optimizer_states_cross_from_the_reference():
    """adamw's ``{"m", "v"}`` and adafactor's ``{"v": {"vr", "vc" | "v"}}``
    of a reduced deepseek-v2 (stacked ``[U, ...]`` units among them):
    ``params_from_jax`` of the reference's state gives the port's init
    tree, the same paths, shapes, dtypes and values."""
    arch = "deepseek-v2-236b"
    jp, tp = _both(_params(arch, 0))
    for topt, jopt in ((toptim.adamw(1e-3), joptim.adamw(1e-3)),
                       (toptim.adafactor(1e-3), joptim.adafactor(1e-3))):
        crossed = interop.params_from_jax(_np(jopt.init(jp)), "cpu")
        mine = topt.init(tp)
        got, want = list(tree_items(crossed)), list(tree_items(mine))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            assert torch.equal(a, b), path
    kinds = {path.rsplit("/", 1)[-1] for path, _ in tree_items(mine)}
    assert kinds == {"vr", "vc", "v"}


# ------------------------------------------------------------------ trainer
def test_synthetic_stream_gives_the_reference_tokens():
    for seed in (0, 1):
        ours, theirs = SyntheticLMStream(vocab=512, seed=seed), \
            JStream(vocab=512, seed=seed)
        for s in (seed, 1000 + seed, 3000 + seed):
            for a, b in zip(ours.sample(4, 64, seed=s),
                            theirs.sample(4, 64, seed=s)):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _reference_loop(arch, steps, batch, seq, groups, sync_every, params_g):
    """``repro.launch.train.main``'s loop (no extras) from ``params_g``:
    every step's losses and the final params."""
    cfg = jconfigs.get_config(arch).reduced(max_seq_len=max(512, seq))
    model = jbuild_model(cfg)
    opt = joptim.adamw(joptim.warmup_cosine(3e-4, 10, max(100, steps)))
    step_fn = _jit_step(jsteps.make_train_step, model=model, optimizer=opt)
    streams = [JStream(vocab=cfg.vocab_size, seed=g) for g in range(groups)]
    opt_g = [opt.init(p) for p in params_g]
    losses = []
    for step in range(steps):
        row = []
        for g in range(groups):
            toks, tgt = streams[g].sample(batch, seq, seed=1000 * step + g)
            b = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
            params_g[g], opt_g[g], m = step_fn(params_g[g], opt_g[g], b,
                                               jnp.asarray(step))
            row.append(float(m["loss"]))
        if groups > 1 and (step + 1) % sync_every == 0:
            stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                             *params_g)
            synced = jsteps.federated_sync(stacked)
            params_g = [jax.tree_util.tree_map(lambda x: x[g], synced)
                        for g in range(groups)]
        losses.append(row)
    return losses, params_g


def test_trainer_follows_the_reference_loop():
    """``train("gemma2-2b", steps=4, groups=2, sync_every=2, seq=64)`` on
    the CPU from the reference's inits at seeds 0 and 1, against the
    reference loop: losses within 1e-4 relative at every step, params
    within 1e-4, and the groups bit-equal after the last step's sync."""
    arch, kw = "gemma2-2b", dict(steps=4, batch=4, seq=64, groups=2,
                                 sync_every=2)
    _, jmodel = _models(arch)
    jcfg = jconfigs.get_config(arch).reduced(max_seq_len=512)
    jinit = jax.jit(jbuild_model(jcfg).init)
    inits = [jinit(jax.random.key(g)) for g in range(2)]
    want_losses, want_params = _reference_loop(arch, params_g=list(inits),
                                               **kw)
    with redirect_stdout(io.StringIO()) as out:
        res = ttrain.train(arch, device="cpu",
                           init_params=[interop.params_from_jax(_np(p), "cpu")
                                        for p in inits], **kw)
    assert out.getvalue().count("[sync]") == 2
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res.params[0]), tree_leaves(res.params[1]), strict=True))
    assert len(res.losses) == 4 and len(res.step_s) == 4
    assert res.n_params == sum(int(np.prod(a.shape)) for a in
                               jax.tree_util.tree_leaves(inits[0]))
    assert res.peak_gib is None
    for step, (got, want) in enumerate(zip(res.losses, want_losses)):
        for g in range(2):
            assert _rel(got[g], want[g]) <= 1e-4, (step, g, got, want)
    for g in range(2):
        for (path, a), b in zip(tree_items(res.params[g]),
                                jax.tree_util.tree_leaves(want_params[g])):
            gap = np.abs(a.numpy() - np.asarray(b))
            assert gap.max() <= 1e-4, (path, gap.max())


def test_trainer_checkpoint_loads_back_equal(tmp_path):
    """``--ckpt-dir`` through ``main``: the round-10 file holds group 0's
    params bit for bit (``train`` with the same arguments, deterministic
    on the CPU) and the reference's metadata keys."""
    argv = ["--arch", "gemma2-2b", "--steps", "10", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    with redirect_stdout(io.StringIO()):
        assert ttrain.main(argv) == 0
        res = ttrain.train("gemma2-2b", steps=10, batch=2, seq=16,
                           device="cpu")
    saved = load_round(str(tmp_path), 10, device="cpu")
    assert saved["metadata"] == {"loss": res.losses[-1][0],
                                 "arch": "gemma2-2b"}
    got, want = tree_items(saved["fog_model"]), tree_items(res.params[0])
    for (pa, a), (pb, b) in zip(got, want, strict=True):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


def test_trainer_picks_the_reference_optimizer():
    params = {"w": torch.zeros(3, 2), "b": torch.zeros(2)}
    paths = lambda arch: [p for p, _ in tree_items(
        ttrain.make_optimizer(arch, 4).init(params))]
    for arch in ("deepseek-v2-236b", "arctic-480b"):
        assert paths(arch) == ["v/b/v", "v/w/vc", "v/w/vr"]
    assert paths("gemma2-2b") == ["m/b", "m/w", "v/b", "v/w"]
