"""``adamw`` and the learning-rate schedules of the port against the JAX
package on the CPU, and the numpy ``ActivePool`` byte for byte.

Tolerances: parameters 1e-6 absolute over 20 steps on the same gradients
(float32, the same elementwise formula); schedule values 1e-7 absolute;
pool windows and labeled arrays exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core.pool import ActivePool as JPool  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core.pool import ActivePool  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SCHEDULES = {
    "constant": dict(lr=3e-3),
    "cosine_decay": dict(lr=3e-3, decay_steps=100, alpha=0.1),
    "warmup_cosine": dict(lr=3e-3, warmup_steps=10, decay_steps=100),
    "warmup_linear": dict(lr=3e-3, warmup_steps=10, total_steps=100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """At step 0, inside the warm-up, mid-decay and past the end, as a
    Python int and as the int32 step the reference's training scan gives."""
    kw = SCHEDULES[name]
    js, ts = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    for step in (0, 5, 10, 55, 100, 150):
        for j_step, t_step in ((step, step),
                               (jnp.int32(step), torch.tensor(step))):
            got = ts(t_step)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert abs(float(got) - float(js(j_step))) <= 1e-7, (step, got)


@pytest.mark.parametrize("lr", ["constant", "warmup_cosine"])
def test_adamw_matches_reference_over_20_steps(lr):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 7), "b": (7,), "deep": {"k": (3, 3, 2)}}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(
        a.shape).astype(np.float32), p0) for _ in range(20)]
    sched = (1e-2 if lr == "constant"
             else dict(lr=1e-2, warmup_steps=5, decay_steps=20))
    jo = joptim.adamw(sched if lr == "constant"
                      else joptim.warmup_cosine(**sched))
    to = toptim.adamw(sched if lr == "constant"
                      else toptim.warmup_cosine(**sched))
    jupd = jax.jit(jo.update)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = jax.tree_util.tree_map(torch.from_numpy, p0)
    ts = to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jupd(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                      jnp.int32(i))
        tp, ts = to.update(jax.tree_util.tree_map(torch.from_numpy, g), ts,
                           tp, i)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(ts["v"]),
                    jax.tree_util.tree_leaves(js["v"]), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)


def test_adamw_defaults_match_reference():
    import inspect
    want = inspect.signature(joptim.adamw).parameters
    got = inspect.signature(toptim.adamw).parameters
    for k in ("b1", "b2", "eps", "weight_decay"):
        assert got[k].default == want[k].default, k


@pytest.mark.parametrize("initial", [None, [3, 9, 4]])
def test_active_pool_byte_equal(initial):
    pools = [cls.create(57, initial_labeled=initial, seed=101)
             for cls in (JPool, ActivePool)]
    for it in range(8):
        wins = [p.draw_window(20) for p in pools]
        np.testing.assert_array_equal(wins[0], wins[1])
        assert wins[0].dtype == wins[1].dtype
        picked = np.arange(min(5, len(wins[0])))[::-1] * (it % 2 + 1) % \
            max(1, len(wins[0]))
        news = [p.acquire(w, picked) for p, w in zip(pools, wins)]
        np.testing.assert_array_equal(news[0], news[1])
        np.testing.assert_array_equal(pools[0].labeled, pools[1].labeled)
        assert pools[0].labeled.dtype == pools[1].labeled.dtype
        np.testing.assert_array_equal(pools[0].unlabeled, pools[1].unlabeled)


# adafactor's tree: a matrix, a bias, a stacked [U, d] norm scale (factored,
# as in one decoder's tree) and a 3-axis kernel
ADAFACTOR_SHAPES = {"w": (5, 7), "b": (7,), "units": {"scale": (3, 6)},
                    "deep": {"k": (2, 3, 4)}}


def _tree_of(shapes, rng, dtype=np.float32):
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(dtype), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_matches_reference_over_10_steps(dtype):
    """Params and the factored state over 10 steps on the same gradients:
    float32 within 1e-6; bfloat16 params and gradients within one
    bfloat16 rounding of the params (1e-2 at these magnitudes), the
    float32 state within 1e-5 relative."""
    rng = np.random.default_rng(1)
    p0 = _tree_of(ADAFACTOR_SHAPES, rng)
    grads = [_tree_of(ADAFACTOR_SHAPES, rng) for _ in range(10)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    sched = dict(lr=1e-2, warmup_steps=3, decay_steps=10)
    jo = joptim.adafactor(joptim.warmup_cosine(**sched))
    to = toptim.adafactor(toptim.warmup_cosine(**sched))
    jupd = jax.jit(jo.update)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(jdt), p0)
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(tdt), p0)
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        jp, js = jupd(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jdt), g), js, jp, jnp.int32(i))
        tp, ts = to.update(jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), g), ts, tp, i)
    patol = 1e-6 if dtype == "float32" else 1e-2
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp), strict=True):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=patol, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js), strict=True):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-30)


def test_adafactor_state_tree_matches_reference():
    """``{"v": tree}``: ``{"vr", "vc"}`` for every leaf of two or more
    axes (the stacked ``[U, d]`` scale among them), ``{"v"}`` for the
    bias; the same paths, shapes and float32 in both, bfloat16 params
    too."""
    p0 = _tree_of(ADAFACTOR_SHAPES, np.random.default_rng(2))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        js = joptim.adafactor(1e-3).init(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).astype(jdt), p0))
        ts = toptim.adafactor(1e-3).init(jax.tree_util.tree_map(
            lambda a: torch.from_numpy(a).to(tdt), p0))
        jflat = jax.tree_util.tree_flatten_with_path(js)[0]
        tflat = jax.tree_util.tree_flatten_with_path(ts)[0]
        assert [jax.tree_util.keystr(k) for k, _ in tflat] == \
            [jax.tree_util.keystr(k) for k, _ in jflat]
        for (_, a), (_, b) in zip(tflat, jflat):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            assert b.dtype == jnp.float32 and not a.any()
    assert set(ts["v"]["units"]["scale"]) == {"vr", "vc"}
    assert tuple(ts["v"]["units"]["scale"]["vr"].shape) == (3,)
    assert set(ts["v"]["b"]) == {"v"}


@pytest.mark.parametrize("max_norm", [1e3, 0.5])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Below the threshold the gradients pass unchanged; above it they
    are scaled to the threshold; a bfloat16 leaf keeps its dtype."""
    p0 = _tree_of(ADAFACTOR_SHAPES, np.random.default_rng(3))
    jg = jax.tree_util.tree_map(jnp.asarray, p0)
    tg = jax.tree_util.tree_map(torch.from_numpy, p0)
    jg["b"], tg["b"] = jg["b"].astype(jnp.bfloat16), tg["b"].to(
        torch.bfloat16)
    want_norm = float(joptim.global_norm(jg))
    assert abs(float(toptim.global_norm(tg)) - want_norm) <= 1e-6 * want_norm
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = toptim.clip_by_global_norm(tg, max_norm)
    assert tn.dtype == torch.float32 and tn.dim() == 0
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for a, b, c in zip(jax.tree_util.tree_leaves(tc),
                       jax.tree_util.tree_leaves(jc),
                       jax.tree_util.tree_leaves(tg), strict=True):
        assert a.dtype == c.dtype
        if max_norm > want_norm:
            assert torch.equal(a, c)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=1e-6 if a.dtype == torch.float32
                                   else 1e-2, rtol=0)
    if max_norm < want_norm:
        assert abs(float(toptim.global_norm(tc)) - max_norm) <= 1e-2
