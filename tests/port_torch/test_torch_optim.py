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
