"""LeNet, its layers, the initializers and Adam against the JAX package.

Weights start on the JAX side and are carried across with
``repro_torch.interop``; images come from numpy seeds.  Tolerances:
forwards 1e-5 absolute in float32 (the same im2col + GEMM arithmetic, in
another summation order); the 60-step Adam fit 1e-4 absolute on params
(Adam divides by sqrt(v), which amplifies float32 rounding in the
gradients of small-gradient weights over 60 steps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn.lenet import LeNet as JLeNet  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro.optim import optimizers as joptim  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.federated import FederatedALConfig, Trainer  # noqa: E402
from repro_torch.nn import init as tinit  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402
from repro_torch.nn.lenet import LeNet, LeNetConfig  # noqa: E402
from repro_torch.optim import optimizers as toptim  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
ATOL = 1e-5
# jitted reference forwards: one compile instead of op-by-op eager dispatch
_jinit = jax.jit(JLeNet.init, static_argnums=1)
_japply = jax.jit(JLeNet.apply, static_argnames=("cfg", "deterministic"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stack1(tree):
    return {k: _stack1(v) if isinstance(v, dict) else v[None]
            for k, v in tree.items()}


def _jparams(seed=0):
    return _np(_jinit(jax.random.key(seed), JLeNetConfig()))


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 28, 28, 1)).astype(np.float32)


def _close_trees(a, b, atol):
    fa = jax.tree_util.tree_leaves_with_path(a)
    for kp, leaf in fa:
        ref = b
        for k in kp:
            ref = ref[k.key]
        np.testing.assert_allclose(np.asarray(leaf), ref, atol=atol,
                                   err_msg=jax.tree_util.keystr(kp))


def test_param_count_and_layout_match_reference():
    p_j = _jparams()
    p_t = LeNet.init(torch.Generator().manual_seed(0), LeNetConfig())
    shapes_j = {jax.tree_util.keystr(kp): np.shape(v) for kp, v in
                jax.tree_util.tree_leaves_with_path(p_j)}
    assert sum(int(np.prod(s)) for s in shapes_j.values()) == 61706
    back = interop.params_to_jax(p_t)
    shapes_t = {jax.tree_util.keystr(kp): np.shape(v) for kp, v in
                jax.tree_util.tree_leaves_with_path(back)}
    assert shapes_t == shapes_j


@pytest.mark.parametrize("shape,in_axis", [((5, 5, 16, 120), -2),
                                           ((120, 84), -2)])
def test_he_normal_matches_reference_statistics(shape, in_axis):
    """Different bits (Philox vs threefry), same distribution: truncated
    at ±2 std and scaled by sqrt(2 / fan_in) / 0.8796; the sample std of
    ~10k draws is within 3% of the target."""
    x = tinit.he_normal(in_axis=in_axis)(shape, torch.Generator()
                                         .manual_seed(1)).numpy()
    fan_in = np.prod(shape) / shape[-1]
    std = np.sqrt(2.0 / fan_in)
    assert abs(x.std() / std - 1.0) < 0.03
    assert np.abs(x).max() <= 2.0 * std / 0.87962566103423978 + 1e-6


@pytest.mark.parametrize("padding,cin", [("SAME", 1), ("VALID", 6)])
def test_conv2d_matches_reference(padding, cin):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 14, 14, cin)).astype(np.float32)
    p = {"kernel": rng.normal(size=(5, 5, cin, 7)).astype(np.float32),
         "bias": rng.normal(size=(7,)).astype(np.float32)}
    want = jlayers.conv2d_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), padding=padding,
                                lowering="conv")
    got = tlayers.conv2d_apply(interop.params_from_jax(_stack1(p), "cpu"),
                               torch.from_numpy(x)[None], padding=padding)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL)


def test_avg_pool_matches_reference():
    x = np.random.default_rng(4).normal(size=(3, 11, 10, 4)).astype(np.float32)
    want = jlayers.avg_pool(jnp.asarray(x))
    got = tlayers.avg_pool(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_deterministic_forward_matches_reference():
    p_j = _jparams(1)
    x = _images(16, seed=1)
    want = _japply(jax.tree_util.tree_map(jnp.asarray, p_j), jnp.asarray(x))
    p_t = interop.params_from_jax(_stack1(p_j), "cpu")
    got = LeNet.apply(p_t, torch.from_numpy(x))           # shared images
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL)
    got_d = LeNet.apply(p_t, torch.from_numpy(x)[None])   # per-device images
    np.testing.assert_allclose(got_d[0].numpy(), np.asarray(want), atol=ATOL)


def test_stacked_forward_is_per_device_forward():
    ps = [_jparams(s) for s in (2, 3, 4)]
    x = _images(6, seed=2)
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), *ps)
    got = LeNet.apply(interop.params_from_jax(stacked, "cpu"),
                      torch.from_numpy(x))
    for d, p in enumerate(ps):
        want = _japply(jax.tree_util.tree_map(jnp.asarray, p),
                       jnp.asarray(x))
        np.testing.assert_allclose(got[d].numpy(), np.asarray(want),
                                   atol=ATOL)


def test_stochastic_forward_with_reference_keep_masks():
    """The JAX package's own dropout draws — split(rng, 3) at lenet.py,
    bernoulli(key, 1 - p, shape) at layers.py — injected as keep-masks."""
    cfg_j = JLeNetConfig()
    p_j = _jparams(5)
    x = _images(8, seed=5)
    rng = jax.random.key(9)
    want = _japply(jax.tree_util.tree_map(jnp.asarray, p_j),
                   jnp.asarray(x), cfg=cfg_j, rng=rng, deterministic=False)
    r1, r2, r3 = jax.random.split(rng, 3)
    shapes = [(8, 14, 14, 6), (8, 5, 5, 16), (8, 84)]
    rates = [cfg_j.p_conv, cfg_j.p_conv, cfg_j.p_fc]
    masks = [torch.from_numpy(np.array(
        jax.random.bernoulli(r, 1.0 - p, s)))[None]
        for r, p, s in zip((r1, r2, r3), rates, shapes)]
    got = LeNet.apply(interop.params_from_jax(_stack1(p_j), "cpu"),
                      torch.from_numpy(x), cfg=LeNetConfig(),
                      keep_masks=masks, deterministic=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL)


def test_dropout_generator_draws_keep_rate():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = tlayers.dropout(x, 0.25, generator=g)
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.01
    assert torch.allclose(y[y > 0], torch.tensor(1 / 0.75))
    assert tlayers.dropout(x, 0.0, generator=g) is x


@pytest.mark.parametrize("name,kw", [("adam", {"lr": 1e-2}),
                                     ("adam", {"lr": 1e-2,
                                               "weight_decay": 0.1}),
                                     ("sgd", {"lr": 0.1}),
                                     ("momentum", {"lr": 0.1,
                                                   "nesterov": True})])
def test_optimizer_update_matches_reference(name, kw):
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    opt_j = getattr(joptim, name)(**kw)
    opt_t = getattr(toptim, name)(**kw)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = opt_j.init(pj)
    pt = interop.params_from_jax(params, "cpu")
    st = opt_t.init(pt)
    for step in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        pj, sj = opt_j.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj,
                              jnp.int32(step))
        pt, st = opt_t.update(interop.params_from_jax(g, "cpu"), st, pt, step)
    _close_trees(_np(pj), interop.params_to_jax(pt), atol=1e-6)
    _close_trees(_np(sj), interop.params_to_jax(st), atol=1e-6)


def test_adam_fit_matches_reference():
    """60 steps (the fog node's initial_train_steps) of full-batch Adam at
    dropout 0, so no randomness enters: params within 1e-4."""
    cfg_j = JConfig(initial_train=20)
    mcfg_j = JLeNetConfig(p_conv=0.0, p_fc=0.0)
    tj = JTrainer(cfg_j, model_cfg=mcfg_j)
    p0 = _jparams(7)
    x = _images(20, seed=7)
    y = np.random.default_rng(7).integers(0, 10, 20).astype(np.int32)
    pj, _ = tj.fit(jax.tree_util.tree_map(jnp.asarray, p0), x, y, steps=60,
                   rng=jax.random.key(0))
    tt = Trainer(FederatedALConfig(initial_train=20),
                 model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0), device="cpu")
    pt, _ = tt.fit(interop.params_from_jax(p0, "cpu"), x, y, steps=60,
                   generator=torch.Generator().manual_seed(0))
    _close_trees(_np(pj), interop.params_to_jax(pt), atol=1e-4)
    assert tj.accuracy(pj, x, y) == tt.accuracy(pt, x, y)


def test_interop_round_trip_keeps_bits():
    p = _jparams(8)
    back = interop.params_to_jax(interop.params_from_jax(p, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert len(tree_leaves(interop.params_from_jax(p, "cpu"))) == 10
