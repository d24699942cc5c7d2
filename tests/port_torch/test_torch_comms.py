"""The comms module of the port against the JAX package on the CPU: the
byte ledger, the codecs, and fused rounds with compressed uploads.

Tolerances: the byte ledger exact (integer arithmetic over shapes); int8
codes, scales, top-k masks and the bfloat16 wire bit-equal given the same
inputs (the int8 rounding uniforms are drawn by JAX and handed to the
port, since the two generators differ); fused top-k and bfloat16 rounds
in the RNG-free configuration (dropout 0, the window covering the pool)
parameters and error-feedback residuals 1e-4 absolute, the Eq. 1 weights
1e-6 and labeled sets exact, as in ``test_torch_slice.py``.  A residual
holds a device's unsent parameter delta, so it takes the parameters' bar
and not a tighter one.  Beyond it lie at most ``comms.SPLIT_SHARE`` of a
leaf's residuals, each within ``INPUT_EPS`` (Adam turns the two packages'
different conv gradient sums into delta differences of up to 1.3e-4 at
entries whose gradient is near 0, which the Eq. 1 average hides from the
parameters) or a codec split bounded in place and size
(``comms.codec_splits``: a top-k boundary or a bfloat16 rounding tie
that the two codec inputs straddle).  Int8 fused rounds cannot match
draw for draw, so they are held to the reference's invariants
(``tests/test_comms.py``): the round trip within one scale, a 1.0 top-k
fraction equal to no codec, and error feedback updated only on uploads.
"""
import math
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import comms as jcomms  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import FederatedALConfig as JConfig  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.model_adapter import DecoderLMAdapter as JDecoder  # noqa: E402
from repro.data.digits import make_digit_dataset as j_digits  # noqa: E402
from repro.data.federated_split import federated_split as j_split  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.nn.lenet import LeNetConfig as JLeNetConfig  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import comms  # noqa: E402
from repro_torch.core import counters  # noqa: E402
from repro_torch.core.comms import CommsConfig  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.federated import (FederatedALConfig, Trainer,  # noqa: E402
                                        run_experiment, run_federated_rounds)
from repro_torch.models.config import lm_100m  # noqa: E402
from repro_torch.nn.lenet import LeNet, LeNetConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# RNG-free fleet: the window covers every shard of 20 samples; one
# acquisition a round keeps the reference's compiled program short
SLICE = dict(initial_train=6, acquisitions=1, k_per_acquisition=3,
             pool_window=64, mc_samples=2, train_steps_per_acq=3,
             initial_train_steps=4)
ROUNDS = 2

CONFIGS = [None, CommsConfig(), CommsConfig(compression="int8"),
           CommsConfig(compression="topk"),
           CommsConfig(compression="topk", topk_fraction=0.5,
                       compute_dtype="bfloat16"),
           CommsConfig(compute_dtype="bfloat16", upload_samples=True)]


def _jcfg(cfg):
    return None if cfg is None else jcomms.CommsConfig(
        compression=cfg.compression, topk_fraction=cfg.topk_fraction,
        error_feedback=cfg.error_feedback,
        upload_samples=cfg.upload_samples, compute_dtype=cfg.compute_dtype)


def _lenet():
    return LeNet.init(torch.Generator().manual_seed(0), LeNetConfig())


def _lm_100m_shapes():
    """lm-100m's float32 parameter shapes (the port's config, built on the
    JAX side), without allocating them: JAX ShapeDtypeStructs and torch
    meta tensors."""
    t_cfg = lm_100m()
    j_cfg = JModelConfig(**{f: getattr(t_cfg, f)
                            for f in JModelConfig.__dataclass_fields__
                            if f not in ("param_dtype", "dtype")},
                         param_dtype=jnp.float32, dtype=jnp.float32)
    j = jax.eval_shape(JDecoder(j_cfg).init, jax.random.key(0))
    t = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"), j)
    return j, t


@pytest.mark.parametrize("tree", ["lenet", "lm-100m"])
def test_byte_ledger_matches_reference(tree):
    if tree == "lenet":
        t = _lenet()
        j = interop.params_to_jax(t)
    else:
        j, t = _lm_100m_shapes()
    assert comms.param_bytes(t) == jcomms.param_bytes(j)
    mask = np.array([[1, 1, 0], [0, 1, 1]], np.float32)
    n_lab = np.array([[5, 6, 5], [9, 12, 10]])
    for cfg in CONFIGS:
        jc = _jcfg(cfg)
        assert comms.upload_bytes(cfg, t) == jcomms.upload_bytes(jc, j)
        assert comms.compression_ratio(cfg, t) == \
            jcomms.compression_ratio(jc, j)
        kw = dict(agg_accs=[0.25, 0.5], n_labeled=n_lab,
                  image_shape=(28, 28, 1))
        assert comms.comms_report(cfg, t, mask, **kw) == \
            jcomms.comms_report(jc, j, mask, **kw)
        assert comms.single_round_report(cfg, t, [0, 2], 3, new_labels=17,
                                         image_shape=(28, 28, 1)) == \
            jcomms.single_round_report(jc, j, [0, 2], 3, new_labels=17,
                                       image_shape=(28, 28, 1))


def test_config_validation_and_unported_tiers():
    for bad in (dict(compression="fp4"), dict(compute_dtype="fp16"),
                dict(fog_compression="x"), dict(topk_fraction=0.0),
                dict(topk_fraction=1.5)):
        with pytest.raises(ValueError):
            CommsConfig(**bad)
    # the per-tier ledger of a fog topology (core.topology)
    from repro.core.topology import uniform_topology as j_uniform
    from repro_torch.core.topology import uniform_topology
    cfg = CommsConfig(compression="int8", fog_compression="topk")
    mask = np.ones((4, 2), np.float32)
    got = comms.tier_report(cfg, _lenet(), mask,
                            uniform_topology(2, 2, local_steps=2))
    assert got == jcomms.tier_report(
        jcomms.CommsConfig(**vars(cfg)), interop.params_to_jax(_lenet()),
        mask, j_uniform(2, 2, local_steps=2))
    assert got["sync_rounds"] == 2 and got["fog_compression"] == "topk"
    assert comms.topk_k(10, 1e-9) == 1 and comms.topk_k(10, 1.0) == 10
    assert comms.index_bytes(2**16 - 1) == 2 and comms.index_bytes(2**16) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantizer_bit_equal_with_injected_uniforms(dtype):
    """The port's codes and scale equal the reference's when it is handed
    the uniforms the reference's ``bernoulli`` draws."""
    key = jax.random.key(0)
    quantize = jax.jit(jcomms.quantize_int8_stochastic)
    for i, sigma in enumerate((1e-4, 1.0, 37.5)):
        shape = (257, 33)
        kx, kq = jax.random.split(jax.random.fold_in(key, i))
        x = (sigma * jax.random.normal(kx, shape)).astype(dtype)
        qj, sj = quantize(kq, x)
        u = np.asarray(jax.random.uniform(kq, shape))
        xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
        if dtype == "bfloat16":
            xt = xt.to(torch.bfloat16)
        qt, st = comms.quantize_int8_stochastic(xt, torch.from_numpy(u))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.item() == float(sj)
        np.testing.assert_array_equal(
            comms.dequantize_int8(qt, st).numpy(),
            np.asarray(jcomms.dequantize_int8(qj, sj)))


def test_int8_roundtrip_within_one_scale():
    gen = torch.Generator().manual_seed(0)
    for sigma in (1e-4, 1.0, 37.5):
        x = sigma * torch.randn((257, 33), generator=gen)
        q, s = comms.quantize_int8_stochastic(
            x, torch.rand(x.shape, generator=gen))
        assert s.item() == pytest.approx(x.abs().max().item() / 127,
                                         rel=1e-6)
        err = x - comms.dequantize_int8(q, s)
        assert err.abs().max().item() <= s.item() * (1 + 1e-5)
        assert abs(err.mean().item()) < s.item() * 0.05


def test_int8_degenerate_and_nonfinite_leaves():
    """The reference's edge cases (``tests/test_comms.py:351-380``): an
    all-zero leaf, a single value on the clip rail, bfloat16 input, and a
    NaN scale for any non-finite value."""
    u = lambda shape: torch.full(shape, 0.5)
    quantize = jax.jit(jcomms.quantize_int8_stochastic)
    q, s = comms.quantize_int8_stochastic(torch.zeros(5, 7), u((5, 7)))
    assert math.isfinite(s.item()) and s.item() > 0
    assert torch.equal(comms.dequantize_int8(q, s), torch.zeros(5, 7))
    x1 = torch.tensor([-3.25])
    q1, s1 = comms.quantize_int8_stochastic(x1, u((1,)))
    assert int(q1[0]) == -127
    torch.testing.assert_close(comms.dequantize_int8(q1, s1), x1, rtol=1e-6,
                               atol=0)
    qb, sb = comms.quantize_int8_stochastic(
        torch.tensor([1.0, -0.5, 0.25], dtype=torch.bfloat16), u((3,)))
    assert qb.dtype == torch.int8
    assert sb.item() == pytest.approx(1.0 / 127.0, rel=1e-6)
    for bad in (math.inf, -math.inf, math.nan):
        x = torch.tensor([[1.0, bad], [2.0, 3.0]])
        q, s = comms.quantize_int8_stochastic(x, u((2, 2)))
        assert not math.isfinite(s.item())
        assert not torch.isfinite(comms.dequantize_int8(q, s)).any()
        qj, sj = quantize(jax.random.key(4), jnp.asarray(x.numpy()))
        assert np.isnan(float(sj))
        # the finite entries' codes agree (the draw only touches
        # fractional parts; these values sit on integers of the scale)
        np.testing.assert_array_equal(q.numpy()[1], np.asarray(qj)[1])


def test_topk_mask_ties_by_position():
    """Many tied magnitudes: the kept ties are the lowest flat positions,
    as ``lax.top_k`` keeps them, and the budget is exact."""
    rng = np.random.default_rng(0)
    x = rng.choice([-3.0, -1.0, 0.0, 1.0, 2.0, 3.0], size=(31, 17)).astype(
        np.float32)
    for frac in (0.01, 0.07, 0.3, 0.5, 1.0):
        k = comms.topk_k(x.size, frac)
        got = comms.topk_mask(torch.from_numpy(x), k).numpy()
        want = np.asarray(jax.jit(jcomms.topk_mask, static_argnums=1)(
            jnp.asarray(x), k))
        np.testing.assert_array_equal(got, want)
        assert int(got.sum()) == k
    zeros = comms.topk_mask(torch.zeros(4, 5), 3).reshape(-1)
    assert zeros.tolist() == [1.0] * 3 + [0.0] * 17
    rows = comms.topk_mask_rows(torch.from_numpy(np.stack([x, -x])), 40)
    for r in range(2):
        np.testing.assert_array_equal(
            rows[r].numpy(), comms.topk_mask(torch.from_numpy(x), 40).numpy())


def test_wire_cast_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    cfg = CommsConfig(compute_dtype="bfloat16")
    got = comms.wire_cast(cfg, torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(lambda a: jcomms.wire_cast(_jcfg(cfg), a))(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert comms.wire_cast(CommsConfig(), torch.from_numpy(x)) is not None


@pytest.mark.parametrize("codec", [
    dict(), dict(compression="topk", topk_fraction=0.1),
    dict(compute_dtype="bfloat16"),
    dict(compression="topk", topk_fraction=0.3, compute_dtype="bfloat16"),
    dict(compression="int8")])
def test_compress_tree_matches_reference(codec):
    """One device's tree through ``compress_tree``: bit-equal with the
    reference for the deterministic codecs; int8 (other draws) within one
    scale of the input, leaf by leaf, in float32."""
    tree = _lenet()
    got = comms.compress_tree(CommsConfig(**codec), tree,
                              torch.Generator().manual_seed(0))
    if not codec:
        assert got is tree
        return
    if codec.get("compression") == "int8":
        for a, b in zip(tree_leaves(got), tree_leaves(tree)):
            assert a.dtype == torch.float32
            scale = b.abs().max() / 127
            assert (a - b).abs().max() <= scale * (1 + 1e-5)
        return
    cc = jcomms.CommsConfig(**codec)
    want = jax.jit(lambda t: jcomms.compress_tree(cc, jax.random.key(0), t))(
        interop.params_to_jax(tree))
    for a, b in zip(tree_leaves(interop.params_to_jax(got)),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_codec_splits_are_bounded_in_place_and_size():
    """``codec_splits`` forgives a residual gap only at a top-k boundary
    or a bfloat16 rounding tie of the codec input, and only up to the
    codec's jump there plus the input difference."""
    eps = 1e-6
    topk = CommsConfig(compression="topk", topk_fraction=0.25)
    x = torch.tensor([[0.5, -0.3, 0.2, 0.1, 0.05, 0.01, 0.0, 0.002]])
    # k = 2: the k-th magnitude is 0.3; entry 1 sent on one side only
    a = x * (x.abs() < 0.29)
    b = a.clone()
    b[0, 1] = x[0, 1]
    assert comms.codec_splits(topk, x, a, b, eps).tolist() == [
        [False, True] + [False] * 6]
    b[0, 1] = 2 * x[0, 1]                            # beyond the jump
    assert not comms.codec_splits(topk, x, a, b, eps).any()
    b = a.clone()
    b[0, 2] = 0.0                                    # not at the boundary
    assert not comms.codec_splits(topk, x, a, b, eps)[0, 2]
    assert comms.residual_gaps(topk, x, a, b, tol=1e-5, eps=eps)[3] == 1

    wire = CommsConfig(compute_dtype="bfloat16")
    step = 2.0 ** -7                                 # one bf16 step at 1.x
    tie = torch.tensor([[1.0 + step / 2, 1.0 + step / 4]])
    a = torch.tensor([[step / 2, step / 4]])         # rounded down
    b = torch.tensor([[-step / 2, step / 4]])        # rounded up at the tie
    assert comms.codec_splits(wire, tie, a, b, eps).tolist() == [
        [True, False]]
    b[0, 0] = -1.5 * step                            # two steps apart
    assert not comms.codec_splits(wire, tie, a, b, eps).any()
    b[0, 1] = -0.75 * step                           # off any tie
    assert not comms.codec_splits(wire, tie, a, b, eps)[0, 1]
    assert not comms.codec_splits(CommsConfig(compression="int8"), tie, a,
                                  b, eps).any()
    assert comms.split_budget(30) == 1 and comms.split_budget(144000) == 1440


def _fleet(D):
    full, test = j_digits(60, seed=0), j_digits(40, seed=5)
    return j_split(full, D, seed=0), j_digits(6, seed=11), test


def _port_engine(D, shards, seed_set, test):
    cfg = FederatedALConfig(num_devices=D, **SLICE)
    trainer = Trainer(cfg, model_cfg=LeNetConfig(p_conv=0.0, p_fc=0.0),
                      device="cpu")
    return EdgeEngine(trainer, cfg, shards, seed_set, test,
                      total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                      device="cpu")


@pytest.mark.parametrize("codec", [
    dict(compression="topk", topk_fraction=0.05),
    dict(compute_dtype="bfloat16"),
    dict(compression="topk", topk_fraction=0.3, compute_dtype="bfloat16")])
def test_delta_step_matches_reference_on_the_same_inputs(codec):
    """The comms step of a fused round alone, on stacked LeNet-shaped
    inputs with a device that skips the round: the wire values, the
    error-feedback residuals (frozen for the skipping device) and the fog
    model ``params_prev[0] + Σ w · sent`` against the reference's codec
    (``compress_tree`` over each device) and its Eq. 1 reduce.  Residuals
    bit-equal; the fog model 1e-6 (the reduce's sum order)."""
    from repro.core.aggregation import aggregate_stacked as j_aggregate
    from repro_torch.core.engine import _delta_aggregate
    D = 3
    gen = torch.Generator().manual_seed(2)
    tmap = jax.tree_util.tree_map
    shapes = tmap(lambda a: (D,) + tuple(a.shape), interop.params_to_jax(
        _lenet()))
    draw = lambda scale: tmap(
        lambda s: scale * torch.randn(s, generator=gen), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    prev = tmap(lambda a: a[:1].expand_as(a).clone(), draw(0.1))
    params = tmap(lambda p, d: p + d, prev, draw(1e-2))
    residual = draw(1e-3)
    w = torch.tensor([0.5, 0.0, 0.5])
    upload = torch.tensor([1.0, 0.0, 1.0])
    res_t = tmap(torch.clone, residual)
    fog_t = _delta_aggregate(CommsConfig(**codec), params, prev, res_t, w,
                             upload, frozenset(), None)

    cc = jcomms.CommsConfig(**codec)

    @jax.jit
    def reference(jp, jprev, jres, w, up):
        to_send = tmap(lambda p, q, r: p - q + r, jp, jprev, jres)
        sent = jax.vmap(lambda d: jcomms.compress_tree(
            cc, jax.random.key(0), d))(to_send)
        res = tmap(lambda a, s, r: jnp.where(
            up.reshape((-1,) + (1,) * (a.ndim - 1)) > 0, a - s, r),
            to_send, sent, jres)
        return res, tmap(lambda q, a: q[0] + a, jprev, j_aggregate(sent, w))

    np_ = interop.params_to_jax
    res_j, fog_j = reference(np_(params), np_(prev), np_(residual),
                             w.numpy(), upload.numpy())
    for a, b in zip(tree_leaves(np_(res_t)), jax.tree_util.tree_leaves(
            res_j), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tree_leaves(np_(fog_t)), jax.tree_util.tree_leaves(
            fog_j), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    for a, b in zip(tree_leaves(res_t), tree_leaves(residual)):
        assert torch.equal(a[1], b[1])                    # skipped: frozen


# the most the two packages' codec inputs (a device's delta plus its
# residual) differ by: Adam turns the packages' different conv gradient
# sums into delta differences of up to 1.3e-4 at entries whose gradient is
# near 0
INPUT_EPS = 2e-4


def _keep_codec_inputs(monkeypatch):
    """A list that receives a copy of every stacked leaf the port's engine
    hands its codec, in the tree's leaf order."""
    seen = []
    encode = comms.encode_rows

    def keep(cfg, x, generator=None):
        seen.append(x.detach().clone())
        return encode(cfg, x, generator)

    monkeypatch.setattr(comms, "encode_rows", keep)
    return seen


def _check_round(cfg, inputs, recs_t, recs_j, st_t, st_j, fin_t, fin_j):
    """One fused round, port against reference: labeled counts exact,
    weights 1e-6, the fog model and the residuals 1e-4.  Residual entries
    beyond 1e-4 may be at most ``comms.SPLIT_SHARE`` of a leaf, each a
    codec split (``comms.codec_splits``: at a top-k boundary or a bfloat16
    rounding tie of the port's codec input, by at most the codec's jump
    there) or within ``INPUT_EPS``; the fog model may differ beyond 1e-4
    only where a device split.  Returns (splits, residual entries beyond
    1e-4, the largest residual gap)."""
    np.testing.assert_array_equal(recs_t["n_labeled"].numpy(),
                                  np.asarray(recs_j["n_labeled"]))
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    as_t = lambda t: [torch.from_numpy(np.array(a))
                      for a in jax.tree_util.tree_leaves(t)]
    splits = far_total = worst = 0
    for x, rt, rj, ft, fj in zip(inputs, tree_leaves(st_t.residual),
                                 as_t(st_j.residual), tree_leaves(fin_t),
                                 as_t(fin_j), strict=True):
        gap, far, split, bad = comms.residual_gaps(cfg, x, rt, rj, tol=1e-4,
                                                   eps=INPUT_EPS)
        assert bad == 0 and far <= comms.split_budget(x.numel()), (far, bad)
        at = comms.codec_splits(cfg, x, rt, rj, INPUT_EPS).any(dim=0)
        off = (ft - fj).abs() > 1e-4
        assert not (off & ~at).any(), "fog model differs"
        splits += split
        far_total += far
        worst = max(worst, gap)
    return splits, far_total, worst


@pytest.mark.parametrize("codec", [
    dict(compression="topk", topk_fraction=0.05),
    dict(compute_dtype="bfloat16")])
def test_fused_compressed_rounds_match_reference(codec, monkeypatch):
    """Two rounds with error feedback.  Round 2 of each side starts from
    the reference's round-1 state (parameters, pools, residuals), so a
    boundary split of round 1 does not carry into round 2's check."""
    D = 3
    shards, seed_set, test = _fleet(D)
    cfg_j = JConfig(num_devices=D, scorer="jnp", **SLICE)
    tr_j = JTrainer(cfg_j, model_cfg=JLeNetConfig(p_conv=0.0, p_fc=0.0))
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=SLICE["acquisitions"] * ROUNDS,
                    scorer="jnp", aggregate_impl="ref", unroll=False)
    eng_t = _port_engine(D, shards, seed_set, test)
    p0 = eng_t.trainer.init_params(torch.Generator().manual_seed(1))
    st_j = eng_j.init_state(interop.params_to_jax(p0))
    st_t = eng_t.init_state(p0)
    inputs = _keep_codec_inputs(monkeypatch)
    cc = CommsConfig(**codec)
    for t in range(ROUNDS):
        st_j, recs_j, fin_j = eng_j.run_rounds_fused(
            st_j, 1, comms=jcomms.CommsConfig(**codec), start_round=t)
        inputs.clear()
        st_t, recs_t, fin_t = eng_t.run_rounds_fused(
            st_t, 1, comms=cc, start_round=t)
        got = _check_round(cc, inputs, recs_t, recs_j, st_t, st_j, fin_t,
                           fin_j)
        print(f"round {t}: codec splits, residual entries beyond 1e-4, "
              f"largest residual gap: {got}")
        if t == 0:
            assert max(float(jnp.abs(a).max()) for a in
                       jax.tree_util.tree_leaves(st_j.residual)) > 0
        # the next round starts from the reference's state on both sides
        back = lambda tree: interop.params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), "cpu")
        params = back(st_j.params)
        st_t = st_t._replace(
            params=params, opt_state=eng_t.trainer.opt.init(params),
            pool=interop.vpool_from_jax(
                jax.tree_util.tree_map(np.asarray, st_j.pool), "cpu"),
            residual=back(st_j.residual))


def test_int8_fused_rounds_keep_the_reference_invariants():
    """One dispatch per call; a top-k fraction of 1.0 equals no codec
    (one round, 1e-6: the delta form's sum order only); error feedback
    creates a residual, updates it only where a device uploaded, and is
    dropped when off."""
    D = 3
    shards, seed_set, test = _fleet(D)
    eng = _port_engine(D, shards, seed_set, test)
    p0 = eng.trainer.init_params(torch.Generator().manual_seed(0))
    finals = {}
    for name, cfg in (("none", None),
                      ("topk1", CommsConfig(compression="topk",
                                            topk_fraction=1.0)),
                      ("int8", CommsConfig(compression="int8"))):
        counters.reset_dispatches()
        _, _, finals[name] = eng.run_rounds_fused(eng.init_state(p0), 1,
                                                  comms=cfg)
        assert counters.dispatch_count() == 1
    for a, b in zip(tree_leaves(finals["none"]), tree_leaves(finals["topk1"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert all(torch.isfinite(a).all() for a in tree_leaves(finals["int8"]))

    int8 = CommsConfig(compression="int8")
    state0 = eng.init_state(p0)
    assert state0.residual == ()
    state1, _, _ = eng.run_rounds_fused(state0, 1, comms=int8)
    res1 = tree_leaves(state1.residual)
    assert len(res1) == len(tree_leaves(state1.params))
    assert max(a.abs().max().item() for a in res1) > 0
    before = [a.clone() for a in res1]
    state2, _, _ = eng.run_rounds_fused(state1, 1, comms=int8,
                                        upload_mask=np.array([[0., 1., 1.]]),
                                        start_round=1)
    changed = False
    for b, r1, r2 in zip(before, res1, tree_leaves(state2.residual)):
        assert torch.equal(r1, b)             # the caller's buffer untouched
        assert torch.equal(r2[0], b[0])       # skipped the round: frozen
        changed = changed or not torch.equal(r2[1:], b[1:])
    assert changed
    state3, _, _ = eng.run_rounds_fused(
        state1, 1, comms=replace(int8, error_feedback=False), start_round=1)
    assert state3.residual == ()


def test_drivers_carry_comms_and_guard_engines():
    D = 3
    shards, seed_set, test = _fleet(D)
    cfg = FederatedALConfig(num_devices=D, **SLICE)
    topk = CommsConfig(compression="topk", topk_fraction=0.1)
    _, reports = run_federated_rounds(cfg, shards, seed_set, test,
                                      rounds=ROUNDS, engine="fused",
                                      comms=topk, device="cpu")
    ratio = comms.compression_ratio(topk, _lenet())
    for t, rep in enumerate(reports):
        c = rep["comms"]
        assert c["compression"] == "topk" and c["uploads"] == D
        assert c["compression_ratio"] == ratio
        assert c["cumulative_uplink_bytes"] == (t + 1) * c["uplink_bytes"]
    for engine in ("vmap", "legacy", "classic"):
        with pytest.raises(ValueError, match="engine='fused'"):
            run_federated_rounds(cfg, shards, seed_set, test, rounds=1,
                                 engine=engine, comms=topk, device="cpu")
    tel = run_experiment(cfg, n_train=60, n_test=20, rounds=ROUNDS,
                         engine="fused", comms=CommsConfig(compression="int8"),
                         device="cpu")[0]["comms"]
    assert tel["compression"] == "int8" and 3.9 < tel["compression_ratio"] < 4
    assert len(tel["uplink_bytes_per_round"]) == ROUNDS
    assert tel["accuracy_vs_bytes"][-1]["cumulative_uplink_bytes"] == \
        tel["uplink_bytes_total"]
