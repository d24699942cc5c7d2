"""The kernels' plain versions, and the scoring and aggregation modules
around them, against the JAX package on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version, so these
tests hold that version (the function the CUDA kernel is compared with on
the card) against the reference's Pallas kernel in interpret mode and its
jnp oracle.  Inputs come from numpy seeds.  Tolerances: 1e-5 absolute in
float32 for the acquisition scores (the reference's own
tests/test_kernels.py bar); atol 1e-6 + rtol 1e-5 for Eq. 1 reductions
(the reference's tests/test_fused_aggregation.py bar), comparing bf16
payloads after float32 accumulation (``out_dtype=float32``); attention
2e-5 in float32 and 2e-2 in bfloat16, SSD 1e-4 (the reference's
tests/test_kernels.py bars).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import acquisition as jacq  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import mc_dropout as jmc  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.fused_aggregation import fused_aggregate as j_fused  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import acquisition as tacq  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import mc_dropout as tmc  # noqa: E402
from repro_torch.kernels import acquisition_scores as k1  # noqa: E402
from repro_torch.kernels import fused_aggregation as k2  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _logprobs(T, N, C, dtype):
    """The reference test's inputs: log_softmax of 3·normal logits cast
    through ``dtype``; numpy seed, so both sides see the same numbers."""
    logits = 3 * np.random.default_rng(T * N + C).normal(size=(T, N, C))
    if dtype == "bfloat16":
        logits = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32),
                                         axis=-1))


# ------------------------------------------------------ K1 acquisition scores
@pytest.mark.parametrize("T,N,C", [(4, 50, 10), (8, 200, 10), (2, 17, 3),
                                   (16, 128, 257)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_acquisition_plain_matches_pallas_and_oracle(T, N, C, dtype):
    lp = _logprobs(T, N, C, dtype)
    before = k1.launches
    got = k1.acquisition_scores(torch.from_numpy(lp))   # CPU → plain version
    assert k1.launches == before
    kern = ops.acquisition_scores(jnp.asarray(lp), interpret=True)
    oracle = ref.acquisition_scores_ref(jnp.asarray(lp))
    for g, k, o in zip(got, kern, oracle):
        np.testing.assert_allclose(g.numpy(), np.asarray(k), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), atol=1e-5)


@pytest.mark.parametrize("T,N,C", [(2, 3, 4099), (4, 2, 50287)])
def test_acquisition_plain_matches_oracle_at_wide_ragged_c(T, N, C):
    """At class counts the split mode takes, not a multiple of 4 (the
    kernel's scalar loads): plain vs ``ref.acquisition_scores_ref``."""
    lp = _logprobs(T, N, C, "float32")
    got = k1.acquisition_scores(torch.from_numpy(lp))
    want = jax.jit(ref.acquisition_scores_ref)(jnp.asarray(lp))
    for g, o in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(o), atol=1e-5)


F32, BF16 = torch.float32, torch.bfloat16
# rows (devices x N), T, C, dtype, aligned -> mode, slices, threads, vec
K1_PLAN_CASES = [
    ((800, 16, 10, F32, True), ("warp", 1, 256, 1)),       # paper
    ((8192, 4, 10, F32, True), ("warp", 1, 256, 1)),       # massive
    ((128, 16, 257, F32, True), ("warp", 1, 256, 1)),
    ((256, 4, 50288, F32, True), ("split", 2, 256, 4)),    # path A
    ((256, 4, 32768, F32, True), ("split", 2, 256, 4)),    # path B
    ((256, 4, 50288, BF16, True), ("split", 2, 256, 8)),
    ((32, 4, 50288, F32, True), ("split", 8, 256, 4)),     # 1 device
    ((100, 4, 50288, F32, True), ("split", 4, 256, 4)),
    ((256, 4, 50287, F32, True), ("split", 2, 256, 1)),    # ragged
    ((256, 4, 50284, BF16, True), ("split", 2, 256, 1)),   # C % 8 = 4
    ((256, 4, 50288, F32, False), ("split", 2, 256, 1)),   # off 16 B
    ((32, 4, 4099, F32, True), ("split", 2, 256, 1)),      # slice >= 2K
    ((8, 4, 3000, F32, True), ("split", 1, 256, 4)),
    ((600, 4, 2048, BF16, True), ("split", 1, 256, 8)),    # > 1 wave
]


@pytest.mark.parametrize("args,want", K1_PLAN_CASES)
def test_acquisition_launch_plan(args, want):
    """K1's plan: a warp per row below 1024 classes; above, the most class
    slices (1, 2, 4, 8) whose blocks run in one wave of 4 a SM, no slice
    under 2048 classes; 16-byte loads only where C and the start allow."""
    plan = k1.launch_plan(*args)
    assert (plan.mode, plan.slices, plan.threads, plan.vec) == want
    if plan.mode == "split" and plan.slices > 1:
        assert args[2] // plan.slices >= k1.MIN_SLICE
        assert args[0] * plan.slices <= k1.RESIDENT_BLOCKS


@pytest.mark.parametrize("args,err", [
    ((256, 4, 50288, torch.float16), TypeError),
    ((256, 4, 50288, torch.float64), TypeError),
    ((256, 0, 50288, F32), ValueError),
    ((256, 4, 0, F32), ValueError),
])
def test_acquisition_launch_plan_refuses(args, err):
    with pytest.raises(err):
        k1.launch_plan(*args)


def test_acquisition_plain_folds_devices_into_rows():
    lp = np.stack([_logprobs(4, 30, 10, "float32"),
                   _logprobs(4, 30, 11, "float32")[..., :10]])
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(lp), axis=-1))
    got = k1.acquisition_scores(torch.from_numpy(lp))     # [D, T, N, C]
    for d in range(2):
        one = k1.acquisition_scores(torch.from_numpy(lp[d]))
        for g, o in zip(got, one):
            np.testing.assert_allclose(g[d].numpy(), o.numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["entropy", "bald", "vr", "margin",
                                  "least_confidence"])
def test_scores_match_reference(name):
    lp = _logprobs(6, 40, 10, "float32")
    got = tacq.acquisition_scores(name, torch.from_numpy(lp))
    want = jacq.acquisition_scores(name, jnp.asarray(lp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_predictive_posterior_matches_reference():
    lp = _logprobs(5, 20, 10, "float32")
    np.testing.assert_allclose(
        tmc.predictive_posterior(torch.from_numpy(lp)).numpy(),
        np.asarray(jmc.predictive_posterior(jnp.asarray(lp))), atol=1e-6)


def test_select_topk_matches_reference_including_ties():
    s = np.array([0.5, 0.9, 0.5, -np.inf, 0.9, 0.1, -np.inf, 0.5],
                 np.float32)
    for k in (1, 3, 5, 8):
        np.testing.assert_array_equal(
            tacq.select_topk(torch.from_numpy(s), k).numpy(),
            np.asarray(jacq.select_topk(jnp.asarray(s), k)))


def test_select_topk_agrees_on_kernel_scores():
    lp = _logprobs(8, 100, 10, "float32")
    ent = k1.acquisition_scores(torch.from_numpy(lp))[0]
    want = jacq.select_topk(jacq.entropy(jnp.asarray(lp)), 10)
    assert set(tacq.select_topk(ent, 10).tolist()) == set(
        np.asarray(want).tolist())


def test_batch_bald_lite_matches_reference():
    lp = _logprobs(6, 30, 4, "float32")
    np.testing.assert_array_equal(
        tacq.batch_bald_lite(torch.from_numpy(lp), 3).numpy(),
        np.asarray(jacq.batch_bald_lite(jnp.asarray(lp), 3)))


# ------------------------------------------------------ K2 fused aggregation
SHAPES = ((3, 4), (7,), (), (2, 1, 2))


def _payload(rng, D, payload):
    if payload == "int8":
        return {f"l{i}": rng.integers(-127, 128, (D,) + s).astype(np.int8)
                for i, s in enumerate(SHAPES)}
    return {f"l{i}": rng.normal(size=(D,) + s).astype(np.float32)
            for i, s in enumerate(SHAPES)}


def _sides(tree_np, payload):
    """The same payload on both sides (bf16 rounds identically: RNE)."""
    jdt = jnp.bfloat16 if payload == "bfloat16" else None
    tdt = torch.bfloat16 if payload == "bfloat16" else None
    j = {k: jnp.asarray(v, jdt) for k, v in tree_np.items()}
    t = {k: torch.from_numpy(v) if tdt is None else torch.from_numpy(v).to(tdt)
         for k, v in tree_np.items()}
    return j, t


def _close(jtree, ttree):
    for k in jtree:
        np.testing.assert_allclose(ttree[k].float().numpy(),
                                   np.asarray(jtree[k], np.float32),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


GRID = [(D, seg, norm, kind, payload)
        for D in (1, 4, 8, 64) for seg in (False, True)
        for norm in (True, False) for kind in ("none", "exp", "poly")
        for payload in (("float32", "bfloat16", "int8") if D == 8
                        else ("float32",))]


@pytest.mark.parametrize("D,segmented,normalize,kind,payload", GRID)
def test_fused_aggregate_plain_matches_reference(D, segmented, normalize,
                                                 kind, payload):
    """flat/segment × normalize × decay kind at D ∈ {1, 4, 8, 64}, and at
    D = 8 every payload (f32, bf16, int8 + scales), against
    ``fused_agg_ref``; at D = 8 also against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(D * 1000 + 10 * segmented + normalize
                                + len(kind) + len(payload))
    tree_j, tree_t = _sides(_payload(rng, D, payload), payload)
    raw = rng.uniform(0.1, 2.0, D).astype(np.float32)
    stale = rng.integers(0, 5, D).astype(np.float32)
    mask = rng.integers(0, 2, D).astype(np.float32)
    kw = dict(kind=kind, rate=0.6, normalize=normalize)
    jkw, tkw = dict(kw), dict(kw)
    if segmented:
        G = min(D, 3) + 1                  # the last group may be empty
        ids = rng.integers(0, G - 1 if D > 1 else 1, D).astype(np.int32)
        jkw.update(segment_ids=jnp.asarray(ids), num_segments=G)
        tkw.update(segment_ids=torch.from_numpy(ids), num_segments=G)
    if payload == "int8":
        sc = {k: rng.uniform(1e-4, 1e-2, D).astype(np.float32)
              for k in tree_j}
        jkw["scales"] = {k: jnp.asarray(v) for k, v in sc.items()}
        tkw["scales"] = {k: torch.from_numpy(v) for k, v in sc.items()}
    jkw["out_dtype"], tkw["out_dtype"] = jnp.float32, torch.float32

    before = k2.launches
    got = k2.fused_aggregate(tree_t, torch.from_numpy(raw),
                             staleness=torch.from_numpy(stale),
                             mask=torch.from_numpy(mask), **tkw)
    assert k2.launches == before           # CPU tensors: the plain version
    _close(ref.fused_agg_ref(tree_j, jnp.asarray(raw),
                             staleness=jnp.asarray(stale),
                             mask=jnp.asarray(mask), **jkw), got)
    if D == 8:
        _close(j_fused(tree_j, jnp.asarray(raw), staleness=jnp.asarray(stale),
                       mask=jnp.asarray(mask), interpret=True, **jkw), got)


@pytest.mark.parametrize("segmented", [False, True])
def test_fused_aggregate_plain_all_dead_uniform_guard(segmented):
    rng = np.random.default_rng(11)
    D = 8
    tree_j, tree_t = _sides(_payload(rng, D, "float32"), "float32")
    raw = rng.uniform(size=D).astype(np.float32)
    dead = np.zeros(D, np.float32)
    jkw, tkw = {}, {}
    if segmented:
        ids = np.array([0] * 4 + [1] * 4, np.int32)
        dead[4:] = 1.0                      # one dead group, one live
        jkw = dict(segment_ids=jnp.asarray(ids), num_segments=2)
        tkw = dict(segment_ids=torch.from_numpy(ids), num_segments=2)
    got = k2.fused_aggregate(tree_t, torch.from_numpy(raw),
                             mask=torch.from_numpy(dead), **tkw)
    _close(ref.fused_agg_ref(tree_j, jnp.asarray(raw), mask=jnp.asarray(dead),
                             **jkw), got)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())


def test_fused_aggregate_default_out_dtypes():
    rng = np.random.default_rng(12)
    _, t16 = _sides(_payload(rng, 4, "float32"), "bfloat16")
    w = torch.full((4,), 0.25)
    out = k2.fused_aggregate(t16, w, normalize=False)
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    q = {k: torch.from_numpy(v) for k, v in _payload(rng, 4, "int8").items()}
    out = k2.fused_aggregate(q, w, scales={k: torch.ones(4) for k in q})
    assert all(v.dtype == torch.float32 for v in out.values())


def test_fused_aggregate_validation():
    tree = {"x": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="staleness decay"):
        k2.fused_aggregate(tree, torch.ones(2), kind="bogus")
    with pytest.raises(ValueError, match="num_segments"):
        k2.fused_aggregate(tree, torch.ones(2),
                           segment_ids=torch.zeros(2, dtype=torch.int32))


def _lm_widths(adapter):
    """Columns of each leaf of an LM adapter's tree, from shapes only
    (fake tensors: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = adapter.init(torch.Generator())
    return tuple(leaf[0].numel() for leaf in tree_leaves(tree))


@functools.lru_cache(maxsize=None)
def _plan_widths(name):
    if name == "lenet":          # LeNet's 10 leaves, 61,706 params
        return (150, 6, 2400, 16, 48000, 120, 10080, 84, 840, 10)
    if name == "odd":
        return (1, 3, 4, 5, 8, 16, 17, 4099, 0, 12, 33)
    if name == "many":           # more leaves than one launch takes
        return tuple(range(1, 41))
    from dataclasses import replace
    from repro_torch.core.model_adapter import DecoderLMAdapter, SSMAdapter
    from repro_torch.configs import get_config
    from repro_torch.models.config import lm_100m
    if name == "ssm":            # path A: one Mamba-2 block, 1.3b widths
        return _lm_widths(SSMAdapter(replace(
            get_config("mamba2-1.3b"), n_layers=1, param_dtype=torch.float32,
            dtype=torch.float32)))
    return _lm_widths(DecoderLMAdapter(lm_100m()))    # path B


@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("D", [1, 8, 256, 300])
@pytest.mark.parametrize("name", ["lenet", "ssm", "decoder", "odd", "many"])
def test_fused_aggregate_tile_plan_covers_every_column_once(name, D,
                                                            itemsize):
    """The kernel's tile table, walked as the kernel walks it (tile → leaf
    by the last first-tile ≤ t; thread lanes → columns): every column of
    every leaf falls in exactly one tile and one thread, and only leaves
    whose rows all start on 16-byte boundaries take 16-byte loads."""
    widths = _plan_widths(name)
    aligned = tuple(i % 7 != 3 for i in range(len(widths)))  # some not
    sms = 132
    plan = k2.tile_plan(widths, itemsize, aligned, D, sms)
    R, TW, vec = plan.row_groups, plan.tile_cols, 16 // itemsize
    assert R & (R - 1) == 0 and R <= min(D, k2.MAX_ROW_GROUPS)
    assert TW == (k2.THREADS // R) * vec
    C = k2.THREADS // R
    # lanes → columns of one tile: vector lanes own V neighbours, scalar
    # lanes columns lc + k·C; both cover the tile's TW columns once
    vec_cols = sorted(lc * vec + k for lc in range(C) for k in range(vec))
    scalar_cols = sorted(lc + k * C for lc in range(C) for k in range(vec))
    assert vec_cols == scalar_cols == list(range(TW))
    total = sum(off[-1] for off in plan.tile_offs)
    assert (total >= k2.TILES_PER_SM * sms
            or R == min(D, k2.MAX_ROW_GROUPS) or R == 1 and D == 1)
    seen = []
    for (first, stop), off, mask in zip(plan.groups, plan.tile_offs,
                                        plan.vec_masks):
        assert 0 < stop - first <= k2.MAX_LEAVES and len(off) == stop - first + 1
        seen.extend(range(first, stop))
        t = np.arange(off[-1])
        leaf = np.searchsorted(np.asarray(off[:-1]), t, side="right") - 1
        for l in range(stop - first):
            n = widths[first + l]
            c0 = (t[leaf == l] - off[l]) * TW
            # consecutive, disjoint tiles whose union is exactly [0, n)
            np.testing.assert_array_equal(c0, np.arange(0, n, TW))
            is_vec = bool(mask >> l & 1)
            assert is_vec == (aligned[first + l] and n * itemsize % 16 == 0)
            if is_vec:               # every row and lane start is aligned
                assert (n * itemsize) % 16 == 0 and (TW * itemsize) % 16 == 0
                assert int(c0.max(initial=0)) * itemsize % 16 == 0
    assert seen == list(range(len(widths)))
    if name in ("ssm", "decoder"):       # the LM trees' bulk is vectorised
        big = [i for i, n in enumerate(widths) if n >= 1 << 16]
        assert all(plan.vec_masks[0] >> i & 1 for i in big if aligned[i])
    if name == "lenet" and D == 256 and itemsize == 4:
        # the massive path splits the rows: R = 8, 487 tiles
        assert R == 8 and total >= k2.TILES_PER_SM * sms


# ------------------------------------------------------ aggregation module
@pytest.mark.parametrize("case", ["random", "zero_weights", "no_participants"])
@pytest.mark.parametrize("segmented", [False, True])
def test_masked_normalize_matches_reference(case, segmented):
    rng = np.random.default_rng(13)
    D = 9
    w = rng.uniform(0.0, 2.0, D).astype(np.float32)
    m = rng.integers(0, 2, D).astype(np.float32)
    if case == "zero_weights":
        w[:] = 0.0
    if case == "no_participants":
        m[:] = 0.0
    kw = {}
    if segmented:
        ids = rng.integers(0, 4, D).astype(np.int32)
        kw = dict(segment_ids=ids, num_segments=4)
    got = tagg.masked_normalize(torch.from_numpy(w), torch.from_numpy(m),
                                **kw)
    want = jagg.masked_normalize(jnp.asarray(w), jnp.asarray(m), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)


@pytest.mark.parametrize("kind", ["none", "exp", "poly"])
def test_staleness_weights_match_reference(kind):
    rng = np.random.default_rng(14)
    raw = rng.uniform(0.1, 1.0, 6).astype(np.float32)
    s = rng.integers(0, 6, 6).astype(np.float32)
    m = rng.integers(0, 2, 6).astype(np.float32)
    got = tagg.staleness_weights(torch.from_numpy(raw), torch.from_numpy(s),
                                 torch.from_numpy(m), kind=kind, rate=0.7)
    want = jagg.staleness_weights(jnp.asarray(raw), jnp.asarray(s),
                                  jnp.asarray(m), kind=kind, rate=0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    assert float(tagg.staleness_decay(torch.zeros(1), kind=kind)[0]) == 1.0


@pytest.mark.parametrize("strategy", ["fedavg", "fedavg_n", "weighted",
                                      "opt"])
def test_list_forms_match_reference(strategy):
    rng = np.random.default_rng(15)
    models = [{"a": rng.normal(size=(3, 2)).astype(np.float32),
               "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
              for _ in range(3)]
    scores = [0.2, 0.7, 0.7]
    jm = [jax.tree_util.tree_map(jnp.asarray, m) for m in models]
    tm = [interop.params_from_jax(m, "cpu") for m in models]
    if strategy == "fedavg":
        want, got = jagg.fedavg(jm), tagg.fedavg(tm)
    elif strategy == "fedavg_n":
        want, got = jagg.fedavg_n(jm, [3, 5, 0]), tagg.fedavg_n(tm, [3, 5, 0])
    elif strategy == "weighted":
        want = jagg.weighted_average(jm, scores)
        got = tagg.weighted_average(tm, scores)
    else:
        (want, bj), (got, bt) = jagg.opt_model(jm, scores), \
            tagg.opt_model(tm, scores)
        assert bj == bt == 1
    back = interop.params_to_jax(got)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)


def test_stacked_forms_match_reference():
    rng = np.random.default_rng(16)
    st = {"a": rng.normal(size=(5, 3)).astype(np.float32)}
    w = rng.uniform(size=5).astype(np.float32)
    m = np.array([1, 0, 1, 1, 0], np.float32)
    jt = jax.tree_util.tree_map(jnp.asarray, st)
    tt = interop.params_from_jax(st, "cpu")
    np.testing.assert_allclose(
        tagg.weighted_average_stacked(tt, torch.from_numpy(w),
                                      mask=torch.from_numpy(m))["a"].numpy(),
        np.asarray(jagg.weighted_average_stacked(jt, jnp.asarray(w),
                                                 mask=jnp.asarray(m))["a"]),
        atol=1e-6)
    np.testing.assert_allclose(
        tagg.fedavg_stacked(tt)["a"].numpy(),
        np.asarray(jagg.fedavg_stacked(jt)["a"]), atol=1e-6)
    (pj, bj), (pt, bt) = (jagg.opt_model_stacked(jt, jnp.asarray(w),
                                                 mask=jnp.asarray(m)),
                          tagg.opt_model_stacked(tt, torch.from_numpy(w),
                                                 mask=torch.from_numpy(m)))
    assert int(bj) == bt
    np.testing.assert_array_equal(pt["a"].numpy(), np.asarray(pj["a"]))
    back = tagg.unstack_models(tagg.stack_models(tagg.unstack_models(tt)))
    np.testing.assert_array_equal(torch.stack([b["a"] for b in back]).numpy(),
                                  st["a"])


# ------------------------------------------------- K1 determinism (Queue 3)
@pytest.mark.parametrize("C", [10, 32768])
def test_acquisition_plain_is_bitwise_repeatable(C):
    """Two calls of the plain K1 version on one CPU tensor give the same
    bits (the comparison chip_smoke.py makes on the card rests on it)."""
    lp = torch.from_numpy(np.array(_logprobs(4, 32, C, "float32")))
    first = k1.acquisition_scores_plain(lp)
    for _ in range(3):
        for a, b in zip(first, k1.acquisition_scores_plain(lp)):
            assert torch.equal(a, b)


# ------------------------------------------------------ K3 flash attention
# the reference's tests/test_kernels.py cases:
# B, Sq, Skv, H, Hkv, d, causal, window, softcap
ATTN_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None),
    (1, 128, 128, 8, 1, 64, True, 32, None),      # MQA + sliding window
    (1, 96, 96, 4, 4, 128, True, None, 50.0),     # softcap
    (2, 1, 80, 4, 4, 64, True, None, None),       # decode-like single query
    (1, 64, 72, 4, 2, 64, False, None, None),     # non-causal
    (1, 33, 47, 2, 2, 256, True, None, None),     # ragged, big head_dim
    # MLA widths (qk_nope + qk_rope): minicpm3-4b's 96, deepseek-v2's 192
    (1, 24, 24, 4, 2, 96, True, None, None),
    (1, 20, 28, 2, 1, 192, True, 8, None),
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_oracle(case, dtype):
    """K3's plain version against ``ref.attention_ref`` and the Pallas
    kernel in interpret mode: f32 2e-5, bf16 2e-2 (the reference's bars)."""
    B, Sq, Skv, H, Hkv, d, causal, window, softcap = case
    r = np.random.default_rng(sum(case[:6]))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(r.normal(size=s).astype(np.float32), jdt)
               for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))
    q_offset = Skv - Sq if causal else 0
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))
    before = k3.launches
    got = k3.flash_attention(tt(q), tt(k), tt(v), **kw)     # CPU → plain
    assert k3.launches == before and got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    want = ref.attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol)
    kern = ops.flash_attention(q, k, v, block_q=64, block_kv=64,
                               interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), atol=tol)


# B, Sq, Skv, H, Hkv, d, itemsize -> rows, heads, blocks, threads, smem,
# flags
PLAN_CASES = [
    ((1024, 32, 32, 10, 5, 64, 4), (32, 2, 5120, 128, 45824, 15)),  # path B
    ((64, 512, 512, 10, 5, 64, 4), (32, 2, 5120, 128, 63232, 15)),  # 512
    ((1, 100, 100, 8, 1, 64, 4), (8, 8, 13, 128, 63232, 15)),       # GQA 8
    ((1, 5, 9, 130, 1, 8, 4), (1, 64, 15, 256, 29440, 15)),         # slices
    ((2, 40, 40, 4, 2, 96, 2), (32, 2, 8, 128, 87808, 15)),
    ((2, 40, 40, 4, 2, 192, 4), (32, 2, 8, 256, 161536, 15)),
    ((1, 37, 45, 4, 2, 13, 4), (32, 2, 4, 256, 38656, 0)),     # 52-byte rows
    ((1, 37, 45, 4, 2, 12, 2), (32, 2, 4, 256, 38656, 0)),     # 24-byte rows
    ((1, 37, 45, 4, 2, 16, 2), (32, 2, 4, 256, 38656, 15)),
    ((1, 8, 8, 2, 2, 256, 4), (8, 1, 2, 256, 144128, 15)),    # 1 kv stage
    ((1, 8, 300, 2, 2, 256, 4), (8, 1, 2, 256, 210688, 15)),
]


@pytest.mark.parametrize("args,want", PLAN_CASES)
def test_flash_attention_launch_plan(args, want):
    """K3's launch plan: a block owns a whole GQA group (at most 64 heads,
    else head slices) and at most 64 query rows over its heads; one kv
    stage when Skv fits one tile; 16-byte pieces only for rows that are
    whole 16-byte pieces."""
    plan = k3.launch_plan(*args)
    assert (plan.rows, plan.heads, plan.blocks, plan.threads, plan.smem,
            plan.flags) == want
    assert plan.rows * plan.heads <= k3.BLOCK_ROWS and plan.smem <= 232448


def test_flash_attention_launch_plan_flags_follow_alignment():
    """A contiguous view at a storage offset of one element starts off 16
    bytes: that tensor takes the kernel's scalar path."""
    base = torch.zeros(1 + 2 * 8 * 4 * 64)
    aligned = base[:-1].view(2, 8, 4, 64)
    off = base[1:].view(2, 8, 4, 64)
    ptrs = lambda *ts: tuple(t.data_ptr() % 16 == 0 for t in ts)
    assert k3.launch_plan(2, 8, 8, 4, 4, 64, 4, ptrs(
        aligned, off, aligned, aligned)).flags == (k3.VEC_Q | k3.VEC_V
                                                   | k3.VEC_O)
    assert k3.launch_plan(2, 8, 8, 4, 4, 64, 4, ptrs(
        off, off, off, aligned)).flags == k3.VEC_O


@pytest.mark.parametrize("d", [0, 257, 512])
def test_flash_attention_launch_plan_refuses_head_dim(d):
    """The kernel takes head dims 1 to 256; a larger one raises a
    ValueError that names the limit (no repo config reaches it)."""
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        k3.launch_plan(1, 4, 4, 2, 2, d, 4)


def test_flash_attention_plain_row_without_keys_is_zero():
    q = torch.ones(1, 3, 2, 64)
    out = k3.flash_attention(q, q, q, causal=True, q_offset=-2)
    assert torch.all(out[:, :2] == 0) and torch.any(out[:, 2] != 0)


# --------------------------------------------------- K4 SSD intra-chunk
@pytest.mark.parametrize("Z,L,g,h,n,p", [(4, 32, 1, 2, 16, 8),
                                         (2, 64, 2, 4, 32, 16),
                                         (1, 128, 1, 1, 128, 64)])
def test_ssd_intra_plain_matches_pallas_and_oracle(Z, L, g, h, n, p):
    """K4's plain version takes B and C once per group ``[Z, L, g, n]``;
    the reference's kernel and oracle take them repeated over the heads,
    transposed to ``[Z·h, L, n]`` — done here, on the test side.  atol
    1e-4 (the reference's bar)."""
    r = np.random.default_rng(Z * L + n)
    C = r.normal(size=(Z, L, g, n)).astype(np.float32)
    B = r.normal(size=(Z, L, g, n)).astype(np.float32)
    la = -np.cumsum(np.log1p(np.exp(r.normal(size=(Z, L, h)))),
                    axis=1).astype(np.float32)
    xdt = r.normal(size=(Z, L, h, p)).astype(np.float32)
    before = k4.launches
    y, st = k4.ssd_intra_chunk(*(torch.from_numpy(a) for a in (C, B, la, xdt)))
    assert k4.launches == before
    assert y.shape == (Z, L, h, p) and st.shape == (Z, h, p, n)

    per_head = lambda a: np.repeat(a, h // g, axis=2).transpose(
        0, 2, 1, 3).reshape(Z * h, L, n)
    args = (jnp.asarray(per_head(C)), jnp.asarray(per_head(B)),
            jnp.asarray(la.transpose(0, 2, 1).reshape(Z * h, L)),
            jnp.asarray(xdt.transpose(0, 2, 1, 3).reshape(Z * h, L, p)))
    y_t = y.numpy().transpose(0, 2, 1, 3).reshape(Z * h, L, p)
    st_t = st.numpy().reshape(Z * h, p, n)
    for y_j, st_j in (ref.ssd_intra_ref(*args),
                      ops.ssd_intra_chunk(*args, interpret=True)):
        np.testing.assert_allclose(y_t, np.asarray(y_j), atol=1e-4)
        np.testing.assert_allclose(st_t, np.asarray(st_j), atol=1e-4)


# K4's launch plan: (Z, L, g, h, n, p, itemsize, C/B aligned, xdt aligned)
# → (heads a block, blocks, shared memory bytes, flags)
_F = k4.VEC_BC | k4.VEC_X | k4.VEC_STATE | k4.VEC_Y
_FB = _F | k4.BULK_STATE


@pytest.mark.parametrize("args,want", [
    # path A, the LM fleet's call: 16 heads a block, 4 blocks a chunk, the
    # state out through bulk copies (32 KB a head)
    ((1024, 32, 1, 64, 128, 64, 4, True, True), (16, 4096, 102400, _FB)),
    ((1024, 32, 1, 64, 128, 64, 2, True, True), (16, 4096, 102400, _FB)),
    # the published chunk at mamba2-1.3b widths: one block an SM, no room
    # for a bulk copy's 32 KB
    ((64, 256, 1, 64, 128, 64, 4, True, True), (16, 256, 230912, _F)),
    # head counts the slice does not divide; two groups
    ((3, 32, 1, 5, 128, 64, 4, True, True), (5, 3, 100992, _FB)),
    ((2, 32, 1, 67, 128, 64, 4, True, True), (16, 10, 102400, _FB)),
    ((2, 64, 2, 6, 32, 16, 4, True, True), (3, 4, 36096, _FB)),
    # L = 37: two tiles, the second with 5 rows
    ((5, 37, 1, 3, 128, 64, 4, True, True), (3, 5, 122112, _FB)),
    # 16-byte rows (n 24, p 40 in float32; p 40 in bf16); rows that are not
    ((5, 37, 1, 3, 24, 40, 4, True, True), (3, 5, 44032, _FB)),
    ((5, 37, 1, 3, 24, 40, 2, True, True), (3, 5, 44032, _FB)),
    ((2, 40, 1, 67, 21, 13, 4, True, True), (16, 10, 34304, 0)),
    ((3, 33, 1, 5, 20, 12, 2, True, True),
     (5, 3, 30912, k4.VEC_STATE | k4.VEC_Y | k4.BULK_STATE)),
    # an xdt view one element past a 16-byte boundary: scalar x copies
    ((64, 32, 1, 64, 128, 64, 4, True, False),
     (16, 256, 102400, _FB & ~k4.VEC_X)),
    # a 256 x 256 state takes 8 rounds of register tiles: register stores
    ((2, 48, 1, 2, 256, 256, 4, False, True),
     (2, 2, 211968, _F & ~k4.VEC_BC)),
])
def test_ssd_launch_plan(args, want):
    """The launch the wrapper makes, in plain Python: a block owns up to 16
    heads of one group, shared memory is the kernel's layout, 16-byte
    copies and stores fall only on rows that start on 16 bytes, and a bulk
    state copy only where the state is whole 16-byte rows that one round of
    register tiles covers."""
    plan = k4.launch_plan(*args)
    assert (plan.heads_per_block, plan.blocks, plan.smem, plan.flags) == want
    Z, L, g, h, n, p, itemsize = args[:7]
    bulk = bool(plan.flags & k4.BULK_STATE)
    assert plan.blocks == Z * g * -(-(h // g) // plan.heads_per_block)
    assert plan.smem <= k4.SMEM_LIMIT
    assert plan.smem == k4.smem_bytes(L, n, p, plan.heads_per_block,
                                      itemsize, bulk)
    if bulk:                 # whole 16-byte rows, one round of tiles
        assert n % 4 == 0 and -(-n // 32) * -(-p // 32) <= 8
    if plan.flags & k4.VEC_X:
        assert args[8] and p * itemsize % 16 == 0
    if plan.flags & k4.VEC_BC:
        assert args[7] and n * itemsize % 16 == 0


@pytest.mark.parametrize("args,match", [
    ((1, 8, 1, 1, 16, 320, 4, True, True), "register"),
    ((1, 256, 1, 8, 256, 64, 4, True, True), "shared memory"),
    ((1, 512, 1, 8, 128, 64, 4, True, True), "shared memory"),
    ((1, 32, 2, 3, 16, 8, 4, True, True), "groups"),
])
def test_ssd_launch_plan_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        k4.launch_plan(*args)
