"""The decoder zoo's layers of the port against the JAX package on the CPU:
the published configs, MoE, MLA, RG-LRU, gated cross-attention, the
decoder's five new families and a fused LM round with an MLA + MoE
decoder.

Inputs come from numpy seeds.  Weights come from the port's inits, whose
trees, shapes and dtypes are checked against the reference's init
(``jax.eval_shape``), and cross to the reference as numpy
(``repro_torch.interop``); the reference's threefry inits would draw
other bits from the same distributions, and compile for seconds each.
MLA's ``q_norm`` and
``kv_norm`` scales, the Mamba block's gated-norm scale and the
cross-attention gates start at zero in both packages, which would make
the compared outputs zero: the tests draw every norm scale and gate from
the seed before comparing.  The port runs ``[D, ...]`` stacked params,
the reference one model, so the port's side is ``D = 1`` (``D = 2`` where
the test is about devices).

Tolerances: configs exact; layer and block outputs 1e-5 absolute
(float32, summation order only; the RG-LRU scan associates differently
from ``jax.lax.associative_scan``); decoder logits 1e-5 and the MoE
auxiliary loss 1e-6; capacity drops exact; the fused round at the bars
of ``test_torch_lm_slice.py``.  Each reference program is compiled once
with ``jax.jit`` and shared by the tests that call it (``_jit``, and the
``rglru_params`` module fixture).
"""
from dataclasses import fields, replace
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.engine import EdgeEngine as JEngine  # noqa: E402
from repro.core.federated import Trainer as JTrainer  # noqa: E402
from repro.core.federated import lm_config as j_lm_config  # noqa: E402
from repro.core.model_adapter import DecoderLMAdapter as JDecoderAdapter  # noqa: E402
from repro.data.lm import lm_federated_split, make_lm_dataset  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import mla as jmla  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn import rglru as jrg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.engine import EdgeEngine  # noqa: E402
from repro_torch.core.federated import Trainer, lm_config  # noqa: E402
from repro_torch.core.model_adapter import DecoderLMAdapter  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import mla as tmla  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn import rglru as trg  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(partial(fn, **dict(static)))


def _jit(fn, **static):
    """``fn`` compiled with ``static`` bound, one program per module
    (later calls with the same arguments reuse it)."""
    return _jitted(fn, tuple(sorted(static.items())))


def _stack(*trees):
    """JAX models' params (numpy leaves) → the port's stacked tree."""
    return interop.params_from_jax(
        jax.tree_util.tree_map(lambda *a: np.stack(a), *trees), "cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _rng(seed):
    return np.random.default_rng(seed)


def _tcfg(jcfg):
    return tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in fields(jcfg)
        if f.name not in ("param_dtype", "dtype")})


def _drawn(tree, seed, names=("q_norm", "kv_norm", "norm", "gate_attn",
                               "gate_ffn")):
    """``tree`` (numpy leaves) with the leaves that start at zero weight
    drawn uniform in [0.5, 1.5] from ``seed``: the scales of MLA's
    ``q_norm`` / ``kv_norm`` and of the Mamba block's gated ``norm``
    (applied with ``zero_centered=False``) and the cross-attention gates;
    leaves named in ``names`` or a ``scale`` under such a key."""
    r = _rng(seed)

    def draw(kp, a):
        keys = [getattr(k, "key", None) for k in kp]
        if keys[-1] in names or (keys[-1] == "scale" and keys[-2] in names):
            return r.uniform(0.5, 1.5, size=a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, _np(tree))


def _init(port_init, ref_init, seed):
    """The port's init at ``seed`` as numpy leaves, checked against the
    reference's init: the same tree, leaf shapes and dtypes (traced by
    ``jax.eval_shape``, not compiled: the reference's truncated-normal
    inits cost seconds of XLA compile apiece).  The weights then cross to
    the reference as they are."""
    p = interop.params_to_jax(port_init(torch.Generator().manual_seed(seed)))
    ref = jax.eval_shape(ref_init, jax.random.key(0))
    assert (jax.tree_util.tree_structure(p)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    return p


# ------------------------------------------------------------ configs
def _cfg_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in fields(cfg)}


@pytest.mark.parametrize("name", tconfigs.ARCH_IDS + ["lenet"])
def test_published_configs_match_the_reference(name):
    """Every field equal, dtypes mapped; the same for ``reduced()``; the
    public id and the module name resolve alike."""
    want, got = jconfigs.get_config(name), tconfigs.get_config(name)
    pairs = [(want, got)]
    if name != "lenet":
        pairs.append((want.reduced(), got.reduced()))
        assert tconfigs.get_config(tconfigs.ALIASES[name]) == got
    for j, t in pairs:
        jf, tf = _cfg_fields(j), _cfg_fields(t)
        assert jf.keys() == tf.keys()
        for k, v in jf.items():
            if k in ("param_dtype", "dtype"):
                assert _DTYPES[v] == tf[k], (name, k)
            else:
                assert v == tf[k], (name, k)
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs._ARCHS == jconfigs._ARCHS


# ------------------------------------------------------------ MoE
def _moe_cfg(case):
    cfg = replace(jconfigs.get_config(
        "arctic-480b" if case == "dense_residual" else "deepseek-v2-236b"
    ).reduced(d_model=64), n_experts=4, experts_top_k=2, moe_d_ff=48,
        d_ff=96)
    if case == "drops":
        cfg = replace(cfg, router_capacity_factor=0.5)
    return cfg


@lru_cache(maxsize=None)
def _j_moe(jcfg, impl):
    """The reference's MoE output, aux and capacity drops (the keep mask
    of its own ``_group_dispatch``)."""
    E, K = jcfg.n_experts, jcfg.experts_top_k

    def fn(p, x):
        y, aux = jmoe.moe_apply(p, x, cfg=jcfg, impl=impl)
        logits = x @ p["router"]["kernel"]
        idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)[1]
        C = max(K, int(x.shape[1] * K / E * jcfg.router_capacity_factor))
        keep = jax.vmap(lambda xg, eg: jmoe._group_dispatch(
            xg, None, eg, E, C)[1][3])(x, idx)
        return y, aux, jnp.sum(~keep)

    return jax.jit(fn)


@pytest.mark.parametrize("case,impl", [
    ("shared", "sort"), ("shared", "dense"), ("dense_residual", "sort"),
    ("drops", "sort"), ("tie", "sort"), ("tie", "dense")])
def test_moe_matches_reference(case, impl):
    """Sort and dense routes against the reference's: shared experts, the
    dense residual branch, capacity drops (factor 0.5), and an all-equal
    router (zero kernel: every token ties, top-K takes experts 0, 1)."""
    jcfg = _moe_cfg(case)
    p = _init(partial(tmoe.moe_init, _tcfg(jcfg)),
              partial(jmoe.moe_init, cfg=jcfg), 3)
    if case == "tie":
        p["router"]["kernel"] = np.zeros_like(p["router"]["kernel"])
    x = _rng(4).normal(size=(3, 12, 64)).astype(np.float32)
    want, want_aux, want_drops = _j_moe(jcfg, impl)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    tp, tx = _stack(p), torch.from_numpy(x)[None]
    got, aux = tmoe.moe_apply(tp, tx, cfg=_tcfg(jcfg), impl=impl)
    _close(got[0], want, 1e-5)
    _close(aux[0], want_aux, 1e-6)
    if impl == "sort":
        experts = tmoe.route(tp, tx, _tcfg(jcfg))[3]
        keep = tmoe._group_dispatch(tx[0], experts[0], jcfg.n_experts,
                                    tmoe.capacity(_tcfg(jcfg), 12))[1][-1]
        drops = (~keep).sum()
        assert int(drops) == int(want_drops)
        if case in ("drops", "tie"):
            assert int(drops) > 0
        assert torch.equal(got, tmoe.moe_apply(tp, tx, cfg=_tcfg(jcfg),
                                               impl=impl)[0])


def test_moe_aux_is_per_device_and_router_entropy_matches():
    """Two devices with their own weights and tokens: each device's output
    and aux equal the reference on that device alone, so aux is ``[D]``;
    the router entropy matches too."""
    jcfg = _moe_cfg("shared")
    ps = [_init(partial(tmoe.moe_init, _tcfg(jcfg)),
                partial(jmoe.moe_init, cfg=jcfg), k) for k in (5, 6)]
    xs = [_rng(s).normal(size=(2, 10, 64)).astype(np.float32)
          for s in (7, 8)]
    ref = _j_moe(jcfg, "sort")
    got, aux = tmoe.moe_apply(_stack(*ps), torch.from_numpy(np.stack(xs)),
                              cfg=_tcfg(jcfg))
    ent = tmoe.moe_router_entropy(_stack(*ps), torch.from_numpy(np.stack(xs)))
    assert aux.shape == (2,)
    for i, (p, x) in enumerate(zip(ps, xs)):
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        want, want_aux, _ = ref(jp, jnp.asarray(x))
        _close(got[i], want, 1e-5)
        _close(aux[i], want_aux, 1e-6)
        _close(ent[i], _jit(jmoe.moe_router_entropy)(jp, jnp.asarray(x)),
               1e-5)
    assert abs(float(aux[0]) - float(aux[1])) > 1e-6


# ------------------------------------------------------------ MLA
@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_mla_apply_matches(q_lora, impl):
    """The direct form with and without ``q_lora_rank``, norm scales drawn
    (they start at zero), on the plain core and the kernel route (its
    plain version on the CPU); the latents too."""
    jcfg = jconfigs.get_config("deepseek-v2-236b").reduced(d_model=128)
    if not q_lora:
        jcfg = replace(jcfg, q_lora_rank=None)
    p = _drawn(_init(partial(tmla.mla_init, _tcfg(jcfg)),
                     partial(jmla.mla_init, cfg=jcfg), 9), 10)
    x = _rng(11).normal(size=(2, 7, 128)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    want, (ckv, krope) = _jit(jmla.mla_apply, cfg=jcfg, impl="naive")(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        positions=jnp.asarray(pos))
    got, (tckv, tkrope) = tmla.mla_apply(
        _stack(p), torch.from_numpy(x)[None], cfg=_tcfg(jcfg),
        positions=torch.from_numpy(pos), impl=impl)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    _close(got[0], want, 1e-5)
    _close(tckv[0], ckv, 1e-5)
    _close(tkrope[0], krope, 1e-5)
    # the absorbed decode form (item 16b) on the prefill's latent cache
    cache = jmla.mla_cache_from_prefill(ckv, krope, max_len=8,
                                        dtype=jnp.float32)
    tcache = tmla.mla_cache_from_prefill(tckv, tkrope, max_len=8,
                                         dtype=torch.float32)
    x1 = _rng(12).normal(size=(2, 1, 128)).astype(np.float32)
    want1, _ = _jit(jmla.mla_decode, cfg=jcfg)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x1), cache,
        position=jnp.asarray(7, jnp.int32))
    got1, _ = tmla.mla_decode(_stack(p), torch.from_numpy(x1)[None], tcache,
                              cfg=_tcfg(jcfg), position=7)
    _close(got1[0], want1, 1e-5)


# ------------------------------------------------------------ RG-LRU
@pytest.fixture(scope="module")
def rglru_params():
    return _init(partial(trg.rglru_init, 24),
                 partial(jrg.rglru_init, width=24), 12)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches(rglru_params, with_state):
    p = rglru_params
    x = _rng(13).normal(size=(2, 37, 24)).astype(np.float32)
    h0 = _rng(14).normal(size=(2, 24)).astype(np.float32)
    kw = {"initial_state": jnp.asarray(h0)} if with_state else {}
    want, want_last = _jit(jrg.rglru_apply, return_state=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), **kw)
    tkw = {"initial_state": torch.from_numpy(h0)[None]} if with_state else {}
    got, last = trg.rglru_apply(_stack(p), torch.from_numpy(x)[None],
                                return_state=True, **tkw)
    _close(got[0], want, 1e-5)
    _close(last[0], want_last, 1e-5)


def test_rglru_step_matches_and_continues_the_scan(rglru_params):
    p = rglru_params
    x = _rng(15).normal(size=(2, 1, 24)).astype(np.float32)
    h = _rng(16).normal(size=(2, 24)).astype(np.float32)
    want, want_h = _jit(jrg.rglru_step)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(h))
    got, got_h = trg.rglru_step(_stack(p), torch.from_numpy(x)[None],
                                torch.from_numpy(h)[None])
    _close(got[0], want, 1e-5)
    _close(got_h[0], want_h, 1e-5)
    full = trg.rglru_apply(_stack(p), torch.from_numpy(x)[None],
                           initial_state=torch.from_numpy(h)[None])
    _close(full, got, 1e-6)


def test_rglru_init_decays_lie_in_range(rglru_params):
    """The port's Λ init gives decays ``exp(-8·softplus(Λ))`` in [0.9,
    0.999], as the reference's does, and the scan stays bounded over 200
    steps of constant input (the reference's test_rglru_decay_bounded)."""
    p = trg.rglru_init(4096, torch.Generator().manual_seed(0))
    for lam in (torch.from_numpy(rglru_params["lambda"]), p["lambda"]):
        a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
        assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(a.min()) < 0.91 and float(a.max()) > 0.99
    p16 = trg.rglru_init(16, torch.Generator().manual_seed(5))
    y = trg.rglru_apply(_stack(interop.params_to_jax(p16)),
                        torch.ones(1, 1, 200, 16))
    assert float(y.abs().max()) < 50.0


def test_recurrent_block_matches_with_conv_tail():
    jcfg = jconfigs.get_config("recurrentgemma-9b").reduced(d_model=64)
    p = _init(partial(trg.recurrent_block_init, _tcfg(jcfg)),
              partial(jrg.recurrent_block_init, cfg=jcfg), 17)
    for S in (2, 9):   # shorter and longer than the conv's W - 1 = 3
        x = _rng(S).normal(size=(2, S, 64)).astype(np.float32)
        want, cache = _jit(jrg.recurrent_block_apply, cfg=jcfg)(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
        got, tcache = trg.recurrent_block_apply(
            _stack(p), torch.from_numpy(x)[None], cfg=_tcfg(jcfg))
        _close(got[0], want, 1e-5)
        _close(tcache["conv"][0], cache["conv"], 1e-5)
        _close(tcache["state"][0], cache["state"], 1e-5)
    # the decode branch (item 16b) continues the S = 9 prefill's cache
    x1 = _rng(3).normal(size=(2, 1, 64)).astype(np.float32)
    want, cache = _jit(jrg.recurrent_block_apply, cfg=jcfg, decode=True)(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x1), cache=cache)
    got, tcache = trg.recurrent_block_apply(
        _stack(p), torch.from_numpy(x1)[None], cfg=_tcfg(jcfg), cache=tcache,
        decode=True)
    _close(got[0], want, 1e-5)
    _close(tcache["conv"][0], cache["conv"], 1e-5)
    _close(tcache["state"][0], cache["state"], 1e-5)


# ------------------------------------------------------------ cross-attn
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_cross_attention_matches(impl):
    """Gated, with the ``wo`` bias, Sq 5 against 11 image tokens, GQA."""
    jcfg = replace(jconfigs.get_config("llama-3.2-vision-11b").reduced(
        d_model=128), n_heads=4, n_kv_heads=2, head_dim=32, attn_bias=True)
    p = _drawn(_init(partial(tatt.cross_attn_init, _tcfg(jcfg)),
                     partial(jatt.cross_attn_init, cfg=jcfg, gated=True),
                     18), 19, names=("gate_attn", "bias"))
    x = _rng(20).normal(size=(2, 5, 128)).astype(np.float32)
    img = _rng(21).normal(size=(2, 11, 128)).astype(np.float32)
    want = _jit(jatt.cross_attn_apply, cfg=jcfg, impl="naive")(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        jnp.asarray(img))
    got = tatt.cross_attn_apply(_stack(p), torch.from_numpy(x)[None],
                                torch.from_numpy(img)[None], cfg=_tcfg(jcfg),
                                impl=impl)
    _close(got[0], want, 1e-5)


# ------------------------------------------------------------ decoder
ZOO = {"deepseek-v2": "deepseek-v2-236b", "arctic": "arctic-480b",
       "recurrentgemma": "recurrentgemma-9b",
       "llama-vision": "llama-3.2-vision-11b", "mamba2": "mamba2-1.3b"}


def _zoo_cfg(name):
    return jconfigs.get_config(ZOO[name]).reduced(d_model=128,
                                                  vocab_size=64)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_decoder_forward_matches(name):
    """Logits at 1e-5 and the per-device MoE aux at 1e-6, norm scales and
    gates drawn; llama-vision with image embeddings from the seed."""
    jcfg = _zoo_cfg(name)
    p = _drawn(_init(partial(tdec.decoder_init, _tcfg(jcfg)),
                     partial(jdec.decoder_init, cfg=jcfg), 22), 23)
    toks = _rng(24).integers(0, 64, size=(3, 8)).astype(np.int32)
    img = (_rng(25).normal(size=(3, jcfg.n_image_tokens, 128)).astype(
        np.float32) if "X" in jcfg.attn_pattern else None)
    want, _, want_aux = _jit(jdec.decoder_forward, cfg=jcfg, impl="naive")(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(toks),
        image_embeds=None if img is None else jnp.asarray(img))
    got, _, aux = tdec.decoder_forward(
        _stack(p), torch.from_numpy(toks)[None], cfg=_tcfg(jcfg),
        image_embeds=None if img is None else torch.from_numpy(img)[None],
        impl="pallas")
    _close(got[0], want, 1e-5)
    assert aux.shape == (1,)
    _close(aux[0], want_aux, 1e-6)
    assert (float(want_aux) > 0) == (jcfg.n_experts > 0)


# ------------------------------------------------------------ fused round
VOCAB, SEQ, D = 64, 8, 2
BUDGET = dict(initial_train=4, acquisitions=2, k_per_acquisition=2,
              pool_window=32, mc_samples=2, train_steps_per_acq=2,
              initial_train_steps=2)


def test_fused_lm_round_with_mla_moe_decoder_matches_reference():
    """One fused ``scenario="lm"`` round (RNG-free: dropout 0, the window
    covers every shard) of a tiny DeepSeek-V2 decoder (MLA, MoE with a
    shared expert, a dense first layer) against the reference's, with the
    MoE aux in the loss on both sides.  Bars of test_torch_lm_slice.py."""
    jm = replace(jconfigs.get_config("deepseek-v2-236b").reduced(
        d_model=64, vocab_size=VOCAB, max_seq_len=SEQ), dropout_rate=0.0)
    ja = JDecoderAdapter(jm, impl="naive")
    ta = DecoderLMAdapter(_tcfg(jm), impl="pallas")
    shards = lm_federated_split(D, 10, seq_len=SEQ, vocab=VOCAB, seed=0)
    test = make_lm_dataset(16, seq_len=SEQ, vocab=VOCAB, seed=5,
                           stream_seed=0)
    seed_set = make_lm_dataset(BUDGET["initial_train"], seq_len=SEQ,
                               vocab=VOCAB, seed=11, stream_seed=0)
    total = BUDGET["acquisitions"]

    cfg_j = j_lm_config(D, adapter=ja, **BUDGET)
    tr_j = JTrainer(cfg_j)
    p0 = _drawn(_init(ta.init, tr_j.init_params, 0), 26)
    eng_j = JEngine(tr_j, cfg_j, shards, seed_set, test,
                    total_acquisitions=total, unroll=False)
    st_j, recs_j, fin_j = eng_j.run_rounds_fused(
        eng_j.init_state(jax.tree_util.tree_map(jnp.asarray, p0)), 1)

    cfg_t = lm_config(D, adapter=ta, **BUDGET)
    eng_t = EdgeEngine(Trainer(cfg_t, device="cpu"), cfg_t, shards, seed_set,
                       test, total_acquisitions=total, device="cpu")
    st_t, recs_t, fin_t = eng_t.run_rounds_fused(
        eng_t.init_state(interop.params_from_jax(p0, "cpu")), 1)

    np.testing.assert_array_equal(recs_t["n_labeled"].numpy(),
                                  np.asarray(recs_j["n_labeled"]))
    np.testing.assert_array_equal(
        interop.vpool_to_jax(st_t.pool)["labeled_mask"],
        np.asarray(st_j.pool.labeled_mask))
    np.testing.assert_allclose(recs_t["weights"].numpy(),
                               np.asarray(recs_j["weights"]), atol=1e-6)
    for key in ("device_accs", "agg_acc"):
        np.testing.assert_allclose(recs_t[key].numpy(),
                                   np.asarray(recs_j[key]),
                                   atol=1 / len(test) + 1e-6)
    for got, want in ((fin_t, fin_j), (st_t.params, st_j.params)):
        got = jax.tree_util.tree_leaves(interop.params_to_jax(got))
        want = jax.tree_util.tree_leaves(_np(want))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-4)
