"""The LM modules of the port against the JAX package on the CPU: token
data, the model config, norms, embeddings, RoPE, MLPs, GQA attention, the
Mamba-2 SSD block, the decoder, and the two LM adapters' forwards.

Inputs come from numpy seeds and weights are carried across with
``repro_torch.interop``, so both sides compute on the same numbers.  The
port's functions take stacked ``[D, ...]`` params; the JAX side runs one
model, so the port's side runs it as ``D = 1`` (and the adapters at
``D = 2``, against the JAX forward of each device's model).  Tolerances:
data and configs exact; layer and block outputs 1e-5 absolute (float32,
summation order only); the SSD core 1e-4 (the reference's own
``tests/test_kernels.py`` bar for SSD, sums over a chunk of decayed
products); adapter logits 1e-5.
"""
from dataclasses import fields, replace
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.federated import lm_model_config as j_lm_model_config  # noqa: E402
from repro.core.model_adapter import DecoderLMAdapter as JDecoderAdapter  # noqa: E402
from repro.core.model_adapter import SSMAdapter as JSSMAdapter  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.decoder import decoder_forward as j_decoder_forward  # noqa: E402
from repro.models.decoder import decoder_init as j_decoder_init  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import embeddings as jemb  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import norms as jnorms  # noqa: E402
from repro.nn import rope as jrope  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import federated as tfed  # noqa: E402
from repro_torch.core.model_adapter import (DecoderLMAdapter,  # noqa: E402
                                            SSMAdapter, excluded_paths)
from repro_torch.data import lm as tlm  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.decoder import decoder_forward  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import embeddings as temb  # noqa: E402
from repro_torch.nn import layers as tlayers  # noqa: E402
from repro_torch.nn import norms as tnorms  # noqa: E402
from repro_torch.nn import rope as trope  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jit(fn, **static):
    """The reference function compiled once (eager JAX compiles every op
    on its own, which costs seconds at these sizes)."""
    return jax.jit(partial(fn, **static))


def _stack1(tree):
    """One JAX model's params → the port's stacked ``[1, ...]`` tree."""
    return interop.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a)[None], tree), "cpu")


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ data, config
@pytest.mark.parametrize("n,seq_len,vocab,seed,temp", [
    (0, 8, 64, 0, 1.0), (13, 8, 64, 3, 1.0), (9, 32, 256, 5, 1.3)])
def test_make_lm_dataset_byte_equal(n, seq_len, vocab, seed, temp):
    a = jlm.make_lm_dataset(n, seq_len=seq_len, vocab=vocab, seed=seed,
                            temperature=temp, stream_seed=seed + 1)
    b = tlm.make_lm_dataset(n, seq_len=seq_len, vocab=vocab, seed=seed,
                            temperature=temp, stream_seed=seed + 1)
    for x, y in ((a.images, b.images), (a.labels, b.labels)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


def test_lm_federated_split_and_batch_byte_equal():
    ja = jlm.lm_federated_split(5, 7, seq_len=8, vocab=64, seed=2)
    ta = tlm.lm_federated_split(5, 7, seq_len=8, vocab=64, seed=2)
    for a, b in zip(ja, ta, strict=True):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    for a, b in zip(jlm.synthetic_lm_batch(3, 9, 50, seed=4),
                    tlm.synthetic_lm_batch(3, 9, 50, seed=4)):
        np.testing.assert_array_equal(a, b)


def _cfg_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in fields(cfg)
            if f.name not in ("param_dtype", "dtype")}


@pytest.mark.parametrize("family,pattern", [("decoder", ("S",)),
                                            ("ssm", ("M",)),
                                            ("decoder", ("L", "S"))])
def test_model_config_and_reduced_match(family, pattern):
    j = JModelConfig(family=family, attn_pattern=pattern, sliding_window=512)
    t = tconfig.ModelConfig(family=family, attn_pattern=pattern,
                            sliding_window=512)
    assert _cfg_dict(j) == _cfg_dict(t)
    kw = dict(n_layers=3, d_model=128, vocab_size=77, max_seq_len=16)
    assert _cfg_dict(j.reduced(**kw)) == _cfg_dict(t.reduced(**kw))
    assert t.reduced(**kw).param_dtype == torch.float32
    assert _cfg_dict(j_lm_model_config(vocab=64, seq_len=8)) == \
        _cfg_dict(tfed.lm_model_config(vocab=64, seq_len=8))


def test_published_widths_match_the_reference():
    from repro.configs import mamba2_13b
    from repro_torch.configs import get_config
    assert _cfg_dict(mamba2_13b.config()) == \
        _cfg_dict(get_config("mamba2-1.3b"))
    assert get_config("mamba2-1.3b").param_dtype == torch.bfloat16
    lm = tconfig.lm_100m()
    assert (lm.n_layers, lm.d_model, lm.n_heads, lm.n_kv_heads,
            lm.resolved_head_dim, lm.d_ff, lm.vocab_size) == \
        (12, 640, 10, 5, 64, 2560, 32768)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("zero_centered", [True, False])
def test_rmsnorm_and_layernorm_match(zero_centered):
    x = _rng(0).normal(size=(2, 3, 16)).astype(np.float32)
    scale = _rng(1).normal(size=(16,)).astype(np.float32)
    bias = _rng(2).normal(size=(16,)).astype(np.float32)
    want = jnorms.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                jnp.asarray(x), zero_centered=zero_centered)
    got = tnorms.rmsnorm_apply({"scale": torch.from_numpy(scale)[None]},
                               torch.from_numpy(x)[None],
                               zero_centered=zero_centered)[0]
    _close(got, want, 1e-5)
    p = {"scale": scale, "bias": bias}
    want = jnorms.layernorm_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                  jnp.asarray(x))
    got = tnorms.layernorm_apply(_stack1(p), torch.from_numpy(x)[None])[0]
    _close(got, want, 1e-5)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_unembed_rope_match(scale):
    table = _rng(3).normal(size=(50, 32)).astype(np.float32)
    toks = _rng(4).integers(0, 50, size=(3, 7)).astype(np.int32)
    p = {"embedding": table}
    want = jemb.embed_apply(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(toks), scale=scale)
    got = temb.embed_apply(_stack1(p), torch.from_numpy(toks)[None],
                           scale=scale)[0]
    _close(got, want, 1e-6)
    h = _rng(5).normal(size=(3, 32)).astype(np.float32)
    _close(temb.unembed_apply(_stack1(p), torch.from_numpy(h)[None])[0],
           jemb.unembed_apply(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(h)), 1e-5)
    x = _rng(6).normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32) + 3
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos)), 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps_match(kind):
    key = jax.random.key(0)
    x = _rng(7).normal(size=(2, 5, 16)).astype(np.float32)
    if kind == "gelu":
        p = jlayers.mlp_gelu_init(key, 16, 24)
        want = jlayers.mlp_gelu_apply(p, jnp.asarray(x))
        got = tlayers.mlp_gelu_apply(_stack1(p), torch.from_numpy(x)[None])
    else:
        p = jlayers.mlp_init(key, 16, 24)
        want = jlayers.mlp_apply(p, jnp.asarray(x), activation=kind)
        got = tlayers.mlp_apply(_stack1(p), torch.from_numpy(x)[None],
                                activation=kind)
    _close(got[0], want, 1e-5)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("window,softcap", [(None, None), (3, None),
                                            (None, 20.0)])
def test_attention_core_matches(impl, window, softcap):
    B, S, H, Hkv, d = 2, 9, 4, 2, 64
    r = _rng(8)
    q, k, v = (r.normal(size=(B, S, h, d)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    pos = np.arange(S, dtype=np.int32)
    want = _jit(jatt.attention_core, window=window, softcap=softcap,
                impl="naive")(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos))
    got = tatt.attention_core(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              softcap=softcap, impl=impl)
    _close(got, want, 1e-5)


def _tiny_decoder(**kw):
    """The reference's tests/test_model_adapter.py decoder (1 layer,
    d_model 64, vocab 64, 8 tokens, dropout 0.1)."""
    base = dict(n_layers=1, d_model=64, vocab_size=64, max_seq_len=8)
    base.update(kw)
    cfg = JModelConfig(family="decoder").reduced(**base)
    return replace(cfg, dropout_rate=0.1)


def _to_torch_cfg(jcfg):
    return tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in fields(jcfg)
        if f.name not in ("param_dtype", "dtype")})


def test_gqa_apply_matches():
    jcfg = replace(_tiny_decoder(d_model=128), n_heads=4, n_kv_heads=2,
                   qk_norm=True, attn_bias=True)
    p = _jit(jatt.gqa_init, cfg=jcfg)(jax.random.key(1))
    x = _rng(9).normal(size=(3, 6, 128)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    want, _ = _jit(jatt.gqa_apply, cfg=jcfg, impl="naive")(
        p, jnp.asarray(x), positions=jnp.asarray(pos))
    got, _ = tatt.gqa_apply(_stack1(p), torch.from_numpy(x)[None],
                            cfg=_to_torch_cfg(jcfg),
                            positions=torch.from_numpy(pos), position=0,
                            impl="pallas")
    _close(got[0], want, 1e-5)


def test_blockwise_attention_raises():
    """The blockwise core (the reference's scan over KV blocks, ported in
    item 16b) runs: equal to the naive core within 1e-5 at a block that
    does not divide the keys."""
    r = _rng(30)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 11, h, 64))
                                .astype(np.float32)) for h in (4, 2, 2))
    for causal, window in ((True, None), (True, 4), (False, None)):
        got = tatt.attention_core(q, k, v, causal=causal, window=window,
                                  impl="blockwise", block_kv=4)
        want = tatt.attention_core(q, k, v, causal=causal, window=window,
                                   impl="naive")
        _close(got, want.numpy(), 1e-5)


# ------------------------------------------------------------ decoder
@pytest.mark.parametrize("variant", ["dense", "gemma_like"])
def test_decoder_forward_matches(variant):
    if variant == "dense":
        jcfg = _tiny_decoder(n_layers=2)
    else:  # local/global pattern, post-norms, softcaps, untied, GeGLU
        jcfg = replace(_tiny_decoder(n_layers=3), attn_pattern=("L", "S"),
                       sliding_window=3, use_post_norms=True,
                       attn_logit_softcap=30.0, final_logit_softcap=20.0,
                       tie_embeddings=False, scale_embeddings=True,
                       activation="geglu", residual_scale=0.7)
    p = _jit(j_decoder_init, cfg=jcfg)(jax.random.key(2))
    toks = _rng(10).integers(0, 64, size=(3, 8)).astype(np.int32)
    for last in (False, True):
        want, _, _ = _jit(j_decoder_forward, cfg=jcfg, impl="naive",
                          last_logit_only=last)(p, jnp.asarray(toks))
        got, _, aux = decoder_forward(_stack1(_np(p)),
                                      torch.from_numpy(toks)[None],
                                      cfg=_to_torch_cfg(jcfg), impl="pallas",
                                      last_logit_only=last)
        _close(got[0], want, 1e-5)
        assert float(aux) == 0.0


@pytest.mark.parametrize("what", ["caches", "x_without_image_embeds"])
def test_unported_decoder_families_raise(what):
    """The decode caches run (item 16b): a prefill and a decode step give
    the full forward's logits within 1e-5; every layer family is ported,
    and a cross-attention layer without image embeddings is a caller's
    error."""
    cfg = tconfig.ModelConfig(n_layers=1, d_model=64, n_heads=1, n_kv_heads=1)
    if what == "caches":
        p = _stack1(interop.params_to_jax(
            DecoderLMAdapter(cfg).init(torch.Generator().manual_seed(0))))
        toks = torch.from_numpy(_rng(31).integers(0, cfg.vocab_size,
                                                  size=(1, 2, 5)))
        full, _, _ = decoder_forward(p, toks, cfg=cfg)
        _, caches, _ = decoder_forward(p, toks[..., :4], cfg=cfg,
                                       collect_prefill_caches=True,
                                       max_cache_len=6,
                                       cache_dtype=torch.float32)
        got, same, _ = decoder_forward(p, toks[..., 4:], cfg=cfg,
                                       positions=4, caches=caches,
                                       decode=True)
        assert same is caches
        _close(got[0, :, 0], full[0, :, 4].numpy(), 1e-5)
        return
    cfg = replace(cfg, attn_pattern=("X",))
    adapter = DecoderLMAdapter(cfg)
    p = adapter.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="image_embeds"):
        adapter.apply(_stack1(interop.params_to_jax(p)),
                      torch.zeros(2, 4, dtype=torch.int32))


def test_interop_carries_lm_trees_and_adam_state():
    """The decoder's list-bearing tree, the SSM's recurrent state and the
    reference's Adam state cross to torch and back bit for bit, in the
    JAX package's leaf order."""
    from repro.optim import adam as j_adam
    for ja in (JDecoderAdapter(_tiny_decoder(n_layers=2)),
               JSSMAdapter(j_lm_model_config(vocab=64, seq_len=8))):
        p = jax.jit(ja.init)(jax.random.key(0))
        opt = j_adam(1e-3).init(p)
        for tree in (p, opt):
            ref = _np(tree)
            back = interop.params_to_jax(interop.params_from_jax(ref, "cpu"))
            for (kp, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                                  jax.tree_util.tree_leaves(back),
                                  strict=True):
                np.testing.assert_array_equal(a, b,
                                              err_msg=jax.tree_util.keystr(kp))


# ------------------------------------------------------------ SSM
def _ssd_inputs(b, s, h, p, g, n, seed):
    r = _rng(seed)
    x = r.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(r.normal(size=(h,))).astype(np.float32)
    B = r.normal(size=(b, s, g, n)).astype(np.float32)
    C = r.normal(size=(b, s, g, n)).astype(np.float32)
    st = r.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, st


@pytest.mark.parametrize("s,chunk", [(12, 16), (16, 16), (37, 16)])
@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_ssd_chunked_matches_including_short_chunk(s, chunk, impl):
    """s < chunk runs as one chunk of length s (the port's short-chunk
    rule) and must equal the reference's zero-padded chunk; s > chunk pads
    to whole chunks, here two chunks and a ragged tail."""
    args = _ssd_inputs(2, s, 4, 8, 2, 16, seed=s)
    ja = [jnp.asarray(a) for a in args]
    y_j, st_j = _jit(jssm.ssd_chunked, chunk=chunk)(*ja[:5],
                                                   initial_state=ja[5])
    ta = [torch.from_numpy(a) for a in args]
    y_t, st_t = tssm.ssd_chunked(*ta[:5], chunk=chunk, initial_state=ta[5],
                                 impl=impl)
    _close(y_t, y_j, 1e-4)
    _close(st_t, st_j, 1e-4)


def test_causal_conv1d_matches():
    x = _rng(11).normal(size=(2, 6, 10)).astype(np.float32)
    kern = _rng(12).normal(size=(4, 10)).astype(np.float32)
    bias = _rng(13).normal(size=(10,)).astype(np.float32)
    want, _ = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(kern),
                                 jnp.asarray(bias))
    got, _ = tssm.causal_conv1d(torch.from_numpy(x)[None],
                                torch.from_numpy(kern)[None],
                                torch.from_numpy(bias)[None])
    _close(got[0], want, 1e-5)


@pytest.mark.parametrize("S", [8, 20])
def test_mamba2_apply_matches(S):
    jcfg = j_lm_model_config(vocab=64, seq_len=32)
    jcfg = replace(jcfg, ssm_chunk=16)
    p = _jit(jssm.mamba2_init, cfg=jcfg)(jax.random.key(3))
    # a nonzero gated-norm scale, so the block's output is not all zero
    p["norm"]["scale"] = jnp.asarray(_rng(14).normal(size=p["norm"][
        "scale"].shape).astype(np.float32))
    x = _rng(15).normal(size=(2, S, 64)).astype(np.float32)
    _, H, P, N, _ = jssm.ssm_dims(jcfg)
    st = _rng(16).normal(size=(2, H, P, N)).astype(np.float32)
    want, wst = _jit(jssm.mamba2_apply, cfg=jcfg, return_state=True)(
        p, jnp.asarray(x), initial_state=jnp.asarray(st))
    for impl in ("ref", "pallas"):
        got, gst = tssm.mamba2_apply(
            _stack1(_np(p)), torch.from_numpy(x)[None], cfg=_to_torch_cfg(jcfg),
            initial_state=torch.from_numpy(st)[None], return_state=True,
            impl=impl)
        _close(got[0], want, 1e-4)
        _close(gst[0], wst, 1e-4)


# ------------------------------------------------------------ adapters
def _adapter_pair(kind, impl):
    if kind == "ssm":
        jcfg = j_lm_model_config(vocab=64, seq_len=8)
        return JSSMAdapter(jcfg), SSMAdapter(_to_torch_cfg(jcfg), impl=impl)
    jcfg = _tiny_decoder()
    return JDecoderAdapter(jcfg), DecoderLMAdapter(_to_torch_cfg(jcfg),
                                                    impl=impl)


@pytest.mark.parametrize("kind", ["ssm", "decoder"])
def test_adapter_forwards_match(kind):
    """Two devices' models, stacked: the port's forward of each row equals
    the JAX adapter's forward of that device's model (≤1e-5) on the kernel
    route and the plain one; shared and per-device inputs agree."""
    ja, ta = _adapter_pair(kind, "pallas")
    init, apply = jax.jit(ja.init), jax.jit(ja.apply)
    ps = [init(jax.random.key(i)) for i in (4, 5)]
    if kind == "ssm":   # a nonzero carried state and gated-norm scale
        for i, p in enumerate(ps):
            p["recurrent"]["state"] = jnp.asarray(_rng(20 + i).normal(
                size=p["recurrent"]["state"].shape).astype(np.float32) * 0.1)
            p["mamba"]["norm"]["scale"] = jnp.ones_like(
                p["mamba"]["norm"]["scale"])
    stacked = interop.params_from_jax(jax.tree_util.tree_map(
        lambda *ls: np.stack([np.asarray(a) for a in ls]), *ps), "cpu")
    x = _rng(17).integers(0, 64, size=(3, 8)).astype(np.int32)
    wants = [apply(p, jnp.asarray(x)) for p in ps]
    plain = "ref" if kind == "ssm" else "naive"
    for impl in ("pallas", plain):
        ta = replace(ta, impl=impl)
        shared = ta.apply(stacked, torch.from_numpy(x))
        per_dev = ta.apply(stacked, torch.from_numpy(np.stack([x, x])))
        assert shared.shape == (2, 3, 64)
        torch.testing.assert_close(shared, per_dev, atol=0, rtol=0)
        for d, want in enumerate(wants):
            _close(shared[d], want, 1e-5)
    assert ta.num_classes == ja.num_classes == 64


def test_excluded_paths_and_aggregate_mask():
    ta = SSMAdapter(_to_torch_cfg(j_lm_model_config(vocab=64, seq_len=8)))
    p = ta.init(torch.Generator().manual_seed(0))
    assert excluded_paths(ta, p) == ("recurrent/state",)
    dec = DecoderLMAdapter(_to_torch_cfg(_tiny_decoder(n_layers=2)))
    pd = dec.init(torch.Generator().manual_seed(0))
    assert excluded_paths(dec, pd) == ()
    # the port's tree has the reference's structure, leaf for leaf
    jp = jax.eval_shape(JDecoderAdapter(_tiny_decoder(n_layers=2)).init,
                        jax.random.key(0))
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in
              jax.tree_util.tree_leaves_with_path(jp)]
    jshapes = [np.shape(a) for a in jax.tree_util.tree_leaves(jp)]
    from repro_torch.tree import tree_items
    tshapes = [tuple(a.shape) for _, a in tree_items(pd)]
    assert len(jpaths) == len(tshapes) and jshapes == tshapes
