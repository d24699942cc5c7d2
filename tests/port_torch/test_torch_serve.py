"""Decode and serving of the port against the JAX package on the CPU: the
attention core's routes on positions and caches, the KV, latent and
recurrent caches, the decode steps of every layer family, prefill then
decode of six decoder families, and ``launch.serve``.

Inputs come from numpy seeds; weights from the port's inits, crossed to
the reference as numpy, with the leaves that
start at zero weight drawn from the seed (MLA's norms, the Mamba gated
norm, the cross-attention gates), as ``test_torch_zoo.py`` does.  The port
runs ``D = 1`` stacked params and caches; its cache leaves are the
reference's with that axis in front.

The reference's ``attention_core(impl="pallas")`` ignores positions and
is never given ``q_offset``, so its decode attends to key 0 alone
(ROADMAP.md Queue 3): the port's ``"pallas"`` decode (the kernel's plain
version on the CPU) is held against the reference's ``"naive"`` decode.

Tolerances: attention, caches, decode steps and decoder logits 1e-5
absolute in float32 (summation order only); with bfloat16 attention and
latent caches the logits within 2e-2 of the largest logit (the
reference's own bar, ``tests/test_arch_smoke.py``) and the caches at one
bfloat16 rounding (1e-2); decode against the port's own full forward
1e-5.  Every reference program is compiled once per module (``_jit``).
"""
from dataclasses import fields, replace
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.nn import attention as jatt  # noqa: E402
from repro.nn import mla as jmla  # noqa: E402
from repro.nn import rglru as jrg  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import mla as tmla  # noqa: E402
from repro_torch.nn import rglru as trg  # noqa: E402
from repro_torch.nn import ssm as tssm  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_map_with_path)

jax.config.update("jax_platform_name", "cpu")

ZERO_START = ("q_norm", "kv_norm", "norm", "gate_attn", "gate_ffn")


@lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(partial(fn, **dict(static)))


def _jit(fn, **static):
    """``fn`` compiled with ``static`` bound, one program per module."""
    return _jitted(fn, tuple(sorted(static.items())))


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def _tcfg(jcfg):
    return tconfig.ModelConfig(**{
        f.name: getattr(jcfg, f.name) for f in fields(jcfg)
        if f.name not in ("param_dtype", "dtype")})


def _params(port_init, seed):
    """The port's init at ``seed`` as numpy leaves, the zero-start leaves
    drawn uniform in [0.5, 1.5]."""
    r = _rng(seed + 1)

    def draw(path, a):
        a = a.detach().numpy()
        keys = path.split("/")
        if keys[-1] in ZERO_START or (keys[-1] == "scale"
                                      and keys[-2] in ZERO_START):
            return r.uniform(0.5, 1.5, size=a.shape).astype(a.dtype)
        return a

    return tree_map_with_path(draw, port_init(
        torch.Generator().manual_seed(seed)))


def _both(p):
    """Numpy params → (the reference's jnp tree, the port's [1, ...])."""
    return (jax.tree_util.tree_map(jnp.asarray, p),
            tree_map(lambda a: _t(a)[None], p))


def _leaves_close(port_tree, ref_tree, atol):
    """The port's ``[1, ...]`` cache tree leaf for leaf against the
    reference's: same leaf order and shapes, values within ``atol``."""
    got = [a[0] for a in tree_leaves(port_tree)]
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.float(), w, atol)


# ------------------------------------------------------------ the core
def _qkv(seed, B, Sq, Skv, H, Hkv, d):
    r = _rng(seed)
    return tuple(r.normal(size=s).astype(np.float32)
                 for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))


# (Sq, Skv, causal, window, softcap, positions): Skv 21 is not a multiple
# of block_kv 8; "ring" puts the keys at the positions of a wrapped ring
# of 21 slots after position 25, two slots empty (-1); "valid" adds a key
# mask
CORE_CASES = [
    (21, 21, True, None, None, "plain"),
    (21, 21, True, 5, 30.0, "plain"),
    (4, 21, False, None, 20.0, "valid"),
    (1, 21, True, 6, None, "ring"),
    (3, 21, True, None, None, "ring"),
]


def _core_positions(Sq, Skv, kind):
    q_pos = np.arange(Skv - Sq, Skv, dtype=np.int32)
    kv_pos = np.arange(Skv, dtype=np.int32)
    valid = None
    if kind == "ring":      # slot s holds s + 21 for s < 5, else s
        kv_pos = np.where(kv_pos < 5, kv_pos + 21, kv_pos).astype(np.int32)
        kv_pos[[3, 11]] = -1
        q_pos = np.arange(26 - Sq, 26, dtype=np.int32)
    if kind == "valid":
        valid = _rng(40).uniform(size=Skv) > 0.3
    return q_pos, kv_pos, valid


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("case", CORE_CASES)
def test_attention_core_routes_match_reference(impl, case):
    """``naive`` and ``blockwise`` (``block_kv`` 8) against the
    reference's routes on the same positions, key mask, window and
    softcap, within 1e-5."""
    Sq, Skv, causal, window, softcap, kind = case
    q, k, v = _qkv(41, 2, Sq, Skv, 4, 2, 32)
    q_pos, kv_pos, valid = _core_positions(Sq, Skv, kind)
    kw = dict(causal=causal, window=window, softcap=softcap, impl=impl,
              block_kv=8)
    want = _jit(jatt.attention_core, **kw)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
        kv_valid=None if valid is None else jnp.asarray(valid))
    got = tatt.attention_core(_t(q), _t(k), _t(v), q_pos=_t(q_pos),
                              kv_pos=_t(kv_pos),
                              kv_valid=None if valid is None else _t(valid),
                              **kw)
    _close(got, want, 1e-5)


def _ref_decode_attention(cache, q, position, window, softcap):
    """The reference's naive core on a reference cache at ``position``."""
    return _jit(jatt.attention_core, causal=True, window=window,
                softcap=softcap, impl="naive")(
        jnp.asarray(q), cache["k"], cache["v"],
        q_pos=jnp.asarray([position], jnp.int32), kv_pos=cache["pos"])


@pytest.mark.parametrize("kind,positions", [
    ("full", (9, 10)), ("ring", (5, 6, 7)), ("ring", (8, 9))])
def test_pallas_decode_matches_reference_naive(kind, positions):
    """The kernel route's position mapping (its plain version here) on a
    full cache and on a ring before it wraps (positions 5-7 of a window
    of 8) and after (8, 9: no causality, every slot), against the
    reference's naive decode; the caches leaf for leaf."""
    B, Hkv, H, hd, W, max_len = 2, 2, 4, 32, 8, 12
    window = W if kind == "ring" else None
    S = positions[0]
    r = _rng(42)
    k0, v0 = (r.normal(size=(B, S, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    jc = jatt.cache_from_prefill(jnp.asarray(k0), jnp.asarray(v0),
                                 kind=kind, max_len=max_len, window=window,
                                 dtype=jnp.float32)
    tc = tatt.cache_from_prefill(_t(k0), _t(v0), kind=kind, max_len=max_len,
                                 window=window, dtype=torch.float32)
    for pos in positions:
        q, k1, v1 = _qkv(pos, B, 1, 1, H, Hkv, hd)
        jc = jatt.cache_update_decode(jc, jnp.asarray(k1), jnp.asarray(v1),
                                      jnp.asarray(pos, jnp.int32))
        tatt.cache_update_decode(tc, _t(k1), _t(v1), pos)
        want = _ref_decode_attention(jc, q, pos, window, 25.0)
        got = tatt.attention_core(_t(q), tc["k"], tc["v"], causal=True,
                                  window=window, softcap=25.0, impl="pallas",
                                  decode_position=pos)
        _close(got, want, 1e-5)
        _leaves_close(tree_map(lambda a: a[None], tc), jc, 0.0)


def test_pallas_refuses_positions_it_cannot_map():
    """Tensors of positions, a key mask, a decode of several queries and a
    wrapped cache longer than the window raise ``ValueError``; nothing
    falls back to the plain version."""
    q, k, v = (_t(a) for a in _qkv(43, 1, 1, 8, 2, 2, 32))
    pos = torch.arange(8, dtype=torch.int32)
    bad = [dict(kv_pos=pos), dict(kv_valid=pos >= 0, decode_position=3),
           dict(decode_position=9, window=4)]
    for kw in bad:
        with pytest.raises(ValueError):
            tatt.attention_core(q, k, v, impl="pallas", **kw)
    with pytest.raises(ValueError):
        tatt.attention_core(_t(_qkv(44, 1, 2, 8, 2, 2, 32)[0]), k, v,
                            impl="pallas", decode_position=3)


# ------------------------------------------------------------ caches
@pytest.mark.parametrize("kind,S", [("full", 5), ("ring", 5), ("ring", 11)])
def test_caches_match_reference_leaf_for_leaf(kind, S):
    """``init_cache``, ``cache_from_prefill`` (a ring with S below and
    above the window 8) and two ``cache_update_decode`` steps, in
    bfloat16 (the default) and float32: equal leaves."""
    B, Hkv, hd, W, max_len = 2, 2, 16, 8, 14
    window = W if kind == "ring" else None
    r = _rng(45)
    k, v = (r.normal(size=(B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float32, torch.float32)):
        _leaves_close(
            tree_map(lambda a: a[None], tatt.init_cache(
                B, max_len, Hkv, hd, kind=kind, window=window, dtype=td)),
            jatt.init_cache(B, max_len, Hkv, hd, kind=kind, window=window,
                            dtype=jd), 0.0)
        jc = jatt.cache_from_prefill(jnp.asarray(k), jnp.asarray(v),
                                     kind=kind, max_len=max_len,
                                     window=window, dtype=jd)
        tc = tatt.cache_from_prefill(_t(k)[None], _t(v)[None], kind=kind,
                                     max_len=max_len, window=window,
                                     dtype=td)
        _leaves_close(tc, jc, 0.0)
        for pos in (S, S + 1):
            k1, v1 = (r.normal(size=(B, 1, Hkv, hd)).astype(np.float32)
                      for _ in range(2))
            jc = jatt.cache_update_decode(jc, jnp.asarray(k1),
                                          jnp.asarray(v1),
                                          jnp.asarray(pos, jnp.int32))
            assert tatt.cache_update_decode(tc, _t(k1)[None], _t(v1)[None],
                                            pos) is tc
            _leaves_close(tc, jc, 0.0)


# ------------------------------------------------------------ decode steps
def test_ssd_step_matches():
    r = _rng(46)
    b, h, p, g, n = 3, 4, 8, 2, 16
    x = r.normal(size=(b, h, p)).astype(np.float32)
    dt = r.uniform(0.01, 0.1, size=(b, h)).astype(np.float32)
    A = -r.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    B_, C_ = (r.normal(size=(b, g, n)).astype(np.float32) for _ in range(2))
    st = r.normal(size=(b, h, p, n)).astype(np.float32)
    want, want_st = _jit(jssm.ssd_step)(*map(jnp.asarray,
                                              (x, dt, A, B_, C_, st)))
    got, got_st = tssm.ssd_step(*map(_t, (x, dt, A, B_, C_, st)))
    _close(got, want, 1e-5)
    _close(got_st, want_st, 1e-5)


def _mamba_cfg():
    return jconfigs.get_config("mamba2-1.3b").reduced(d_model=64)


def test_mamba2_decode_matches_over_three_steps():
    """A prefill of 5 tokens (``return_cache``) then three
    ``mamba2_decode`` steps, outputs and the conv / state cache."""
    jcfg = _mamba_cfg()
    jp, tp = _both(_params(partial(tssm.mamba2_init, _tcfg(jcfg)), 47))
    r = _rng(48)
    x = r.normal(size=(2, 5, 64)).astype(np.float32)
    want, jc = _jit(jssm.mamba2_apply, cfg=jcfg, return_cache=True)(
        jp, jnp.asarray(x))
    got, tc = tssm.mamba2_apply(tp, _t(x)[None], cfg=_tcfg(jcfg),
                                return_cache=True)
    _close(got[0], want, 1e-5)
    _leaves_close(tc, jc, 1e-5)
    for _ in range(3):
        x1 = r.normal(size=(2, 1, 64)).astype(np.float32)
        want, jc = _jit(jssm.mamba2_decode, cfg=jcfg)(jp, jnp.asarray(x1),
                                                       jc)
        got, tc2 = tssm.mamba2_decode(tp, _t(x1)[None], tc, cfg=_tcfg(jcfg))
        assert tc2 is tc
        _close(got[0], want, 1e-5)
        _leaves_close(tc, jc, 1e-5)


def test_recurrent_block_and_mla_decode_from_empty_caches():
    """Three decode steps of the recurrent block from
    ``recurrent_block_init_cache`` and of MLA's absorbed form from
    ``mla_init_cache`` (float32), outputs and caches."""
    r = _rng(49)
    jrc = jconfigs.get_config("recurrentgemma-9b").reduced(d_model=64)
    jp, tp = _both(_params(partial(trg.recurrent_block_init, _tcfg(jrc)), 50))
    jc = jrg.recurrent_block_init_cache(2, jrc)
    tc = tree_map(lambda a: a[None], trg.recurrent_block_init_cache(
        2, _tcfg(jrc)))
    _leaves_close(tc, jc, 0.0)
    for _ in range(3):
        x1 = r.normal(size=(2, 1, 64)).astype(np.float32)
        want, jc = _jit(jrg.recurrent_block_apply, cfg=jrc, decode=True)(
            jp, jnp.asarray(x1), cache=jc)
        got, _ = trg.recurrent_block_apply(tp, _t(x1)[None], cfg=_tcfg(jrc),
                                           cache=tc, decode=True)
        _close(got[0], want, 1e-5)
        _leaves_close(tc, jc, 1e-5)

    jmc = jconfigs.get_config("deepseek-v2-236b").reduced(d_model=128)
    jp, tp = _both(_params(partial(tmla.mla_init, _tcfg(jmc)), 51))
    jc = jmla.mla_init_cache(2, 6, jmc, dtype=jnp.float32)
    tc = tree_map(lambda a: a[None], tmla.mla_init_cache(
        2, 6, _tcfg(jmc), dtype=torch.float32))
    for pos in range(3):
        x1 = r.normal(size=(2, 1, 128)).astype(np.float32)
        want, jc = _jit(jmla.mla_decode, cfg=jmc)(
            jp, jnp.asarray(x1), jc, position=jnp.asarray(pos, jnp.int32))
        got, _ = tmla.mla_decode(tp, _t(x1)[None], tc, cfg=_tcfg(jmc),
                                 position=pos)
        _close(got[0], want, 1e-5)
        _leaves_close(tc, jc, 1e-5)


# ------------------------------------------------------------ decoders
# family → (published config, changes after reduced(d_model=128, vocab 64))
FAMILIES = {
    "dense_gqa": ("qwen3-8b", dict(n_heads=4, n_kv_heads=2, head_dim=32)),
    "gemma_local_global": ("gemma2-2b", dict(sliding_window=4)),
    # capacity for every token, so the full forward drops none either
    "mla_moe": ("deepseek-v2-236b", dict(router_capacity_factor=8.0)),
    "rglru": ("recurrentgemma-9b", {}),
    "mamba2": ("mamba2-1.3b", {}),
    "vision": ("llama-3.2-vision-11b", {}),
}
VOCAB, PROMPT, STEPS = 64, 3, 6


def _family(name):
    arch, changes = FAMILIES[name]
    return replace(jconfigs.get_config(arch).reduced(
        d_model=128, vocab_size=VOCAB), **changes)


def _ref_prefill(jcfg, cache_dtype, max_len):
    return _jit(jdec.decoder_forward, cfg=jcfg, collect_prefill_caches=True,
                max_cache_len=max_len, cache_dtype=cache_dtype,
                last_logit_only=True, impl="naive")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_prefill_then_decode_matches_reference(name, cache_dtype):
    """Prefill 3 tokens, then 6 decode steps (a window of 4 wraps its ring
    at the second), the same tokens on both sides: logits and caches
    against the reference's after every step.  Float32 caches: 1e-5, the
    port on the kernel route (its plain version), and decode equal to the
    port's own full forward within 1e-5; bfloat16 caches: 2e-2 of the
    largest logit, the port on the naive route."""
    jcfg = _family(name)
    tcfg = _tcfg(jcfg)
    jd, td = ((jnp.float32, torch.float32) if cache_dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    impl = "pallas" if cache_dtype == "float32" else "naive"
    jp, tp = _both(_params(partial(tdec.decoder_init, tcfg), 52))
    toks = _rng(53).integers(0, VOCAB, size=(2, PROMPT + STEPS)).astype(
        np.int32)
    img = (_rng(54).normal(size=(2, jcfg.n_image_tokens, 128)).astype(
        np.float32) if "X" in jcfg.attn_pattern else None)
    jimg = None if img is None else jnp.asarray(img)
    timg = None if img is None else _t(img)[None]
    max_len = PROMPT + STEPS + 1

    def check(got, want):
        if cache_dtype == "float32":
            _close(got, want, 1e-5)
        else:
            assert _rel(got, want) < 2e-2

    want, jc, _ = _ref_prefill(jcfg, jd, max_len)(
        jp, jnp.asarray(toks[:, :PROMPT]), image_embeds=jimg)
    got, tc, _ = tdec.decoder_forward(
        tp, _t(toks[:, :PROMPT])[None], cfg=tcfg, image_embeds=timg,
        collect_prefill_caches=True, max_cache_len=max_len, cache_dtype=td,
        last_logit_only=True, impl=impl)
    check(got[0], want)
    _leaves_close(tc, jc, 1e-5 if cache_dtype == "float32" else 1e-2)
    steps = [got[0, :, 0]]
    decode = _jit(jdec.decoder_forward, cfg=jcfg, decode=True, impl="naive")
    for i in range(STEPS):
        pos = PROMPT + i
        want, jc, _ = decode(jp, jnp.asarray(toks[:, pos:pos + 1]),
                             positions=jnp.asarray([pos], jnp.int32),
                             caches=jc, image_embeds=jimg)
        got, same, _ = tdec.decoder_forward(
            tp, _t(toks[:, pos:pos + 1])[None], cfg=tcfg, positions=pos,
            caches=tc, decode=True, image_embeds=timg, impl=impl)
        assert same is tc
        check(got[0], want)
        _leaves_close(tc, jc, 1e-5 if cache_dtype == "float32" else 1e-2)
        steps.append(got[0, :, 0])
    if cache_dtype == "float32":   # the port's own invariant
        full, _, _ = tdec.decoder_forward(tp, _t(toks)[None], cfg=tcfg,
                                          image_embeds=timg, impl="naive")
        _close(torch.stack(steps, dim=1),
               full[0, :, PROMPT - 1:PROMPT + STEPS], 1e-5)


# ------------------------------------------------------------ the API
def test_model_api_decode_step_takes_a_tensor_position():
    """``build_model``'s prefill and decode_step on one model (no device
    axis), ``position`` as a 0-dim tensor, ``caches_init``'s tree equal to
    the reference's; the same for the encoder-decoder family (whisper,
    frames from the seed)."""
    jcfg = _family("gemma_local_global")
    model = build_model(_tcfg(jcfg))
    params = model.init(torch.Generator().manual_seed(55))
    toks = torch.from_numpy(_rng(56).integers(0, VOCAB, size=(2, 5)))
    _leaves_close(tree_map(lambda a: a[None], model.caches_init(2, 8)),
                  jdec.decoder_caches_init(jcfg, 2, 8), 0.0)
    full, aux = model.apply(params, toks)
    assert full.shape == (2, 5, VOCAB) and float(aux) == 0.0
    last, caches = model.prefill(params, toks[:, :4], max_cache_len=8,
                                 cache_dtype=torch.float32, impl="pallas")
    logits, same = model.decode_step(params, toks[:, 4:], caches,
                                     position=torch.tensor(4), impl="pallas")
    assert same is caches
    _close(last[:, 0], full[:, 3], 1e-5)
    _close(logits[:, 0], full[:, 4], 1e-5)
    wcfg = get_config("whisper-small").reduced(vocab_size=VOCAB)
    model = build_model(wcfg)
    params = model.init(torch.Generator().manual_seed(57))
    extras = {"frames": torch.from_numpy(_rng(58).normal(
        size=(2, wcfg.encoder_seq_len, wcfg.d_model)).astype(np.float32))}
    full, aux = model.apply(params, toks, extras=extras)
    assert full.shape == (2, 5, VOCAB) and float(aux) == 0.0
    last, caches = model.prefill(params, toks[:, :3], extras=extras,
                                 max_cache_len=8, cache_dtype=torch.float32,
                                 impl="pallas")
    _close(last[:, 0], full[:, 2], 1e-5)
    for k in (3, 4):
        logits, same = model.decode_step(params, toks[:, k:k + 1], caches,
                                         position=torch.tensor(k),
                                         extras=extras, impl="pallas")
        assert same is caches
        _close(logits[:, 0], full[:, k], 1e-5)


def test_serve_on_the_cpu(capsys, monkeypatch):
    """``serve`` of a reduced config returns ``batch × max_new_tokens``
    tokens in range; greedy decoding picks the same tokens on the kernel
    route and the naive one, and teacher-forcing with its own tokens
    repeats its logits within 1e-5; ``main`` runs on the card (it raises
    without one) and prints the reference's report."""
    from repro_torch.launch import serve as serve_mod
    kw = dict(batch=2, prompt_len=6, max_new_tokens=4, device="cpu",
              keep_logits=True, dtype=torch.float32)
    a = serve("gemma2-2b", impl="pallas", **kw)
    b = serve("gemma2-2b", impl="naive", forced=a.tokens, **kw)
    assert a.tokens.shape == (2, 4) and a.logits.shape == (2, 4, 512)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < 512
    assert torch.equal(a.tokens, b.tokens)
    _close(b.logits, a.logits, 1e-5)
    assert a.max_cache_len == 11 and a.tokens_per_s > 0
    c = serve("llama-3.2-vision-11b", batch=2, prompt_len=4,
              max_new_tokens=3, temperature=1.0, device="cpu")
    assert c.tokens.shape == (2, 3) and int(c.tokens.max()) < 512
    argv = ["--arch", "mamba2-1.3b", "--max-new-tokens", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_main(argv)
    monkeypatch.setattr(serve_mod, "serve", partial(serve, device="cpu"))
    assert serve_main(argv) == 0
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b (reduced) batch=4 prompt=32" in out
    assert "tok/s" in out and "request 1:" in out
