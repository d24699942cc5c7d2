"""The encoder-decoder family of the port (``repro_torch.models.whisper``,
the whisper half of ``models.api``, the sinusoidal and learned positions)
against the JAX package on the CPU, at ``get_config("whisper-small")
.reduced()``: 2 + 2 layers, d_model 256, 4 heads of 64, vocab 512,
float32.

Weights come from the port's init, whose tree, shapes and dtypes are
checked against the reference's (``jax.eval_shape``), and cross as numpy
(``repro_torch.interop``).  Every bias and every LayerNorm scale and bias
starts at 0 or 1 in both packages, where a port that dropped one would
still agree: the tests draw them from the seed first.  The port runs
``D = 1`` stacked params and caches; its cache leaves are the
reference's with that axis in front.

The reference passes no ``impl``, so its whisper attention is always the
naive core (at most 2048 keys, or a single query): the port's kernel
route (the kernel's plain version on the CPU) and its naive route are
both held against it.

Tolerances: the sinusoidal table bit-equal; encoder states, logits and
float32 caches 1e-5 absolute (summation order only); with bfloat16 caches
the logits within 2e-2 of the largest logit and the caches at one
bfloat16 rounding (``_cache_bar``), the bars of ``test_torch_serve.py``; decode
against the port's own full forward 1e-5.  Every reference program is
compiled once per module (``_jit``).
"""
from dataclasses import replace
from functools import lru_cache, partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.nn import embeddings as jemb  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import whisper as tW  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.nn import attention as tatt  # noqa: E402
from repro_torch.nn import embeddings as temb  # noqa: E402
from repro_torch.tree import (tree_leaves, tree_map,  # noqa: E402
                              tree_map_with_path)

jax.config.update("jax_platform_name", "cpu")

JCFG = jconfigs.get_config("whisper-small").reduced()
TCFG = get_config("whisper-small").reduced()
B, PROMPT, STEPS = 2, 5, 3
S_ENC = JCFG.encoder_seq_len
MAX_LEN = PROMPT + STEPS + 1
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(partial(fn, **dict(static)))


def _jit(fn, **static):
    """``fn`` compiled with ``static`` bound, one program per module."""
    return _jitted(fn, tuple(sorted(static.items())))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _leaves_close(port_tree, ref_tree, atol, rtol=0.0):
    """The port's ``[1, ...]`` tree leaf for leaf against the reference's:
    the same leaf order and shapes, values within ``atol + rtol ·
    |want|``."""
    got = [a[0] for a in tree_leaves(port_tree)]
    want = jax.tree_util.tree_leaves(ref_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.float(), w, atol, rtol)


def _cache_bar(f32):
    """(atol, rtol) of a cache leaf: 1e-5 in float32; in bfloat16 one
    rounding step, 1e-2 (``test_torch_serve.py``'s bar) or 2^-7 of the
    value, which is a step above 1 (the drawn norms and biases take
    entries past 2, where a float32 difference of 1e-7 can round to the
    other side)."""
    return (1e-5, 0.0) if f32 else (1e-2, 2.0 ** -7)


def _init_tree(tcfg, jcfg, seed):
    """The port's init, its tree, shapes and dtypes checked against
    ``jax.eval_shape`` of the reference's init."""
    p = tW.whisper_init(tcfg, torch.Generator().manual_seed(seed))
    ref = jax.eval_shape(partial(jW.whisper_init, cfg=jcfg),
                         jax.random.key(0))
    assert (jax.tree_util.tree_structure(p)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(ref)):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype) == f"torch.{b.dtype.name}"
    return p


@lru_cache(maxsize=None)
def _params():
    """(the reference's jnp tree, the port's ``[1, ...]`` tree): the
    port's init at seed 60, every bias drawn normal(0, 0.1) and every
    LayerNorm scale uniform in [0.5, 1.5] (both start at 0 or 1)."""
    r = np.random.default_rng(61)

    def draw(path, a):
        name = path.split("/")[-1]
        if name == "bias":
            return r.normal(scale=0.1, size=a.shape).astype(a.dtype)
        if name == "scale":
            return r.uniform(0.5, 1.5, size=a.shape).astype(a.dtype)
        return a

    p = tree_map_with_path(draw, interop.params_to_jax(
        _init_tree(TCFG, JCFG, 60)))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            tree_map(lambda a: a[None], interop.params_from_jax(p, "cpu")))


@lru_cache(maxsize=None)
def _inputs():
    """(frames [B, S_enc, d], tokens [B, PROMPT + STEPS]) from seed 62."""
    r = np.random.default_rng(62)
    frames = r.normal(size=(B, S_ENC, JCFG.d_model)).astype(np.float32)
    toks = r.integers(0, JCFG.vocab_size, size=(B, PROMPT + STEPS))
    return frames, toks.astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))[None]


@lru_cache(maxsize=None)
def _ref_encode():
    jp, _ = _params()
    return _jit(jW.encode, cfg=JCFG)(jp, jnp.asarray(_inputs()[0]))


@lru_cache(maxsize=None)
def _ref_decode(cache_dtype):
    """The reference's prefill of PROMPT tokens, then STEPS decode steps:
    ``[(logits, caches as numpy)]``, the prefill first."""
    jp, _ = _params()
    frames, toks = _inputs()
    jd = DTYPES[cache_dtype][0]
    logits, caches = _jit(jW.prefill, cfg=JCFG, max_cache_len=MAX_LEN,
                          cache_dtype=jd)(
        jp, jnp.asarray(toks[:, :PROMPT]), jnp.asarray(frames))
    out = [(np.asarray(logits), jax.tree_util.tree_map(np.asarray, caches))]
    step = _jit(jW.decode_step, cfg=JCFG)
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = step(jp, jnp.asarray(toks[:, pos:pos + 1]), caches,
                              position=jnp.asarray(pos, jnp.int32))
        out.append((np.asarray(logits),
                    jax.tree_util.tree_map(np.asarray, caches)))
    return out


# ------------------------------------------------------------ positions
@pytest.mark.parametrize("seq_len,dim", [(64, 256), (1500, 768), (7, 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_bit_equal(seq_len, dim, dtype):
    jd, td = DTYPES[dtype]
    want = np.asarray(jemb.sinusoidal_positions(seq_len, dim, dtype=jd)
                      .astype(jnp.float32))
    got = temb.sinusoidal_positions(seq_len, dim, dtype=td)
    assert got.shape == (seq_len, dim) and got.dtype == td
    assert np.array_equal(got.float().numpy(), want)


def test_learned_positions_init_draws_normal_002():
    p = temb.learned_positions_init(4000, 64, torch.Generator().manual_seed(3),
                                    dtype=torch.bfloat16)["embedding"]
    assert p.shape == (4000, 64) and p.dtype == torch.bfloat16
    assert abs(float(p.float().std()) - 0.02) < 5e-4
    assert abs(float(p.float().mean())) < 5e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_init_tree_matches_reference(dtype):
    """The same paths, shapes and dtypes as the reference's init, with the
    config's param dtype (bfloat16 at the published config): the
    LayerNorms and the MLPs stay float32 in both."""
    jd, td = DTYPES[dtype]
    p = _init_tree(replace(TCFG, param_dtype=td),
                   replace(JCFG, param_dtype=jd), 63)
    assert p["embed"]["embedding"].dtype == td
    assert p["decoder"]["mlp"]["wi"]["kernel"].dtype == torch.float32
    assert "bias" not in p["encoder"]["attn"]["wk"]
    assert p["dec_pos"]["embedding"].shape == (JCFG.max_seq_len,
                                               JCFG.d_model)


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("impl", ["pallas", "naive", "blockwise"])
def test_encode_matches_reference(impl):
    _, tp = _params()
    got = tW.encode(tp, _t(_inputs()[0]), cfg=TCFG, impl=impl)
    assert got.shape == (1, B, S_ENC, JCFG.d_model)
    _close(got[0], _ref_encode(), 1e-5)


@pytest.mark.parametrize("impl", ["pallas", "naive", "blockwise"])
def test_decode_train_matches_reference(impl):
    jp, tp = _params()
    toks = _inputs()[1]
    want = _jit(jW.decode_train, cfg=JCFG)(jp, jnp.asarray(toks),
                                          _ref_encode())
    got = tW.decode_train(tp, _t(toks), _t(np.asarray(_ref_encode())),
                          cfg=TCFG, impl=impl)
    assert got.shape == (1, B, PROMPT + STEPS, JCFG.vocab_size)
    _close(got[0], want, 1e-5)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "naive"])
def test_prefill_then_decode_matches_reference(impl, cache_dtype):
    """Prefill 5 tokens against 64 frames, then 3 decode steps, the same
    tokens on both sides: the last logits and every cache leaf (``self``
    k, v and pos, ``ck``, ``cv``) after the prefill and after every step;
    the prefill's logits at 1e-5 with either cache dtype.
    A step writes into the tree it is given and keeps the cross caches
    as they are."""
    frames, toks = _inputs()
    _, tp = _params()
    f32 = cache_dtype == "float32"
    ref = _ref_decode(cache_dtype)

    def check(got, want):
        if f32:
            _close(got, want, 1e-5)
        else:
            assert _rel(got, want) < 2e-2

    logits, caches = tW.prefill(tp, _t(toks[:, :PROMPT]), _t(frames),
                                cfg=TCFG, max_cache_len=MAX_LEN,
                                cache_dtype=DTYPES[cache_dtype][1],
                                impl=impl)
    assert logits.shape == (1, B, 1, JCFG.vocab_size)
    # the prefill attends to its keys and values as computed, not to the
    # rounded caches: 1e-5 whatever the cache dtype
    _close(logits[0], ref[0][0], 1e-5)
    _leaves_close(caches, ref[0][1], *_cache_bar(f32))
    ck = caches["ck"].clone()
    for i in range(STEPS):
        pos = PROMPT + i
        logits, same = tW.decode_step(tp, _t(toks[:, pos:pos + 1]), caches,
                                      cfg=TCFG, position=pos, impl=impl)
        assert same is caches
        check(logits[0], ref[i + 1][0])
        _leaves_close(caches, ref[i + 1][1], *_cache_bar(f32))
    assert torch.equal(caches["ck"], ck)


@lru_cache(maxsize=None)
def _bf16_params():
    """The drawn weights of ``_params`` at the published dtype: each leaf
    cast to its dtype in the reference's bfloat16 init (``BF16`` configs),
    the same values on both sides."""
    jp, tp = _params()
    shapes = jax.eval_shape(partial(jW.whisper_init, cfg=JBF16),
                            jax.random.key(0))
    jp = jax.tree_util.tree_map(lambda a, s: a.astype(s.dtype), jp, shapes)
    return jp, tree_map(lambda a, s: a.to(DTYPES[s.dtype.name][1]), tp,
                        shapes)


JBF16 = replace(JCFG, param_dtype=jnp.bfloat16, dtype=jnp.bfloat16)
TBF16 = replace(TCFG, param_dtype=torch.bfloat16, dtype=torch.bfloat16)


@pytest.mark.parametrize("impl", ["pallas", "naive"])
def test_bfloat16_model_matches_reference(impl):
    """The published dtype end to end: bfloat16 weights (each leaf of the
    reference's bfloat16 tree, LayerNorms included, in its own dtype),
    activations and caches.  The encoder states, then a prefill of 5
    tokens against 64 frames and 3 decode steps, the same tokens on both
    sides: the states, the prefill's last logits and every step's within
    2e-2 of the largest value (the
    reference's own bfloat16 bar, ``tests/test_arch_smoke.py``: the
    port's naive route rounds P·V once where the reference rounds P
    first), and the states, logits and caches in the reference's dtypes.  A cast that left a
    layer in the wrong dtype would show here and nowhere in float32."""
    frames, toks = _inputs()
    jp, tp = _bf16_params()
    want = _jit(jW.encode, cfg=JBF16)(jp, jnp.asarray(frames))
    got = tW.encode(tp, _t(frames), cfg=TBF16, impl=impl)
    assert str(got.dtype) == f"torch.{want.dtype.name}"
    assert _rel(got[0].float(), want) < 2e-2
    logits, caches = _jit(jW.prefill, cfg=JBF16, max_cache_len=MAX_LEN,
                          cache_dtype=jnp.bfloat16)(
        jp, jnp.asarray(toks[:, :PROMPT]), jnp.asarray(frames))
    got, tc = tW.prefill(tp, _t(toks[:, :PROMPT]), _t(frames), cfg=TBF16,
                         max_cache_len=MAX_LEN, cache_dtype=torch.bfloat16,
                         impl=impl)
    assert str(got.dtype) == f"torch.{logits.dtype.name}"
    assert _rel(got[0].float(), logits) < 2e-2
    assert ([str(a.dtype) for a in tree_leaves(tc)]
            == [f"torch.{a.dtype.name}"
                for a in jax.tree_util.tree_leaves(caches)])
    step = _jit(jW.decode_step, cfg=JBF16)
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = step(jp, jnp.asarray(toks[:, pos:pos + 1]), caches,
                              position=jnp.asarray(pos, jnp.int32))
        got, tc = tW.decode_step(tp, _t(toks[:, pos:pos + 1]), tc,
                                 cfg=TBF16, position=pos, impl=impl)
        assert str(got.dtype) == f"torch.{logits.dtype.name}"
        assert _rel(got[0].float(), logits) < 2e-2, (i, _rel(got[0].float(),
                                                             logits))


def test_decode_matches_the_ports_own_forward():
    """Prefill then decode on the kernel route equals the port's own
    teacher-forced pass over the same tokens, 1e-5."""
    frames, toks = _inputs()
    _, tp = _params()
    logits, caches = tW.prefill(tp, _t(toks[:, :PROMPT]), _t(frames),
                                cfg=TCFG, max_cache_len=MAX_LEN,
                                cache_dtype=torch.float32, impl="pallas")
    steps = [logits[0, :, 0]]
    for i in range(STEPS):
        pos = PROMPT + i
        logits, caches = tW.decode_step(tp, _t(toks[:, pos:pos + 1]),
                                        caches, cfg=TCFG, position=pos,
                                        impl="pallas")
        steps.append(logits[0, :, 0])
    enc = tW.encode(tp, _t(frames), cfg=TCFG, impl="naive")
    full = tW.decode_train(tp, _t(toks), enc, cfg=TCFG, impl="naive")
    _close(torch.stack(steps, dim=1), full[0, :, PROMPT - 1:], 1e-5)


def test_kernel_route_reaches_the_kernel_for_every_attention(monkeypatch):
    """On the kernel route every attention of a prefill (the encoder's,
    the decoder's self and cross) and of a decode step (self and cross)
    calls ``kernels.flash_attention.flash_attention``, with the mapping
    of positions the module names: the encoder and the cross-attention
    without causality, the prefill's self-attention causal from 0, the
    decode's self-attention at ``q_offset = position`` on the full
    cache.  The naive route calls it never."""
    calls = []
    kernel = tatt.flash_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["q_offset"]))
        return kernel(q, k, v, **kw)

    monkeypatch.setattr(tatt, "flash_attention", counted)
    frames, toks = _inputs()
    _, tp = _params()
    for impl in ("naive", "pallas"):
        calls.clear()
        _, caches = tW.prefill(tp, _t(toks[:, :PROMPT]), _t(frames),
                               cfg=TCFG, max_cache_len=MAX_LEN, impl=impl)
        tW.decode_step(tp, _t(toks[:, PROMPT:PROMPT + 1]), caches, cfg=TCFG,
                       position=PROMPT, impl=impl)
        if impl == "naive":
            assert calls == []
    L = JCFG.n_layers
    enc = [(S_ENC, S_ENC, False, 0)] * JCFG.n_encoder_layers
    dec = [(PROMPT, PROMPT, True, 0), (PROMPT, S_ENC, False, 0)] * L
    step = [(1, MAX_LEN, True, PROMPT), (1, S_ENC, False, 0)] * L
    assert calls == enc + dec + step


# ------------------------------------------------------------ API, serve
def test_build_model_inputs_and_caches_match_reference():
    """``extra_input_shapes`` and ``caches_init`` (``enc_len`` from the
    frames' shape, else ``encoder_seq_len``) equal to the reference's
    ``whisper_caches_init`` tree; ``apply`` returns a zero aux."""
    from repro.models.api import build_model as jbuild
    model, jmodel = build_model(TCFG), jbuild(JCFG)
    assert model.extra_input_shapes(3, 40) == jmodel.extra_input_shapes(3, 40)
    shapes = model.extra_input_shapes(2, 40)
    for got, enc_len in ((model.caches_init(2, 9, extras_shape=shapes), 40),
                         (model.caches_init(2, 9), S_ENC)):
        want = jW.whisper_caches_init(JCFG, 2, 9, enc_len)
        _leaves_close(tree_map(lambda a: a[None], got), want, 0.0)
        assert ([a.dtype for a in tree_leaves(got)]
                == [torch.bfloat16] * 2 + [torch.bfloat16, torch.int32,
                                           torch.bfloat16])
    frames, toks = _inputs()
    params = model.init(torch.Generator().manual_seed(64))
    logits, aux = model.apply(params, torch.from_numpy(toks),
                              extras={"frames": torch.from_numpy(frames)})
    assert logits.shape == (B, PROMPT + STEPS, JCFG.vocab_size)
    assert float(aux) == 0.0 and aux.shape == ()


def test_serve_whisper_on_the_cpu():
    """``serve`` of whisper-small (reduced, frames ``[2, 6, 256]`` from the
    seed): greedy tokens equal on the kernel route and the naive one, the
    naive run teacher-forced on the first's tokens within 1e-5."""
    kw = dict(batch=2, prompt_len=6, max_new_tokens=4, device="cpu",
              keep_logits=True, dtype=torch.float32)
    a = serve("whisper-small", impl="pallas", **kw)
    b = serve("whisper-small", impl="naive", **kw)
    c = serve("whisper-small", impl="naive", forced=a.tokens, **kw)
    assert a.tokens.shape == (2, 4) and a.logits.shape == (2, 4, 512)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < 512
    assert torch.equal(a.tokens, b.tokens)
    _close(c.logits, a.logits, 1e-5)
    assert a.max_cache_len == 11 and a.n_params == sum(
        x.numel() for x in tree_leaves(build_model(
            replace(TCFG, max_seq_len=18)).init(torch.Generator())))
