"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch sees no CUDA card (a CUDA kernel has
no CPU mode) and run on the card with

    python -m pytest -q -m cuda tests/port_torch

This file imports no JAX, so it runs on a machine that has only the port's
dependencies.  Tolerances: 1e-5 absolute in float32 for K1 and K2
(summation order differs from the plain version, nothing else), and 1e-4
for K1 from C = 32768 classes on (entropies near 10 summed over tens of
thousands of classes in another order); K3 2e-5
in float32 and 2e-2 in bfloat16, K4 1e-4 (the JAX package's bars for the
kernels they replace).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import acquisition_scores as k1  # noqa: E402
from repro_torch.kernels import flash_attention as k3  # noqa: E402
from repro_torch.kernels import fused_aggregation as k2  # noqa: E402
from repro_torch.kernels import ssd_scan as k4  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 16, 200, 10), (16, 800, 10),
                                   (8, 333, 10), (16, 128, 257),
                                   (2, 1, 5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_acquisition_kernel_matches_plain(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    lp = torch.log_softmax(3 * torch.randn(shape, generator=gen, device=cuda),
                           dim=-1).to(dtype)
    before = k1.launches
    got = k1.acquisition_scores(lp)
    assert k1.launches == before + 1
    for g, w in zip(got, k1.acquisition_scores_plain(lp)):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def _k1_input(shape, dtype, cuda):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    return torch.log_softmax(3 * torch.randn(shape, generator=gen,
                                             device=cuda), dim=-1).to(dtype)


def _k1_rows(shape):
    return (shape[0] if len(shape) == 4 else 1) * shape[-2]


# the LM fleet's scoring call at both vocabularies, one device of it (fewer
# rows: eight slices), and C that takes scalar loads
K1_LM_SHAPES = [(8, 4, 32, 32768), (8, 4, 32, 50288), (4, 32, 50288),
                (8, 4, 32, 50287), (4, 32, 4099)]


@pytest.mark.parametrize("shape", K1_LM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_acquisition_kernel_matches_plain_at_lm_widths(cuda, shape, dtype):
    """The split mode against plain: atol 1e-4 from C = 32768 on (entropies
    near 10 summed over 3e4-5e4 classes in another order), 1e-5 below."""
    lp = _k1_input(shape, dtype, cuda)
    assert k1.launch_plan(_k1_rows(shape), shape[-3], shape[-1], dtype,
                          True).mode == "split"
    before = k1.launches
    got = k1.acquisition_scores(lp)
    assert k1.launches == before + 1
    tol = 1e-4 if shape[-1] >= 32768 else 1e-5
    for g, w in zip(got, k1.acquisition_scores_plain(lp)):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=tol, rtol=0)


# the acquisition step's scoring call at gemma2-2b's vocabulary (the
# score step's [T, B·S, V] block, 64 of its 1,024 rows)
K1_VOCAB_256K = (4, 64, 256000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_acquisition_kernel_at_the_256k_vocabulary(cuda, dtype):
    """K1 at 256,000 classes against plain (atol 1e-4, as from C = 32768
    on), one launch, and two calls bit-equal."""
    lp = _k1_input(K1_VOCAB_256K, dtype, cuda)
    before = k1.launches
    one = k1.acquisition_scores(lp)
    assert k1.launches == before + 1
    two = k1.acquisition_scores(lp)
    for a, b, w in zip(one, two, k1.acquisition_scores_plain(lp)):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, w, atol=1e-4, rtol=0)


# one shape for each number of class slices the plan picks
K1_SLICE_SHAPES = {1: (4, 600, 2048), 2: (8, 4, 32, 32768),
                   4: (4, 100, 50288), 8: (4, 32, 50288)}


@pytest.mark.parametrize("slices", sorted(K1_SLICE_SHAPES))
def test_acquisition_kernel_each_slice_count(cuda, slices):
    shape = K1_SLICE_SHAPES[slices]
    assert k1.launch_plan(_k1_rows(shape), shape[-3], shape[-1],
                          torch.float32, True).slices == slices
    lp = _k1_input(shape, torch.float32, cuda)
    tol = 1e-4 if shape[-1] >= 32768 else 1e-5
    for g, w in zip(k1.acquisition_scores(lp),
                    k1.acquisition_scores_plain(lp)):
        torch.testing.assert_close(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("shape", [(4, 16, 200, 10), (256, 4, 32, 10),
                                   (8, 4, 32, 50288), (4, 32, 50288),
                                   (8, 4, 32, 50287)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_acquisition_kernel_is_bitwise_repeatable(cuda, shape, dtype):
    """Two calls on the same input give equal bits in both modes: no
    atomics, and the slices of a row are added in rank order."""
    lp = _k1_input(shape, dtype, cuda)
    one, two = k1.acquisition_scores(lp), k1.acquisition_scores(lp)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def test_acquisition_kernel_misaligned_input_takes_scalar_loads(cuda):
    """A contiguous view that starts 4 bytes past 16 takes the scalar path
    of the split mode."""
    shape = (8, 4, 32, 50288)
    aligned = _k1_input(shape, torch.float32, cuda)
    lp = torch.empty(1 + aligned.numel(), device=cuda)[1:].view(shape)
    lp.copy_(aligned)
    assert lp.data_ptr() % 16 != 0
    for g, w in zip(k1.acquisition_scores(lp),
                    k1.acquisition_scores_plain(lp)):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


def test_acquisition_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        k1.acquisition_scores(torch.zeros(2, 3, 4, device=cuda,
                                          dtype=torch.float16))
    with pytest.raises(ValueError):
        k1.acquisition_scores(torch.zeros(2, 3, 4, device=cuda).transpose(0, 1))


# leaf shapes: 16-byte rows for some payload types only (vector path), odd
# widths (scalar path), and widths that leave a ragged last tile
TREE_SHAPES = {"a": (3, 4), "b": (7,), "c": (), "d": (2, 1, 2),
               "e": (61, 13), "w3": (3,), "w5": (5,), "w8": (8,),
               "w16": (16,), "w17": (17,), "w4099": (4099,)}


def _leaf(gen, shape, dtype, cuda):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=cuda,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=cuda).to(dtype)


def _tree(gen, D, dtype, cuda, shapes=TREE_SHAPES):
    return {k: _leaf(gen, (D,) + s, dtype, cuda) for k, s in shapes.items()}


def _assert_matches_plain(tree, raw, **kw):
    before = k2.launches
    got = k2.fused_aggregate(tree, raw, **kw)
    assert k2.launches == before + 1
    want = k2.fused_aggregate_plain(tree, raw, **kw)
    for k in tree:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5)
    return got


@pytest.mark.parametrize("D", [1, 4, 8, 64, 256, 300])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("kind", ["none", "exp", "poly"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fused_aggregate_kernel_matches_plain(cuda, D, segmented, normalize,
                                              kind, dtype):
    gen = torch.Generator(device=cuda).manual_seed(D)
    tree = _tree(gen, D, dtype, cuda)
    raw = torch.rand(D, generator=gen, device=cuda) + 0.1
    stale = torch.randint(0, 5, (D,), generator=gen, device=cuda).float()
    mask = (torch.rand(D, generator=gen, device=cuda) < 0.6).float()
    kw = dict(staleness=stale, mask=mask, kind=kind, rate=0.6,
              normalize=normalize, out_dtype=torch.float32)
    if segmented:
        G = min(D, 3) + 1
        kw.update(segment_ids=torch.randint(0, max(G - 1, 1), (D,),
                                            generator=gen, device=cuda),
                  num_segments=G)
    if dtype == torch.int8:
        kw["scales"] = {k: 1e-2 * torch.rand(D, generator=gen, device=cuda)
                        for k in tree}
    _assert_matches_plain(tree, raw, **kw)


@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 16, 17, 4099])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fused_aggregate_kernel_misaligned_leaf(cuda, width, dtype):
    """A contiguous leaf that starts one element past a 16-byte boundary
    (a view at an odd storage offset) takes the scalar path."""
    D = 8
    gen = torch.Generator(device=cuda).manual_seed(width)
    base = _leaf(gen, (D * width + 1,), dtype, cuda)
    tree = {"aligned": _leaf(gen, (D, width), dtype, cuda),
            "odd": base[1:].view(D, width)}
    assert tree["odd"].is_contiguous() and tree["odd"].data_ptr() % 16 != 0
    kw = dict(normalize=False, out_dtype=torch.float32)
    if dtype == torch.int8:
        kw["scales"] = {k: 1e-2 * torch.rand(D, generator=gen, device=cuda)
                        for k in tree}
    _assert_matches_plain(tree, torch.rand(D, generator=gen, device=cuda),
                          **kw)


@pytest.mark.parametrize("D", [256, 300])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fused_aggregate_kernel_many_segments(cuda, D, normalize, dtype):
    """G = 40 segments (the last one empty): each segment's pass reads its
    own rows, in device order."""
    G = 40
    gen = torch.Generator(device=cuda).manual_seed(D + G)
    tree = _tree(gen, D, dtype, cuda)
    kw = dict(segment_ids=torch.randint(0, G - 1, (D,), generator=gen,
                                        device=cuda),
              num_segments=G, normalize=normalize,
              mask=(torch.rand(D, generator=gen, device=cuda) < 0.7).float(),
              out_dtype=torch.float32)
    if dtype == torch.int8:
        kw["scales"] = {k: 1e-2 * torch.rand(D, generator=gen, device=cuda)
                        for k in tree}
    got = _assert_matches_plain(tree, torch.rand(D, generator=gen,
                                                 device=cuda), **kw)
    assert all(bool((v[G - 1] == 0).all()) for v in got.values())


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("kind", ["none", "exp"])
def test_fused_aggregate_kernel_absent_vectors(cuda, segmented, kind):
    """No staleness and no mask: the kernel reads null as 0 and 1."""
    D = 64
    gen = torch.Generator(device=cuda).manual_seed(7)
    tree = _tree(gen, D, torch.float32, cuda)
    kw = dict(kind=kind, rate=0.6)
    if segmented:
        kw.update(segment_ids=torch.randint(0, 5, (D,), generator=gen,
                                            device=cuda), num_segments=5)
    _assert_matches_plain(tree, torch.rand(D, generator=gen, device=cuda),
                          **kw)


@pytest.mark.parametrize("D", [8, 256])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_fused_aggregate_kernel_is_bitwise_repeatable(cuda, D, segmented,
                                                      dtype):
    """Two calls on the same inputs give equal bits: no atomics, and a
    summation order fixed by the shapes."""
    gen = torch.Generator(device=cuda).manual_seed(3 * D)
    tree = _tree(gen, D, dtype, cuda, {"conv3": (5, 5, 16, 120),
                                       "fc1": (120, 84), "bias": (10,)})
    kw = dict(normalize=True, mask=(torch.rand(
        D, generator=gen, device=cuda) < 0.8).float())
    if segmented:
        kw.update(segment_ids=torch.randint(0, 16, (D,), generator=gen,
                                            device=cuda), num_segments=16)
    if dtype == torch.int8:
        kw["scales"] = {k: 1e-2 * torch.rand(D, generator=gen, device=cuda)
                        for k in tree}
    raw = torch.rand(D, generator=gen, device=cuda)
    one = k2.fused_aggregate(tree, raw, **kw)
    two = k2.fused_aggregate(tree, raw, **kw)
    for k in tree:
        assert torch.equal(one[k], two[k]), k


def test_fused_aggregate_kernel_groups_many_leaves(cuda):
    """More leaves than one launch takes: one launch per 32 leaves."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {f"l{i:02d}": torch.randn(5, i + 1, generator=gen, device=cuda)
            for i in range(40)}
    w = torch.rand(5, generator=gen, device=cuda)
    before = k2.launches
    got = k2.fused_aggregate(tree, w, normalize=False)
    assert k2.launches == before + 2
    want = k2.fused_aggregate_plain(tree, w, normalize=False)
    for k in tree:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5)


def test_fused_aggregate_kernel_rejects_what_it_does_not_take(cuda):
    x = {"a": torch.ones(4, 3, device=cuda)}
    with pytest.raises(TypeError):
        k2.fused_aggregate(x, torch.ones(4, device=cuda),
                           scales={"a": torch.ones(4, device=cuda)})
    with pytest.raises(ValueError):
        k2.fused_aggregate({"a": torch.ones(3, 4, device=cuda).t()},
                           torch.ones(4, device=cuda))


# ------------------------------------------------------ K3 flash attention
# B, Sq, Skv, H, Hkv, d, causal, window, softcap, q_offset
ATTN_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None, 0),
    (1, 128, 128, 8, 1, 64, True, 32, None, 0),
    (1, 96, 96, 4, 4, 128, True, None, 50.0, 0),
    (2, 1, 80, 4, 4, 64, True, None, None, 79),
    (1, 64, 72, 4, 2, 64, False, None, None, 0),
    (1, 33, 47, 2, 2, 256, True, None, None, 14),
    (64, 32, 32, 10, 5, 64, True, None, None, 0),     # the decoder path
    (1, 40, 40, 2, 1, 64, True, 7, 30.0, -5),         # rows without keys
    # GQA ratios 1, 2, 4 and 8 in one query tile (Sq <= 64)
    (2, 48, 48, 4, 4, 64, True, None, None, 0),
    (2, 48, 48, 8, 4, 64, True, None, None, 0),
    (1, 48, 48, 8, 2, 64, True, None, None, 0),
    (1, 40, 40, 8, 1, 64, True, 16, None, 0),
    # several query tiles (Sq > 64) with Skv != Sq
    (1, 100, 130, 4, 2, 64, True, None, None, 30),
    (1, 150, 90, 4, 1, 128, False, None, None, 0),
    # the generic instantiation (16, 80; 13: 52-byte rows, scalar loads)
    # and the MLA widths 96 and 192
    (1, 40, 40, 4, 2, 16, True, None, None, 0),
    (1, 70, 100, 4, 1, 80, True, None, None, 30),
    (1, 50, 50, 4, 2, 96, True, None, None, 0),
    (1, 50, 50, 4, 2, 192, True, None, 30.0, 0),
    # MiniCPM3-4B's MLA (path C): 40 heads of dn + dr = 96, H = Hkv
    (8, 32, 32, 40, 40, 96, True, None, None, 0),
    # llama-3.2-vision's cross-attention: 32 text tokens against 1,600
    # image tokens, 32 query heads over 8 KV heads of 128, non-causal
    (2, 32, 1600, 32, 8, 128, False, None, None, 0),
    (1, 37, 45, 4, 2, 13, True, None, None, 8),       # 52-byte rows
    (2, 512, 512, 10, 5, 64, True, None, None, 0),    # lm-100m, 512 tokens
    # gemma2-2b decode (8 over 4 heads of 256, softcap 50): one query at
    # q_offset against a full cache whose slots past it are unwritten, the
    # same under a window, and a wrapped ring (every slot, no causality)
    (4, 1, 600, 8, 4, 256, True, None, 50.0, 400),
    (4, 1, 300, 8, 4, 256, True, 128, 50.0, 250),
    (4, 1, 256, 8, 4, 256, False, None, 50.0, 0),
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    B, Sq, Skv, H, Hkv, d, causal, window, softcap, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(Sq * Skv + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    before = k3.launches
    got = k3.flash_attention(q, k, v, **kw)
    assert k3.launches == before + 1 and got.dtype == dtype
    want = k3.flash_attention_plain(q, k, v, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


def _off16(shape, gen, dtype, device):
    """A contiguous view at a storage offset of one element: its base
    pointer is off 16 bytes."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.randn(n + 1, generator=gen, device=device).to(dtype)
    return buf[1:].view(shape)


@pytest.mark.parametrize("d", [64, 96, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_scalar_path_off_16_bytes(cuda, d, dtype):
    """q, k and v off 16 bytes take the kernel's scalar loads; o (a fresh
    tensor) keeps its 16-byte stores where its rows allow."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = _off16((2, 40, 4, d), gen, dtype, cuda)
    k, v = (_off16((2, 56, 2, d), gen, dtype, cuda) for _ in range(2))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    plan = k3.launch_plan(2, 40, 56, 4, 2, d, q.element_size(),
                          (False, False, False, True))
    assert plan.flags & (k3.VEC_Q | k3.VEC_K | k3.VEC_V) == 0
    kw = dict(causal=True, window=None, softcap=None, q_offset=16)
    got = k3.flash_attention(q, k, v, **kw)
    want = k3.flash_attention_plain(q, k, v, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("case", [ATTN_CASES[6], ATTN_CASES[7],
                                  ATTN_CASES[-4], ATTN_CASES[-3],
                                  ATTN_CASES[-2], ATTN_CASES[-1]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_is_bitwise_repeatable(cuda, case, dtype):
    """Two calls on the same inputs give the same bits: sums run in a
    fixed order, with no atomics."""
    B, Sq, Skv, H, Hkv, d, causal, window, softcap, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    first = k3.flash_attention(q, k, v, **kw)
    for _ in range(2):
        assert torch.equal(first, k3.flash_attention(q, k, v, **kw))


# whisper-small served (12 heads of 64, H = Hkv), at a batch of 1: the
# encoder's and the prefill's cross-attention over 1,500 frames, the
# prefill's causal self-attention, a decode step's self-attention at
# q_offset 1,500 on the full cache of 1,533 slots, and its
# cross-attention over the 1,500 encoder keys
WHISPER_CASES = [
    (1, 1500, 1500, 12, 12, 64, False, None, None, 0),
    (1, 1500, 1500, 12, 12, 64, True, None, None, 0),
    (1, 1, 1533, 12, 12, 64, True, None, None, 1500),
    (1, 1, 1500, 12, 12, 64, False, None, None, 0),
]


@pytest.mark.parametrize("case", WHISPER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_whisper_shapes(cuda, case, dtype):
    """K3 against its plain version at whisper-small's shapes: 2e-5 in
    float32; in bfloat16 2e-2 of the plain output's largest magnitude (a
    diffuse attention over 1,500 keys gives outputs far below 1, so an
    absolute limit would pass a wrong kernel); two calls bit-equal."""
    B, Sq, Skv, H, Hkv, d, causal, window, softcap, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype)
               for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    before = k3.launches
    got = k3.flash_attention(q, k, v, **kw)
    assert k3.launches == before + 1 and got.dtype == dtype
    assert torch.equal(got, k3.flash_attention(q, k, v, **kw))
    want = k3.flash_attention_plain(q, k, v, **kw).float()
    tol = 2e-2 * float(want.abs().max()) if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("positions", [(30, 31), (62, 63, 64, 70)])
def test_attention_core_kernel_decode_matches_the_positional_mask(
        cuda, positions):
    """``attention_core(impl="pallas")`` maps a decode on a ring of 64
    slots (window 64) onto the kernel before and after the ring wraps,
    from the host-side position: equal to the naive route on the cache's
    position tensor within 2e-5."""
    from repro_torch.nn.attention import attention_core, cache_update_decode
    gen = torch.Generator(device=cuda).manual_seed(positions[0])
    W, kw = 64, dict(causal=True, window=64, softcap=50.0)
    cache = {"k": torch.zeros(2, W, 2, 128, device=cuda),
             "v": torch.zeros(2, W, 2, 128, device=cuda),
             "pos": torch.full((W,), -1, dtype=torch.int32, device=cuda)}
    for p in range(positions[-1] + 1):
        k1, v1 = (torch.randn(2, 1, 2, 128, generator=gen, device=cuda)
                  for _ in range(2))
        cache_update_decode(cache, k1, v1, p)
        if p not in positions:
            continue
        q = torch.randn(2, 1, 4, 128, generator=gen, device=cuda)
        before = k3.launches
        got = attention_core(q, cache["k"], cache["v"], impl="pallas",
                             decode_position=p, **kw)
        assert k3.launches == before + 1
        want = attention_core(q, cache["k"], cache["v"], impl="naive",
                              q_pos=torch.tensor([p], device=cuda),
                              kv_pos=cache["pos"], **kw)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_flash_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 4, 2, 257, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k3.flash_attention(q, q, q)
    q = torch.zeros(1, 4, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        k3.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        k3.flash_attention(q.transpose(1, 2), q, q)


# --------------------------------------------------- K4 SSD intra-chunk
# Z, L, g, h, n, p
SSD_CASES = [(4, 32, 1, 1, 16, 8), (2, 64, 1, 1, 32, 16),
             (1, 128, 1, 1, 128, 64), (2, 64, 2, 4, 32, 16),
             (3, 256, 1, 4, 128, 64), (5, 37, 1, 3, 24, 40),
             (2, 48, 1, 2, 256, 256),                 # several state passes
             (64, 32, 1, 64, 128, 64),                # the SSM path
             # head counts a 16-head slice does not divide; two groups
             (3, 32, 1, 5, 128, 64), (2, 32, 1, 67, 128, 64),
             (2, 64, 2, 6, 32, 16),
             # L = 37 (a 5-row last tile) and L = 256 at mamba2-1.3b widths
             (3, 37, 1, 4, 128, 64), (2, 256, 1, 20, 128, 64),
             # rows that are not 16 bytes long: scalar copies and stores
             (2, 40, 1, 67, 21, 13), (3, 33, 1, 5, 20, 12)]


def _ssd_inputs(case, dtype, cuda):
    Z, L, g, h, n, p = case
    gen = torch.Generator(device=cuda).manual_seed(Z * L + n)
    C, B = (torch.randn((Z, L, g, n), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    la = -torch.cumsum(torch.nn.functional.softplus(
        torch.randn((Z, L, h), generator=gen, device=cuda)), dim=1)
    xdt = torch.randn((Z, L, h, p), generator=gen, device=cuda).to(dtype)
    return C, B, la, xdt


def _assert_ssd_matches_plain(C, B, la, xdt):
    before = k4.launches
    y, st = k4.ssd_intra_chunk(C, B, la, xdt)
    assert k4.launches == before + 1
    y_p, st_p = k4.ssd_intra_chunk_plain(C, B, la, xdt)
    torch.testing.assert_close(y, y_p, atol=1e-4, rtol=0)
    torch.testing.assert_close(st, st_p, atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(cuda, case, dtype):
    _assert_ssd_matches_plain(*_ssd_inputs(case, dtype, cuda))


@pytest.mark.parametrize("case", [(64, 32, 1, 64, 128, 64),
                                  (3, 37, 1, 4, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_misaligned_xdt(cuda, case, dtype):
    """A contiguous xdt view one element past a 16-byte boundary takes the
    scalar copies; the result is the same function."""
    C, B, la, xdt = _ssd_inputs(case, dtype, cuda)
    base = torch.empty(xdt.numel() + 1, dtype=dtype, device=cuda)
    odd = base[1:].view(xdt.shape)
    odd.copy_(xdt)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    _assert_ssd_matches_plain(C, B, la, odd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_bitwise_repeatable(cuda, dtype):
    """Two calls on the same inputs give equal bits (no atomics, a
    summation order fixed by the shapes), at path A's shape cut to Z = 64."""
    args = _ssd_inputs((64, 32, 1, 64, 128, 64), dtype, cuda)
    one = k4.ssd_intra_chunk(*args)
    two = k4.ssd_intra_chunk(*args)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    z = torch.zeros(2, 8, 1, 16, device=cuda)
    la = torch.zeros(2, 8, 3, device=cuda)
    x = torch.zeros(2, 8, 3, 8, device=cuda)
    with pytest.raises(TypeError):
        k4.ssd_intra_chunk(z.half(), z.half(), la, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        k4.ssd_intra_chunk(z, z, la, x.transpose(2, 3).contiguous()
                           .transpose(2, 3))
    with pytest.raises(ValueError, match="register"):
        k4.ssd_intra_chunk(torch.zeros(1, 8, 1, 16, device=cuda),
                           torch.zeros(1, 8, 1, 16, device=cuda),
                           torch.zeros(1, 8, 1, device=cuda),
                           torch.zeros(1, 8, 1, 320, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        k4.ssd_intra_chunk(torch.zeros(1, 256, 1, 256, device=cuda),
                           torch.zeros(1, 256, 1, 256, device=cuda),
                           torch.zeros(1, 256, 1, device=cuda),
                           torch.zeros(1, 256, 1, 64, device=cuda))
