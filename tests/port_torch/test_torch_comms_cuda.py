"""The host-aggregation engines' kernel shapes and the comms codecs on the
card, against the same functions on the CPU.

Marked ``cuda``: they skip where torch sees no CUDA card and run on the
card with

    python -m pytest -q -m cuda tests/port_torch

This file imports no JAX.  Tolerances: K1 1e-5 absolute against its plain
version (summation order only); the codecs bit-equal between the card and
the CPU on the same inputs and the same rounding uniforms (elementwise
float32 arithmetic, a max, a top-k threshold and a running count, none of
which depends on a summation order); the delta step's fog model 1e-6
(the fused-aggregation kernel's sum order) and its residuals bit-equal.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import comms  # noqa: E402
from repro_torch.core.comms import CommsConfig  # noqa: E402
from repro_torch.kernels import acquisition_scores as k1  # noqa: E402
from repro_torch.kernels import fused_aggregation as k2  # noqa: E402

pytestmark = pytest.mark.cuda

CODECS = [dict(compression="int8"),
          dict(compression="topk", topk_fraction=0.05),
          dict(compression="topk", topk_fraction=0.3,
               compute_dtype="bfloat16"),
          dict(compute_dtype="bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(16, 200, 10), (1, 16, 200, 10)])
def test_acquisition_kernel_at_the_host_engines_shapes(cuda, shape):
    """The classic engine's ``[T, W, C]`` and the legacy engine's ``[1, T,
    W, C]`` against plain, and two calls bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    lp = torch.log_softmax(3 * torch.randn(shape, generator=gen, device=cuda),
                           dim=-1)
    before = k1.launches
    got = k1.acquisition_scores(lp)
    assert k1.launches == before + 1
    for g, w in zip(got, k1.acquisition_scores_plain(lp)):
        assert g.shape == shape[:-3] + shape[-2:-1]
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    for a, b in zip(got, k1.acquisition_scores(lp)):
        assert torch.equal(a, b)


def _stacked(gen, D=3):
    """A stacked LeNet-shaped tree with small deltas, ties included."""
    shapes = {"conv1": (5, 5, 1, 6), "conv3": (5, 5, 16, 120),
              "fc2": (84, 10), "bias": (6,)}
    tree = {k: 1e-2 * torch.randn((D,) + s, generator=gen)
            for k, s in shapes.items()}
    tree["fc2"][1, :20] = 1e-2                       # tied magnitudes
    tree["fc2"][2, ::3] = -1e-2
    return tree


@pytest.mark.parametrize("codec", CODECS, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_codec_on_the_card_equals_the_cpu(cuda, codec):
    cfg = CommsConfig(**codec)
    gen = torch.Generator().manual_seed(0)
    for name, x in _stacked(gen).items():
        u = torch.rand(x.shape, generator=gen)
        if cfg.compression == "int8":
            q_c, s_c = comms.quantize_int8_rows(x, u)
            q_g, s_g = comms.quantize_int8_rows(x.to(cuda), u.to(cuda))
            again = comms.quantize_int8_rows(x.to(cuda), u.to(cuda))
            assert torch.equal(q_g.cpu(), q_c), name
            assert torch.equal(s_g.cpu(), s_c), name
            assert torch.equal(again[0], q_g) and torch.equal(again[1], s_g)
            continue
        p_c, _ = comms.encode_rows(cfg, x)
        p_g, _ = comms.encode_rows(cfg, x.to(cuda))
        assert p_g.dtype == p_c.dtype and torch.equal(p_g.cpu(), p_c), name
        assert torch.equal(comms.encode_rows(cfg, x.to(cuda))[0], p_g)


def test_topk_mask_and_wire_cast_on_the_card(cuda):
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(-3, 4, (7, 999), generator=gen).float()
    for k in (1, 50, 500, 999):
        want = comms.topk_mask_rows(x, k)
        got = comms.topk_mask_rows(x.to(cuda), k)
        assert torch.equal(got.cpu(), want)
        assert int(want[0].sum()) == k
    y = torch.randn(4096, generator=gen) * torch.exp(
        40 * torch.rand(4096, generator=gen) - 20)
    cfg = CommsConfig(compute_dtype="bfloat16")
    assert torch.equal(comms.wire_cast(cfg, y.to(cuda)).cpu(),
                       comms.wire_cast(cfg, y))


@pytest.mark.parametrize("codec", CODECS[1:], ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_delta_step_on_the_card_equals_the_cpu(cuda, codec):
    """A fused round's comms step on the same inputs (the deterministic
    codecs; int8's draws come from each device's own generator): one
    fused-aggregation launch on the card, residuals bit-equal, the fog
    model within 1e-6 of the CPU's plain reduce."""
    from repro_torch.core.engine import _delta_aggregate
    cfg = CommsConfig(**codec)
    gen = torch.Generator().manual_seed(2)
    delta = _stacked(gen)
    prev = {k: torch.randn(v.shape[1:], generator=gen).expand_as(v).clone()
            for k, v in delta.items()}
    params = {k: prev[k] + delta[k] for k in delta}
    residual = {k: 1e-3 * torch.randn(v.shape, generator=gen)
                for k, v in delta.items()}
    w = torch.tensor([0.25, 0.0, 0.75])
    upload = torch.tensor([1.0, 0.0, 1.0])
    out = {}
    for dev in ("cpu", "cuda"):
        on = lambda t: {k: v.to(dev, copy=True) for k, v in t.items()}
        res = on(residual)
        before = k2.launches
        fog = _delta_aggregate(cfg, on(params), on(prev), res, w.to(dev),
                               upload.to(dev), frozenset(), None)
        out[dev] = (fog, res, k2.launches - before)
    (fog_c, res_c, n_c), (fog_g, res_g, n_g) = out["cpu"], out["cuda"]
    assert n_c == 0 and n_g == 1
    for k in delta:
        assert torch.equal(res_g[k].cpu(), res_c[k]), k
        assert torch.equal(res_c[k][1], residual[k][1])   # skipped: frozen
        torch.testing.assert_close(fog_g[k].cpu(), fog_c[k], atol=1e-6,
                                   rtol=0)
