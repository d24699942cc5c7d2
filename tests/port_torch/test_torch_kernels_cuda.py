"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch sees no CUDA card (a CUDA kernel has
no CPU mode) and run on the card with

    python -m pytest -q -m cuda tests/port_torch

This file imports no JAX, so it runs on a machine that has only the port's
dependencies.  Tolerances: 1e-5 absolute in float32 for both kernels
(summation order differs from the plain version, nothing else).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import acquisition_scores as k1  # noqa: E402
from repro_torch.kernels import fused_aggregation as k2  # noqa: E402

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


def test_acquisition_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        k1.acquisition_scores(torch.zeros(2, 3, 4, device=cuda,
                                          dtype=torch.float16))
    with pytest.raises(ValueError):
        k1.acquisition_scores(torch.zeros(2, 3, 4, device=cuda).transpose(0, 1))


def _tree(gen, D, dtype, cuda):
    shapes = {"a": (3, 4), "b": (7,), "c": (), "d": (2, 1, 2),
              "e": (61, 13)}
    if dtype == torch.int8:
        return {k: torch.randint(-127, 128, (D,) + s, generator=gen,
                                 device=cuda, dtype=torch.int8)
                for k, s in shapes.items()}
    return {k: torch.randn((D,) + s, generator=gen, device=cuda).to(dtype)
            for k, s in shapes.items()}


@pytest.mark.parametrize("D", [1, 4, 8, 64, 300])
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
    before = k2.launches
    got = k2.fused_aggregate(tree, raw, **kw)
    assert k2.launches == before + 1
    want = k2.fused_aggregate_plain(tree, raw, **kw)
    for k in tree:
        torch.testing.assert_close(got[k], want[k], atol=1e-5, rtol=1e-5)


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
