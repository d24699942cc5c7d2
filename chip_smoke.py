#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
CUDA PyTorch.  Phases, each of which stops the run on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` each, all
   started together) into ``build/repro_torch/``;
3. the acquisition-score kernel against its plain PyTorch version at the
   main-path shapes, a ragged N, C = 257 and bfloat16 input (atol 1e-5);
4. the fused-aggregation kernel against its plain version: D = 256 devices
   × the 61,706 LeNet parameters, flat preweighted (the engine's mode),
   plus every other mode (atol 1e-5); kernel, plain and ``torch.mv`` times;
5. a small RNG-free paper round on the card against the same round on the
   CPU (the CPU port is held against the JAX package by the tests);
6. the paper's main path: ``run_experiment(scenario="paper")`` at the
   default ``FederatedALConfig`` (D=4, R=10, W=200, T=16, n_train 4000);
7. the massive main path: ``run_experiment(scenario="massive",
   num_devices=256, rounds=2)``;
8. both paths again under ``torch.profiler``: wall, device-busy time,
   idle share and the kernels with the most device time;
9. a ``{"kernels": [...]}`` line (launches in phases 6 and 7, error, times,
   bound), and last the ``{"ok": true, "device": ...}`` line.

Kernel times are device times from ``torch.profiler`` (CUDA activity):
the kernel's own time for ``ms``, every kernel of the call for
``plain_ms`` and ``library_ms``.  Host-inclusive times per call (CUDA
events around back-to-back calls) are printed beside them.

Kernel launch counters are set to 0 just before each main path and read
just after; a main path that does not reach a kernel it should is a
failure.  Without a CUDA card, or without the repository's ``src/`` beside
this file, the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes: float, flops: float) -> float:
    """The least time of a function: the larger of its bytes over the memory
    rate and its float32 operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, match: str = "", iters: int = 20):
    """Device time per call of ``fn`` from ``torch.profiler`` (CUDA
    activity only): ``(all kernels, kernels whose name contains match)`` in
    ms, or None when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = matched = 0.0
    for ev in prof.key_averages():
        t = ev.self_device_time_total                     # us
        total += t
        if match and match in ev.key:
            matched += t
    if total <= 0.0:
        return None
    return total / iters / 1e3, matched / iters / 1e3


def timed(torch, fn, match: str = ""):
    """``(ms, how, host_ms)``: the device time of the kernels named
    ``match`` (all kernels when ``match`` is empty) per call, from the
    profiler, and the host-inclusive time per call from CUDA events.  Falls
    back to the events when the profiler sees no device time."""
    host = time_ms(torch, fn)
    dev = device_ms(torch, fn, match)
    if dev is None or (match and dev[1] <= 0.0):
        return host, "events (host-inclusive)", host
    return (dev[1] if match else dev[0]), "profiler (device)", host


def profile_path(torch, fn):
    """Run ``fn`` once under the profiler: ``(wall s, device-busy s, the
    six kernels with the most device time as (name, ms, calls))``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    evs = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
           for ev in prof.key_averages() if ev.self_device_time_total > 0]
    evs.sort(key=lambda e: -e[1])
    busy = sum(e[1] for e in evs) / 1e3
    return wall, busy, [(k[:70], round(ms, 3), n) for k, ms, n in evs[:6]]


def max_err(torch, got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_acquisition_kernel(torch, k1):
    """Phase 3: K1 vs its plain version; returns the kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def logprobs(shape, dtype=torch.float32):
        x = 3 * torch.randn(shape, generator=gen, device="cuda")
        return torch.log_softmax(x, dim=-1).to(dtype).contiguous()

    cases = {
        "paper [D=4, T=16, W=200, C=10]": logprobs((4, 16, 200, 10)),
        "paper folded [T=16, N=800, C=10]": logprobs((16, 800, 10)),
        "massive [D=256, T=4, W=32, C=10]": logprobs((256, 4, 32, 10)),
        "ragged [T=8, N=333, C=10]": logprobs((8, 333, 10)),
        "wide [T=16, N=128, C=257]": logprobs((16, 128, 257)),
        "bf16 [D=4, T=16, W=200, C=10]": logprobs((4, 16, 200, 10),
                                                 torch.bfloat16),
    }
    worst = 0.0
    for name, lp in cases.items():
        got = k1.acquisition_scores(lp)
        torch.cuda.synchronize()
        err = max_err(torch, got, k1.acquisition_scores_plain(lp))
        print(f"  K1 {name}: max_abs_err {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"K1 {name}: max_abs_err {err} > 1e-5")
        worst = max(worst, err)

    lp = cases["paper [D=4, T=16, W=200, C=10]"]
    D, T, W, C = lp.shape
    ms, how, host = timed(torch, lambda: k1.acquisition_scores(lp),
                          "acquisition_scores_kernel")
    plain, _, plain_host = timed(
        torch, lambda: k1.acquisition_scores_plain(lp))
    bound = bound_ms(lp.numel() * 4 + 3 * D * W * 4, 4 * lp.numel())
    lpm = cases["massive [D=256, T=4, W=32, C=10]"]
    ms_m, _, host_m = timed(torch, lambda: k1.acquisition_scores(lpm),
                            "acquisition_scores_kernel")
    bound_m = bound_ms(lpm.numel() * 4 + 3 * 256 * 32 * 4, 4 * lpm.numel())
    print(f"  K1 paper shape, {how}: kernel {ms:.5f} ms, plain {plain:.5f} "
          f"ms, bound {bound:.5f} ms; per call with host overhead: wrapper "
          f"{host:.5f} ms, plain {plain_host:.5f} ms")
    print(f"  K1 massive shape: kernel {ms_m:.5f} ms, bound {bound_m:.5f} "
          f"ms, wrapper per call {host_m:.5f} ms")
    return {"name": "acquisition_scores", "route": "cuda",
            "source": "src/repro_torch/csrc/acquisition_scores.cu",
            "replaces": "src/repro/kernels/acquisition_scores.py:49",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def lenet_tree(torch, D, gen):
    """A stacked float32 [D, ...] tree with LeNet's leaf shapes (61,706
    values)."""
    shapes = {"conv1": {"kernel": (5, 5, 1, 6), "bias": (6,)},
              "conv2": {"kernel": (5, 5, 6, 16), "bias": (16,)},
              "conv3": {"kernel": (5, 5, 16, 120), "bias": (120,)},
              "fc1": {"kernel": (120, 84), "bias": (84,)},
              "fc2": {"kernel": (84, 10), "bias": (10,)}}
    return {layer: {k: 0.1 * torch.randn((D,) + s, generator=gen,
                                         device="cuda")
                    for k, s in leaves.items()}
            for layer, leaves in shapes.items()}


def check_aggregation_kernel(torch, k2, tree_leaves):
    """Phase 4: K2 vs its plain version; returns the kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    D = 256
    tree = lenet_tree(torch, D, gen)
    N = sum(leaf[0].numel() for leaf in tree_leaves(tree))
    assert N == 61706, N
    raw = torch.rand(D, generator=gen, device="cuda")
    mask = (torch.rand(D, generator=gen, device="cuda") < 0.8).float()
    w = raw * mask / (raw * mask).sum()
    stale = torch.randint(0, 5, (D,), generator=gen, device="cuda").float()
    seg = torch.randint(0, 16, (D,), generator=gen, device="cuda")
    q = {layer: {k: torch.randint(-127, 128, v.shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
                 for k, v in leaves.items()} for layer, leaves in tree.items()}
    scales = {layer: {k: 1e-3 * torch.rand(D, generator=gen, device="cuda")
                      for k in leaves} for layer, leaves in tree.items()}
    tree16 = {layer: {k: v.to(torch.bfloat16) for k, v in leaves.items()}
              for layer, leaves in tree.items()}
    cases = {
        "flat preweighted f32 (engine mode)": (tree, w, {"normalize": False}),
        "flat normalize exp f32": (tree, raw, dict(mask=mask, staleness=stale,
                                                   kind="exp", rate=0.5)),
        "flat normalize poly f32": (tree, raw, dict(mask=mask, staleness=stale,
                                                    kind="poly", rate=0.5)),
        "segment G=16 normalize f32": (tree, raw, dict(
            mask=mask, segment_ids=seg, num_segments=16)),
        "segment G=16 preweighted f32": (tree, w, dict(
            normalize=False, segment_ids=seg, num_segments=16)),
        "flat normalize bf16 -> f32": (tree16, raw, dict(
            mask=mask, out_dtype=torch.float32)),
        "flat normalize int8 + scales": (q, raw, dict(mask=mask,
                                                      scales=scales)),
    }
    worst = 0.0
    for name, (payload, weights, kw) in cases.items():
        got = k2.fused_aggregate(payload, weights, **kw)
        torch.cuda.synchronize()
        err = max_err(torch, tree_leaves(got), tree_leaves(
            k2.fused_aggregate_plain(payload, weights, **kw)))
        print(f"  K2 {name}: max_abs_err {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"K2 {name}: max_abs_err {err} > 1e-5")
        worst = max(worst, err)

    ms, how, host = timed(torch, lambda: k2.fused_aggregate(
        tree, w, normalize=False), "fused_aggregate_kernel")
    plain, _, plain_host = timed(torch, lambda: k2.fused_aggregate_plain(
        tree, w, normalize=False))
    flat = torch.cat([leaf.reshape(D, -1) for leaf in tree_leaves(tree)],
                     dim=1)                                   # [D, N]
    lib, _, lib_host = timed(torch, lambda: torch.mv(flat.t(), w))
    bound = bound_ms(D * N * 4 + N * 4 + D * 4, 2 * D * N)
    print(f"  K2 D=256 x N=61706 f32 flat preweighted, {how}: kernel "
          f"{ms:.5f} ms, plain {plain:.5f} ms, torch.mv {lib:.5f} ms, bound "
          f"{bound:.5f} ms; per call with host overhead: wrapper {host:.5f} "
          f"ms, plain {plain_host:.5f} ms, torch.mv {lib_host:.5f} ms")
    return {"name": "fused_aggregation", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_aggregation.cu",
            "replaces": "src/repro/kernels/fused_aggregation.py:109",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib}


def check_small_round_against_cpu(torch, fed, interop, lenet):
    """Phase 5: the same RNG-free round (dropout 0, window ≥ shard) on the
    card and on the CPU: equal labeled sets, params within 1e-4."""
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import federated_split

    cfg = fed.FederatedALConfig(num_devices=3, initial_train=10,
                                acquisitions=3, k_per_acquisition=4,
                                pool_window=128, mc_samples=4,
                                train_steps_per_acq=5)
    mcfg = lenet.LeNetConfig(p_conv=0.0, p_fc=0.0)
    shards = federated_split(make_digit_dataset(300, seed=0), 3, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        200, seed=5)
    p0 = interop.params_to_jax(lenet.LeNet.init(
        torch.Generator().manual_seed(0), mcfg))
    out = {}
    for dev in ("cuda", "cpu"):
        agg, rep = fed.run_federated_round(
            cfg, shards, seed_set, test,
            trainer=fed.Trainer(cfg, model_cfg=mcfg, device=dev),
            initial_params=interop.params_from_jax(p0, dev))
        out[dev] = (interop.params_to_jax(agg), rep)
    (pg, rg), (pc, rc) = out["cuda"], out["cpu"]
    for hg, hc in zip(rg["device_histories"], rc["device_histories"]):
        for a, b in zip(hg, hc):
            if set(a["selected"]) != set(b["selected"]):
                raise AssertionError(f"card and CPU picked different samples: "
                                     f"{a['selected']} vs {b['selected']}")
    import numpy as np
    err = 0.0
    for layer in pg:
        for k in pg[layer]:
            err = max(err, float(np.abs(pg[layer][k] - pc[layer][k]).max()))
    print(f"  card vs CPU small round: labeled sets equal, params "
          f"max_abs_err {err:.3e}, aggregated_acc {rg['aggregated_acc']} vs "
          f"{rc['aggregated_acc']}")
    if not err <= 1e-4:
        raise AssertionError(f"card vs CPU params differ by {err} > 1e-4")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    from repro_torch import interop
    from repro_torch.core import federated as fed
    from repro_torch.kernels import _build
    from repro_torch.kernels import acquisition_scores as k1
    from repro_torch.kernels import fused_aggregation as k2
    from repro_torch.nn import lenet
    from repro_torch.tree import tree_leaves

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; matmul allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    print("phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 3: acquisition-score kernel vs plain")
    k1_entry = check_acquisition_kernel(torch, k1)
    print("phase 4: fused-aggregation kernel vs plain")
    k2_entry = check_aggregation_kernel(torch, k2, tree_leaves)
    print("phase 5: small round, card vs CPU")
    check_small_round_against_cpu(torch, fed, interop, lenet)

    print("phase 6: paper main path (run_experiment scenario='paper')")
    k1.launches = k2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = fed.run_experiment(fed.FederatedALConfig(), scenario="paper")[0]
    torch.cuda.synchronize()
    paper_s = time.perf_counter() - t0
    paper_launches = {"acquisition_scores": k1.launches,
                      "fused_aggregation": k2.launches}
    print(f"  initial_acc {rep['initial_acc']} aggregated_acc "
          f"{rep['aggregated_acc']} wall {paper_s:.3f} s launches "
          f"{paper_launches}")
    if paper_launches["acquisition_scores"] < 1:
        raise AssertionError("the paper path launched no acquisition-score "
                             "kernel")
    for v in (rep["initial_acc"], rep["aggregated_acc"]):
        if not (np.isfinite(v) and 0.0 <= v <= 1.0):
            raise AssertionError(f"accuracy out of range: {v}")
    n_hist = [len(h) for h in rep["device_histories"]]
    if n_hist != [10] * 4:
        raise AssertionError(f"device histories {n_hist} != 4 x 10")

    print("phase 7: massive main path (scenario='massive', D=256, 2 rounds)")
    k1.launches = k2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = fed.run_experiment(scenario="massive", num_devices=256,
                                rounds=2)[0]["rounds"]
    torch.cuda.synchronize()
    massive_s = time.perf_counter() - t0
    massive_launches = {"acquisition_scores": k1.launches,
                        "fused_aggregation": k2.launches}
    accs = [r["aggregated_acc"] for r in rounds]
    print(f"  aggregated_acc per round {accs} wall {massive_s:.3f} s "
          f"launches {massive_launches}")
    if massive_launches["fused_aggregation"] < 2:
        raise AssertionError("the massive path launched the fused-aggregation "
                             "kernel fewer than 2 times")
    if massive_launches["acquisition_scores"] < 1:
        raise AssertionError("the massive path launched no acquisition-score "
                             "kernel")
    for r in rounds:
        wsum = sum(r["aggregation"]["weights"])
        if not (abs(wsum - 1.0) < 1e-4 and 0.0 <= r["aggregated_acc"] <= 1.0):
            raise AssertionError(f"round {r['round']}: weights sum {wsum}, "
                                 f"acc {r['aggregated_acc']}")

    print("phase 8: where the time goes (both paths again, profiled)")
    from repro_torch.data.digits import make_digit_dataset
    t0 = time.perf_counter()
    for n, seed in ((4000, 0), (1000, 5), (20, 11)):
        make_digit_dataset(n, seed=seed)
    print(f"  paper data generation (host numpy): "
          f"{time.perf_counter() - t0:.3f} s")
    for name, fn in (
            ("paper", lambda: fed.run_experiment(fed.FederatedALConfig(),
                                                 scenario="paper")),
            ("massive", lambda: fed.run_experiment(
                scenario="massive", num_devices=256, rounds=2))):
        wall, busy, top = profile_path(torch, fn)
        print(f"  {name}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle share {1.0 - busy / wall:.3f}); top kernels {top}")

    k1_entry["launches"] = (paper_launches["acquisition_scores"]
                            + massive_launches["acquisition_scores"])
    k2_entry["launches"] = (paper_launches["fused_aggregation"]
                            + massive_launches["fused_aggregation"])
    print(json.dumps({"paper_s": paper_s, "massive_s": massive_s,
                      "paper_launches": paper_launches,
                      "massive_launches": massive_launches,
                      "total_s": time.perf_counter() - t_start}))
    print(f"card: {card}")
    print(json.dumps({"kernels": [k1_entry, k2_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
