#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
CUDA PyTorch.  Phases, each of which stops the run on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` each, all
   started together) into ``build/repro_torch/``;
3. the acquisition-score kernel (K1) against its plain PyTorch version at
   the LeNet paths' shapes (the classic engine's ``[T=16, W=200, C=10]``,
   the legacy engine's ``[1, 16, 200, 10]`` and the stream path's request
   queues ``[256, 4, 16, 10]`` among them), a ragged N,
   C = 257 and bfloat16 input (atol 1e-5), at the LM fleets'
   vocabularies C = 32768, 50288 and 73456 in float32 and bfloat16, one
   device's rows at C = 50288 and the ragged C = 50287
   (atol 1e-4: entropies near 10 summed over 5e4 classes in another
   order), C = 4099 (1e-5), and phase 25's acquisition step at
   gemma2-2b's vocabulary, ``[4, 1024, 256000]`` in float32 and
   bfloat16 (1e-4); two calls bit-equal in every case; the LM cases'
   times beside their byte bound and their plain version's;
4. the fused-aggregation kernel (K2) against its plain version: D = 256
   devices × the 61,706 LeNet parameters, flat preweighted (the engine's
   mode), plus every other mode (atol 1e-5) and the compressed rounds'
   int8 and bfloat16 payloads in the engine's mode, and D = 8 copies of
   the LM trees A and B (~129M and ~95M parameters) and D = 4 of tree C
   (~251M), tree A also in bfloat16
   and int8, tree B also in int8 (path B's int8 uploads); two calls of
   each case must give equal bits; each case's kernel time against its
   own byte bound, and kernel, plain and ``torch.mv`` times in the
   engine's mode; the segment form at the fog path's shape (D = 256 in
   ``default_topology(256)``'s 16 groups): kernel, plain and ``torch.mm``
   times beside its byte bound;
5. the flash-attention kernel (K3) against its plain version: every case
   of the JAX package's tests/test_kernels.py, the kernel's edges (GQA 8,
   several query tiles, head dims 13, 80, 96 and 192), path B's shape,
   path C's MLA shape (40 heads of 96, v zero-padded from 64) and
   llama-3.2-vision's cross-attention (32 tokens against 1,600 image
   tokens, 32 over 8 heads of 128, non-causal), in float32 (atol 2e-5)
   and bfloat16 (2e-2), two calls bit-equal; kernel, plain and
   ``scaled_dot_product_attention`` times at path B's shape, at lm-100m's
   full 512-token context and at the MLA and cross-attention shapes,
   and at the MLA shape the layer's own bound (v and o at dv 64) beside
   the kernel's on the padded inputs; then the serve path's shapes
   (gemma2-2b, 8 over 4 heads of 256, softcap 50): the prefill of 4 x
   4,128 tokens with and without the 4,096 window, a decode step at
   q_offset 4,128 on the full cache of 4,161 slots and one on the
   wrapped ring of 4,096, each timed in float32 (the decode on the full
   cache in bfloat16 too) beside its bound, its plain version and
   ``scaled_dot_product_attention`` without the softcap; then whisper's
   serve shapes (whisper-small, 12 heads of 64, H = Hkv, batch 4): the
   encoder's and the prefill's cross-attention over 1,500 frames
   (non-causal), the prefill's causal self-attention over 1,500 tokens,
   a decode step's self-attention at q_offset 1,500 on the full cache of
   1,533 slots and its cross-attention over the 1,500 encoder keys, each
   in float32 (2e-5) and bfloat16 (2e-2 of the plain output's largest
   magnitude), two calls bit-equal, each timed in both beside its bound,
   its plain version and ``scaled_dot_product_attention`` (no softcap:
   the same function);
6. the SSD intra-chunk kernel (K4) against its plain version: the JAX
   package's test shapes, the kernel's edges and the SSM path's shape
   (atol 1e-4), two calls bit-equal; kernel and plain times at the SSM
   path's shape and at the published chunk (L = 256, n 128, p 64);
7. small RNG-free rounds on the card against the same rounds on the CPU:
   LeNet (the paper round on the vmap, classic and legacy engines; fused
   rounds with top-k 0.05 and with a bfloat16 wire, error feedback on:
   params within 1e-4, the card's residuals bit-equal to its own codec
   input minus the CPU codec's output, residuals within 1e-5 but at
   bounded codec splits, ``comms.codec_splits``), fused LeNet rounds
   of a heterogeneous fleet (a host straggler schedule with an empty
   round, a step-limit profile, exp decay, buffering) and of a faulty one
   (churn, crashes, lost, corrupted and label-noise rounds from the port's
   numpy fault draws, guards ``"drop"``): staleness, liveness and the
   fault and guard rows exactly equal, params within 1e-4 but for a
   bounded few entries within one round's fit reach; 4 events of the
   async loop on 8 devices (a quorum of 2 with a 0.5 s timer over
   exponential latencies with a 10x skew, churn, crashes, drops, NaN
   corruption and label noise, guards ``"drop"``): arrivals, simulated
   times, timer events, staleness and the fault and guard rows exactly
   equal, the fog model, params and banked deltas by the same rule; a fog
   topology of 2 groups on 8 devices (3 fused rounds with a top-k fog
   codec, 4 async events: ``fog_sync``, ``group_accept`` and the other
   rows exactly equal, β within 1e-6, the rest by the same rule) and
   ``uniform_topology(8, 1)`` against the flat run on the card (bit for
   bit when two flat runs repeat their bits); 4 events of live traffic on
   8 devices (Poisson arrivals with burst and drift, score selection,
   churn): the stream rows, queue depths, labeled counts and masks,
   arrivals and staleness exactly equal, the rest by the same rule; the
   reduced SSM LM and a small decoder LM (fused rounds); the
   CPU port is held against the JAX package by the tests;
8. the paper's main path: ``run_experiment(scenario="paper")`` at the
   default ``FederatedALConfig`` (D=4, R=10, W=200, T=16, n_train 4000);
9. the massive main path: ``run_experiment(scenario="massive",
   num_devices=256, rounds=2)``;
10. the LM paths, ``run_experiment(cfg, scenario="lm", rounds=2,
    n_test=256)``: A, one Mamba-2 block at mamba2-1.3b widths on 8 devices
    (K1, K2, K4); B, the 12-layer lm-100m decoder on 8 devices (K1, K2,
    K3); C, MiniCPM3-4B at its published widths cut to one layer
    (``repro_torch.configs.get_config("minicpm3-4b")``: MLA, 250,724,864
    parameters a device) on 4 devices (K1 at C 73456, K2, K3 at 40 heads
    of 96, every K3 call checked to be MLA's); each path's wall, peak
    memory and launches;
12. the host-aggregation engines at the paper's defaults:
    ``run_experiment(FederatedALConfig(), scenario="paper",
    engine="classic" | "legacy")``, K1 40 launches each, the round's
    uplink bytes exact;
13. the massive path with compressed uploads: ``run_experiment(
    scenario="massive", num_devices=256, rounds=2, comms=...)`` with int8,
    top-k 0.05 and a bfloat16 wire (K2 and K1 launched, every round's
    uplink bytes exact, weights summing to 1, the fog model finite);
14. path B with int8 uploads: ``run_experiment(configs["B"],
    scenario="lm", rounds=2, n_test=256, comms=CommsConfig(
    compression="int8"))`` (K1, K2, K3), its wall and peak memory (under
    76 GiB), the fog model finite;
15. the heterogeneous fleet: ``run_experiment(scenario="hetero",
    num_devices=256, rounds=3)`` (30% stragglers buffered and
    staleness-decayed, a quarter of the fleet on half the fit steps):
    wall, the staleness summary beside ``expected_staleness(0.3)``, K1 at
    least 6 launches and K2 at least 6 (buffering reduces params and the
    backlog apart, two launches a round);
16. the faulty fleet: ``run_experiment(scenario="churn",
    num_devices=256, rounds=3)`` (churn, crashes, lost, x50-corrupted and
    label-noise rounds, guards ``"drop"``): wall, the faults summary, K1
    at least 6 and K2 at least 3, every corrupted received upload
    rejected; then the same fleet's resume: two uninterrupted 3-round runs
    (do the card's bits repeat?), and 2 rounds, ``save_engine_state``,
    ``load_engine_state``, ``resume_state(next_round=2)``, 1 round with
    ``start_round=2``, equal to the uninterrupted run bit for bit when the
    bits repeat, else within twice the run-to-run gap; and the async
    restore on 8 devices (faults, guards, int8): 2 events, save, load,
    ``resume_state(next_round=2)``, 2 events, against 2 events chained on
    the in-memory state, by the same rule;
17. the async event loop: ``run_experiment(scenario="async",
    num_devices=256, rounds=8)`` (``default_async(256)``: a FedBuff quorum
    of 64, a 4 s timer, exponential latencies with a 10x skew, poly decay
    0.5, over 8 events): wall, simulated seconds, mean arrivals, timer
    events and staleness, K1 exactly 16 launches (2 an event), K2 one an
    accepting event, weights summing to 1 on those, the fog model finite;
19. the fog topology: ``run_experiment(scenario="fog", num_devices=256,
    rounds=4)`` (``default_topology(256)``: 16 groups of 16, rounds 0-2
    fog-local, round 3 a sync): wall, ``fog_sync`` [0, 0, 0, 1], β summing
    to 1 on accepting rounds, ``group_accept``, the tiers' bytes and
    ``cross_tier_reduction``; K1 exactly 8 launches, K2's flat and
    segment launches apart, a segment launch in each fog-local round;
    then with ``CommsConfig(fog_compression="int8")``: a segment launch
    every round (the delta form), the fog→cloud bytes exact, the fog
    model finite;
21. live traffic: ``run_experiment(scenario="stream", num_devices=256,
    rounds=8)`` (``default_async(256)`` and ``default_stream(256)``: ~2
    requests a device a simulated second with a 4x skew, queues of 16,
    serve at most 0.6 nats, escalate the top 2 from 1.0, drift over 8 s):
    wall, simulated seconds, the traffic totals and serve accuracy, the
    escalation uplink bytes exact, K1 exactly 24 launches (3 an event: 2
    in the candidate round, 1 on the queues), K2 one an accepting event,
    weights summing to 1 on those, conservation of requests (offered =
    dropped + served + escalated + still queued), the fog model finite;
22. the decoder zoo (``repro_torch.configs``) at the JAX package's
    ``reduced()`` sizes: ``decoder_forward`` of deepseek-v2 (MLA, MoE with
    a shared expert, a dense first layer), arctic (MoE with the dense
    residual), recurrentgemma (R, R, L and its tail), llama-3.2-vision
    (gated cross-attention to image embeddings from the seed) and a
    mamba2 decoder (M), two devices with their own weights, the same on
    the card and on the CPU: logits within 1e-4, the per-device MoE aux
    within 1e-5, every MoE layer's capacity drops equal, and its least
    gap between the K-th and (K+1)-th router probability printed; then
    one ``scenario="lm"`` round at 4 devices on the card for deepseek-v2
    and recurrentgemma (dropout 0.1, ``impl="pallas"``): accuracy in [0,
    1], weights summing to 1, the MoE fleet's aux positive; then (c)
    serving through ``models.api`` at ``reduced()``: qwen3-8b, gemma2-2b
    (its ring of 128 wraps at the fifth step), deepseek-v2, arctic,
    recurrentgemma, mamba2, llama-3.2-vision and whisper-small (against
    frames of its ``encoder_seq_len`` 64) each prefill 2 prompts of
    124 tokens and decode 8 steps on the card and on the CPU, the same
    weights and tokens, ``impl="pallas"``: every step's logits within
    1e-4 with float32 caches, within 2e-2 of the largest logit with
    bfloat16 caches, every MoE call's capacity drops equal;
23. gemma2-2b served at its published widths and full depth
    (``repro_torch.launch.serve.serve("gemma2-2b", full_config=True,
    batch=4, prompt_len=4128, max_new_tokens=32)``: 2,614,341,888
    parameters, caches of 4,161 slots, the local layers' rings wrapped):
    (a) float32 on the routes ``"pallas"`` (K3 on every prefill and
    decode attention, 832 launches), ``"naive"`` and ``"auto"`` (the
    blockwise prefill), the last two teacher-forced on the first's
    tokens: every step's logits within 1e-4 of the largest logit, and
    within 1e-4 of a full forward over the same tokens; (b) bfloat16,
    ``"pallas"``: prefill seconds, decode tokens a second, peak memory,
    K3 launches, finite logits;
24. whisper-small served at its published widths
    (``serve("whisper-small", full_config=True, batch=4,
    prompt_len=1500, max_new_tokens=32)``: frames ``[4, 1500, 768]``, the
    family's native encoder length, 263,454,720 parameters, caches of
    1,533 slots): (a) float32 on the routes ``"pallas"`` (K3 on every
    attention: 36 launches in the prefill, 24 a decode step, 780 in
    all), ``"naive"`` and ``"blockwise"``, the last two teacher-forced on
    the first's tokens: every step's logits within 1e-4 of the largest
    logit, and within 1e-4 of ``model.apply`` (the full forward) over
    the same frames and tokens; (b) bfloat16, ``"pallas"``: prefill
    seconds, decode tokens a second, peak memory, K3 launches, finite
    logits;
25. the training half (``launch.train``, ``launch.steps``,
    ``core.selection``): (a) ``train("gemma2-2b", full_config=True,
    steps=6, batch=4, seq=128)`` (2,614,341,888 parameters, adamw, the
    reference's data): every loss finite, seconds a step, peak memory, no
    kernel launched, then the host's stream sampling at that batch alone;
    (b) ``train("whisper-small", full_config=True, steps=10, batch=4,
    seq=128, groups=2, sync_every=2, ckpt_dir=...)`` (263,454,720
    parameters): 5 syncs, both groups' params bit-equal after the last,
    the round-10 ``save_round`` checkpoint reloaded bit-equal to group
    0's, then the host's stream sampling alone; (c) at ``reduced()`` on the card against the CPU, the same
    weights and batches: 3 ``make_train_step`` steps of gemma2-2b (adamw,
    ``clip_norm`` 0.1, 2 microbatches) and of deepseek-v2-236b
    (adafactor, the MoE aux), 2 ``make_federated_train_step`` steps of 2
    groups then ``federated_sync``, one ``make_score_step`` (T = 4) with
    ``select_batch``: losses within 1e-5 relative, scores within 1e-5,
    the picked indices equal, params within 1e-4; (d) the acquisition step at full width on (a)'s params:
    ``make_score_step(mc_samples=4)`` over 8 candidates of 128 tokens
    from ``SyntheticLMStream`` (K1 exactly once a step, on ``[4, 1024,
    256000]``), ``select_batch`` keeping 4, one train step on them;
20. the sharded fleet (``launch.mesh``): (a) massive, fog, async and stream
    once more unsharded and once on a one-rank NCCL mesh
    (``make_device_mesh()``, the fog path ``make_fog_mesh(1, 1)``), each
    equal to its first run (phases 9, 17, 19, 21) bit for bit when the two
    unsharded runs repeat
    their bits, else within their gap, with as many K1 and K2 launches;
    the walls side by side; (b) massive at D = 256 split over two
    processes that share the card through a gloo group this script
    starts, CUDA tensors in the collectives: each rank's report and fog
    model against the first unsharded run by the bars of
    ``tests/port_torch/test_torch_mesh.py``, both ranks bit-equal, each
    rank's wall, launches and global-shape draw bytes (a refusal of gloo
    to take CUDA tensors is reported on its own line); every group is
    destroyed after;
26. the model-parallel launch tools (``launch.mesh``, ``launch.sharding``,
    ``nn.shard_hints``, ``launch.op_analysis``, ``launch.dryrun``): (a)
    ``python -m repro_torch.launch.dryrun --arch gemma2-2b`` in a child
    process on a fake 16 × 16 group over meta tensors, all four shapes,
    host only (the card hidden from it; started right after phase 2 and
    read here): per device GB, FLOPs, traffic, collective bytes and
    counts, the three roofline terms (H100 constants) and the trace
    seconds, no shape recording an error; (b) gemma2-2b at full depth in
    bfloat16 on a one-rank NCCL ``make_debug_mesh(1)``, params placed by
    the rule tables: one ``"pallas"`` prefill of ``[4, 4128]`` under
    ``op_analysis.analyze`` on the card, its FLOPs equal to the same step
    traced on meta tensors, no collective, K3 launched 26 times, and the
    measured prefill seconds beside the roofline's compute and memory
    seconds for that count; (c) ``serve``'s greedy loop of the same
    model driven through ``make_prefill_step`` and ``make_decode_step``
    with ``shard_hints=True`` under that mesh, a prefill and 4 decode
    steps on ``"pallas"``: the logits and tokens bit-equal to ``serve``
    without a mesh and hints;
11. run last: the host time of each path's data generation, then the
    five paths of phases 8-10, phases 15-17, 19 and 21, phases 23
    (b) and 24 (b), two train steps of phase 25 (a) (``launch.train.
    train`` itself) and one score step of phase 25 (d) again under the
    CUDA activity tracer (wall, device-busy time, idle share, the
    kernels with the most device time, and the host seconds spent
    reading the trace), and phase 13's int8 run and phase 14 with host
    activity too, for the device time of the codec (the kernels
    launched inside the engine's ``comms_codec`` spans);
18. a ``{"kernels": [...]}`` line (launches in phases 8-10, 12-17, 19,
    21, 22 (the fleets), 23, 24, 25, 20 (a) and 26, K2's segment-form
    launches of phase 19
    apart, error, times, bound), and last the ``{"ok": true, "device":
    ...}`` line.

Each phase's heading shows the seconds since the start.

Kernel times are device times from ``torch.profiler`` (CUDA activity):
the kernel's own time for ``ms``, every kernel of the call for
``plain_ms`` and ``library_ms``.  Host-inclusive times per call (CUDA
events around back-to-back calls) are printed beside them.  Each timed
entry of the kernels line says in ``how`` which of the two its ``ms`` is:
when two profiles in a row see no device time for the kernel, ``ms`` is
the host-inclusive time.

Kernel launch counters are set to 0 just before each main path and read
just after; a main path that does not reach a kernel it should is a
failure.  Bounds use the H100 SXM's published peaks (3.35 TB/s, 67 TFLOP/s
float32 outside the tensor cores); the card's power limit is printed
beside them.  Without a CUDA card, or without the repository's ``src/`` beside
this file, the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

# LM path A peaks at ~68 GiB of the card's 80; with fixed-size cached
# segments the blocks that earlier phases left behind can leave no hole for
# its largest [8, ...] leaf although enough memory is free in all.
# Segments that grow in place leave none.  Set before torch touches CUDA;
# the phase-20 processes inherit it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
FP32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM bfloat16 on the tensor cores, dense


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS) -> float:
    """The least time of a function: the larger of its bytes over the memory
    rate and its operations over the peak rate for their type (float32
    unless ``flops_per_s``)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s) * 1e3


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
    back to the events, and says so in ``how``, when two profiles in a row
    see no device time."""
    host = time_ms(torch, fn)
    for _ in range(2):
        dev = device_ms(torch, fn, match)
        if dev is not None and (not match or dev[1] > 0.0):
            break
    else:
        return host, "events (host-inclusive)", host
    return (dev[1] if match else dev[0]), "profiler (device)", host


def trace_path(torch, fn, span: str = ""):
    """Run ``fn`` once under the CUDA activity tracer (host activity too
    when ``span`` names a profiler range, which the tracer then mirrors
    on the device timeline): ``(wall s, device-busy s, (device ms of the
    kernels that start inside the ``span`` mirrors, ms the mirrors cover)
    or None, the six kernels with the most device time as (name, ms,
    calls), host seconds spent reading the trace)``.  The profiler's
    ``device_time_total`` of the span's key adds the two.  The trace's raw
    events are read as they come: ``torch.profiler``'s parse, event tree
    and ``key_averages`` spend host time on every event, which made most
    of this phase's time when it used them (PERF.md)."""
    from bisect import bisect_right
    from torch.autograd import DeviceType, _disable_profiler
    from torch.autograd.profiler import profile
    prof = profile(use_device="cuda", use_cpu=bool(span), use_kineto=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof._prepare_trace()
    prof._start_trace()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        result = _disable_profiler()
    t1 = time.perf_counter()
    kernels, mirrors = {}, []
    for ev in result.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        start, ns = ev.start_ns(), ev.duration_ns()
        if span and ev.name() == span:
            mirrors.append((start, start + ns))
        else:
            kernels.setdefault(ev.name(), []).append((start, ns))
    totals = sorted(((name, sum(ns for _, ns in runs), len(runs))
                     for name, runs in kernels.items()), key=lambda e: -e[1])
    busy = sum(ns for _, ns, _ in totals) / 1e9
    top = [(k[:70], round(ns / 1e6, 3), n) for k, ns, n in totals[:6]]
    in_span = None
    if span:
        mirrors.sort()
        lows = [lo for lo, _ in mirrors]

        def inside(t):
            i = bisect_right(lows, t) - 1
            return i >= 0 and t <= mirrors[i][1]

        in_span = (sum(ns for runs in kernels.values() for t, ns in runs
                       if inside(t)) / 1e6,
                   sum(hi - lo for lo, hi in mirrors) / 1e6)
    return wall, busy, in_span, top, time.perf_counter() - t1


def max_err(torch, got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def k1_inputs(torch, gen, shape, dtype=None):
    """MC log-probs of ``shape``: log_softmax of 3·normal logits."""
    x = 3 * torch.randn(shape, generator=gen, device="cuda")
    return torch.log_softmax(x, dim=-1).to(dtype or torch.float32)


def check_k1_case(torch, k1, name, lp, tol):
    """K1 against plain on one input, and two calls bit-equal; returns the
    error."""
    got = k1.acquisition_scores(lp)
    torch.cuda.synchronize()
    err = max_err(torch, got, k1.acquisition_scores_plain(lp))
    again = k1.acquisition_scores(lp)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K1 {name}: two calls differ")
    T, C = lp.shape[-3], lp.shape[-1]
    rows = lp.numel() // (T * C)
    plan = k1.launch_plan(rows, T, C, lp.dtype, lp.data_ptr() % 16 == 0)
    blocks = (rows * plan.slices if plan.mode == "split"
              else -(-rows // (plan.threads // 32)))
    print(f"  K1 {name}: {plan.mode}, {plan.slices} slice(s), vec "
          f"{plan.vec}, {blocks} blocks; max_abs_err {err:.3e}, two "
          f"calls bit-equal")
    if not err <= tol:
        raise AssertionError(f"K1 {name}: max_abs_err {err} > {tol}")
    return err


def k1_bound_ms(lp) -> float:
    """K1's bound: the log-probs read once at their width, three float32
    outputs a row written once; ~4 operations an element."""
    rows = lp.numel() // (lp.shape[-3] * lp.shape[-1])
    return bound_ms(lp.numel() * lp.element_size() + 3 * rows * 4,
                    4 * lp.numel())


def check_acquisition_kernel(torch, k1):
    """Phase 3: K1 vs its plain version at the LeNet paths' shapes (the warp
    mode), two calls bit-equal; returns the kernels-line entry."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "paper [D=4, T=16, W=200, C=10]": k1_inputs(torch, gen,
                                                    (4, 16, 200, 10)),
        "paper folded [T=16, N=800, C=10]": k1_inputs(torch, gen,
                                                      (16, 800, 10)),
        "massive [D=256, T=4, W=32, C=10]": k1_inputs(torch, gen,
                                                      (256, 4, 32, 10)),
        "stream queues [D=256, T=4, Q=16, C=10]": k1_inputs(
            torch, gen, (256, 4, 16, 10)),
        "ragged [T=8, N=333, C=10]": k1_inputs(torch, gen, (8, 333, 10)),
        "wide [T=16, N=128, C=257]": k1_inputs(torch, gen, (16, 128, 257)),
        "bf16 [D=4, T=16, W=200, C=10]": k1_inputs(
            torch, gen, (4, 16, 200, 10), torch.bfloat16),
        "classic [T=16, W=200, C=10]": k1_inputs(torch, gen, (16, 200, 10)),
        "legacy [D=1, T=16, W=200, C=10]": k1_inputs(torch, gen,
                                                     (1, 16, 200, 10)),
    }
    worst = max(check_k1_case(torch, k1, name, lp, 1e-5)
                for name, lp in cases.items())
    shapes = []
    for name in ("paper [D=4, T=16, W=200, C=10]",
                 "massive [D=256, T=4, W=32, C=10]",
                 "classic [T=16, W=200, C=10]",
                 "stream queues [D=256, T=4, Q=16, C=10]"):
        lp = cases[name]
        ms, how, host = timed(torch, lambda: k1.acquisition_scores(lp),
                              "acquisition_scores_kernel")
        plain, _, plain_host = timed(
            torch, lambda: k1.acquisition_scores_plain(lp))
        bound = k1_bound_ms(lp)
        print(f"  K1 {name}, {how}: kernel {ms:.5f} ms, plain {plain:.5f} "
              f"ms, bound {bound:.5f} ms; per call with host overhead: "
              f"wrapper {host:.5f} ms, plain {plain_host:.5f} ms")
        shapes.append({"shape": list(lp.shape), "ms": ms, "how": how,
                       "plain_ms": plain, "bound_ms": bound})
    return {"name": "acquisition_scores", "route": "cuda",
            "source": "src/repro_torch/csrc/acquisition_scores.cu",
            "replaces": "src/repro/kernels/acquisition_scores.py:49",
            "max_abs_err": worst, "ms": shapes[0]["ms"],
            "how": shapes[0]["how"], "plain_ms": shapes[0]["plain_ms"],
            "bound_ms": shapes[0]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "shapes": shapes}


# phase 3, LM widths: the fused LM rounds' MC scoring call [D, T=4, W=32,
# C] at the three vocabularies (D = 8 on paths A and B, 4 on path C), one
# device of it (fewer rows, so more slices a row), class counts that
# take scalar loads, and phase 25 (d)'s acquisition step: T = 4 passes
# over 8 candidates of 128 tokens at gemma2-2b's 256,000 words
K1_LM_CASES = [("path C", (4, 4, 32, 73456), "float32"),
               ("path C", (4, 4, 32, 73456), "bfloat16"),
               ("path B", (8, 4, 32, 32768), "float32"),
               ("path B", (8, 4, 32, 32768), "bfloat16"),
               ("path A", (8, 4, 32, 50288), "float32"),
               ("path A", (8, 4, 32, 50288), "bfloat16"),
               ("one device", (4, 32, 50288), "float32"),
               ("ragged", (8, 4, 32, 50287), "float32"),
               ("ragged", (4, 32, 4099), "float32"),
               ("ragged", (4, 32, 4099), "bfloat16"),
               ("acquisition step", (4, 1024, 256000), "float32"),
               ("acquisition step", (4, 1024, 256000), "bfloat16")]


def check_acquisition_lm_widths(torch, k1):
    """Phase 3, LM widths: K1 against plain (atol 1e-4 from C = 32768 on:
    entropies near 10 summed over 3e4-5e4 classes in another order; 1e-5
    below), two calls bit-equal, kernel and plain time and the share of
    the byte bound.  Returns (worst error, times per case)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, times = 0.0, {}
    for what, shape, dtype in K1_LM_CASES:
        name = f"{what} {list(shape)} {dtype}"
        lp = k1_inputs(torch, gen, shape, getattr(torch, dtype))
        tol = 1e-4 if shape[-1] >= 32768 else 1e-5
        worst = max(worst, check_k1_case(torch, k1, name, lp, tol))
        ms, how, _ = timed(torch, lambda: k1.acquisition_scores(lp),
                           "acquisition_scores_kernel")
        plain, _, _ = timed(torch, lambda: k1.acquisition_scores_plain(lp))
        bound = k1_bound_ms(lp)
        print(f"  K1 {name}, {how}: kernel {ms:.5f} ms ({bound / ms:.3f} of "
              f"the {bound:.5f} ms byte bound), plain {plain:.5f} ms")
        times[name] = {"shape": list(shape), "dtype": dtype, "ms": ms,
                       "how": how, "plain_ms": plain, "bound_ms": bound}
        del lp
        torch.cuda.empty_cache()
    return worst, times


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


def k2_bound_ms(tree_leaves, payload, kw) -> float:
    """K2's bound for one call: its payload read once at its own width (4,
    2 or 1 bytes), the int8 scales and per-device vectors read once, the G
    float32 outputs written once; 2 operations a payload element."""
    leaves = tree_leaves(payload)
    D = leaves[0].shape[0]
    N = sum(leaf[0].numel() for leaf in leaves)
    G = kw.get("num_segments") or 1
    vectors = 1 + sum(kw.get(k) is not None for k in
                      ("staleness", "mask", "segment_ids"))
    scales = 4 * D * len(leaves) if kw.get("scales") is not None else 0
    nbytes = (D * N * leaves[0].element_size() + 4 * G * N + 4 * D * vectors
              + scales)
    return bound_ms(nbytes, 2 * D * N)


def check_k2_repeatable(torch, k2, tree_leaves, name, got, payload, weights,
                        kw):
    """A second K2 call on the same inputs must give the same bits."""
    again = k2.fused_aggregate(payload, weights, **kw)
    if not all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(again))):
        raise AssertionError(f"K2 {name}: two calls differ")


def check_aggregation_kernel(torch, k2, tree_leaves):
    """Phase 4: K2 vs its plain version on LeNet trees; returns the
    kernels-line entry."""
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
        # the delta-form reduce of the compressed fused rounds, as
        # engine._delta_aggregate calls it: preweighted, float32 out
        "flat preweighted int8 + scales (codec mode)": (q, w, dict(
            normalize=False, scales=scales, out_dtype=torch.float32)),
        "flat preweighted bf16 -> f32 (codec mode)": (tree16, w, dict(
            normalize=False, out_dtype=torch.float32)),
    }
    worst = 0.0
    for name, (payload, weights, kw) in cases.items():
        got = k2.fused_aggregate(payload, weights, **kw)
        torch.cuda.synchronize()
        err = max_err(torch, tree_leaves(got), tree_leaves(
            k2.fused_aggregate_plain(payload, weights, **kw)))
        check_k2_repeatable(torch, k2, tree_leaves, name, got, payload,
                            weights, kw)
        ms, _, host = timed(torch, lambda: k2.fused_aggregate(
            payload, weights, **kw), "fused_aggregate_kernel")
        bound = k2_bound_ms(tree_leaves, payload, kw)
        print(f"  K2 {name}: max_abs_err {err:.3e}, two calls bit-equal; "
              f"kernel {ms:.5f} ms, bound {bound:.5f} ms ({bound / ms:.3f} "
              f"of it), per call with host overhead {host:.5f} ms")
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
            "how": how, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": lib,
            "segment": check_segment_at_fog_shape(torch, k2, tree_leaves,
                                                  tree, gen)}


def check_segment_at_fog_shape(torch, k2, tree_leaves, tree, gen):
    """Phase 4, K2's segment form at the fog path's shape: D = 256 LeNet
    rows in the G = 16 contiguous groups of ``default_topology(256)``,
    preweighted (the intra-fog reduce of the fused rounds, per-group
    weights summing to 1): error against plain, two calls bit-equal, and
    kernel, plain and ``torch.mm`` (a ``[G, D]`` weight matrix, built
    outside the timing, times the ``[D, N]`` rows) times beside the byte
    bound.  Returns the kernels line's ``segment`` entry."""
    from repro_torch.core import federated as fed
    topo = fed.default_topology(256)
    D, G = 256, topo.num_groups
    ids = topo.segment_ids("cuda")
    raw = torch.rand(D, generator=gen, device="cuda")
    onehot = (ids[None, :] == torch.arange(G, device="cuda")[:, None]).float()
    alpha = raw / (onehot * raw).sum(dim=1)[ids]
    kw = dict(normalize=False, segment_ids=ids, num_segments=G)
    got = k2.fused_aggregate(tree, alpha, **kw)
    torch.cuda.synchronize()
    err = max_err(torch, tree_leaves(got), tree_leaves(
        k2.fused_aggregate_plain(tree, alpha, **kw)))
    check_k2_repeatable(torch, k2, tree_leaves, "segment fog shape", got,
                        tree, alpha, kw)
    if not err <= 1e-5:
        raise AssertionError(f"K2 segment at the fog shape: max_abs_err "
                             f"{err} > 1e-5")
    ms, how, host = timed(torch, lambda: k2.fused_aggregate(tree, alpha, **kw),
                          "fused_aggregate_kernel")
    plain, _, plain_host = timed(torch, lambda: k2.fused_aggregate_plain(
        tree, alpha, **kw))
    flat = torch.cat([leaf.reshape(D, -1) for leaf in tree_leaves(tree)],
                     dim=1)                                   # [D, N]
    weights = onehot * alpha[None, :]                         # [G, D]
    lib, _, lib_host = timed(torch, lambda: torch.mm(weights, flat))
    bound = k2_bound_ms(tree_leaves, tree, kw)
    print(f"  K2 segment form at the fog path's shape (D=256, G={G} "
          f"contiguous, N=61706 f32 preweighted), {how}: max_abs_err "
          f"{err:.3e}, two calls bit-equal; kernel {ms:.5f} ms, plain "
          f"{plain:.5f} ms, torch.mm {lib:.5f} ms, bound {bound:.5f} ms; "
          f"per call with host overhead: wrapper {host:.5f} ms, plain "
          f"{plain_host:.5f} ms, torch.mm {lib_host:.5f} ms")
    return {"shape": f"D 256, G {G}, LeNet f32", "max_abs_err": err,
            "ms": ms, "how": how, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib,
            "library": "torch.mm of a [G, D] weight matrix"}


def lm_path_configs(torch, fed):
    """The three LM fleets of phase 10, as a user builds them from
    ``lm_config``: A, one Mamba-2 block at mamba2-1.3b widths (float32,
    dropout 0.1 for MC scoring), 8 devices; B, the lm-100m decoder, 8
    devices; C, MiniCPM3-4B at its published widths (MLA) cut to one
    layer, float32, dropout 0.1, 4 devices (8 would not fit: the paths
    peak near 68 bytes a fleet parameter).  All route their no-grad
    forwards through the kernels (``impl="pallas"``)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core.model_adapter import DecoderLMAdapter, SSMAdapter
    from repro_torch.models.config import lm_100m
    m = replace(get_config("mamba2-1.3b"), n_layers=1, dropout_rate=0.1,
                param_dtype=torch.float32, dtype=torch.float32)
    c = replace(get_config("minicpm3-4b"), n_layers=1, dropout_rate=0.1,
                param_dtype=torch.float32, dtype=torch.float32)
    return {"A": fed.lm_config(8, adapter=SSMAdapter(m, impl="pallas")),
            "B": fed.lm_config(8, adapter=DecoderLMAdapter(lm_100m(),
                                                           impl="pallas")),
            "C": fed.lm_config(4, adapter=DecoderLMAdapter(c, impl="pallas"))}


def check_aggregation_lm_trees(torch, k2, tree_leaves, tree_map, configs):
    """Phase 4, LM trees: K2 over as many stacked copies of each LM path's
    parameter tree as the path has devices (8 on A and B, 4 on C), over
    tree A in bfloat16 and in int8 with scales, and over tree B in int8
    with scales (path B's int8 uploads).  Returns (worst error, times per
    case)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, times = 0.0, {}
    for name, cfg in configs.items():
        D = cfg.num_devices
        one = cfg.adapter.init(gen)
        tree = tree_map(lambda a: torch.randn((D,) + tuple(a.shape),
                                              generator=gen, device="cuda"),
                        one)
        del one
        N = sum(leaf[0].numel() for leaf in tree_leaves(tree))
        w = torch.rand(D, generator=gen, device="cuda")
        w = w / w.sum()
        got = k2.fused_aggregate(tree, w, normalize=False)
        torch.cuda.synchronize()
        err = max_err(torch, tree_leaves(got), tree_leaves(
            k2.fused_aggregate_plain(tree, w, normalize=False)))
        check_k2_repeatable(torch, k2, tree_leaves, f"LM tree {name}", got,
                            tree, w, {"normalize": False})
        del got
        if not err <= 1e-5:
            raise AssertionError(f"K2 LM tree {name}: max_abs_err {err}")
        if name in ("A", "B"):
            worst = max(worst, check_aggregation_narrow_tree(
                torch, k2, tree_leaves, tree_map, name, tree, w, gen, times))
        ms, how, _ = timed(torch, lambda: k2.fused_aggregate(
            tree, w, normalize=False), "fused_aggregate_kernel")
        plain, _, _ = timed(torch, lambda: k2.fused_aggregate_plain(
            tree, w, normalize=False))
        flat = torch.cat([leaf.reshape(D, -1) for leaf in tree_leaves(tree)],
                         dim=1)
        del tree
        lib, _, _ = timed(torch, lambda: torch.mv(flat.t(), w))
        del flat
        bound = bound_ms(D * N * 4 + N * 4 + D * 4, 2 * D * N)
        print(f"  K2 LM tree {name} (D={D} x N={N}): max_abs_err {err:.3e}; "
              f"{how}: kernel {ms:.5f} ms, plain {plain:.5f} ms, torch.mv "
              f"{lib:.5f} ms, bound {bound:.5f} ms")
        worst = max(worst, err)
        times[name] = {"D": D, "N": N, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": bound}
        torch.cuda.empty_cache()
    return worst, times


def check_aggregation_narrow_tree(torch, k2, tree_leaves, tree_map, tree_name,
                                  tree, w, gen, times):
    """Phase 4, narrow payloads of LM tree ``tree_name``, preweighted with
    float32 out as the compressed fused rounds reduce them: tree A in
    bfloat16 and as int8 codes with per-(device, leaf) scales, tree B as
    int8 codes with scales.  Error against the plain version, two calls
    bit-equal, kernel time against its own byte bound.  Returns the worst
    error."""
    worst = 0.0
    narrow = {"int8 + scales": lambda: (
        tree_map(lambda a: torch.randint(-127, 128, a.shape, generator=gen,
                                         device="cuda", dtype=torch.int8),
                 tree),
        {"normalize": False, "out_dtype": torch.float32, "scales": tree_map(
            lambda a: 1e-3 * torch.rand(8, generator=gen, device="cuda"),
            tree)})}
    if tree_name == "A":
        narrow = {"bf16": lambda: (
            tree_map(lambda a: a.to(torch.bfloat16), tree),
            {"normalize": False, "out_dtype": torch.float32}), **narrow}
    for kind, make in narrow.items():
        name = f"{tree_name} {kind}"
        payload, kw = make()
        got = k2.fused_aggregate(payload, w, **kw)
        torch.cuda.synchronize()
        err = max_err(torch, tree_leaves(got), tree_leaves(
            k2.fused_aggregate_plain(payload, w, **kw)))
        check_k2_repeatable(torch, k2, tree_leaves, f"LM tree {name}", got,
                            payload, w, kw)
        del got
        if not err <= 1e-5:
            raise AssertionError(f"K2 LM tree {name}: max_abs_err {err}")
        ms, how, _ = timed(torch, lambda: k2.fused_aggregate(payload, w, **kw),
                           "fused_aggregate_kernel")
        bound = k2_bound_ms(tree_leaves, payload, kw)
        print(f"  K2 LM tree {name} (D=8): max_abs_err {err:.3e}, two calls "
              f"bit-equal; {how}: kernel {ms:.5f} ms, bound {bound:.5f} ms "
              f"({bound / ms:.3f} of it)")
        times[name] = {"ms": ms, "bound_ms": bound}
        worst = max(worst, err)
        del payload
        torch.cuda.empty_cache()
    return worst


# the JAX package's tests/test_kernels.py attention cases, then the port's
# own edges: GQA 8 with a window, several query tiles with Skv != Sq, the
# generic instantiation (d 13: 52-byte rows, scalar loads; d 80) and the
# MLA widths 96 and 192:
# B, Sq, Skv, H, Hkv, d, causal, window, softcap
ATTN_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None),
    (1, 128, 128, 8, 1, 64, True, 32, None),
    (1, 96, 96, 4, 4, 128, True, None, 50.0),
    (2, 1, 80, 4, 4, 64, True, None, None),
    (1, 64, 72, 4, 2, 64, False, None, None),
    (1, 33, 47, 2, 2, 256, True, None, None),
    (1, 40, 40, 8, 1, 64, True, 16, None),
    (1, 100, 130, 4, 2, 64, True, None, None),
    (1, 37, 45, 4, 2, 13, True, None, None),
    (1, 70, 100, 4, 1, 80, True, None, None),
    (1, 50, 50, 4, 2, 96, True, None, None),
    (1, 50, 50, 4, 2, 192, True, None, 30.0),
]
# path B's MC-scoring call: 8 devices x T=4 x W=32 sequences of 32 tokens
PATH_B_ATTN = (1024, 32, 32, 10, 5, 64, True, None, None)
# lm-100m at its full context (max_seq_len 512): 64 sequences of 512 tokens
LONG_ATTN = (64, 512, 512, 10, 5, 64, True, None, None)
# path C's MC-scoring call: 4 devices x T=4 x W=32 sequences of 32 tokens
# through MiniCPM3-4B's MLA, 40 heads of dn + dr = 96 with v zero-padded
# from dv = 64 (nn/mla.py)
PATH_C_ATTN = (512, 32, 32, 40, 40, 96, True, None, None)
MLA_V_DIM = 64
# llama-3.2-vision's gated cross-attention at its published widths: 32
# text tokens against its 1,600 image tokens, 32 query heads over 8 KV
# heads of 128, no causality; 32 sequences
VISION_ATTN = (32, 32, 1600, 32, 8, 128, False, None, None)
# gemma2-2b served (phase 23): 4 prompts of 4,128 tokens, 8 query heads
# over 4 KV heads of 256, softcap 50; the prefill of a global (S) layer and
# of a local (L) one (window 4,096), and a decode step at q_offset 4,128
# against the full cache of 4,161 slots and against the wrapped ring of
# 4,096 (every slot valid: no causality, no window)
# (name, (B, Sq, Skv, H, Hkv, d, causal, window, softcap), q_offset)
SERVE_ATTN = (
    ("serve prefill (S layer)", (4, 4128, 4128, 8, 4, 256, True, None, 50.0),
     0),
    ("serve prefill (L layer)", (4, 4128, 4128, 8, 4, 256, True, 4096, 50.0),
     0),
    ("serve decode (full cache)", (4, 1, 4161, 8, 4, 256, True, None, 50.0),
     4128),
    ("serve decode (wrapped ring)", (4, 1, 4096, 8, 4, 256, False, None,
                                     50.0), 0),
)
# whisper-small served (phase 24): 4 requests, 12 heads of 64 (H = Hkv),
# 1,500 frames and a prompt of 1,500 tokens, caches of 1,533 slots; no
# softcap, so SDPA computes the same function
WHISPER_ATTN = (
    ("whisper encoder / prefill cross", (4, 1500, 1500, 12, 12, 64, False,
                                         None, None), 0),
    ("whisper prefill self", (4, 1500, 1500, 12, 12, 64, True, None, None),
     0),
    ("whisper decode self (full cache)", (4, 1, 1533, 12, 12, 64, True,
                                          None, None), 1500),
    ("whisper decode cross", (4, 1, 1500, 12, 12, 64, False, None, None),
     0),
)


def causal_pairs(Sq, Skv, causal, window, q_offset):
    """(query, key) pairs the mask keeps, per (batch, head)."""
    n = 0
    for i in range(Sq):
        qp = q_offset + i
        lo = 0 if window is None else max(0, qp - window + 1)
        hi = min(Skv, qp + 1) if causal else Skv
        n += max(0, hi - lo)
    return n


def attn_bound(B, Sq, Skv, H, Hkv, d, causal=True, dv=None, window=None,
               q_offset=0, itemsize=4):
    """K3's bound at one shape (float32 unless ``itemsize``; 2 is bfloat16,
    whose products the tensor cores' peak bounds): q read once,
    the keys and values that the mask can keep read once (causal: none
    past ``q_offset + Sq - 1``; with a window, none before ``q_offset -
    window + 1``), o written once; 2·d + 2·dv operations a kept (query,
    key) pair under the causal mask from ``q_offset`` and the window.
    ``dv`` (default d) is the head dim of v and o: MLA's layer needs only
    dv 64 of the 96 its padded v carries.  Returns (bound ms, bytes,
    flops, bound_by)."""
    dv = d if dv is None else dv
    lo = 0 if window is None else max(0, q_offset - window + 1)
    hi = min(Skv, q_offset + Sq) if causal else Skv
    keys = max(0, hi - lo)
    nbytes = itemsize * (B * Sq * H * (d + dv) + B * keys * Hkv * (d + dv))
    flops = (2 * d + 2 * dv) * B * H * causal_pairs(Sq, Skv, causal, window,
                                                    q_offset)
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / rate
          else "operations")
    return bound_ms(nbytes, flops, rate), nbytes, flops, by


def attn_inputs(torch, gen, case, dtype=None):
    """Random q, k, v of one case (float32 unless ``dtype``); path C's v
    zero-padded from dv as the MLA layer pads it."""
    B, Sq, Skv, H, Hkv, d = case[:6]
    dtype = dtype or torch.float32
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
               for s in ((B, Sq, H, d), (B, Skv, Hkv, d), (B, Skv, Hkv, d)))
    if case == PATH_C_ATTN:
        v[..., MLA_V_DIM:] = 0
    return q, k, v


def check_flash_attention_kernel(torch, k3):
    """Phase 5: K3 vs its plain version, two calls bit-equal; kernel,
    plain and ``scaled_dot_product_attention`` times at path B's shape, at
    512 tokens, at path C's MLA shape and at the vision cross-attention
    shape.  Returns the kernels-line entry (path B's numbers, every timed
    shape under "shapes")."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    cases = [(c, dt) for dt in (torch.float32, torch.bfloat16)
             for c in ATTN_CASES + [PATH_B_ATTN, PATH_C_ATTN, VISION_ATTN]]
    for case, dtype in cases:
        B, Sq, Skv, H, Hkv, d, causal, window, softcap = case
        q, k, v = attn_inputs(torch, gen, case, dtype)
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=Skv - Sq if causal else 0)
        got = k3.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(torch, [got], [k3.flash_attention_plain(q, k, v, **kw)])
        if not torch.equal(got, k3.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"K3 {case} {dtype}: two calls differ")
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        print(f"  K3 {case} {str(dtype)[6:]}: max_abs_err {err:.3e}, two "
              f"calls bit-equal")
        if not err <= tol:
            raise AssertionError(f"K3 {case} {dtype}: max_abs_err {err} > "
                                 f"{tol}")
        if dtype == torch.float32:
            worst = max(worst, err)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = []
    for name, case in (("path B", PATH_B_ATTN), ("512 tokens", LONG_ATTN),
                       ("path C (MLA)", PATH_C_ATTN),
                       ("vision cross-attention", VISION_ATTN)):
        B, Sq, Skv, H, Hkv, d, causal = case[:7]
        q, k, v = attn_inputs(torch, gen, case)
        ms, how, host = timed(torch, lambda: k3.flash_attention(
            q, k, v, causal=causal), "flash_attention_kernel")
        plain, _, _ = timed(torch, lambda: k3.flash_attention_plain(
            q, k, v, causal=causal))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib, _, _ = timed(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True))
        bound, nbytes, flops, by = attn_bound(B, Sq, Skv, H, Hkv, d, causal)
        mode = "causal" if causal else f"non-causal, Skv {Skv}, Hkv {Hkv}"
        print(f"  K3 {name} q [{B}, {Sq}, {H}, {d}] f32 {mode}, {how}: "
              f"kernel {ms:.5f} ms, plain {plain:.5f} ms, "
              f"scaled_dot_product_attention {lib:.5f} ms, bound "
              f"{bound:.5f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.2f} GFLOP; {bound / ms:.3f} of it); wrapper "
              f"per call with host overhead {host:.5f} ms")
        entry = {"case": name, "shape": list(case[:6]), "causal": causal,
                 "ms": ms, "how": how, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib}
        if case == PATH_C_ATTN:
            # the bound above is the kernel's, on v padded to d; the MLA
            # layer itself reads v and writes o at dv only
            lb, lbytes, lflops, lby = attn_bound(B, Sq, Skv, H, Hkv, d,
                                                 causal, dv=MLA_V_DIM)
            print(f"  K3 {name}: the layer's bound at dv {MLA_V_DIM} "
                  f"{lb:.5f} ms by {lby} ({lbytes / 1e9:.4f} GB, "
                  f"{lflops / 1e9:.2f} GFLOP; {lb / ms:.3f} of the kernel's "
                  f"time); the padding costs {bound - lb:.5f} ms of bound")
            entry.update(layer_bound_ms=lb, layer_bound_by=lby)
        shapes.append(entry)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    worst = max(worst, check_flash_attention_serve_shapes(
        torch, k3, gen, sdpa, shapes, SERVE_ATTN,
        time_bf16=lambda name: "full cache" in name))
    worst = max(worst, check_flash_attention_serve_shapes(
        torch, k3, gen, sdpa, shapes, WHISPER_ATTN,
        time_bf16=lambda name: True))
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "max_abs_err": worst, "ms": shapes[0]["ms"],
            "how": shapes[0]["how"], "plain_ms": shapes[0]["plain_ms"],
            "bound_ms": shapes[0]["bound_ms"],
            "bound_by": shapes[0]["bound_by"],
            "library_ms": shapes[0]["library_ms"], "shapes": shapes}


def check_flash_attention_serve_shapes(torch, k3, gen, sdpa, shapes, cases,
                                       time_bf16):
    """Phase 5, the serve paths' shapes (``SERVE_ATTN``, ``WHISPER_ATTN``):
    K3 against its plain version in float32 (2e-5) and bfloat16 (2e-2 of
    the plain output's largest magnitude: a diffuse decode over 4,161
    keys gives outputs of about 0.03, so an absolute limit would pass a
    wrong kernel), two calls bit-equal; kernel, plain and
    ``scaled_dot_product_attention`` times beside the bound in float32,
    and in bfloat16 where ``time_bf16(name)`` (SDPA has no softcap: timed
    without one, a decode on a full cache with a boolean mask of the keys
    up to q_offset).  Appends the entries to ``shapes``; returns the
    largest float32 error."""
    worst = 0.0
    for name, case, q_offset in cases:
        B, Sq, Skv, H, Hkv, d, causal, window, softcap = case
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = attn_inputs(torch, gen, case, dtype)
            got = k3.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = k3.flash_attention_plain(q, k, v, **kw)
            err = max_err(torch, [got], [want])
            if not torch.equal(got, k3.flash_attention(q, k, v, **kw)):
                raise AssertionError(f"K3 {name} {dtype}: two calls differ")
            top = float(want.float().abs().max())
            tol = 2e-2 * top if dtype == torch.bfloat16 else 2e-5
            print(f"  K3 {name} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                  f"(limit {tol:.3e}; largest plain output {top:.4f}), "
                  f"two calls bit-equal")
            del want
            if not err <= tol:
                raise AssertionError(f"K3 {name} {dtype}: max_abs_err {err} "
                                     f"> {tol}")
            if dtype == torch.float32:
                worst = max(worst, err)
            else:   # the float32 entry of this shape, appended just before
                shapes[-1].update(bf16_max_abs_err=err, bf16_limit=tol)
            if dtype == torch.bfloat16 and not time_bf16(name):
                continue
            ms, how, host = timed(torch, lambda: k3.flash_attention(
                q, k, v, **kw), "flash_attention_kernel")
            plain, _, _ = timed(torch, lambda: k3.flash_attention_plain(
                q, k, v, **kw))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = None
            if Sq == 1 and causal:
                mask = (torch.arange(Skv, device="cuda") <= q_offset)[None]
            lib, _, _ = timed(torch, lambda: sdpa(
                qt, kt, vt, attn_mask=mask, is_causal=causal and Sq > 1,
                enable_gqa=True))
            bound, nbytes, flops, by = attn_bound(
                B, Sq, Skv, H, Hkv, d, causal, window=window,
                q_offset=q_offset, itemsize=q.element_size())
            lib_name = ("scaled_dot_product_attention" if softcap is None
                        else "scaled_dot_product_attention (no softcap)")
            print(f"  K3 {name} q [{B}, {Sq}, {H}, {d}] k [{B}, {Skv}, "
                  f"{Hkv}, {d}] {str(dtype)[6:]} q_offset {q_offset}, "
                  f"causal {causal}, {how}: kernel {ms:.5f} ms, plain "
                  f"{plain:.5f} ms, {lib_name} {lib:.5f} ms, "
                  f"bound {bound:.5f} ms by {by} ({nbytes / 1e9:.4f} GB, "
                  f"{flops / 1e9:.2f} GFLOP; {bound / ms:.3f} of it); "
                  f"wrapper per call with host overhead {host:.5f} ms")
            shapes.append({"case": f"{name} {str(dtype)[6:]}",
                           "shape": list(case[:6]), "causal": causal,
                           "window": window, "q_offset": q_offset, "ms": ms,
                           "how": how, "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by, "library_ms": lib,
                           "max_abs_err": err})
            del qt, kt, vt
        del q, k, v, got
        torch.cuda.empty_cache()
    return worst


# (Z, L, g, h, n, p): the JAX package's tests/test_kernels.py shapes
# (G, L, n, p) with one head per group, a multi-head case, the published
# chunk, the kernel's edges (head counts a 16-head block does not divide,
# two groups, a 5-row last tile, rows that are not 16 bytes long), and
# path A's MC-scoring call (8 devices x T=4 x W=32 sequences of 32 tokens,
# 64 heads of 64, state 128, one group)
SSD_CASES = [(4, 32, 1, 1, 16, 8), (2, 64, 1, 1, 32, 16),
             (1, 128, 1, 1, 128, 64), (2, 64, 2, 4, 32, 16),
             (4, 256, 1, 8, 128, 64), (3, 32, 1, 5, 128, 64),
             (2, 32, 1, 67, 128, 64), (2, 64, 2, 6, 32, 16),
             (3, 37, 1, 4, 128, 64), (2, 40, 1, 67, 21, 13)]
PATH_A_SSD = (1024, 32, 1, 64, 128, 64)
# the published chunk at mamba2-1.3b widths: 8 sequences of 2048 tokens
PUBLISHED_SSD = (64, 256, 1, 64, 128, 64)


def ssd_inputs(torch, gen, Z, L, g, h, n, p, dtype=None):
    dtype = dtype or torch.float32
    C, B = (torch.randn((Z, L, g, n), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    la = -torch.cumsum(torch.nn.functional.softplus(torch.randn(
        (Z, L, h), generator=gen, device="cuda")), dim=1)
    xdt = torch.randn((Z, L, h, p), generator=gen, device="cuda").to(dtype)
    return C, B, la, xdt


def ssd_bound(Z, L, g, h, n, p):
    """K4's bound at one float32 shape: C, B, la and xdt read once, y and
    the state written once; the causal C·Bᵀ once per group, the causal y
    and the state per head.  Returns (bound ms, bytes, flops, bound_by)."""
    pairs = L * (L + 1) // 2
    nbytes = 4 * (2 * Z * L * g * n + Z * L * h + 2 * Z * L * h * p
                  + Z * h * p * n)
    flops = 2 * Z * (g * pairs * n + h * (pairs * p + L * p * n))
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
          else "operations")
    return bound_ms(nbytes, flops), nbytes, flops, by


def check_ssd_kernel(torch, k4):
    """Phase 6: K4 vs its plain version, two calls bit-equal; kernel and
    plain times at path A's shape and at the published chunk.  Returns the
    kernels-line entry (path A's numbers, both shapes under "shapes")."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    cases = [(c, torch.float32) for c in SSD_CASES + [PATH_A_SSD]]
    cases += [(c, torch.bfloat16) for c in (SSD_CASES[4], SSD_CASES[-1],
                                            PATH_A_SSD)]
    for case, dtype in cases:
        args = ssd_inputs(torch, gen, *case, dtype=dtype)
        got = k4.ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        err = max_err(torch, got, k4.ssd_intra_chunk_plain(*args))
        again = k4.ssd_intra_chunk(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K4 {case} {dtype}: two calls differ")
        print(f"  K4 (Z, L, g, h, n, p) = {case} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e}, two calls bit-equal")
        if not err <= 1e-4:
            raise AssertionError(f"K4 {case}: max_abs_err {err} > 1e-4")
        worst = max(worst, err)
        del got, again, args

    shapes = []
    for name, shape in (("path A", PATH_A_SSD), ("published chunk",
                                                 PUBLISHED_SSD)):
        args = ssd_inputs(torch, gen, *shape)
        ms, how, host = timed(torch, lambda: k4.ssd_intra_chunk(*args),
                              "ssd_intra_chunk_kernel")
        plain, _, _ = timed(torch, lambda: k4.ssd_intra_chunk_plain(*args))
        bound, nbytes, flops, by = ssd_bound(*shape)
        print(f"  K4 {name} (Z, L, g, h, n, p) = {shape} f32, {how}: kernel "
              f"{ms:.5f} ms, plain {plain:.5f} ms, bound {bound:.5f} ms by "
              f"{by} ({nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP; "
              f"{bound / ms:.3f} of it); wrapper per call with host "
              f"overhead {host:.5f} ms")
        shapes.append({"shape": list(shape), "ms": ms, "how": how,
                       "plain_ms": plain, "bound_ms": bound, "bound_by": by})
        del args
        torch.cuda.empty_cache()
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:50",
            "max_abs_err": worst, "ms": shapes[0]["ms"],
            "how": shapes[0]["how"], "plain_ms": shapes[0]["plain_ms"],
            "bound_ms": shapes[0]["bound_ms"],
            "bound_by": shapes[0]["bound_by"], "library_ms": None,
            "shapes": shapes}


def check_small_lm_rounds_against_cpu(torch, fed, interop):
    """Phase 7, LM: the same RNG-free fused LM rounds (dropout 0, window ≥
    shard) on the card and on the CPU, for the reduced SSM and a two-layer
    decoder cut from lm-100m: equal labeled sets, and params within 1e-4
    or twice the float32 rounding floor of the run, whichever is larger.
    The floor is the distance between the CPU run and a CPU run with
    float64 weights: Adam's normalized steps turn rounding noise in
    near-zero gradient components into steps of up to lr, so in the
    decoder float32 rounding alone moves the weights by ~6e-4 here."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.core.model_adapter import DecoderLMAdapter, SSMAdapter
    from repro_torch.data.lm import lm_federated_split, make_lm_dataset
    from repro_torch.models.config import lm_100m
    from repro_torch.tree import tree_leaves, tree_map

    dec = replace(lm_100m().reduced(n_layers=2, vocab_size=256,
                                    max_seq_len=32), dropout_rate=0.0)
    adapters = {"ssm": SSMAdapter(fed.lm_model_config(dropout_rate=0.0),
                                  impl="pallas"),
                "decoder": DecoderLMAdapter(dec, impl="pallas")}
    shards = lm_federated_split(3, 20, seq_len=32, vocab=256, seed=0)
    test = make_lm_dataset(64, seq_len=32, vocab=256, seed=5, stream_seed=0)
    seed_set = make_lm_dataset(6, seq_len=32, vocab=256, seed=11,
                               stream_seed=0)
    for name, adapter in adapters.items():
        cfg = fed.lm_config(3, adapter=adapter, initial_train=6,
                            acquisitions=2, k_per_acquisition=3,
                            pool_window=64, mc_samples=2,
                            train_steps_per_acq=3)
        p0 = interop.params_to_jax(adapter.init(
            torch.Generator().manual_seed(0)))
        wide = replace(adapter, config=replace(
            adapter.config, param_dtype=torch.float64, dtype=torch.float64))
        out = {}
        for run, dev, ad in (("cuda", "cuda", adapter), ("cpu", "cpu", adapter),
                             ("cpu64", "cpu", wide)):
            c = replace(cfg, adapter=ad)
            eng = EdgeEngine(fed.Trainer(c, device=dev), c, shards,
                             seed_set, test, total_acquisitions=4, device=dev)
            start = interop.params_from_jax(p0, dev)
            if run == "cpu64":
                start = tree_map(lambda a: a.double(), start)
            st, recs, fin = eng.run_rounds_fused(eng.init_state(start), 2)
            out[run] = (interop.vpool_to_jax(st.pool)["labeled_mask"],
                        [np.asarray(a, np.float64) for a in tree_leaves(
                            interop.params_to_jax(fin))],
                        recs["agg_acc"].tolist())
        (mg, pg, ag), (mc, pc, ac) = out["cuda"], out["cpu"]
        if not np.array_equal(mg, mc):
            raise AssertionError(f"LM {name}: card and CPU labeled different "
                                 "samples")
        dist = lambda x, y: max(float(np.abs(a - b).max())
                                for a, b in zip(x, y))
        err, floor = dist(pg, pc), dist(pc, out["cpu64"][1])
        tol = max(1e-4, 2 * floor)
        print(f"  card vs CPU small LM rounds ({name}): labeled sets equal, "
              f"params max_abs_err {err:.3e} (float32 rounding floor "
              f"{floor:.3e}, tolerance {tol:.3e}), agg_acc {ag} vs {ac}")
        if not err <= tol:
            raise AssertionError(f"LM {name}: card vs CPU params differ by "
                                 f"{err} > {tol}")


# path C's parameters a device: MiniCPM3-4B's embedding (73456 x 2560,
# tied), one layer at its published widths (MLA 13,520,384 with its norm,
# SwiGLU 49,154,560 with its norm) and the final norm; the JAX package's
# decoder_init gives the same count (jax.eval_shape, on the CPU)
PATH_C_PARAMS = 250_724_864


class AttentionShapes:
    """While active, the ``(H, Hkv, d)`` of every call the attention layers
    make to K3's wrapper (``impl="pallas"``), counted in ``self.seen``; the
    wrapper itself runs, and counts its launches, as always."""

    def __init__(self):
        from repro_torch.nn import attention
        self.module, self.seen = attention, {}

    def __enter__(self):
        self.fn = self.module.flash_attention

        def record(q, k, v, **kw):
            key = (q.shape[2], k.shape[2], q.shape[3])
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.fn(q, k, v, **kw)
        self.module.flash_attention = record
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.fn


def run_lm_path(torch, fed, name, cfg, kernels):
    """Phase 10: one LM path through ``run_experiment``; returns (wall s,
    launches, peak GiB, K3's (H, Hkv, d) calls)."""
    from repro_torch.tree import tree_leaves
    n_params = sum(a.numel() for a in tree_leaves(cfg.adapter.init(
        torch.Generator(device="cuda").manual_seed(0))))
    if name == "C" and n_params != PATH_C_PARAMS:
        raise AssertionError(f"path C: {n_params} parameters a device, not "
                             f"{PATH_C_PARAMS}")
    for k in kernels.values():
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with AttentionShapes() as shapes:
        rounds = fed.run_experiment(cfg, scenario="lm", rounds=2,
                                    n_test=256)[0]["rounds"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    accs = [r["aggregated_acc"] for r in rounds]
    print(f"  path {name}: {n_params} params per device x "
          f"{cfg.num_devices} devices; "
          f"aggregated_acc per round {accs}; wall {wall:.3f} s; launches "
          f"{launches}; K3 calls by (H, Hkv, head dim) {shapes.seen}; peak "
          f"device memory {peak:.2f} GiB "
          f"({torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved, "
          f"allocator {os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")
    for r in rounds:
        wsum = sum(r["aggregation"]["weights"])
        acc = r["aggregated_acc"]
        if not (abs(wsum - 1.0) < 1e-4 and acc == acc and 0.0 <= acc <= 1.0):
            raise AssertionError(f"path {name} round {r['round']}: weights "
                                 f"sum {wsum}, acc {acc}")
    return wall, launches, peak, shapes.seen


# phase 22: the decoder zoo's families at the JAX package's reduced()
# sizes (the published widths do not fit a fleet on one card)
ZOO_FAMILIES = (("deepseek-v2", "deepseek-v2-236b"),
                ("arctic", "arctic-480b"),
                ("recurrentgemma", "recurrentgemma-9b"),
                ("llama-vision", "llama-3.2-vision-11b"),
                ("mamba2", "mamba2-1.3b"))
# leaves that start at zero weight (MLA's q_norm / kv_norm and the Mamba
# block's gated norm, applied with zero_centered=False; the gates of the
# cross-attention layers): drawn from the seed so the outputs are not 0
ZERO_START = ("q_norm", "kv_norm", "norm", "gate_attn", "gate_ffn")


class MoERecords:
    """While active, every MoE layer call of the decoder records its
    capacity drops a device and the least gap, over its tokens, between
    the K-th and (K+1)-th router probability (expert choice is an integer
    decision: a small gap could flip between card and CPU)."""

    def __init__(self, torch):
        from repro_torch.models import decoder
        from repro_torch.nn import moe
        self.torch, self.decoder, self.moe, self.calls = torch, decoder, moe, []

    def __enter__(self):
        torch, moe = self.torch, self.moe

        def record(params, x, *, cfg, impl="sort"):
            _, probs, _, experts = moe.route(params, x, cfg)
            top = torch.sort(probs, dim=-1, descending=True)[0]
            K, E = cfg.experts_top_k, cfg.n_experts
            gap = float((top[..., K - 1] - top[..., K]).min().detach())
            # a group (device, row) drops what an expert gets past C
            load = torch.nn.functional.one_hot(experts, E).sum(dim=(2, 3))
            drops = (load - moe.capacity(cfg, x.shape[2])).clamp(min=0)
            self.calls.append((gap, drops.sum(dim=(1, 2)).tolist()))
            return moe.moe_apply(params, x, cfg=cfg, impl=impl)
        self.decoder.moe_apply = record
        return self

    def __exit__(self, *exc):
        self.decoder.moe_apply = self.moe.moe_apply


def zoo_params(torch, cfg, seed, D=2):
    """D models of ``cfg`` stacked (``models.api``'s init: the decoder's
    or whisper's), on the CPU, from ``seed``, with the ``ZERO_START``
    leaves drawn uniform in [0.5, 1.5]."""
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map, tree_map_with_path
    gen = torch.Generator().manual_seed(seed)
    init = build_model(cfg).init
    params = tree_map(lambda *a: torch.stack(a),
                      *(init(gen) for _ in range(D)))

    def draw(path, a):
        keys = path.split("/")
        if keys[-1] in ZERO_START or (keys[-1] == "scale"
                                      and keys[-2] in ZERO_START):
            return 0.5 + torch.rand(a.shape, generator=gen)
        return a
    return tree_map_with_path(draw, params)


def check_zoo_against_cpu(torch):
    """Phase 22 (a): ``decoder_forward`` of each zoo family at its
    ``reduced()`` config, two devices with their own weights, the same
    weights and tokens (and image embeddings) on the card and on the CPU,
    ``impl="pallas"`` (K3 on the card, its plain version on the CPU):
    logits within 1e-4, the per-device aux within 1e-5, the capacity
    drops of every MoE layer equal.  Returns a summary per family."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.decoder import decoder_forward
    from repro_torch.tree import tree_map
    out = {}
    for name, arch in ZOO_FAMILIES:
        cfg = get_config(arch).reduced()
        params = zoo_params(torch, cfg, 22)
        r = np.random.default_rng(22)
        toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (2, 4, 32))
                                .astype(np.int32))
        img = (torch.from_numpy(r.normal(size=(
            2, 4, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
            if "X" in cfg.attn_pattern else None)
        res = {}
        for dev in ("cuda", "cpu"):
            with MoERecords(torch) as rec:
                logits, _, aux = decoder_forward(
                    tree_map(lambda a: a.to(dev), params), toks.to(dev),
                    cfg=cfg, image_embeds=None if img is None else img.to(dev),
                    impl="pallas")
            res[dev] = (logits.cpu(), aux.cpu(), rec.calls)
        (lg, ag, mg), (lc, ac, mc) = res["cuda"], res["cpu"]
        err = float((lg - lc).abs().max())
        aux_err = float((ag - ac).abs().max())
        drops_g, drops_c = [m[1] for m in mg], [m[1] for m in mc]
        gaps = (min((m[0] for m in mg), default=None),
                min((m[0] for m in mc), default=None))
        print(f"  {name} ({arch} reduced: layers {cfg.n_layers}, pattern "
              f"{''.join(cfg.attn_pattern)}, d_model {cfg.d_model}, experts "
              f"{cfg.n_experts}): logits {tuple(lg.shape)} max_abs_err "
              f"{err:.3e}; aux card {ag.tolist()} CPU {ac.tolist()} "
              f"(err {aux_err:.3e}); MoE layers {len(mg)}: capacity drops "
              f"card {drops_g} CPU {drops_c}, least K-th to (K+1)-th router "
              f"gap card {gaps[0]} CPU {gaps[1]}")
        if not (err <= 1e-4 and aux_err <= 1e-5 and drops_g == drops_c
                and bool(torch.isfinite(lg).all())):
            raise AssertionError(f"zoo {name}: card vs CPU logits {err}, aux "
                                 f"{aux_err}, drops {drops_g} vs {drops_c}")
        out[name] = {"logits_err": err, "aux_err": aux_err,
                     "aux": ag.tolist(), "drops": drops_g,
                     "least_router_gap": gaps[1]}
    return out


def run_zoo_fleets(torch, fed, reset, read):
    """Phase 22 (b): one ``scenario="lm"`` round at 4 devices on the card
    for deepseek-v2 and recurrentgemma at ``reduced()``, dropout 0.1,
    ``impl="pallas"``: accuracy finite in [0, 1], weights summing to 1;
    the MoE fleet's fog model gives a positive aux on test tokens.
    Returns {name: (wall s, launches)}."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core.model_adapter import DecoderLMAdapter
    from repro_torch.data.lm import make_lm_dataset
    from repro_torch.models.decoder import decoder_forward
    from repro_torch.tree import tree_map
    out = {}
    for name, arch in (("deepseek-v2", "deepseek-v2-236b"),
                       ("recurrentgemma", "recurrentgemma-9b")):
        mcfg = replace(get_config(arch).reduced(), dropout_rate=0.1)
        cfg = fed.lm_config(4, adapter=DecoderLMAdapter(mcfg, impl="pallas"))
        reset()
        t0 = time.perf_counter()
        with FogModels(fed) as fog:
            rep = fed.run_experiment(cfg, scenario="lm", rounds=1,
                                     n_test=256)[0]
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, read()
        fog.check_finite(torch, f"zoo fleet {name}")
        r = rep["rounds"][0]
        wsum, acc = sum(r["aggregation"]["weights"]), r["aggregated_acc"]
        toks = torch.from_numpy(make_lm_dataset(
            64, seq_len=32, vocab=mcfg.vocab_size, seed=5,
            stream_seed=0).images).to("cuda")
        _, _, aux = decoder_forward(
            tree_map(lambda a: a[None], fog.models[-1]), toks[None],
            cfg=mcfg, impl="pallas")
        print(f"  fleet {name} (4 devices, 1 round): aggregated_acc {acc}, "
              f"weights sum {wsum:.6f}, fog model's aux on 64 test "
              f"sequences {float(aux[0]):.6f}; wall {wall:.3f} s; launches "
              f"{launches}")
        if not (acc == acc and 0.0 <= acc <= 1.0 and abs(wsum - 1.0) < 1e-4):
            raise AssertionError(f"zoo fleet {name}: acc {acc}, weights sum "
                                 f"{wsum}")
        if (mcfg.n_experts > 0) != (float(aux[0]) > 0.0):
            raise AssertionError(f"zoo fleet {name}: aux {float(aux[0])}")
        out[name] = (wall, launches)
    return out


# phase 22 (c): prefill then decode, each family at reduced(); gemma2-2b's
# window is 128 there, so a prompt of 124 wraps its ring at the fifth step;
# whisper attends to frames of its reduced encoder_seq_len, 64
ZOO_DECODE = (("qwen3-8b", "qwen3-8b"), ("gemma2-2b", "gemma2-2b"),
              ("deepseek-v2", "deepseek-v2-236b"), ("arctic", "arctic-480b"),
              ("recurrentgemma", "recurrentgemma-9b"),
              ("mamba2", "mamba2-1.3b"),
              ("llama-vision", "llama-3.2-vision-11b"),
              ("whisper", "whisper-small"))
DECODE_PROMPT, DECODE_STEPS = 124, 8


def check_zoo_decode_against_cpu(torch):
    """Phase 22 (c): each ``ZOO_DECODE`` family at ``reduced()`` through
    ``models.api`` as a server calls it: a prefill of 2 prompts of 124
    tokens, then 8 decode steps on the same tokens, on the card and on the
    CPU (the same weights, tokens, image embeddings and frames from the
    seed),
    ``impl="pallas"`` (K3 on the card, its plain version on the CPU):
    every step's logits within 1e-4 with float32 caches and within 2e-2 of
    the largest logit with the default bfloat16 caches; every MoE call's
    capacity drops equal.  Returns a summary per family."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_map
    out = {}
    for name, arch in ZOO_DECODE:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = tree_map(lambda a: a[0], zoo_params(torch, cfg, 23, D=1))
        r = np.random.default_rng(23)
        toks = torch.from_numpy(r.integers(
            0, cfg.vocab_size, (2, DECODE_PROMPT + DECODE_STEPS)))
        img = {k: torch.from_numpy(r.normal(size=shape).astype(np.float32))
               for k, shape in model.extra_input_shapes(
                   2, cfg.encoder_seq_len).items()}
        res = {}
        for cache_dtype in (torch.float32, torch.bfloat16):
            for dev in ("cuda", "cpu"):
                p = tree_map(lambda a: a.to(dev), params)
                extras = {k: v.to(dev) for k, v in img.items()} or None
                with MoERecords(torch) as rec:
                    logits, caches = model.prefill(
                        p, toks[:, :DECODE_PROMPT].to(dev), extras=extras,
                        max_cache_len=DECODE_PROMPT + DECODE_STEPS + 1,
                        cache_dtype=cache_dtype, impl="pallas")
                    steps = [logits[:, 0]]
                    for i in range(DECODE_STEPS):
                        pos = DECODE_PROMPT + i
                        logits, caches = model.decode_step(
                            p, toks[:, pos:pos + 1].to(dev), caches,
                            position=pos, extras=extras, impl="pallas")
                        steps.append(logits[:, 0])
                res[dev] = (torch.stack(steps, dim=1).float().cpu(),
                            [c[1] for c in rec.calls])
            (lg, dg), (lc, dc) = res["cuda"], res["cpu"]
            err = float((lg - lc).abs().max())
            rel = err / float(lc.abs().max())
            f32 = cache_dtype == torch.float32
            print(f"  {name} decode ({arch} reduced, {str(cache_dtype)[6:]} "
                  f"caches): prefill {DECODE_PROMPT} + {DECODE_STEPS} steps, "
                  f"logits {tuple(lg.shape)} card vs CPU max_abs_err "
                  f"{err:.3e} ({rel:.3e} of the largest); MoE calls "
                  f"{len(dg)}, capacity drops equal: {dg == dc}")
            if not ((err <= 1e-4 if f32 else rel <= 2e-2) and dg == dc
                    and bool(torch.isfinite(lg).all())):
                raise AssertionError(f"zoo decode {name} {cache_dtype}: "
                                     f"err {err} ({rel}), drops {dg} vs {dc}")
            out[f"{name} {str(cache_dtype)[6:]}"] = {
                "logits_err": err, "rel_err": rel, "moe_calls": len(dg),
                "drops": sum(sum(d) for d in dg)}
    return out


# phase 23: gemma2-2b (src/repro_torch/configs/gemma2_2b.py, arXiv:2408.00118)
# served at its published widths and full depth, 26 layers; the JAX
# package's decoder_init gives the same count (jax.eval_shape, on the CPU)
SERVE = dict(batch=4, prompt_len=4128, max_new_tokens=32)
SERVE_PARAMS = 2_614_341_888
SERVE_K3 = 26 * SERVE["max_new_tokens"]   # a prefill and 31 decode steps


# phase 24: whisper-small (src/repro_torch/configs/whisper_small.py,
# arXiv:2212.04356) served at its published widths, 12 + 12 layers, with
# frames of the family's native 1,500-frame encoder length; the JAX
# package's whisper_init gives the same count (jax.eval_shape, on the CPU).
# ``serve`` makes the frames [B, prompt_len, d_model], the reference's
# rule, so 1,500 frames bring 1,500-token prompts: past whisper's
# 448-token decoder context, a decoder length no whisper user sends.
WHISPER = dict(batch=4, prompt_len=1500, max_new_tokens=32)
WHISPER_PARAMS = 263_454_720
# the prefill: 12 encoder, 12 decoder self and 12 cross; a decode step:
# 12 self and 12 cross, 31 steps
WHISPER_K3 = 36 + 24 * (WHISPER["max_new_tokens"] - 1)

# the two served families: the traffic, the parameter count, K3's launches
# in a "pallas" serve, and the teacher-forced routes held against it
SERVED = {
    "gemma2-2b": dict(shape=SERVE, n_params=SERVE_PARAMS, k3=SERVE_K3,
                      routes=("naive", "auto")),
    "whisper-small": dict(shape=WHISPER, n_params=WHISPER_PARAMS,
                          k3=WHISPER_K3, routes=("naive", "blockwise")),
}


def serve_run(torch, serve, reset, read, arch, **kw):
    """One ``serve(arch, full_config=True, ...)`` call at the arch's
    ``SERVED`` shape on the card, its launches counted: ``(result, wall s,
    launches, peak allocated GiB, peak reserved GiB)``."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    res = serve(arch, full_config=True, device="cuda",
                **SERVED[arch]["shape"], **kw)
    torch.cuda.synchronize()
    wall, launches = time.perf_counter() - t0, read()
    return (res, wall, launches, torch.cuda.max_memory_allocated() / 2**30,
            torch.cuda.max_memory_reserved() / 2**30)


def run_serve_path(torch, reset, read, arch):
    """Phases 23 and 24: ``arch`` served as a user serves it
    (``launch.serve``) at its ``SERVED`` traffic.  Phase 23, gemma2-2b: 4
    prompts of 4,128 tokens (past the 4,096 window: the rings wrap; past
    2,048 keys: ``"auto"`` prefills on the blockwise core), 32 new tokens,
    caches of 4,161 slots.  Phase 24, whisper-small: frames ``[4, 1500,
    768]`` and prompts of 1,500 tokens (``serve`` ties the frames to the
    prompt length), 32 new tokens, caches of 1,533 slots.  (a) float32
    weights, activations and caches, the same weights, prompts and
    modality inputs on ``"pallas"`` (K3 on every attention, the arch's
    ``k3`` launches) and on the arch's other routes teacher-forced on the
    pallas run's tokens (no launch): every step's logits within 1e-4 of
    the largest logit, and the pallas run's within 1e-4 of ``model.apply``
    over the same inputs and tokens (one request at a time); the share of
    equal greedy tokens.  (b) the published bfloat16, ``"pallas"``: prefill
    seconds, decode tokens a second, peak memory, K3 launches, logits
    finite and tokens in range.  Returns the summary and the main-path
    launches."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.api import build_model
    spec = SERVED[arch]
    shape, want_params = spec["shape"], spec["n_params"]
    f32 = torch.float32
    runs, summary, all_launches = {}, {}, []
    for impl in ("pallas",) + spec["routes"]:
        forced = None if impl == "pallas" else runs["pallas"].tokens
        res, wall, launches, peak, reserved = serve_run(
            torch, serve, reset, read, arch, impl=impl, dtype=f32,
            forced=forced, keep_logits=True)
        runs[impl] = res
        all_launches.append(launches)
        how = "" if forced is None else ", teacher-forced"
        print(f"  (a) float32, impl={impl!r}{how}: {res.n_params:,} "
              f"parameters; prefill {res.prefill_s:.3f} s, "
              f"decode {res.tokens_per_s:.1f} tokens/s ({res.decode_s:.3f} "
              f"s); wall {wall:.3f} s; peak {peak:.2f} GiB allocated, "
              f"{reserved:.2f} reserved; launches {launches}")
        if res.n_params != want_params:
            raise AssertionError(f"{arch} has {res.n_params} parameters, "
                                 f"not {want_params}")
        want_k3 = spec["k3"] if impl == "pallas" else 0
        if launches["flash_attention"] != want_k3:
            raise AssertionError(f"{arch} serve impl={impl}: K3 launched "
                                 f"{launches['flash_attention']} times, not "
                                 f"{want_k3}")
        summary[f"f32 {impl}"] = {
            "wall_s": wall, "prefill_s": res.prefill_s,
            "decode_s": res.decode_s, "tokens_per_s": res.tokens_per_s,
            "peak_gib": peak, "reserved_gib": reserved,
            "launches": launches}
    base = runs["pallas"].logits
    scale = float(base.abs().max())
    for impl in spec["routes"]:
        d = (runs[impl].logits - base).abs()
        pre, dec = float(d[:, 0].max()) / scale, float(d[:, 1:].max()) / scale
        same = float((runs[impl].tokens == runs["pallas"].tokens)
                     .float().mean())
        print(f"  (a) {impl} vs pallas: prefill's last logits "
              f"{pre:.3e}, decode steps {dec:.3e} of the largest logit "
              f"{scale:.4f}; equal greedy tokens {same:.4f}")
        if not (pre <= 1e-4 and dec <= 1e-4):
            raise AssertionError(f"{arch} serve {impl} vs pallas: {pre}, "
                                 f"{dec}")
        summary[f"f32 {impl}"].update(rel_err_prefill=pre, rel_err_decode=dec,
                                      equal_tokens=same)
    # serve's weights come from seed 0 and its modality inputs from seed 2
    cfg = replace(get_config(arch), param_dtype=f32, dtype=f32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    extras = {k: torch.randn(s, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
        for k, s in model.extra_input_shapes(shape["batch"],
                                             shape["prompt_len"]).items()}
    toks = torch.cat([runs["pallas"].prompts, runs["pallas"].tokens[:, :-1]],
                     dim=1)
    P = shape["prompt_len"]
    worst = 0.0
    with torch.no_grad():
        for b in range(shape["batch"]):
            full, _ = model.apply(
                params, toks[b:b + 1], impl="pallas",
                extras={k: e[b:b + 1] for k, e in extras.items()} or None)
            worst = max(worst, float((full[0, P - 1:] - base[b]).abs().max()))
            del full
    del params, extras
    worst /= scale
    print(f"  (a) decode vs the full forward over the same inputs and "
          f"{toks.shape[1]} tokens: {worst:.3e} of the largest logit")
    if not worst <= 1e-4:
        raise AssertionError(f"{arch} serve decode vs full forward: {worst}")
    summary["decode_vs_forward"] = worst
    del runs, base
    res, wall, launches, peak, reserved = serve_run(
        torch, serve, reset, read, arch, impl="pallas", keep_logits=True)
    all_launches.append(launches)
    ok = (bool(torch.isfinite(res.logits.float()).all())
          and 0 <= int(res.tokens.min())
          and int(res.tokens.max()) < cfg.vocab_size)
    print(f"  (b) bfloat16, impl='pallas': prefill {res.prefill_s:.3f} s, "
          f"decode {res.tokens_per_s:.1f} tokens/s ({res.decode_s:.3f} s for "
          f"{shape['max_new_tokens']} tokens of {shape['batch']} requests); "
          f"wall {wall:.3f} s; peak {peak:.2f} GiB allocated, "
          f"{reserved:.2f} reserved; K3 launches "
          f"{launches['flash_attention']}; logits finite and tokens in "
          f"range: {ok}; request 0: {res.tokens[0, :16].tolist()}")
    if not ok or launches["flash_attention"] != spec["k3"]:
        raise AssertionError(f"{arch} serve bf16: ok {ok}, launches "
                             f"{launches}")
    summary["bf16 pallas"] = {
        "wall_s": wall, "prefill_s": res.prefill_s, "decode_s": res.decode_s,
        "tokens_per_s": res.tokens_per_s, "peak_gib": peak,
        "reserved_gib": reserved, "launches": launches}
    return summary, all_launches


# phase 25: the training half.  (a) gemma2-2b trained at its published
# widths and full depth through launch.train (SERVE_PARAMS parameters,
# adamw); (b) whisper-small's federated schedule at published widths,
# two groups syncing every 2nd step, a checkpoint at step 10; (d) the
# acquisition step at gemma2-2b's full vocabulary: 8 candidates of 128
# tokens scored with T = 4 (K1 on [4, 1024, 256000] float32), 4 kept
TRAIN = dict(steps=6, batch=4, seq=128, groups=1)
WHISPER_TRAIN = dict(steps=10, batch=4, seq=128, groups=2, sync_every=2)
ACQUIRE = dict(candidates=8, seq=128, mc_samples=4, keep=4)


def run_train_path(torch, reset, read):
    """Phase 25 (a) and (b): ``launch.train.train`` as a user calls it, on
    the card.  (a) gemma2-2b, ``TRAIN``: the parameter count, every step's
    loss finite, seconds a step, peak memory, no kernel launched (the
    train step runs ``"auto"``, naive attention at 128 tokens).  (b)
    whisper-small, ``WHISPER_TRAIN``: a sync every 2nd step, both groups'
    params bit-equal after the last (step 10's), and the round-10
    checkpoint (``save_round``) loaded back (``load_round``) bit-equal to
    group 0's params.  After each run, the host's side of a step alone:
    the arch's ``SyntheticLMStream`` built and sampled at the run's batch
    as ``train`` samples it.  Returns (summary, gemma2-2b's trained
    params, launches of both runs)."""
    import io
    import math
    import tempfile
    from contextlib import redirect_stdout
    from repro_torch.checkpoint import load_round
    from repro_torch.configs import get_config
    from repro_torch.data.lm import SyntheticLMStream
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_items, tree_leaves

    def host_data(arch, batch, seq, **_):
        vocab = get_config(arch).vocab_size
        t0 = time.perf_counter()
        stream = SyntheticLMStream(vocab=vocab, seed=0)
        built, sampled = time.perf_counter() - t0, []
        for step in range(3):
            t0 = time.perf_counter()
            stream.sample(batch, seq, seed=1000 * step)
            sampled.append(time.perf_counter() - t0)
        print(f"  {arch} host data alone (SyntheticLMStream, vocab {vocab}):"
              f" built in {built:.4f} s; sample({batch}, {seq}) "
              f"{[round(t, 4) for t in sampled]} s")
        return {"stream_build_s": built, "sample_s": sampled}

    def run(arch, **kw):
        torch.cuda.empty_cache()
        reset()
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()) as out:
            res = train(arch, full_config=True, device="cuda", **kw)
        torch.cuda.synchronize()
        wall, launches = time.perf_counter() - t0, read()
        print(out.getvalue(), end="")
        losses = [l for row in res.losses for l in row]
        later = res.step_s[1:]
        print(f"  {arch}: {res.n_params:,} parameters; losses "
              f"{[[round(l, 5) for l in row] for row in res.losses]}; "
              f"seconds a step {[round(t, 4) for t in res.step_s]} (after "
              f"the first: mean {sum(later) / len(later):.4f}); wall "
              f"{wall:.3f} s; peak {res.peak_gib:.2f} GiB allocated, "
              f"{torch.cuda.max_memory_reserved() / 2**30:.2f} reserved; "
              f"launches {launches}")
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"{arch} train: a loss is not finite")
        if any(launches.values()):
            raise AssertionError(f"{arch} train launched {launches}")
        return res, out.getvalue().count("[sync]"), {
            "wall_s": wall, "losses": res.losses, "step_s": res.step_s,
            "step_s_after_first": sum(later) / len(later),
            "peak_gib": res.peak_gib, "n_params": res.n_params,
            "launches": launches, "host_data": host_data(arch, **kw)}

    summary = {}
    res, _, summary["gemma2-2b"] = run("gemma2-2b", **TRAIN)
    if res.n_params != SERVE_PARAMS:
        raise AssertionError(f"gemma2-2b trains {res.n_params} parameters, "
                             f"not {SERVE_PARAMS}")
    gemma = res.params[0]
    del res
    with tempfile.TemporaryDirectory() as ckpt:
        res, syncs, summary["whisper-small"] = run(
            "whisper-small", ckpt_dir=ckpt, **WHISPER_TRAIN)
        saved = load_round(ckpt, WHISPER_TRAIN["steps"], device="cuda")
    equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res.params[0]), tree_leaves(res.params[1]), strict=True))
    pairs = list(zip(tree_items(saved["fog_model"]),
                     tree_items(res.params[0])))
    reloaded = (len(pairs) == len(tree_leaves(res.params[0])) and all(
        pa == pb and a.dtype == b.dtype and torch.equal(a, b)
        for (pa, a), (pb, b) in pairs))
    print(f"  whisper-small: {syncs} syncs; groups bit-equal after the "
          f"last: {equal}; the round-{WHISPER_TRAIN['steps']} checkpoint "
          f"reloads bit-equal: {reloaded} (metadata {saved['metadata']})")
    if res.n_params != WHISPER_PARAMS:
        raise AssertionError(f"whisper-small trains {res.n_params} "
                             f"parameters, not {WHISPER_PARAMS}")
    if (syncs != WHISPER_TRAIN["steps"] // WHISPER_TRAIN["sync_every"]
            or not equal or not reloaded):
        raise AssertionError(f"whisper-small federated: {syncs} syncs, "
                             f"groups equal {equal}, reloaded {reloaded}")
    summary["whisper-small"].update(syncs=syncs, synced_equal=equal,
                                    reloaded=reloaded)
    del res, saved, pairs
    return summary, gemma, [summary[a]["launches"] for a in summary]


def check_train_against_cpu(torch):
    """Phase 25 (c): the train, federated and score steps at ``reduced()``
    (float32), the same weights (``zoo_params``, zero-start leaves drawn)
    and batches on the card and on the CPU: 3 ``make_train_step`` steps of
    gemma2-2b (adamw, ``clip_norm`` 0.1 so the clip bites, 2
    microbatches) and of deepseek-v2-236b (adafactor, the MoE aux in the
    loss; every MoE call's capacity drops equal), 2 ``make_federated_
    train_step`` steps of 2 gemma2-2b groups then ``federated_sync``, and
    one ``make_score_step`` (T = 4) with ``select_batch`` keeping 4 of 8.
    Losses within 1e-5 relative, scores within 1e-5, the picked indices
    equal, params within 1e-4.  Returns the largest errors."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import selection
    from repro_torch.launch import steps as S
    from repro_torch.models.api import build_model
    from repro_torch.optim import adafactor, adamw
    from repro_torch.tree import tree_items, tree_map

    lr = 1e-3
    on = lambda dev, tree: tree_map(lambda a: a.to(dev), tree)

    def batch(cfg, seed, B=4, T=32):
        r = np.random.default_rng(seed)
        return {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (B, T))
                                    .astype(np.int32))
                for k in ("tokens", "targets")}

    def leaves(tree):
        return [(path, a.detach().float().cpu().numpy())
                for path, a in tree_items(tree)]

    def compare(name, card, cpu):
        """``card`` and ``cpu``: (losses, params) of the same run."""
        rel = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
        got, want = leaves(card[1]), leaves(cpu[1])
        if [p for p, _ in got] != [p for p, _ in want]:
            raise AssertionError(f"{name}: card and CPU trees differ")
        err = max(float(np.abs(a - b).max())
                  for (_, a), (_, b) in zip(got, want))
        print(f"  (c) {name}: losses card {[round(l, 6) for l in card[0]]}, "
              f"largest relative gap {rel:.3e}; params max_abs_err "
              f"{err:.3e}")
        if not (rel <= 1e-5 and err <= 1e-4):
            raise AssertionError(f"{name}: card vs CPU losses {rel}, "
                                 f"params {err}")
        return {"loss_rel_err": rel, "params_err": err}

    out = {}
    for arch, opt, kw in (
            ("gemma2-2b", lambda: adamw(lr),
             dict(clip_norm=0.1, num_microbatches=2)),
            ("deepseek-v2-236b", lambda: adafactor(lr), {})):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        p0 = tree_map(lambda a: a[0], zoo_params(torch, cfg, 31, D=1))
        runs, drops = {}, {}
        for dev in ("cuda", "cpu"):
            o = opt()
            step = S.make_train_step(model, o, **kw)
            params = on(dev, p0)
            state, losses = o.init(params), []
            with MoERecords(torch) as rec:
                for i in range(3):
                    params, state, m = step(params, state,
                                            on(dev, batch(cfg, 40 + i)), i)
                    losses.append(float(m["loss"]))
                    if "clip_norm" in kw and not float(m["grad_norm"]) > 0.1:
                        raise AssertionError(f"{arch}: the clip did not bite")
            runs[dev], drops[dev] = (losses, params), [c[1] for c in
                                                       rec.calls]
        if drops["cuda"] != drops["cpu"]:
            raise AssertionError(f"{arch}: capacity drops {drops}")
        out[arch] = compare(f"{arch} train step {kw}", runs["cuda"],
                            runs["cpu"])
        out[arch]["moe_calls"] = len(drops["cuda"])
    cfg = get_config("gemma2-2b").reduced()
    model = build_model(cfg)
    p0 = tree_map(lambda *a: torch.stack(a),
                  *(tree_map(lambda a: a[0], zoo_params(torch, cfg, s, D=1))
                    for s in (32, 33)))
    runs = {}
    for dev in ("cuda", "cpu"):
        o = adamw(lr)
        fed = S.make_federated_train_step(model, o, clip_norm=0.1)
        params = on(dev, p0)
        state = tree_map(lambda *a: torch.stack(a), *(
            o.init(tree_map(lambda a: a[g], params)) for g in range(2)))
        losses = []
        for i in range(2):
            b = [batch(cfg, 50 + 2 * i + g) for g in range(2)]
            params, state, m = fed(params, state, on(dev, tree_map(
                lambda *a: torch.stack(a), *b)), i)
            losses += m["loss"].tolist()
        runs[dev] = (losses, S.federated_sync(params))
    out["federated"] = compare("gemma2-2b federated step x 2 groups + sync",
                               runs["cuda"], runs["cpu"])
    scores = {}
    cand = batch(cfg, 60, B=8)
    for dev in ("cuda", "cpu"):
        score = S.make_score_step(model, mc_samples=4)
        got = score(on(dev, tree_map(lambda a: a[0], p0)), on(dev, cand),
                    torch.Generator(device=dev).manual_seed(0))
        _, _, idx = selection.select_batch(got, *on(dev, (cand["tokens"],
                                                           cand["targets"])),
                                           4)
        scores[dev] = (got.cpu(), idx.cpu())
    err = float((scores["cuda"][0] - scores["cpu"][0]).abs().max())
    top = torch.sort(scores["cpu"][0], descending=True)[0]
    same = torch.equal(scores["cuda"][1], scores["cpu"][1])
    print(f"  (c) score step (T = 4) + select_batch: scores card vs CPU "
          f"max_abs_err {err:.3e}; picked {scores['cuda'][1].tolist()} "
          f"card, {scores['cpu'][1].tolist()} CPU; gap between the 4th "
          f"and 5th score {float(top[3] - top[4]):.3e}")
    if not (err <= 1e-5 and same):
        raise AssertionError(f"score step card vs CPU: {err}, {same}")
    out["score"] = {"scores_err": err, "picked": scores["cuda"][1].tolist()}
    return out


def acquisition_candidates(torch, cfg):
    """Phase 25 (d)'s candidates: ``ACQUIRE["candidates"]`` sequences of
    ``ACQUIRE["seq"]`` tokens from ``SyntheticLMStream`` at seed 7, on the
    card."""
    from repro_torch.data.lm import SyntheticLMStream
    toks, tgts = SyntheticLMStream(vocab=cfg.vocab_size, seed=7).sample(
        ACQUIRE["candidates"], ACQUIRE["seq"], seed=7)
    return {"tokens": torch.from_numpy(toks).cuda(),
            "targets": torch.from_numpy(tgts).cuda()}


def run_acquisition_step(torch, reset, read, params):
    """Phase 25 (d): the acquisition step at gemma2-2b's published widths
    on the params phase 25 (a) trained: ``make_score_step(mc_samples=4)``
    scores ``ACQUIRE["candidates"]`` sequences from ``SyntheticLMStream``
    (K1 exactly once a score step, on ``[4, 1024, 256000]``; two calls,
    the first warms up), ``select_batch`` keeps 4, one adamw train step
    runs on them.  Returns the summary and the launches of the three
    calls."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.core import selection
    from repro_torch.launch import steps as S
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    cfg = get_config("gemma2-2b")
    model = build_model(cfg)
    cand = acquisition_candidates(torch, cfg)
    score = S.make_score_step(model, mc_samples=ACQUIRE["mc_samples"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls, all_launches = [], []
    for _ in range(2):                       # the first call warms up
        reset()
        t0 = time.perf_counter()
        scores = score(params, cand, torch.Generator(device="cuda")
                       .manual_seed(0))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        all_launches.append(read())
    tok, tgt, idx = selection.select_batch(scores, cand["tokens"],
                                           cand["targets"],
                                           ACQUIRE["keep"])
    score_peak = torch.cuda.max_memory_allocated() / 2**30
    opt = adamw(3e-4)
    reset()
    t0 = time.perf_counter()
    _, _, m = S.make_train_step(model, opt)(params, opt.init(params),
                                            {"tokens": tok, "targets": tgt},
                                            0)
    loss = float(m["loss"])
    step_s = time.perf_counter() - t0
    all_launches.append(read())
    peak = torch.cuda.max_memory_allocated() / 2**30
    k1 = [run["acquisition_scores"] for run in all_launches[:2]]
    print(f"  (d) score step ({ACQUIRE['candidates']} x {ACQUIRE['seq']} "
          f"tokens, T = {ACQUIRE['mc_samples']}, vocab {cfg.vocab_size}): "
          f"{walls[0]:.4f} s cold, {walls[1]:.4f} s warm; K1 launches a "
          f"step {k1}; scores {[round(float(x), 5) for x in scores]}; "
          f"picked {idx.tolist()}; peak {score_peak:.2f} GiB; train step on "
          f"the 4 kept: loss {loss:.5f}, {step_s:.3f} s, peak {peak:.2f} "
          f"GiB; launches {all_launches}")
    if k1 != [1, 1] or any(run["acquisition_scores"]
                           for run in all_launches[2:]):
        raise AssertionError(f"score step K1 launches {all_launches}")
    if not (bool(torch.isfinite(scores).all()) and math.isfinite(loss)
            and len(set(idx.tolist())) == ACQUIRE["keep"]):
        raise AssertionError(f"acquisition step: scores {scores}, picked "
                             f"{idx}, loss {loss}")
    return ({"score_s": walls, "scores": scores.tolist(),
             "picked": idx.tolist(), "score_peak_gib": score_peak,
             "train_step_s": step_s, "loss": loss, "peak_gib": peak,
             "launches": all_launches}, all_launches)


def gemma_train_paths(torch):
    """Phase 11's traced train path: two steps of ``launch.train.train``
    (gemma2-2b at full depth, ``TRAIN``'s batch; the stream and the
    optimiser's set-up included) from weights at seed 0, which ``train``
    would draw itself, passed through ``init_params=`` so that the trace
    holds no weight init; and phase 25 (d)'s score step on those
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_score_step
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    cfg = get_config("gemma2-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cand = acquisition_candidates(torch, cfg)
    score = make_score_step(model, mc_samples=ACQUIRE["mc_samples"])
    kw = dict(TRAIN, steps=2)
    return (lambda: train("gemma2-2b", full_config=True, device="cuda",
                          init_params=[params], **kw),
            lambda: score(params, cand, torch.Generator(device="cuda")
                          .manual_seed(0)))


def check_small_round_against_cpu(torch, fed, interop, lenet):
    """Phase 7, LeNet: the same RNG-free round (dropout 0, window ≥ shard) on the
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


def small_lenet_fleet(torch, fed, interop, lenet):
    """Phase 7's RNG-free LeNet fleet: 3 devices of 100 samples, a window
    of 128 that covers each shard, dropout 0, and the start weights as
    numpy."""
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
    return cfg, mcfg, shards, seed_set, test, p0


def leaves_err(interop, tree_leaves, a, b) -> float:
    import numpy as np
    return max(float(np.abs(x - y).max()) for x, y in zip(
        tree_leaves(interop.params_to_jax(a)),
        tree_leaves(interop.params_to_jax(b))))


def check_host_engines_against_cpu(torch, fed, interop, lenet, tree_leaves):
    """Phase 7, host engines: the RNG-free round of ``engine="classic"``
    and ``engine="legacy"`` on the card and on the CPU: equal labeled
    counts (and sets, where the history names them), params within
    1e-4."""
    cfg, mcfg, shards, seed_set, test, p0 = small_lenet_fleet(
        torch, fed, interop, lenet)
    for engine in ("classic", "legacy"):
        out = {}
        for dev in ("cuda", "cpu"):
            out[dev] = fed.run_federated_round(
                cfg, shards, seed_set, test,
                trainer=fed.Trainer(cfg, model_cfg=mcfg, device=dev),
                initial_params=interop.params_from_jax(p0, dev),
                engine=engine)
        (pg, rg), (pc, rc) = out["cuda"], out["cpu"]
        for hg, hc in zip(rg["device_histories"], rc["device_histories"]):
            for a, b in zip(hg, hc):
                if (a["n_labeled"] != b["n_labeled"]
                        or set(a.get("selected", ())) !=
                        set(b.get("selected", ()))):
                    raise AssertionError(f"{engine}: card and CPU labeled "
                                         f"differently: {a} vs {b}")
        err = leaves_err(interop, tree_leaves, pg, pc)
        print(f"  card vs CPU small {engine} round: labeled counts equal, "
              f"params max_abs_err {err:.3e}, aggregated_acc "
              f"{rg['aggregated_acc']} vs {rc['aggregated_acc']}")
        if not err <= 1e-4:
            raise AssertionError(f"{engine}: card vs CPU params differ by "
                                 f"{err} > 1e-4")


class CodecInputs:
    """While active, every stacked leaf the engine hands its codec
    (``comms.encode_rows``) is also kept, on the host, in ``self.leaves``
    (the tree's leaf order)."""

    def __init__(self, comms):
        self.comms, self.encode, self.leaves = comms, comms.encode_rows, []

    def __enter__(self):
        def keep(cfg, x, generator=None):
            self.leaves.append(x.detach().to("cpu", copy=True))
            return self.encode(cfg, x, generator)
        self.leaves = []
        self.comms.encode_rows = keep
        return self

    def __exit__(self, *exc):
        self.comms.encode_rows = self.encode


def check_comms_rounds_against_cpu(torch, fed, interop, lenet, tree_leaves,
                                   tree_map):
    """Phase 7, compressed uploads: fused LeNet rounds with top-k 0.05 and
    with a bfloat16 wire (error feedback on) on the card and on the CPU,
    round by round, the card's next round starting from the CPU's state
    so that a codec split does not carry over.  Per round and leaf:
    labeled sets equal and params within 1e-4; the card's residuals
    bit-equal to its own codec input minus what the CPU's codec sends for
    that input (the codec and the error-feedback update on the card, held
    exactly); the two runs' codec inputs (a device's own trained delta
    plus its residual) within the params' 1e-4 but for at most
    ``comms.split_budget`` entries of a leaf, none beyond one Adam step,
    the learning rate (where a gradient is near 0, Adam's normalised step
    turns the two runs' different sum orders into steps of either sign);
    and the residuals within 1e-5 but for at most ``comms.split_budget``
    entries of a leaf, each a codec split (``comms.codec_splits``: at a
    top-k boundary or a bfloat16 rounding tie, apart by at most the
    codec's jump there plus the inputs' difference) or apart by no more
    than its inputs' difference."""
    from repro_torch.core import comms
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.core.vpool import VPool

    cfg, mcfg, shards, seed_set, test, p0 = small_lenet_fleet(
        torch, fed, interop, lenet)
    for name, cc in (("top-k 0.05", comms.CommsConfig(compression="topk",
                                                       topk_fraction=0.05)),
                     ("bf16 wire", comms.CommsConfig(
                         compute_dtype="bfloat16"))):
        engs = {dev: EdgeEngine(fed.Trainer(cfg, model_cfg=mcfg, device=dev),
                                cfg, shards, seed_set, test,
                                total_acquisitions=2 * cfg.acquisitions,
                                device=dev) for dev in ("cuda", "cpu")}
        st = {dev: e.init_state(interop.params_from_jax(p0, dev))
              for dev, e in engs.items()}
        for t in range(2):
            fin, xs = {}, {}
            for dev, e in engs.items():
                with CodecInputs(comms) as seen:
                    st[dev], _, fin[dev] = e.run_rounds_fused(
                        st[dev], 1, comms=cc, start_round=t)
                xs[dev] = seen.leaves
            (sg, sc) = st["cuda"], st["cpu"]
            if not torch.equal(sg.pool.labeled_mask.cpu(),
                               sc.pool.labeled_mask):
                raise AssertionError(f"{name} round {t}: card and CPU "
                                     "labeled different samples")
            err = leaves_err(interop, tree_leaves, fin["cuda"], fin["cpu"])
            worst = eps_max = 0.0
            far_n = splits = noisy_n = 0
            for xg, xc, rg, rc in zip(xs["cuda"], xs["cpu"],
                                      tree_leaves(sg.residual),
                                      tree_leaves(sc.residual), strict=True):
                rg = rg.cpu()
                sent = comms.decode_rows(*comms.encode_rows(cc, xg))
                if not torch.equal(rg, xg - sent):
                    raise AssertionError(f"{name} round {t}: the card's "
                                         "residual is not its codec input "
                                         "minus the CPU codec's output")
                eps = (xg - xc).abs()
                noisy = int((eps > 1e-4).sum())
                if (noisy > comms.split_budget(eps.numel())
                        or not float(eps.max()) <= cfg.lr):
                    raise AssertionError(
                        f"{name} round {t}: codec inputs apart by up to "
                        f"{float(eps.max())}, {noisy} entries beyond 1e-4")
                gap, far, sp, bad = comms.residual_gaps(cc, xc, rg, rc,
                                                        tol=1e-5, eps=eps)
                if bad or far > comms.split_budget(rg.numel()):
                    raise AssertionError(
                        f"{name} round {t}: {far} residual entries of "
                        f"{rg.numel()} beyond 1e-5, {sp} of them codec "
                        f"splits, {bad} neither a split nor within their "
                        "inputs' difference")
                worst = max(worst, gap)
                eps_max = max(eps_max, float(eps.max()))
                noisy_n += noisy
                far_n, splits = far_n + far, splits + sp
            print(f"  card vs CPU fused LeNet round {t}, {name}: labeled "
                  f"sets equal, params max_abs_err {err:.3e}; the card's "
                  f"residuals bit-equal to its codec's; codec inputs apart "
                  f"by at most {eps_max:.3e} ({noisy_n} entries beyond "
                  f"1e-4); residuals max_abs_err "
                  f"{worst:.3e}, {far_n} entries beyond 1e-5 ({splits} of "
                  f"them codec splits)")
            if not err <= 1e-4:
                raise AssertionError(f"{name} round {t}: params differ by "
                                     f"{err} > 1e-4")
            # the card's next round starts from the CPU's state
            params = tree_map(lambda a: a.to("cuda"), sc.params)
            st["cuda"] = sg._replace(
                params=params,
                opt_state=engs["cuda"].trainer.opt.init(params),
                pool=VPool(*(f.to("cuda") for f in sc.pool)),
                residual=tree_map(lambda a: a.to("cuda"), sc.residual))


def lenet_template(torch, lenet):
    """One LeNet parameter tree (the byte ledger's template)."""
    return lenet.LeNet.init(torch.Generator().manual_seed(0),
                            lenet.LeNetConfig())


def run_host_engine_paths(torch, fed, comms, lenet, reset, read):
    """Phase 12: the paper's defaults on the host-aggregation engines,
    ``run_experiment(FederatedALConfig(), scenario="paper",
    engine=...)``: K1 launched 40 times (4 devices x 10 acquisitions),
    histories 4 x 10, accuracies finite in [0, 1], and the round's uplink
    exactly 4 uploads of a float32 LeNet plus metadata.  Returns {engine:
    (wall s, launches)}."""
    import numpy as np
    want = 4 * (comms.upload_bytes(None, lenet_template(torch, lenet))
                + comms.METADATA_BYTES_PER_UPLOAD)
    out = {}
    for engine in ("classic", "legacy"):
        reset()
        t0 = time.perf_counter()
        rep = fed.run_experiment(fed.FederatedALConfig(), scenario="paper",
                                 engine=engine)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        print(f"  {engine}: initial_acc {rep['initial_acc']} aggregated_acc "
              f"{rep['aggregated_acc']} wall {wall:.3f} s launches "
              f"{launches}; uplink {rep['comms']['uplink_bytes']} bytes")
        if launches["acquisition_scores"] != 40:
            raise AssertionError(f"{engine}: {launches['acquisition_scores']}"
                                 " acquisition-score launches, not 40")
        n_hist = [len(h) for h in rep["device_histories"]]
        if n_hist != [10] * 4:
            raise AssertionError(f"{engine}: histories {n_hist} != 4 x 10")
        for v in (rep["initial_acc"], rep["aggregated_acc"]):
            if not (np.isfinite(v) and 0.0 <= v <= 1.0):
                raise AssertionError(f"{engine}: accuracy {v}")
        if rep["comms"]["uplink_bytes"] != want:
            raise AssertionError(f"{engine}: uplink "
                                 f"{rep['comms']['uplink_bytes']} != {want}")
        out[engine] = (wall, launches)
    return out


def check_round_bytes(comms, name, rounds, cc, template):
    """Each round's uplink is exactly its uploads times (the codec's
    upload bytes + metadata), and its Eq. 1 weights sum to 1 within 1e-4
    with a finite accuracy in [0, 1]."""
    ub = comms.upload_bytes(cc, template) + comms.METADATA_BYTES_PER_UPLOAD
    for r in rounds:
        c = r["comms"]
        if c["uplink_bytes"] != c["uploads"] * ub or c["uploads"] < 1:
            raise AssertionError(f"{name} round {r['round']}: uplink "
                                 f"{c['uplink_bytes']} != {c['uploads']} x "
                                 f"{ub}")
        wsum = sum(r["aggregation"]["weights"])
        acc = r["aggregated_acc"]
        if not (abs(wsum - 1.0) < 1e-4 and acc == acc and 0.0 <= acc <= 1.0):
            raise AssertionError(f"{name} round {r['round']}: weights sum "
                                 f"{wsum}, acc {acc}")


class FogModels:
    """While active, the fog model that each ``run_federated_rounds`` call
    returns (``run_experiment`` reports without it) is kept in
    ``self.models``."""

    def __init__(self, fed):
        self.fed, self.rounds, self.models = fed, fed.run_federated_rounds, []

    def __enter__(self):
        def keep(*args, **kw):
            fog, reports = self.rounds(*args, **kw)
            self.models.append(fog)
            return fog, reports
        self.fed.run_federated_rounds = keep
        return self

    def __exit__(self, *exc):
        self.fed.run_federated_rounds = self.rounds

    def check_finite(self, torch, name):
        """Every leaf of every kept fog model is finite (a NaN int8 scale,
        which the codec sends for a non-finite leaf, would spread)."""
        from repro_torch.tree import tree_items
        if not self.models:
            raise AssertionError(f"{name}: no fog model came back")
        for fog in self.models:
            for path, leaf in tree_items(fog):
                if not bool(torch.isfinite(leaf).all()):
                    raise AssertionError(f"{name}: fog model leaf {path} "
                                         "is not finite")


MASSIVE_CODECS = {"int8": dict(compression="int8"),
                  "top-k 0.05": dict(compression="topk", topk_fraction=0.05),
                  "bf16 wire": dict(compute_dtype="bfloat16")}


def run_massive_codecs(torch, fed, comms, lenet, reset, read):
    """Phase 13: ``run_experiment(scenario="massive", num_devices=256,
    rounds=2, comms=...)`` for each codec: K2 at least twice and K1 at
    least once, the byte ledger exact, weights summing to 1, the fog model
    finite.  Returns
    {codec: (wall s, launches, uplink bytes a round)}."""
    template = lenet_template(torch, lenet)
    out = {}
    for name, kw in MASSIVE_CODECS.items():
        cc = comms.CommsConfig(**kw)
        reset()
        t0 = time.perf_counter()
        with FogModels(fed) as fog:
            rep = fed.run_experiment(scenario="massive", num_devices=256,
                                     rounds=2, comms=cc)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        fog.check_finite(torch, f"massive {name}")
        del fog
        per_round = rep["comms"]["uplink_bytes_per_round"]
        print(f"  {name}: aggregated_acc per round "
              f"{[r['aggregated_acc'] for r in rep['rounds']]} wall "
              f"{wall:.3f} s launches {launches}; uplink bytes per round "
              f"{per_round}, compression ratio "
              f"{rep['comms']['compression_ratio']:.4f}")
        if launches["fused_aggregation"] < 2:
            raise AssertionError(f"massive {name}: fewer than 2 "
                                 "fused-aggregation launches")
        if launches["acquisition_scores"] < 1:
            raise AssertionError(f"massive {name}: no acquisition-score "
                                 "launch")
        check_round_bytes(comms, f"massive {name}", rep["rounds"], cc,
                          template)
        out[name] = (wall, launches, per_round)
    return out


def run_lm_int8(torch, fed, comms, config, reset, read):
    """Phase 14: path B (lm-100m, full width and depth, 8 devices) for 2
    rounds with int8 uploads: K1, K2 (at least twice) and K3 launched, the
    byte ledger exact, the fog model finite, peak device memory under 76
    GiB.  Returns (wall s,
    launches, peak GiB)."""
    cc = comms.CommsConfig(compression="int8")
    template = config.adapter.init(torch.Generator(device="cuda").manual_seed(0))
    ub = comms.upload_bytes(cc, template)
    del template
    torch.cuda.empty_cache()
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FogModels(fed) as fog:
        rep = fed.run_experiment(config, scenario="lm", rounds=2, n_test=256,
                                 comms=cc)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    fog.check_finite(torch, "path B int8")
    del fog
    print(f"  path B int8: aggregated_acc per round "
          f"{[r['aggregated_acc'] for r in rep['rounds']]}; wall {wall:.3f} "
          f"s; launches {launches}; peak device memory {peak:.2f} GiB; "
          f"upload {ub} bytes a device (ratio "
          f"{rep['comms']['compression_ratio']:.4f})")
    for k, least in (("acquisition_scores", 1), ("fused_aggregation", 2),
                     ("flash_attention", 1)):
        if launches[k] < least:
            raise AssertionError(f"path B int8: {launches[k]} {k} launches")
    for r in rep["rounds"]:
        c = r["comms"]
        if c["uplink_bytes"] != c["uploads"] * (
                ub + comms.METADATA_BYTES_PER_UPLOAD):
            raise AssertionError(f"path B int8 round {r['round']}: uplink "
                                 f"{c['uplink_bytes']}")
        wsum = sum(r["aggregation"]["weights"])
        if not abs(wsum - 1.0) < 1e-4:
            raise AssertionError(f"path B int8: weights sum {wsum}")
    if not peak < 76.0:
        raise AssertionError(f"path B int8 peaks at {peak:.2f} GiB >= 76")
    return wall, launches, peak


def check_hetero_churn_rounds_against_cpu(torch, fed, interop, lenet,
                                          tree_leaves):
    """Phase 7, heterogeneous and faulty fleets: fused LeNet rounds on the
    card and on the CPU from the same start, RNG-free (dropout 0, window ≥
    shard): (a) hetero rounds from a host ``straggler_schedule`` with a
    round that no device reaches, a step-limit profile, exp decay and
    buffering; (b) churn rounds with the port's own fault draws (numpy, so
    the same on both sides) and guards ``"drop"``.  Staleness, liveness
    and the fault and guard rows exactly equal; params within 1e-4, but
    for at most ``comms.split_budget`` entries of a leaf, each within the
    most one round's fit can move an entry (steps × lr), the rule of the
    CPU parity tests: Adam turns the two runs' different gradient sums
    into steps of either sign where a gradient is near 0, and few arrivals
    leave them unaveraged."""
    import numpy as np
    from repro_torch.core import comms
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.core.faults import REPORT_KEYS, FaultConfig, GuardConfig
    from repro_torch.core.hetero import HeteroConfig, straggler_schedule

    cfg, mcfg, shards, seed_set, test, p0 = small_lenet_fleet(
        torch, fed, interop, lenet)
    rounds = 3
    arrivals = straggler_schedule(3, 0.4, 2, rounds)
    arrivals[1] = 0.0
    runs = {
        "hetero": (dict(upload_mask=arrivals, hetero=HeteroConfig(
            decay="exp", step_limits=(2, 5, 3))), ("staleness",)),
        "churn, guards drop": (dict(
            faults=FaultConfig(death_rate=0.3, birth_rate=0.5,
                               crash_rate=0.2, drop_rate=0.2,
                               corrupt_rate=0.4, label_noise_rate=0.2,
                               seed=3),
            guards=GuardConfig(policy="drop", norm_factor=3.0)),
            REPORT_KEYS + ("accepted",)),
    }
    reach = cfg.acquisitions * cfg.train_steps_per_acq * cfg.lr
    for name, (kw, exact) in runs.items():
        out = {}
        for dev in ("cuda", "cpu"):
            eng = EdgeEngine(fed.Trainer(cfg, model_cfg=mcfg, device=dev),
                             cfg, shards, seed_set, test,
                             total_acquisitions=rounds * cfg.acquisitions,
                             device=dev)
            st, recs, fin = eng.run_rounds_fused(
                eng.init_state(interop.params_from_jax(p0, dev)), rounds,
                **kw)
            out[dev] = ({k: v.cpu().numpy() for k, v in recs.items()},
                        tree_leaves(interop.params_to_jax(fin)))
        (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
        for key in exact + ("upload_mask", "n_labeled"):
            if not np.array_equal(rg[key], rc[key]):
                raise AssertionError(f"{name}: card and CPU {key} rows "
                                     f"differ: {rg[key]} vs {rc[key]}")
        err, far = 0.0, 0
        for a, b in zip(pg, pc, strict=True):
            gap = np.abs(a - b)
            err, n_far = max(err, float(gap.max())), int((gap > 1e-4).sum())
            far += n_far
            if n_far > comms.split_budget(gap.size) or gap.max() > reach:
                raise AssertionError(f"{name}: card vs CPU params differ by "
                                     f"up to {gap.max()}, {n_far} entries "
                                     "beyond 1e-4")
        shown = {k: rg[k].sum().item() for k in exact if k != "staleness"}
        if "staleness" in rg:
            shown["staleness"] = rg["staleness"].tolist()
        print(f"  card vs CPU fused LeNet rounds, {name}: rows {exact} "
              f"equal ({shown}), params max_abs_err {err:.3e}, {far} "
              "entries beyond 1e-4")


def check_async_events_against_cpu(torch, fed, interop, lenet, tree_leaves):
    """Phase 7, the async event loop: 4 events of an RNG-free LeNet fleet
    of 8 devices (dropout 0, a window of 64 over shards of at most 53) on
    the card and on the CPU from the same start, a FedBuff quorum of 2
    with a 0.5 s timer over exponential latencies with a 10x skew, churn,
    crashes, drops, corruption and label noise from the port's numpy
    draws, guards ``"drop"``.  The corruption is NaN, which the guards
    reject at any arrival count: a lone x50 arrival is its own median,
    passes the guards on both sides and would multiply the card's and the
    CPU's float32 gaps by 50.  Arrivals, ``sim_time``, timer events,
    staleness and the fault and guard rows exactly equal; the fog model,
    params and the banked deltas within 1e-4 by the per-device-delta rule
    of phase 7's hetero and churn rounds."""
    import numpy as np
    from repro_torch.core import comms
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.core.faults import REPORT_KEYS, FaultConfig, GuardConfig
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import federated_split

    D, events = 8, 4
    cfg = fed.FederatedALConfig(num_devices=D, initial_train=10,
                                acquisitions=2, k_per_acquisition=4,
                                pool_window=64, mc_samples=4,
                                train_steps_per_acq=5)
    mcfg = lenet.LeNetConfig(p_conv=0.0, p_fc=0.0)
    shards = federated_split(make_digit_dataset(320, seed=0), D, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        200, seed=5)
    p0 = interop.params_to_jax(lenet.LeNet.init(
        torch.Generator().manual_seed(0), mcfg))
    kw = dict(async_cfg=AsyncConfig(quorum=2, timer=0.5, dist="exp",
                                    mean_latency=1.0, latency_skew=10.0),
              faults=FaultConfig(death_rate=0.3, birth_rate=0.5,
                                 crash_rate=0.2, drop_rate=0.2,
                                 corrupt_rate=0.4, corrupt_mode="nan",
                                 label_noise_rate=0.2, seed=3),
              guards=GuardConfig(policy="drop", norm_factor=3.0))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = EdgeEngine(fed.Trainer(cfg, model_cfg=mcfg, device=dev), cfg,
                         shards, seed_set, test,
                         total_acquisitions=events * cfg.acquisitions,
                         device=dev)
        st, recs, fog = eng.run_async(
            eng.init_state(interop.params_from_jax(p0, dev)), events, **kw)
        out[dev] = ({k: v.cpu().numpy() for k, v in recs.items()},
                    [tree_leaves(interop.params_to_jax(t))
                     for t in (fog, st.params, st.pending)])
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    exact = ("upload_mask", "arrivals", "sim_time", "timer_fired",
             "staleness", "n_labeled", "accepted") + REPORT_KEYS
    for key in exact:
        if not np.array_equal(rg[key], rc[key]):
            raise AssertionError(f"async: card and CPU {key} rows differ: "
                                 f"{rg[key]} vs {rc[key]}")
    reach = cfg.acquisitions * cfg.train_steps_per_acq * cfg.lr
    err, far = 0.0, 0
    for name, leaves_g, leaves_c in zip(("fog", "params", "pending"), pg, pc):
        for a, b in zip(leaves_g, leaves_c, strict=True):
            gap = np.abs(a - b)
            err, n_far = max(err, float(gap.max())), int((gap > 1e-4).sum())
            far += n_far
            if n_far > comms.split_budget(gap.size) or gap.max() > reach:
                raise AssertionError(f"async: card vs CPU {name} differ by "
                                     f"up to {gap.max()}, {n_far} entries "
                                     "beyond 1e-4")
    shown = {k: rg[k].sum().item() for k in REPORT_KEYS + ("accepted",)}
    print(f"  card vs CPU async events: sim_time {rg['sim_time'].tolist()}, "
          f"timer {rg['timer_fired'].tolist()}, arrivals "
          f"{rg['arrivals'].tolist()}, rows equal ({shown}), stale arrivals "
          f"{int((rg['staleness'] * rg['upload_mask']).sum())}; fog, params "
          f"and pending max_abs_err {err:.3e}, {far} entries beyond 1e-4")


def check_stream_events_against_cpu(torch, fed, interop, lenet, tree_leaves):
    """Phase 7, live traffic: 4 events of phase 7's RNG-free 8-device LeNet
    fleet with a quorum of 2 and a 0.5 s timer, Poisson arrivals (20 a
    device a simulated second, 4x skew, burst 0.5, drift κ 2 over 8 s)
    into queues of 4, score selection (serve at most 0.45 nats, escalate
    the top 2 from 1.2) and churn, on the card and on the CPU from the
    same start.  The stream rows, queue depths, labeled counts and masks,
    arrivals, staleness and liveness exactly equal; the fog model, params
    and banked deltas by phase 7's rule.  Prints the least distance of a
    queued score to a threshold on each side (the exact rows need the
    card's scores on the CPU's side of each threshold)."""
    import numpy as np
    from repro_torch.core import async_engine, comms
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.stream import STREAM_REPORT_KEYS, StreamConfig
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import federated_split

    D, events = 8, 4
    cfg = fed.FederatedALConfig(num_devices=D, initial_train=10,
                                acquisitions=2, k_per_acquisition=4,
                                pool_window=64, mc_samples=4,
                                train_steps_per_acq=5)
    mcfg = lenet.LeNetConfig(p_conv=0.0, p_fc=0.0)
    shards = federated_split(make_digit_dataset(320, seed=0), D, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        200, seed=5)
    p0 = interop.params_to_jax(lenet.LeNet.init(
        torch.Generator().manual_seed(0), mcfg))
    traffic = StreamConfig(arrival_rate=20.0, rate_skew=4.0, burst=0.5,
                           queue_cap=4, max_arrivals=4, serve_threshold=0.45,
                           escalate_threshold=1.2, escalate_k=2,
                           drift_kappa=2.0, drift_period=8.0)
    kw = dict(async_cfg=AsyncConfig(quorum=2, timer=0.5, dist="exp",
                                    mean_latency=1.0, latency_skew=10.0),
              stream=traffic,
              faults=FaultConfig(death_rate=0.3, birth_rate=0.5, seed=3))
    decide = async_engine.cascade_decide
    out, margins = {}, {}
    for dev in ("cuda", "cpu"):
        queued = []

        def keep(scores, rank, idx, labeled, valid, *args):
            queued.append(scores[valid].float().cpu())
            return decide(scores, rank, idx, labeled, valid, *args)

        eng = EdgeEngine(fed.Trainer(cfg, model_cfg=mcfg, device=dev), cfg,
                         shards, seed_set, test,
                         total_acquisitions=events * (cfg.acquisitions
                                                      + traffic.escalate_k),
                         device=dev)
        async_engine.cascade_decide = keep
        try:
            st, recs, fog = eng.run_async(
                eng.init_state(interop.params_from_jax(p0, dev)), events,
                **kw)
        finally:
            async_engine.cascade_decide = decide
        scores = torch.cat(queued)
        margins[dev] = min(float((scores - t).abs().min()) for t in (
            traffic.serve_threshold, traffic.escalate_threshold))
        out[dev] = ({k: v.cpu().numpy() for k, v in recs.items()},
                    st.pool.labeled_mask.cpu().numpy(),
                    [tree_leaves(interop.params_to_jax(t))
                     for t in (fog, st.params, st.pending)])
    (rg, mg, pg), (rc, mc, pc) = out["cuda"], out["cpu"]
    exact = STREAM_REPORT_KEYS + ("upload_mask", "arrivals", "sim_time",
                                  "timer_fired", "staleness", "n_labeled",
                                  "live")
    for key in exact:
        if not np.array_equal(rg[key], rc[key]):
            raise AssertionError(f"stream: card and CPU {key} rows differ: "
                                 f"{rg[key]} vs {rc[key]}")
    if not np.array_equal(mg, mc):
        raise AssertionError("stream: card and CPU labeled masks differ")
    reach = cfg.acquisitions * cfg.train_steps_per_acq * cfg.lr
    err, far = 0.0, 0
    for name, leaves_g, leaves_c in zip(("fog", "params", "pending"), pg, pc):
        for a, b in zip(leaves_g, leaves_c, strict=True):
            gap = np.abs(a - b)
            err, n_far = max(err, float(gap.max())), int((gap > 1e-4).sum())
            far += n_far
            if n_far > comms.split_budget(gap.size) or gap.max() > reach:
                raise AssertionError(f"stream: card vs CPU {name} differ by "
                                     f"up to {gap.max()}, {n_far} entries "
                                     "beyond 1e-4")
    sums = {k: float(rg[k].sum()) for k in STREAM_REPORT_KEYS[:-1]}
    if not all(sums[k] > 0 for k in ("served", "escalated",
                                     "stream_dropped")):
        raise AssertionError(f"stream: the case must serve, escalate and "
                             f"drop: {sums}")
    print(f"  card vs CPU stream events: {sums}, final queue depths "
          f"{rg['queue_depth'][-1].tolist()}, rows and labeled masks "
          f"equal; least score-to-threshold distance card {margins['cuda']:.4f}"
          f", CPU {margins['cpu']:.4f}; fog, params and pending max_abs_err "
          f"{err:.3e}, {far} entries beyond 1e-4")


class ChurnFleet:
    """``scenario="churn"`` at ``num_devices`` on the card, built as
    ``run_experiment`` builds it (data, seed fit, engine) but kept open,
    so rounds can be chained, checkpointed and resumed."""

    def __init__(self, torch, fed, num_devices: int, rounds: int):
        from repro_torch.core.engine import EdgeEngine
        from repro_torch.data.digits import make_digit_dataset
        from repro_torch.data.federated_split import dirichlet_split

        cfg = fed.churn_config(num_devices)
        full = make_digit_dataset(fed.MASSIVE_SAMPLES_PER_DEVICE
                                  * num_devices, seed=cfg.seed)
        test = make_digit_dataset(1000, seed=cfg.seed + 5)
        seed_set = make_digit_dataset(cfg.initial_train, seed=cfg.seed + 11)
        shards = dirichlet_split(full, num_devices,
                                 alpha=fed.HETERO_DIRICHLET_ALPHA,
                                 seed=cfg.seed)
        trainer = fed.Trainer(cfg)
        self.params0 = fed.FogNode(trainer, cfg, seed_set).initial_model()
        self.engine = EdgeEngine(trainer, cfg, shards, seed_set, test,
                                 total_acquisitions=cfg.acquisitions * rounds)
        self.kw = dict(aggregation=cfg.aggregation,
                       faults=fed.DEFAULT_FAULTS, guards=fed.DEFAULT_GUARDS)

    def run(self, state, rounds: int, start_round: int = 0):
        return self.engine.run_rounds_fused(state, rounds,
                                            start_round=start_round,
                                            **self.kw)

    def start(self):
        return self.engine.init_state(self.params0)


def run_gap(torch, a, b) -> tuple:
    """``(largest |a − b| over the two runs' fog models, recs and states,
    the first place they differ or None)``; a run is ``(state, recs,
    fog)``."""
    from repro_torch.tree import tree_items
    worst, where = 0.0, None
    (sa, ra, fa), (sb, rb, fb) = a, b
    items = lambda tree: dict(tree_items(tree))
    fog_b = items(fb)
    state_b = items(tuple(sb._replace(rng=())))
    pairs = [(f"fog/{p}", x, fog_b[p]) for p, x in tree_items(fa)]
    pairs += [(f"recs/{k}", ra[k], rb[k]) for k in sorted(ra)]
    pairs += [(f"state/{p}", x, state_b[p])
              for p, x in tree_items(tuple(sa._replace(rng=())))]
    for name, x, y in pairs:
        if torch.equal(x, y):
            continue
        gap = float((x.double() - y.double()).abs().max())
        if where is None:
            where = name
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst, where


def run_scenario(torch, fed, name, reset, read, least):
    """Phases 15-16: ``run_experiment(scenario=name, num_devices=256,
    rounds=3)``: at least ``least`` launches of each kernel, weights
    summing to 1 in every round, finite accuracies and fog model.
    Returns (report, wall s, launches)."""
    reset()
    t0 = time.perf_counter()
    with FogModels(fed) as fog:
        rep = fed.run_experiment(scenario=name, num_devices=256,
                                 rounds=3)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    fog.check_finite(torch, name)
    del fog
    print(f"  {name}: aggregated_acc per round "
          f"{[r['aggregated_acc'] for r in rep['rounds']]} wall {wall:.3f} s "
          f"launches {launches}")
    for k, n in least.items():
        if launches[k] < n:
            raise AssertionError(f"{name}: {launches[k]} {k} launches, the "
                                 f"path needs {n}")
    for r in rep["rounds"]:
        wsum = sum(r["aggregation"]["weights"])
        acc = r["aggregated_acc"]
        if not (abs(wsum - 1.0) < 1e-4 and acc == acc and 0.0 <= acc <= 1.0):
            raise AssertionError(f"{name} round {r['round']}: weights sum "
                                 f"{wsum}, acc {acc}")
    return rep, wall, launches


def run_hetero_path(torch, fed, reset, read):
    """Phase 15: ``scenario="hetero"`` at D = 256 for 3 rounds (K1 2 and
    K2 2 a round: buffering hetero reduces params and the pending backlog
    apart), its staleness beside ``expected_staleness(0.3)``."""
    from repro_torch.core.hetero import expected_staleness
    rep, wall, launches = run_scenario(
        torch, fed, "hetero", reset, read,
        {"acquisition_scores": 6, "fused_aggregation": 6})
    st = rep["staleness"]
    print(f"  hetero staleness: mean {st['mean']:.4f} (expected_staleness"
          f"(0.3) = {expected_staleness(0.3):.4f} at the steady state), "
          f"per round {st['per_round_mean']}, max {st['max']}, stale "
          f"fraction {st['stale_fraction']:.4f}")
    return wall, launches, st


def run_churn_path(torch, fed, reset, read, tree_leaves):
    """Phase 16: ``scenario="churn"`` at D = 256 for 3 rounds (K1 2 and
    K2 1 a round), every corrupted received upload rejected (x50 under
    ``norm_factor`` 8), then a resume at the same size: two uninterrupted
    3-round runs show whether the card repeats its bits; 2 rounds,
    ``save_engine_state``, ``load_engine_state``, ``resume_state(2)`` and
    1 round with ``start_round=2`` must then equal the uninterrupted run
    bit for bit, else within twice the run-to-run gap."""
    import tempfile
    from repro_torch.checkpoint import load_engine_state, save_engine_state

    rep, wall, launches = run_scenario(
        torch, fed, "churn", reset, read,
        {"acquisition_scores": 6, "fused_aggregation": 3})
    print(f"  churn faults: {rep['faults']}")
    seen = 0
    for r in rep["rounds"]:
        for i, c in enumerate(r["corrupted"]):
            if c > 0:
                seen += 1
                if not r["rejected"][i] > 0:
                    raise AssertionError(f"churn round {r['round']}: device "
                                         f"{i}'s corrupted upload accepted")
    if not seen:
        raise AssertionError("churn: no corrupted upload reached the fog")

    fleet = ChurnFleet(torch, fed, 256, 3)
    t0 = time.perf_counter()
    first = fleet.run(fleet.start(), 3)
    second = fleet.run(fleet.start(), 3)
    repeat_gap, where = run_gap(torch, first, second)
    state, _, _ = fleet.run(fleet.start(), 2)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/churn.msgpack"
        save_engine_state(path, state, metadata={"next_round": 2})
        nbytes = Path(path).stat().st_size
        state, meta = load_engine_state(path)
    state = fleet.engine.resume_state(state, next_round=meta["next_round"])
    s1, r1, f1 = fleet.run(state, 1, start_round=meta["next_round"])
    s3, r3, f3 = first
    resumed = (s1, {k: v[-1:] for k, v in r1.items()}, f1)
    uninterrupted = (s3, {k: v[-1:] for k, v in r3.items()}, f3)
    resume_gap, resume_where = run_gap(torch, uninterrupted, resumed)
    secs = time.perf_counter() - t0
    print(f"  churn resume: checkpoint {nbytes} bytes; two uninterrupted "
          f"runs {'bit-equal' if where is None else 'differ'} (largest gap "
          f"{repeat_gap:.3e}, first at {where}); 2 + 1 resumed rounds vs 3: "
          f"largest gap {resume_gap:.3e} (first at {resume_where}); "
          f"{secs:.3f} s")
    if where is None:
        if resume_where is not None:
            raise AssertionError(f"churn resume differs from the "
                                 f"uninterrupted run at {resume_where} "
                                 f"(gap {resume_gap}) although the card "
                                 "repeats its bits")
    elif not resume_gap <= 2 * repeat_gap:
        raise AssertionError(f"churn resume gap {resume_gap} > twice the "
                             f"run-to-run gap {repeat_gap}")
    return wall, launches, rep["faults"], {
        "repeat_gap": repeat_gap, "repeat_first_diff": where,
        "resume_gap": resume_gap, "checkpoint_bytes": nbytes}


def run_async_path(torch, fed, reset, read, first):
    """Phase 17: ``run_experiment(scenario="async", num_devices=256,
    rounds=8)``, ``default_async(256)`` over 8 events.  Each event runs a
    whole-fleet candidate round (K1 2 launches at R = 2) and, when it
    accepts an upload, one Eq. 1 reduce (K2 1 launch over LeNet's 10
    leaves): K1 exactly 16, K2 the accepting events (at least 1), weights
    summing to 1 within 1e-5 on those events and to 0 on the others, the
    final accuracy in [0, 1], the fog model finite."""
    reset()
    t0 = time.perf_counter()
    with FogModels(fed) as fog:
        rep = fed.run_experiment(scenario="async", num_devices=256,
                                 rounds=8)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    fog.check_finite(torch, "async")
    first["async"] = (rep, fog.models[-1], wall, launches)
    del fog
    tel = rep["async"]
    accepting = sum(1 for r in rep["rounds"] if r["arrivals"] > 0)
    print(f"  async: wall {wall:.3f} s, launches {launches}; "
          f"{tel['sim_seconds_total']:.4f} simulated s over "
          f"{tel['events']} events (per event {tel['sim_time_per_event']}), "
          f"mean arrivals {tel['mean_arrivals_per_event']}, timer events "
          f"{tel['timer_fired_events']}, accepting events {accepting}, "
          f"final_acc {tel['final_acc']}")
    print(f"  async staleness: {tel['staleness']}")
    if launches["acquisition_scores"] != 16:
        raise AssertionError(f"async: {launches['acquisition_scores']} K1 "
                             "launches, 8 events of R = 2 make 16")
    if not 1 <= accepting == launches["fused_aggregation"]:
        raise AssertionError(f"async: {launches['fused_aggregation']} K2 "
                             f"launches for {accepting} accepting events")
    for r in rep["rounds"]:
        wsum = sum(r["aggregation"]["weights"])
        want = 1.0 if r["arrivals"] > 0 else 0.0
        if not abs(wsum - want) < 1e-5:
            raise AssertionError(f"async event {r['round']}: weights sum "
                                 f"{wsum}, arrivals {r['arrivals']}")
    acc = tel["final_acc"]
    if not (acc == acc and 0.0 <= acc <= 1.0):
        raise AssertionError(f"async: final accuracy {acc}")
    return wall, launches, tel


def run_stream_path(torch, fed, comms, reset, read, first):
    """Phase 21: ``run_experiment(scenario="stream", num_devices=256,
    rounds=8)``, ``default_async(256)`` and ``default_stream(256)`` over 8
    events.  Each event runs the candidate round (K1 2 launches at R = 2)
    and scores every device's request queue ``[256, T=4, Q=16, C=10]``
    (K1 1), and an accepting event one Eq. 1 reduce (K2 1): K1 exactly 24,
    K2 the accepting events; weights summing to 1 on those and 0 on the
    others; traffic totals, serve accuracy in [0, 1], the escalation
    uplink bytes exact (``comms.sample_bytes`` of a 28 x 28 x 1 image, its
    label included, an escalation), and conservation: every offered
    request was dropped, served, escalated or is still queued (every
    shard of the split holds samples, which the run checks)."""
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import dirichlet_split
    reset()
    t0 = time.perf_counter()
    with FogModels(fed) as fog:
        rep = fed.run_experiment(scenario="stream", num_devices=256,
                                 rounds=8)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read()
    fog.check_finite(torch, "stream")
    first["stream"] = (rep, fog.models[-1], wall, launches)
    del fog
    tel, st = rep["async"], rep["stream"]
    accepting = sum(1 for r in rep["rounds"] if r["arrivals"] > 0)
    print(f"  stream: wall {wall:.3f} s, launches {launches}; "
          f"{tel['sim_seconds_total']:.4f} simulated s over {tel['events']} "
          f"events, accepting events {accepting}, final_acc "
          f"{tel['final_acc']}")
    print(f"  stream traffic: {st}")
    if launches["acquisition_scores"] != 24:
        raise AssertionError(f"stream: {launches['acquisition_scores']} K1 "
                             "launches, 8 events of R = 2 plus the queues "
                             "make 24")
    if not 1 <= accepting == launches["fused_aggregation"]:
        raise AssertionError(f"stream: {launches['fused_aggregation']} K2 "
                             f"launches for {accepting} accepting events")
    for r in rep["rounds"]:
        wsum = sum(r["aggregation"]["weights"])
        want = 1.0 if r["arrivals"] > 0 else 0.0
        if not abs(wsum - want) < 1e-5:
            raise AssertionError(f"stream event {r['round']}: weights sum "
                                 f"{wsum}, arrivals {r['arrivals']}")
    acc, serve_acc = tel["final_acc"], st["serve_accuracy"]
    if not (acc == acc and 0.0 <= acc <= 1.0 and 0.0 <= serve_acc <= 1.0):
        raise AssertionError(f"stream: final accuracy {acc}, serve "
                             f"accuracy {serve_acc}")
    per = comms.sample_bytes((28, 28, 1))
    if not (st["escalated_total"] > 0 and st["escalation_uplink_bytes"]
            == st["escalated_total"] * per):
        raise AssertionError(f"stream: {st['escalated_total']} escalations, "
                             f"{st['escalation_uplink_bytes']} uplink bytes "
                             f"({per} a sample)")
    cfg = fed.stream_config(256)
    shards = dirichlet_split(
        make_digit_dataset(fed.MASSIVE_SAMPLES_PER_DEVICE * 256,
                           seed=cfg.seed), 256,
        alpha=fed.HETERO_DIRICHLET_ALPHA, seed=cfg.seed)
    if min(len(d) for d in shards) == 0:
        raise AssertionError("stream: an empty shard; conservation holds "
                             "for non-empty shards only")
    held = sum(rep["rounds"][-1]["queue_depth"])
    out = st["dropped_total"] + st["served_total"] + st["escalated_total"]
    print(f"  stream conservation: offered {st['offered_total']} = dropped "
          f"{st['dropped_total']} + served {st['served_total']} + escalated "
          f"{st['escalated_total']} + queued {held:.0f}; escalation uplink "
          f"{st['escalation_uplink_bytes']} bytes ({per} a sample)")
    if st["offered_total"] != out + held:
        raise AssertionError(f"stream: offered {st['offered_total']} != "
                             f"{out} + {held} queued")
    return wall, launches, {"async": tel, "stream": st}


def small_fog_fleet(torch, fed, interop, lenet, events: int):
    """Phase 7's RNG-free fog fleet: 8 LeNet devices (dropout 0, a window
    of 64 over shards of at most 53) with the same start on both sides,
    and a maker of its engine on a device."""
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import federated_split

    D = 8
    cfg = fed.FederatedALConfig(num_devices=D, initial_train=10,
                                acquisitions=2, k_per_acquisition=4,
                                pool_window=64, mc_samples=4,
                                train_steps_per_acq=5)
    mcfg = lenet.LeNetConfig(p_conv=0.0, p_fc=0.0)
    shards = federated_split(make_digit_dataset(320, seed=0), D, seed=0)
    seed_set, test = make_digit_dataset(10, seed=11), make_digit_dataset(
        200, seed=5)
    p0 = interop.params_to_jax(lenet.LeNet.init(
        torch.Generator().manual_seed(0), mcfg))

    def engine(dev):
        eng = EdgeEngine(fed.Trainer(cfg, model_cfg=mcfg, device=dev), cfg,
                         shards, seed_set, test,
                         total_acquisitions=events * cfg.acquisitions,
                         device=dev)
        return eng, interop.params_from_jax(p0, dev)

    return cfg, engine


def split_rule(name, pairs, reach):
    """Card-vs-CPU leaves ``(what, card, cpu)`` within 1e-4, but for at
    most ``comms.split_budget`` entries of a leaf, each within ``reach``
    (phase 7's rule); returns (max_abs_err, entries beyond 1e-4)."""
    import numpy as np
    from repro_torch.core import comms
    err, far = 0.0, 0
    for what, a, b in pairs:
        gap = np.abs(a - b)
        err, n_far = max(err, float(gap.max())), int((gap > 1e-4).sum())
        far += n_far
        if n_far > comms.split_budget(gap.size) or gap.max() > reach:
            raise AssertionError(f"{name}: card vs CPU {what} differ by up "
                                 f"to {gap.max()}, {n_far} entries beyond "
                                 "1e-4")
    return err, far


def check_fog_rounds_against_cpu(torch, fed, interop, lenet, tree_leaves):
    """Phase 7, the fog topology: on 8 RNG-free LeNet devices in G = 2
    groups syncing every 2nd round, (a) 3 fused rounds with a top-k fog
    codec and (b) 4 async events (a quorum of 2, a 0.5 s timer,
    exponential latencies with a 10x skew), on the card and on the CPU
    from the same start: ``fog_sync``, ``group_accept``, the arrival
    masks, labeled counts (and the async clock, arrivals and staleness)
    exactly equal, β within 1e-6, the fog model, params (and banked
    deltas) within 1e-4 by the split rule.  Then (c) ``uniform_topology(8,
    1)`` against the flat run on the card, both engines: bit for bit when
    two flat runs repeat their bits, else within twice their gap."""
    import numpy as np
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.comms import CommsConfig
    from repro_torch.core.topology import uniform_topology
    from repro_torch.tree import tree_map

    cfg, engine = small_fog_fleet(torch, fed, interop, lenet, 4)
    topo = uniform_topology(8, 2, local_steps=2)
    acfg = AsyncConfig(quorum=2, timer=0.5, dist="exp", mean_latency=1.0,
                       latency_skew=10.0)
    reach = cfg.acquisitions * cfg.train_steps_per_acq * cfg.lr
    cases = {
        "fused, top-k fog codec": (
            lambda eng, p0: eng.run_rounds_fused(
                eng.init_state(p0), 3, topology=topo,
                comms=CommsConfig(fog_compression="topk")),
            ("upload_mask", "n_labeled", "fog_sync", "group_accept")),
        "async events": (
            lambda eng, p0: eng.run_async(eng.init_state(p0), 4,
                                          async_cfg=acfg, topology=topo),
            ("upload_mask", "n_labeled", "fog_sync", "group_accept",
             "arrivals", "sim_time", "timer_fired", "staleness")),
    }
    for name, (run, exact) in cases.items():
        out = {}
        for dev in ("cuda", "cpu"):
            st, recs, fog = run(*engine(dev))
            out[dev] = ({k: v.cpu().numpy() for k, v in recs.items()},
                        [tree_leaves(interop.params_to_jax(t))
                         for t in (fog, st.params, st.pending)])
        (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
        for key in exact:
            if not np.array_equal(rg[key], rc[key]):
                raise AssertionError(f"fog {name}: card and CPU {key} rows "
                                     f"differ: {rg[key]} vs {rc[key]}")
        beta = float(np.abs(rg["beta"] - rc["beta"]).max())
        if not beta <= 1e-6:
            raise AssertionError(f"fog {name}: card vs CPU beta {beta}")
        err, far = split_rule(f"fog {name}", [
            (what, a, b) for what, ga, ca in zip(("fog", "params", "pending"),
                                                 lg, lc)
            for a, b in zip(ga, ca, strict=True)], reach)
        print(f"  card vs CPU fog {name}: fog_sync {rg['fog_sync'].tolist()}"
              f", group_accept {rg['group_accept'].tolist()}, rows equal, "
              f"beta max_abs_err {beta:.3e}; fog, params and pending "
              f"max_abs_err {err:.3e}, {far} entries beyond 1e-4")

    one = uniform_topology(8, 1)
    runs = {
        "fused": lambda eng, p0, **kw: eng.run_rounds_fused(
            eng.init_state(p0), 2, **kw),
        "async": lambda eng, p0, **kw: eng.run_async(
            eng.init_state(p0), 3, async_cfg=acfg, **kw)}
    for name, run in runs.items():
        eng, p0 = engine("cuda")
        first, second = run(eng, p0), run(eng, p0)
        st, recs, fog = run(eng, p0, topology=one)
        if name == "async":
            fog = tree_map(lambda a: a[0], fog)      # the [1, ...] stack
        recs = {k: v for k, v in recs.items()
                if k not in ("fog_sync", "beta", "group_accept")}
        repeat_gap, where = run_gap(torch, first, second)
        gap, at = run_gap(torch, first, (st, recs, fog))
        print(f"  fog G = 1 vs flat, {name}, card: two flat runs "
              f"{'bit-equal' if where is None else 'differ'} (gap "
              f"{repeat_gap:.3e}); G = 1 vs flat gap {gap:.3e} (first at "
              f"{at})")
        if where is None and at is not None:
            raise AssertionError(f"fog G = 1 {name}: differs from the flat "
                                 f"run at {at} although the card repeats "
                                 "its bits")
        if where is not None and not gap <= 2 * repeat_gap:
            raise AssertionError(f"fog G = 1 {name}: gap {gap} > twice the "
                                 f"run-to-run gap {repeat_gap}")


def check_async_resume(torch, fed, interop, lenet):
    """Phase 16, the async restore: 8 devices (the phase 7 fleet with MC
    dropout on), churn, crashes, drops, corruption, label noise, guards
    ``"drop"`` and int8 uploads with error feedback; 2 events, save, load,
    ``resume_state(next_round=2)``, 2 events with ``start_event=2``
    against 2 events chained on the in-memory state: bit for bit when two
    chained continuations repeat their bits, else within twice their
    gap."""
    import tempfile
    from repro_torch.checkpoint import load_engine_state, save_engine_state
    from repro_torch.core.async_engine import AsyncConfig
    from repro_torch.core.comms import CommsConfig
    from repro_torch.core.faults import FaultConfig, GuardConfig
    from repro_torch.core.engine import EdgeEngine
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.data.federated_split import federated_split

    cfg = fed.massive_config(8)
    shards = federated_split(make_digit_dataset(320, seed=0), 8, seed=0)
    seed_set, test = make_digit_dataset(20, seed=11), make_digit_dataset(
        200, seed=5)
    trainer = fed.Trainer(cfg)
    eng = EdgeEngine(trainer, cfg, shards, seed_set, test,
                     total_acquisitions=4 * cfg.acquisitions)
    p0 = trainer.init_params(torch.Generator(device="cuda").manual_seed(0))
    kw = dict(async_cfg=AsyncConfig(quorum=3, timer=4.0, dist="exp",
                                    mean_latency=1.0, latency_skew=4.0),
              faults=FaultConfig(death_rate=0.2, birth_rate=0.5,
                                 crash_rate=0.1, drop_rate=0.1,
                                 corrupt_rate=0.2, label_noise_rate=0.1),
              guards=GuardConfig(policy="drop"),
              comms=CommsConfig(compression="int8"))
    st, _, _ = eng.run_async(eng.init_state(p0), 2, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/async.msgpack"
        save_engine_state(path, st, metadata={"next_event": 2})
        loaded, meta = load_engine_state(path)
    chained = eng.run_async(st, 2, start_event=2, **kw)
    again = eng.run_async(st, 2, start_event=2, **kw)
    loaded = eng.resume_state(loaded, next_round=meta["next_event"])
    restored = eng.run_async(loaded, 2, start_event=meta["next_event"], **kw)
    repeat_gap, where = run_gap(torch, chained, again)
    gap, at = run_gap(torch, chained, restored)
    print(f"  async resume (D = 8, 2 + 2 events): two chained continuations "
          f"{'bit-equal' if where is None else 'differ'} (gap "
          f"{repeat_gap:.3e}); restored vs chained gap {gap:.3e} (first at "
          f"{at})")
    if where is None and at is not None:
        raise AssertionError(f"async resume differs from the chained "
                             f"continuation at {at} although the card "
                             "repeats its bits")
    if where is not None and not gap <= 2 * repeat_gap:
        raise AssertionError(f"async resume gap {gap} > twice the "
                             f"run-to-run gap {repeat_gap}")
    return {"repeat_gap": repeat_gap, "resume_gap": gap,
            "first_diff": at}


class SegmentsPerRound:
    """While active, the fused-aggregation kernel's segment-launch count
    at the end of every fused round (read where the round re-dispatches
    the fog models, ``topology.take_group_rows``)."""

    def __init__(self, k2):
        from repro_torch.core import topology
        self.k2, self.topo, self.take = k2, topology, topology.take_group_rows
        self.marks = []

    def __enter__(self):
        def take(*args, **kw):
            self.marks.append(self.k2.segment_launches)
            return self.take(*args, **kw)
        self.topo.take_group_rows = take
        return self

    def __exit__(self, *exc):
        self.topo.take_group_rows = self.take

    def per_round(self):
        marks = [0] + self.marks
        return [b - a for a, b in zip(marks, marks[1:])]


def run_fog_path(torch, fed, comms, lenet, k2, reset, read, first):
    """Phase 19: ``run_experiment(scenario="fog", num_devices=256,
    rounds=4)`` on ``default_topology(256)`` (G = 16, local_steps 4:
    rounds 0-2 fog-local, round 3 a sync): wall, ``fog_sync`` [0, 0, 0,
    1], β summing to 1 on every accepting round, ``group_accept``, the
    tiers summary; K1 exactly 8 launches, K2's flat and segment launches
    apart, at least one segment launch in each of rounds 0-2.  Then the
    same fleet with ``CommsConfig(fog_compression="int8")``: the delta
    form's segment launches (one every round), every round's fog→cloud
    bytes exact, the fog model finite."""
    runs = {}
    template = lenet_template(torch, lenet)
    for name, cc in (("fog", None),
                     ("fog int8 fog codec",
                      comms.CommsConfig(fog_compression="int8"))):
        reset()
        k2.segment_launches = 0
        t0 = time.perf_counter()
        with FogModels(fed) as fog, SegmentsPerRound(k2) as seg:
            rep = fed.run_experiment(scenario="fog", num_devices=256,
                                     rounds=4, comms=cc)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read()
        fog.check_finite(torch, name)
        if cc is None:
            first["fog"] = (rep, fog.models[-1], wall, launches)
        del fog
        rounds = rep["rounds"]
        segs = seg.per_round()
        launches["fused_aggregation_segment"] = k2.segment_launches
        flat = launches["fused_aggregation"] - k2.segment_launches
        syncs = [int(r["fog_sync"]) for r in rounds]
        tiers = rep["tiers"]
        print(f"  {name}: wall {wall:.3f} s, aggregated_acc per round "
              f"{[r['aggregated_acc'] for r in rounds]}, launches "
              f"{launches} (K2 flat {flat}, segment {k2.segment_launches}, "
              f"segment per round {segs}); fog_sync {syncs}; beta sums "
              f"{[round(sum(r['beta']), 6) for r in rounds]}; group_accept "
              f"{[r['group_accept'] for r in rounds]}")
        print(f"  {name} tiers: edge->fog {tiers['edge_fog_bytes_total']} "
              f"bytes, fog->cloud {tiers['fog_cloud_bytes_total']} bytes, "
              f"cross_tier_reduction {tiers['cross_tier_reduction']}, "
              f"per round {tiers['bytes_per_round']}")
        if syncs != [0, 0, 0, 1]:
            raise AssertionError(f"{name}: fog_sync {syncs}")
        if launches["acquisition_scores"] != 8:
            raise AssertionError(f"{name}: {launches['acquisition_scores']} "
                                 "K1 launches, 4 rounds of R = 2 make 8")
        if len(segs) != 4 or min(segs[:3]) < 1:
            raise AssertionError(f"{name}: K2 segment launches per round "
                                 f"{segs}, each fog-local round needs one")
        for r in rounds:
            bsum = sum(r["beta"])
            if sum(r["group_accept"]) > 0 and not abs(bsum - 1.0) < 1e-5:
                raise AssertionError(f"{name} round {r['round']}: beta sums "
                                     f"{bsum}")
            acc = r["aggregated_acc"]
            if not (acc == acc and 0.0 <= acc <= 1.0):
                raise AssertionError(f"{name} round {r['round']}: acc {acc}")
        G = tiers["num_groups"]
        per_group = comms.upload_bytes(comms.CommsConfig(
            compression=(cc.fog_compression if cc else "none")), template)
        for r, t in zip(rounds, tiers["bytes_per_round"]):
            want = (G * (per_group + comms.METADATA_BYTES_PER_UPLOAD)
                    if r["fog_sync"] else 0)
            if t["fog_cloud_uplink_bytes"] != want:
                raise AssertionError(f"{name} round {r['round']}: fog->cloud "
                                     f"{t['fog_cloud_uplink_bytes']} bytes, "
                                     f"the ledger's formula gives {want}")
        if cc is not None and segs != [1, 1, 1, 1]:
            raise AssertionError(f"{name}: the delta form reduces every "
                                 f"round per segment, got {segs}")
        runs[name] = {"wall_s": wall, "launches": launches,
                      "k2_flat": flat, "k2_segment_per_round": segs,
                      "tiers": {k: tiers[k] for k in (
                          "edge_fog_bytes_total", "fog_cloud_bytes_total",
                          "cross_tier_reduction")}}
        torch.cuda.empty_cache()
    return runs


def report_gap(a, b, where=""):
    """``(largest |a − b| over the floats of two reports, the first place
    they differ or None)``; an integer, bool, string or structure that
    differs counts as an infinite gap."""
    if isinstance(a, dict) or isinstance(a, (list, tuple)):
        keys = (sorted(a) if isinstance(a, dict) else range(len(a)))
        if (isinstance(a, dict) and set(a) != set(b)) or len(a) != len(b):
            return float("inf"), where
        worst, first = 0.0, None
        for k in keys:
            gap, at = report_gap(a[k], b[k], f"{where}/{k}")
            if at is not None and first is None:
                first = at
            worst = max(worst, gap)
        return worst, first
    if isinstance(a, float) and isinstance(b, float):
        if a == b or (a != a and b != b):
            return 0.0, None
        return abs(a - b), where
    return (0.0, None) if a == b else (float("inf"), where)


def fog_gap(torch, a, b):
    """``(largest |a − b| over two fog models' leaves, entries beyond 1e-5
    per leaf, the first leaf that differs or None)``."""
    from repro_torch.tree import tree_items
    worst, beyond, first = 0.0, {}, None
    other = dict(tree_items(b))
    for path, x in tree_items(a):
        y = other[path]
        if torch.equal(x, y):
            continue
        gap = (x.double() - y.double()).abs()
        worst = max(worst, float(gap.max()))
        beyond[path] = (int((gap > 1e-5).sum()), gap.numel())
        first = first or path
    return worst, beyond, first


# scenario arguments of the paths phase 20 runs on a mesh
SHARDED_PATHS = {"massive": dict(scenario="massive", num_devices=256,
                                 rounds=2),
                 "fog": dict(scenario="fog", num_devices=256, rounds=4),
                 "async": dict(scenario="async", num_devices=256, rounds=8),
                 "stream": dict(scenario="stream", num_devices=256,
                                rounds=8)}


def run_sharded_paths(torch, fed, reset, read, first):
    """Phase 20 (a): each of massive, fog, async and stream once more
    unsharded and once on a one-rank NCCL mesh (``make_device_mesh()``;
    the fog path on ``make_fog_mesh(1, 1)``).  Against the path's first
    run (phases 9, 17, 19 and 21): when the two unsharded runs repeat
    their bits, the meshed run must too; else it must lie within their
    gap.  K1 and K2 launch as often as unsharded.  The group is destroyed
    after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh, make_fog_mesh

    meshes = {"massive": make_device_mesh(), "fog": make_fog_mesh(1, 1)}
    meshes["async"] = meshes["stream"] = meshes["massive"]
    m = meshes["massive"]
    print(f"  one-rank group: backend {m.backend}, world {m.world}, "
          f"device {m.device}")
    if m.backend != "nccl" or m.world != 1:
        raise AssertionError(f"phase 20 (a) wants a one-rank NCCL group, "
                             f"got {m.backend} over {m.world}")
    out = {}
    for name, kw in SHARDED_PATHS.items():
        runs = {"first": first[name]}
        for label, extra in (("unsharded", {}),
                             ("one-rank nccl", {"mesh": meshes[name]})):
            reset()
            t0 = time.perf_counter()
            with FogModels(fed) as fog:
                rep = fed.run_experiment(**kw, **extra)[0]
            torch.cuda.synchronize()
            runs[label] = (rep, fog.models[-1], time.perf_counter() - t0,
                           read())
            del fog
        gaps = {}
        for label in ("unsharded", "one-rank nccl"):
            rgap, rwhere = report_gap(runs["first"][0], runs[label][0])
            fgap, _, fwhere = fog_gap(torch, runs["first"][1],
                                      runs[label][1])
            gaps[label] = (max(rgap, fgap), rwhere or fwhere)
        walls = {k: v[2] for k, v in runs.items()}
        launches = {k: v[3] for k, v in runs.items() if k != "first"}
        print(f"  {name}: walls {walls}; launches {launches}; first run vs "
              f"unsharded again: largest gap {gaps['unsharded'][0]:.3e} "
              f"(first at {gaps['unsharded'][1]}); vs the one-rank NCCL "
              f"mesh: {gaps['one-rank nccl'][0]:.3e} (first at "
              f"{gaps['one-rank nccl'][1]})")
        repeat, meshed = gaps["unsharded"][0], gaps["one-rank nccl"][0]
        if repeat == 0.0 and gaps["unsharded"][1] is None:
            if gaps["one-rank nccl"][1] is not None:
                raise AssertionError(
                    f"{name}: the one-rank mesh differs at "
                    f"{gaps['one-rank nccl'][1]} (gap {meshed}) although "
                    "two unsharded runs repeat their bits")
        elif not meshed <= repeat:
            raise AssertionError(f"{name}: one-rank mesh gap {meshed} over "
                                 f"the run-to-run gap {repeat}")
        for k in ("acquisition_scores", "fused_aggregation"):
            if launches["one-rank nccl"][k] != runs["first"][3][k]:
                raise AssertionError(
                    f"{name}: {launches['one-rank nccl'][k]} {k} launches "
                    f"on the mesh, {runs['first'][3][k]} unsharded")
        out[name] = {"walls_s": walls, "launches": launches,
                     "repeat_gap": repeat, "mesh_gap": meshed}
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def _gloo_rank(rank, out_dir, src):
    """One of phase 20 (b)'s two processes: join a gloo group over a
    ``FileStore``, run massive at D = 256 on a 2-way ``make_device_mesh()``
    with CUDA tensors on the one card, and save the report, the fog model,
    the wall, the launches and the global-shape draw bytes (or the
    error)."""
    import traceback
    from datetime import timedelta
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    got = {}
    try:
        from repro_torch.core import federated as fed
        from repro_torch.kernels import acquisition_scores as k1
        from repro_torch.kernels import fused_aggregation as k2
        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import make_device_mesh
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(f"{out_dir}/store", 2), rank=rank,
            world_size=2, timeout=timedelta(seconds=60))
        mesh = make_device_mesh()
        k1.launches = k2.launches = 0
        t0 = time.perf_counter()
        with FogModels(fed) as fog:
            rep = fed.run_experiment(**SHARDED_PATHS["massive"],
                                     mesh=mesh)[0]
        torch.cuda.synchronize()
        got = {"rep": rep, "fog": fog.models[-1], "backend": mesh.backend,
               "wall_s": time.perf_counter() - t0,
               "launches": {"acquisition_scores": k1.launches,
                            "fused_aggregation": k2.launches},
               "drawn_bytes": dict(sharding.drawn_bytes)}
    except Exception:
        got = {"error": traceback.format_exc()}
    torch.save(got, f"{out_dir}/rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def run_gloo_split(torch, massive):
    """Phase 20 (b): massive at D = 256 split over two processes that share
    the card through a gloo group this script starts, CUDA tensors in the
    collectives.  Held to the unsharded first run (``massive``: its report
    and fog model) by the bars of ``tests/port_torch/test_torch_mesh.py``:
    report floats within 1e-5 and integers equal; the fog model within
    1e-5 but for at most ``comms.split_budget`` entries a leaf within the
    fit's reach; both ranks bit-equal.  A refusal of gloo to take CUDA
    tensors is reported on its own line, not worked around."""
    import tempfile
    from repro_torch.core import comms
    ctx = torch.multiprocessing.get_context("spawn")
    src = str(Path(__file__).resolve().parent / "src")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_gloo_rank, args=(r, tmp, src))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, 300 - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        secs = time.perf_counter() - t0
        got = []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"rank{r}.pt"
            got.append(torch.load(path, weights_only=False,
                                  map_location="cuda:0") if path.exists()
                       else {"error": f"rank {r} saved nothing (exit code "
                                      f"{p.exitcode})"})
    errors = [g["error"] for g in got if "error" in g]
    if errors:
        text = errors[0].strip().splitlines()[-1]
        if "gloo" in errors[0].lower() and "cuda" in errors[0].lower():
            print(f"  phase 20 (b): gloo refused CUDA tensors: {text}")
            return {"refused": text, "seconds": secs}
        raise AssertionError("phase 20 (b) failed:\n" + "\n".join(errors))
    rep, fog = massive[0], massive[1]
    # 2 rounds x R 2 x 10 steps, each moving an entry by about lr 1e-3
    reach = 2 * 2 * 10 * 1e-3
    for r, g in enumerate(got):
        rgap, rwhere = report_gap(rep, g["rep"])
        fgap, beyond, _ = fog_gap(torch, fog, g["fog"])
        print(f"  rank {r} ({g['backend']}): wall {g['wall_s']:.3f} s "
              f"(unsharded {massive[2]:.3f} s), launches {g['launches']}, "
              f"report gap {rgap:.3e} (first at {rwhere}), fog model gap "
              f"{fgap:.3e}, entries beyond 1e-5 {beyond}; global-shape "
              f"draws {g['drawn_bytes']['global']} bytes, "
              f"{g['drawn_bytes']['kept']} of them kept")
        if rwhere is not None and not rgap <= 1e-5:
            raise AssertionError(f"gloo split rank {r}: report differs at "
                                 f"{rwhere} by {rgap}")
        if not fgap <= reach or any(
                n > comms.split_budget(size) for n, size in beyond.values()):
            raise AssertionError(f"gloo split rank {r}: fog model gap "
                                 f"{fgap}, beyond 1e-5 {beyond}")
    gap, _, at = fog_gap(torch, got[0]["fog"], got[1]["fog"])
    if at is not None or got[0]["rep"] != got[1]["rep"]:
        raise AssertionError(f"gloo split: the ranks differ at {at} ({gap})")
    return {"seconds": secs,
            "walls_s": [g["wall_s"] for g in got],
            "unsharded_wall_s": massive[2],
            "rank_launches": [g["launches"] for g in got],
            "report_gap": max(report_gap(rep, g["rep"])[0] for g in got),
            "fog_gap": max(fog_gap(torch, fog, g["fog"])[0] for g in got),
            "drawn_bytes": [g["drawn_bytes"] for g in got]}


# phase 26: the model-parallel launch tools
DRYRUN_TIMEOUT_S = 900          # the dry run's child, from its start
MESH_SERVE = dict(batch=4, prompt_len=4128, max_new_tokens=5)


def start_dry_run(src: Path):
    """Phase 26 (a), started right after the build: the port's dry run of
    gemma2-2b (``python -m repro_torch.launch.dryrun``) in a child process
    on a fake 16 × 16 group over meta tensors, all four shapes, the card
    hidden from it, one host thread.  Its records and log go to
    ``build/dryrun/``.  Returns ``(process, out dir, log, start time)``;
    an exit of this script kills the child if it still runs."""
    import atexit
    import shutil
    out = src.parent / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(src), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    log = out / "log.txt"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "gemma2-2b", "--out-dir", str(out)], stdout=f,
            stderr=subprocess.STDOUT, env=env, cwd=str(src.parent))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log, time.perf_counter()


def finish_dry_run(handle):
    """Phase 26 (a): wait for the dry run's child, then print each shape's
    record; a shape that recorded an error, or a child that failed or ran
    past ``DRYRUN_TIMEOUT_S``, fails the run."""
    proc, out, log, t0 = handle
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"phase 26 (a): the dry run ran past "
                             f"{DRYRUN_TIMEOUT_S} s:\n{log.read_text()[-3000:]}")
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"phase 26 (a): the dry run exited {rc}:\n"
                             f"{log.read_text()[-3000:]}")
    records = {}
    for path in sorted(out.glob("gemma2-2b__*.json")):
        rec = json.loads(path.read_text())
        records[rec["shape"]] = rec
    print(f"  (a) host only (fake 16 x 16 group, meta tensors, the card "
          f"hidden): the child's wall {wall:.1f} s from its start after "
          f"phase 2")
    want = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    for shape in want:
        rec = records.get(shape)
        if rec is None or "error" in rec:
            raise AssertionError(f"phase 26 (a): gemma2-2b {shape}: "
                                 f"{rec and rec.get('error')}")
        m, r = rec["per_device_bytes"], rec["roofline"]
        print(f"  (a) {shape}: per device argument {m['argument_gb']:.3f} "
              f"GB, output {m['output_gb']:.3f}, alias {m['alias_gb']:.3f}, "
              f"temp {m['temp_gb']:.3f}; FLOPs {rec['hlo_flops']:.6g}, "
              f"traffic {rec['hlo_traffic']:.6g} B, collectives "
              f"{rec['collective_bytes']:.6g} B {rec['collective_counts']}; "
              f"roofline compute {r['compute_s']:.6g} s, memory "
              f"{r['memory_s']:.6g} s, collective {r['collective_s']:.6g} s "
              f"({r['bottleneck']}); trace {rec['lower_s']} + "
              f"{rec['compile_s']} s")
    return {"wall_s": wall, "records": {k: records[k] for k in want}}


def run_mesh_analysis(torch, reset, read):
    """Phase 26 (b): gemma2-2b at full depth in bfloat16 on a one-rank
    NCCL ``make_debug_mesh(1)``, params placed by the rule tables; one
    ``"pallas"`` prefill of ``[4, 4128]`` (caches of 4,161 slots, phase
    23's) timed warm, then again under ``op_analysis.analyze``: FLOPs
    equal to the same step traced on meta tensors over the same mesh, no
    collective on either, K3 launched 26 times; the measured seconds
    beside ``roofline_terms``' compute and memory seconds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import on_meta, roofline_terms
    from repro_torch.launch.mesh import make_debug_mesh, use_mesh
    from repro_torch.launch.sharding import (batch_spec, distribute,
                                             distribute_params)
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.api import build_model
    from repro_torch.tree import tree_leaves

    mesh = make_debug_mesh(1)
    group = mesh.get_group("model")
    print(f"  (b) mesh {mesh}, backend "
          f"{torch.distributed.get_backend(group)}")
    cfg = get_config("gemma2-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(a.numel() for a in tree_leaves(params))
    if n_params != SERVE_PARAMS:
        raise AssertionError(f"gemma2-2b has {n_params} parameters")
    B, S = MESH_SERVE["batch"], MESH_SERVE["prompt_len"]
    prompts = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(1))
    prefill = make_prefill_step(model, max_cache_len=S + 32 + 1,
                                impl="pallas")
    dparams = distribute_params(mesh, params)
    batch = {"tokens": distribute(mesh, prompts, batch_spec(mesh, 2))}
    with use_mesh(mesh):
        prefill(dparams, batch)                       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(dparams, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        reset()
        (logits, _), card, traced_s = op_analysis.analyze(prefill, dparams,
                                                          batch)
        torch.cuda.synchronize()
        launches = read()
    finite = bool(torch.isfinite(logits.full_tensor()).all())
    del dparams, params, logits
    torch.cuda.empty_cache()
    mparams = distribute_params(mesh, on_meta(model.init, torch.Generator()))
    mbatch = {"tokens": distribute(mesh, torch.zeros(
        (B, S), dtype=prompts.dtype, device="meta"), batch_spec(mesh, 2))}
    with use_mesh(mesh):
        _, meta, meta_s = op_analysis.analyze(prefill, mparams, mbatch)
    roof = roofline_terms(1, card.flops, card.traffic, card.collective_bytes)
    share = max(roof["compute_s"], roof["memory_s"]) / secs
    print(f"  (b) pallas prefill [{B}, {S}]: card FLOPs {card.flops:.6g}, "
          f"meta {meta.flops:.6g} (equal: {card.flops == meta.flops}); "
          f"traffic card {card.traffic:.6g} B, meta {meta.traffic:.6g} B; "
          f"collectives card {card.collective_counts}, meta "
          f"{meta.collective_counts}; K3 {launches['flash_attention']} "
          f"launches; traced in {traced_s:.3f} s on the card, "
          f"{meta_s:.3f} s on meta")
    print(f"  (b) measured prefill {secs:.4f} s; roofline compute "
          f"{roof['compute_s']:.6g} s, memory {roof['memory_s']:.6g} s "
          f"(traffic proxy: operand + result bytes of every op); the larger "
          f"is {share:.4f} of the measured")
    if card.flops != meta.flops or card.flops <= 0:
        raise AssertionError(f"phase 26 (b): card FLOPs {card.flops} vs "
                             f"meta {meta.flops}")
    if card.collective_counts or meta.collective_counts:
        raise AssertionError("phase 26 (b): collectives on a one-rank mesh: "
                             f"{card.collective_counts}, "
                             f"{meta.collective_counts}")
    if launches["flash_attention"] != cfg.n_layers or not finite:
        raise AssertionError(f"phase 26 (b): K3 {launches}, finite {finite}")
    return ({"prefill_s": secs, "flops": card.flops, "traffic": card.traffic,
             "meta_flops": meta.flops, "meta_traffic": meta.traffic,
             "roofline": roof, "share": share, "traced_s": traced_s,
             "meta_traced_s": meta_s, "launches": launches}, launches, mesh)


def run_mesh_hints(torch, reset, read, mesh):
    """Phase 26 (c): ``serve("gemma2-2b", full_config=True, impl="pallas")``,
    a prefill of ``[4, 4128]`` and 4 decode steps in bfloat16, against
    its greedy loop driven through ``make_prefill_step`` and
    ``make_decode_step`` with ``shard_hints=True`` under ``use_mesh``,
    the same seed's params placed by the rule tables: logits and tokens
    bit-equal, K3 26 launches a step in both.  The group is destroyed
    after."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.sharding import (batch_spec, distribute,
                                             distribute_params)
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.api import build_model

    B, P = MESH_SERVE["batch"], MESH_SERVE["prompt_len"]
    new = MESH_SERVE["max_new_tokens"]
    launches = []
    torch.cuda.empty_cache()
    reset()
    a = serve("gemma2-2b", full_config=True, device="cuda", impl="pallas",
              keep_logits=True, **MESH_SERVE)
    launches.append(read())
    print(f"  (c) plain serve: prefill {a.prefill_s:.3f} s, decode "
          f"{a.decode_s:.3f} s for {new - 1} steps; launches {launches[-1]}")

    torch.cuda.empty_cache()
    model = build_model(replace(get_config("gemma2-2b"), shard_hints=True))
    params = distribute_params(mesh, model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    prefill = make_prefill_step(model, max_cache_len=P + new + 1,
                                impl="pallas")
    decode = make_decode_step(model, impl="pallas")
    place = lambda t: distribute(mesh, t, batch_spec(mesh, 2))
    kept, toks = [], []
    reset()
    with use_mesh(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": place(a.prompts)})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(new):
            kept.append(logits[:, -1].full_tensor())
            toks.append(kept[-1].float().argmax(dim=-1, keepdim=True))
            if i < new - 1:
                logits, caches = decode(params, place(toks[-1]), caches,
                                        P + i)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    launches.append(read())
    print(f"  (c) steps over the mesh with hints: prefill {prefill_s:.3f} s, "
          f"decode {decode_s:.3f} s for {new - 1} steps; launches "
          f"{launches[-1]}")
    logits_b, tokens_b = torch.stack(kept, dim=1), torch.cat(toks, dim=1)
    same = bool(torch.equal(a.logits, logits_b)
                and torch.equal(a.tokens, tokens_b))
    gap = float((a.logits.float() - logits_b.float()).abs().max())
    print(f"  (c) logits bit-equal: {same} (largest gap {gap:.3e}); tokens "
          f"{tokens_b[0].tolist()}")
    del params, caches, logits, kept
    torch.distributed.destroy_process_group()
    want = 26 * new
    if not same or any(n["flash_attention"] != want for n in launches):
        raise AssertionError(f"phase 26 (c): bit-equal {same}, launches "
                             f"{launches}")
    return {"bit_equal": same, "prefill_s": [a.prefill_s, prefill_s],
            "decode_s": [a.decode_s, decode_s]}, launches


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
    from repro_torch.core import comms
    from repro_torch.core import federated as fed
    from repro_torch.core.engine import CODEC_SPAN
    from repro_torch.kernels import _build
    from repro_torch.kernels import acquisition_scores as k1
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.kernels import fused_aggregation as k2
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.nn import lenet
    from repro_torch.tree import tree_leaves, tree_map

    kernels = {"acquisition_scores": k1, "fused_aggregation": k2,
               "flash_attention": k3, "ssd_intra_chunk": k4}
    t_start = time.perf_counter()

    def phase(title):
        print(f"{title} (t = {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}; matmul allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    phase("phase 2: build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"  built {secs} in {time.perf_counter() - t0:.1f} s")
    dry_run = start_dry_run(src)
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  {name}: {line.strip()}")

    configs = lm_path_configs(torch, fed)
    phase("phase 3: acquisition-score kernel (K1) vs plain")
    k1_entry = check_acquisition_kernel(torch, k1)
    err, k1_lm = check_acquisition_lm_widths(torch, k1)
    k1_entry["max_abs_err"] = max(k1_entry["max_abs_err"], err)
    k1_entry["shapes"] += [{"case": name, **t} for name, t in k1_lm.items()]
    phase("phase 4: fused-aggregation kernel (K2) vs plain")
    k2_entry = check_aggregation_kernel(torch, k2, tree_leaves)
    err, k2_lm = check_aggregation_lm_trees(torch, k2, tree_leaves, tree_map,
                                            configs)
    k2_entry["max_abs_err"] = max(k2_entry["max_abs_err"], err)
    phase("phase 5: flash-attention kernel (K3) vs plain")
    k3_entry = check_flash_attention_kernel(torch, k3)
    phase("phase 6: SSD intra-chunk kernel (K4) vs plain")
    k4_entry = check_ssd_kernel(torch, k4)
    torch.cuda.empty_cache()
    phase("phase 7: small rounds, card vs CPU")
    check_small_round_against_cpu(torch, fed, interop, lenet)
    check_host_engines_against_cpu(torch, fed, interop, lenet, tree_leaves)
    check_comms_rounds_against_cpu(torch, fed, interop, lenet, tree_leaves,
                                   tree_map)
    check_hetero_churn_rounds_against_cpu(torch, fed, interop, lenet,
                                          tree_leaves)
    check_async_events_against_cpu(torch, fed, interop, lenet, tree_leaves)
    check_stream_events_against_cpu(torch, fed, interop, lenet, tree_leaves)
    check_fog_rounds_against_cpu(torch, fed, interop, lenet, tree_leaves)
    check_small_lm_rounds_against_cpu(torch, fed, interop)

    def reset():
        for mod in kernels.values():
            mod.launches = 0
        torch.cuda.synchronize()

    def read():
        return {k: mod.launches for k, mod in kernels.items()}

    phase("phase 8: paper main path (run_experiment scenario='paper')")
    reset()
    t0 = time.perf_counter()
    rep = fed.run_experiment(fed.FederatedALConfig(), scenario="paper")[0]
    torch.cuda.synchronize()
    paper_s = time.perf_counter() - t0
    paper_launches = read()
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

    phase("phase 9: massive main path (scenario='massive', D=256, 2 rounds)")
    # the first run of each path phase 20 holds its sharded runs to
    first = {}
    reset()
    t0 = time.perf_counter()
    with FogModels(fed) as fog:
        rep = fed.run_experiment(scenario="massive", num_devices=256,
                                 rounds=2)[0]
    torch.cuda.synchronize()
    massive_s = time.perf_counter() - t0
    massive_launches = read()
    first["massive"] = (rep, fog.models[-1], massive_s, massive_launches)
    rounds = rep["rounds"]
    del fog
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

    phase("phase 10: LM paths (scenario='lm', 2 rounds, n_test 256; A and "
          "B on 8 devices, C on 4)")
    lm_walls, lm_launches, lm_peaks = {}, {}, {}
    for name, own in (("A", "ssd_intra_chunk"), ("B", "flash_attention"),
                      ("C", "flash_attention")):
        reset()
        lm_walls[name], lm_launches[name], lm_peaks[name], k3_shapes = \
            run_lm_path(torch, fed, name, configs[name], kernels)
        for k in ("acquisition_scores", "fused_aggregation", own):
            if lm_launches[name][k] < 1:
                raise AssertionError(f"path {name} launched no {k} kernel")
        if name == "C" and set(k3_shapes) != {(40, 40, 96)}:
            raise AssertionError(f"path C: K3 calls {k3_shapes}, not only "
                                 "MLA's 40 heads of 96")
        torch.cuda.empty_cache()

    phase("phase 12: host-aggregation engines at the paper's defaults")
    host = run_host_engine_paths(torch, fed, comms, lenet, reset, read)
    torch.cuda.empty_cache()
    phase("phase 13: massive main path with compressed uploads (D=256, 2 "
          "rounds)")
    codecs = run_massive_codecs(torch, fed, comms, lenet, reset, read)
    torch.cuda.empty_cache()
    phase("phase 14: path B with int8 uploads (lm-100m, 8 devices, 2 rounds)")
    b_int8 = run_lm_int8(torch, fed, comms, configs["B"], reset, read)
    torch.cuda.empty_cache()

    phase("phase 15: hetero path (scenario='hetero', D=256, 3 rounds)")
    hetero = run_hetero_path(torch, fed, reset, read)
    torch.cuda.empty_cache()
    phase("phase 16: churn path (scenario='churn', D=256, 3 rounds), a "
          "2 + 1-round resume and a 2 + 2-event async resume")
    churn = run_churn_path(torch, fed, reset, read, tree_leaves)
    async_resume = check_async_resume(torch, fed, interop, lenet)
    torch.cuda.empty_cache()
    phase("phase 17: async path (scenario='async', D=256, 8 events)")
    async_path = run_async_path(torch, fed, reset, read, first)
    torch.cuda.empty_cache()
    phase("phase 19: fog path (scenario='fog', D=256, G=16, 4 rounds), and "
          "with an int8 fog codec")
    fog_path = run_fog_path(torch, fed, comms, lenet, k2, reset, read,
                            first)
    torch.cuda.empty_cache()
    phase("phase 21: stream path (scenario='stream', D=256, 8 events)")
    stream_path = run_stream_path(torch, fed, comms, reset, read, first)
    torch.cuda.empty_cache()
    phase("phase 22: the decoder zoo at reduced() sizes, card vs CPU, and "
          "two 4-device fleets")
    zoo = check_zoo_against_cpu(torch)
    zoo_fleets = run_zoo_fleets(torch, fed, reset, read)
    zoo_decode = check_zoo_decode_against_cpu(torch)
    torch.cuda.empty_cache()
    phase("phase 23: gemma2-2b served at full depth (launch.serve, 4 x "
          "4,128-token prompts, 32 new tokens)")
    serve_path, serve_launches = run_serve_path(torch, reset, read,
                                                "gemma2-2b")
    torch.cuda.empty_cache()
    phase("phase 24: whisper-small served at its published widths "
          "(launch.serve, 4 x 1,500 frames and 1,500-token prompts, 32 new "
          "tokens)")
    whisper_path, whisper_launches = run_serve_path(torch, reset, read,
                                                    "whisper-small")
    torch.cuda.empty_cache()
    phase("phase 25: the training half: gemma2-2b trained at full depth, "
          "whisper-small's federated schedule, the steps card vs CPU, and "
          "the acquisition step at vocab 256,000")
    train_path, gemma_trained, train_launches = run_train_path(torch, reset,
                                                               read)
    train_vs_cpu = check_train_against_cpu(torch)
    acquire, acquire_launches = run_acquisition_step(torch, reset, read,
                                                     gemma_trained)
    del gemma_trained
    torch.cuda.empty_cache()
    phase("phase 20: the sharded fleet: one-rank NCCL meshes (massive, fog, "
          "async, stream), then massive split over two processes on gloo")
    sharded = run_sharded_paths(torch, fed, reset, read, first)
    torch.cuda.empty_cache()
    sharded["gloo split"] = run_gloo_split(torch, first["massive"])
    del first
    torch.cuda.empty_cache()
    phase("phase 26: the model-parallel launch tools: the dry run (host "
          "only), the analysis held against the card, the hints on the card")
    launch_tools = {"dry_run": finish_dry_run(dry_run)}
    launch_tools["analysis"], mesh_launches, mp_mesh = run_mesh_analysis(
        torch, reset, read)
    launch_tools["hints"], hint_launches = run_mesh_hints(torch, reset, read,
                                                          mp_mesh)
    del mp_mesh
    torch.cuda.empty_cache()

    phase("phase 11: where the time goes (all paths again, profiled)")
    from repro_torch.data.digits import make_digit_dataset
    from repro_torch.launch.serve import serve
    t0 = time.perf_counter()
    for n, seed in ((4000, 0), (1000, 5), (20, 11)):
        make_digit_dataset(n, seed=seed)
    print(f"  paper data generation (host numpy): "
          f"{time.perf_counter() - t0:.3f} s")
    from repro_torch.data.lm import lm_federated_split, make_lm_dataset
    for name in ("A", "B", "C"):
        vocab = configs[name].adapter.config.vocab_size
        t0 = time.perf_counter()
        make_lm_dataset(256, seq_len=32, vocab=vocab, seed=5, stream_seed=0)
        make_lm_dataset(20, seq_len=32, vocab=vocab, seed=11, stream_seed=0)
        lm_federated_split(configs[name].num_devices, 40, seq_len=32,
                           vocab=vocab, seed=0)
        print(f"  path {name} data generation (host numpy, vocab {vocab}): "
              f"{time.perf_counter() - t0:.3f} s")
    profiled = (
        ("paper", lambda: fed.run_experiment(fed.FederatedALConfig(),
                                             scenario="paper")),
        ("massive", lambda: fed.run_experiment(
            scenario="massive", num_devices=256, rounds=2)),
        ("A", lambda: fed.run_experiment(configs["A"], scenario="lm",
                                         rounds=2, n_test=256)),
        ("B", lambda: fed.run_experiment(configs["B"], scenario="lm",
                                         rounds=2, n_test=256)),
        ("C", lambda: fed.run_experiment(configs["C"], scenario="lm",
                                         rounds=2, n_test=256)),
        ("hetero", lambda: fed.run_experiment(
            scenario="hetero", num_devices=256, rounds=3)),
        ("churn", lambda: fed.run_experiment(
            scenario="churn", num_devices=256, rounds=3)),
        ("async", lambda: fed.run_experiment(
            scenario="async", num_devices=256, rounds=8)),
        ("fog", lambda: fed.run_experiment(
            scenario="fog", num_devices=256, rounds=4)),
        ("stream", lambda: fed.run_experiment(
            scenario="stream", num_devices=256, rounds=8)),
        ("serve (bf16, pallas)", lambda: serve(
            "gemma2-2b", full_config=True, device="cuda", impl="pallas",
            **SERVE)),
        ("whisper serve (bf16, pallas)", lambda: serve(
            "whisper-small", full_config=True, device="cuda", impl="pallas",
            **WHISPER)))
    path_profiles = {}
    for name, fn in profiled:
        torch.cuda.reset_peak_memory_stats()
        wall, busy, _, top, read_s = trace_path(torch, fn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        path_profiles[name] = {"wall_s": wall, "busy_s": busy,
                               "trace_read_s": read_s, "peak_gib": peak}
        print(f"  {name}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle share {1.0 - busy / wall:.3f}); top kernels {top}; "
              f"trace read in {read_s:.3f} s; peak device memory "
              f"{peak:.2f} GiB")
        torch.cuda.empty_cache()
    train_two, score_one = gemma_train_paths(torch)
    score_one()                              # warm, as phase 25 (d)
    for name, fn in (
            (f"train (launch.train, gemma2-2b at full depth, 2 steps of "
             f"{TRAIN['batch']} x {TRAIN['seq']} tokens, host data and "
             f"set-up included)", train_two),
            ("score step (gemma2-2b, T = 4 over 8 x 128 tokens)",
             score_one)):
        torch.cuda.reset_peak_memory_stats()
        wall, busy, _, top, read_s = trace_path(torch, fn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        path_profiles[name.split(" (")[0]] = {
            "wall_s": wall, "busy_s": busy, "trace_read_s": read_s,
            "peak_gib": peak}
        print(f"  {name}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"(idle share {1.0 - busy / wall:.3f}); top kernels {top}; "
              f"trace read in {read_s:.3f} s; peak device memory "
              f"{peak:.2f} GiB")
    del train_two, score_one
    torch.cuda.empty_cache()
    int8 = comms.CommsConfig(compression="int8")
    codec_profiles = {}
    for name, fn in (
            ("massive int8", lambda: fed.run_experiment(
                scenario="massive", num_devices=256, rounds=2, comms=int8)),
            ("B int8", lambda: fed.run_experiment(
                configs["B"], scenario="lm", rounds=2, n_test=256,
                comms=int8))):
        wall, busy, (codec, spanned), top, read_s = trace_path(
            torch, fn, CODEC_SPAN)
        codec_profiles[name] = {"wall_s": wall, "busy_s": busy,
                                "codec_device_ms": codec,
                                "codec_span_device_ms": spanned,
                                "trace_read_s": read_s}
        print(f"  {name} (host and device activity): wall {wall:.3f} s, "
              f"device busy {busy:.3f} s (idle share "
              f"{1.0 - busy / wall:.3f}); codec ({CODEC_SPAN} spans) "
              f"{codec:.3f} ms of kernel time, the spans {spanned:.3f} ms "
              f"of the device timeline; top kernels {top}; trace read in "
              f"{read_s:.3f} s")
        torch.cuda.empty_cache()

    all_launches = [paper_launches, massive_launches, *lm_launches.values(),
                    *(v[1] for v in host.values()),
                    *(v[1] for v in codecs.values()), b_int8[1],
                    hetero[1], churn[1], async_path[1], stream_path[1],
                    *(v[1] for v in zoo_fleets.values()), *serve_launches,
                    *whisper_launches, *train_launches,
                    *acquire_launches, mesh_launches, *hint_launches,
                    *(v["launches"] for v in fog_path.values()),
                    *(run for v in sharded.values()
                      for run in v.get("launches", {}).values())]
    for entry in (k1_entry, k2_entry, k3_entry, k4_entry):
        entry["launches"] = sum(run[entry["name"]] for run in all_launches)
    # of K2's launches on the paths, those in segment form (phase 19)
    k2_entry["segment_launches"] = sum(
        run.get("fused_aggregation_segment", 0) for run in all_launches)
    print(json.dumps({"paper_s": paper_s, "massive_s": massive_s,
                      "lm_s": lm_walls, "lm_peak_gib": lm_peaks,
                      "paper_launches": paper_launches,
                      "massive_launches": massive_launches,
                      "lm_launches": lm_launches,
                      "host_engines": host, "massive_codecs": codecs,
                      "lm_b_int8": {"wall_s": b_int8[0],
                                    "launches": b_int8[1],
                                    "peak_gib": b_int8[2]},
                      "codec_profiles": codec_profiles,
                      "path_profiles": path_profiles,
                      "hetero": {"wall_s": hetero[0], "launches": hetero[1],
                                 "staleness": hetero[2]},
                      "churn": {"wall_s": churn[0], "launches": churn[1],
                                "faults": churn[2], "resume": churn[3]},
                      "async": {"wall_s": async_path[0],
                                "launches": async_path[1],
                                "telemetry": async_path[2]},
                      "async_resume": async_resume, "fog": fog_path,
                      "stream": {"wall_s": stream_path[0],
                                 "launches": stream_path[1],
                                 "telemetry": stream_path[2]},
                      "sharded": sharded, "zoo": zoo,
                      "zoo_decode": zoo_decode, "serve": serve_path,
                      "whisper_serve": whisper_path,
                      "train": train_path, "train_vs_cpu": train_vs_cpu,
                      "acquire": acquire, "launch_tools": launch_tools,
                      "zoo_fleets": {k: {"wall_s": w, "launches": n}
                                     for k, (w, n) in zoo_fleets.items()},
                      "k2_lm_trees": k2_lm,
                      "total_s": time.perf_counter() - t_start}))
    print(f"card: {card}")
    print(json.dumps({"kernels": [k1_entry, k2_entry, k3_entry, k4_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
