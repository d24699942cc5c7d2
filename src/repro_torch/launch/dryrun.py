"""Multi-pod dry run: trace every (architecture × input shape) on the
production meshes, proving the sharding rules are coherent, and take the
roofline terms from the trace (``repro.launch.dryrun`` ported).

The reference lowers and compiles each step for 256 or 512 forced host
devices and reads the partitioned HLO.  PyTorch has no GSPMD and no HLO:
here the mesh is a ``DeviceMesh`` over a FAKE process group of 256 or
512 ranks (``launch.mesh``, ``backend="fake"``: collectives are no-ops),
params, optimiser state, caches and batches are DTensors placed by the
rule tables (``launch.sharding``) over META tensors, and the port's own
steps (``launch.steps``) run eagerly on them under ``launch.op_analysis``,
which counts rank 0's local ops.  Nothing is allocated on any device, as
nothing is in the reference, whose dry run is a CPU-side trace too.

The fake group becomes this process's default group, so the dry run
runs as its own process: ``python -m repro_torch.launch.dryrun``.  It
writes one JSON record a combination under ``experiments/dryrun/``; a
failure is recorded as ``{"error": ...}`` and the run goes on.

A decode step runs at position ``seq_len − 1``, against a full cache (the
reference traces a symbolic position; eager needs a number).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import asdict, dataclass, replace
from typing import Dict, Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     batch_axes, make_auto_mesh,
                                     make_production_mesh, use_mesh)
from repro_torch.launch.sharding import (batch_spec, cache_pspecs, distribute,
                                         distribute_params)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.api import build_model
from repro_torch.optim import adafactor, adamw
from repro_torch.tree import tree_map

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, batch=1),
}

# long_500k only for sub-quadratic / compressed-cache archs
LONG_OK = {"gemma2-2b", "recurrentgemma-9b", "deepseek-v2-236b",
           "minicpm3-4b", "mamba2-1.3b"}

# factored optimizer for the giant MoEs
ADAFACTOR_ARCHS = {"deepseek-v2-236b", "arctic-480b"}

DEFAULT_MICROBATCHES = {"train_4k": 8}


class _OnMeta(TorchFunctionMode):
    """Factory calls land on the meta device, their generator dropped: an
    init runs its shapes and dtypes and draws nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def on_meta(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` (an init) with every tensor on meta."""
    with _OnMeta():
        return fn(*args, **kwargs)


def make_optimizer(arch: str):
    if arch in ADAFACTOR_ARCHS:
        return adafactor(1e-3)
    return adamw(3e-4)


def _zeros(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str, mesh, *, cfg=None,
                federated_groups: int = 0):
    """Meta DTensor stand-ins for every model input of the step kind,
    placed over ``mesh`` (the reference's ``ShapeDtypeStruct`` trees)."""
    cfg = cfg or get_config(arch)
    model = build_model(cfg)
    info = SHAPES[shape_name]
    S, B = info["seq_len"], info["batch"]
    if federated_groups:
        B //= federated_groups     # one group's batch, on its pod
    bspec = batch_spec(mesh, 2)

    def extras(batch, seq):
        return {k: distribute(mesh, _zeros(shp, torch.bfloat16),
                              batch_spec(mesh, len(shp)))
                for k, shp in model.extra_input_shapes(batch, seq).items()}

    if info["kind"] == "train":
        return {"batch": {
            "tokens": distribute(mesh, _zeros((B, S), torch.int32), bspec),
            "targets": distribute(mesh, _zeros((B, S), torch.int32), bspec),
            **extras(B, S)}}
    if info["kind"] == "prefill":
        # enc-dec: the 32k sequence is the AUDIO input (frames); decoder
        # prefill stays at the family's 448-token spec
        tok_len = min(S, 448) if cfg.family == "encdec" else S
        return {"batch": {
            "tokens": distribute(mesh, _zeros((B, tok_len), torch.int32),
                                 bspec),
            **extras(B, S)}}
    # decode: one new token against a seq_len cache
    batch_sharded = B > 1
    caches = model.caches_init(B, S, extras_shape=model.extra_input_shapes(
        B, S) or None, device="meta")
    specs = cache_pspecs(caches, batch_sharded=batch_sharded,
                         batch_axes=batch_axes(mesh))
    caches = tree_map(lambda c, sp: distribute(mesh, c, sp), caches, specs)
    tok = distribute(mesh, _zeros((B, 1), torch.int32),
                     bspec if batch_sharded else (None, None))
    out = {"token": tok, "caches": caches, "position": S - 1}
    if cfg.family == "vlm":
        out["extras"] = extras(B, 1)   # image tokens re-read every step
    return out


@dataclass
class DryRunRecord:
    """One (arch, shape, mesh, mode) trace, the reference's fields.

    ``lower_s``: seconds to build the meta params, optimiser state and
    inputs and place them on the mesh; ``compile_s``: seconds of the
    traced step itself (eager PyTorch compiles nothing).
    ``per_device_bytes`` (GB, rank 0's local shards): ``argument_gb`` and
    ``output_gb`` exactly; ``alias_gb`` the outputs that share storage
    with an argument (a decode step's caches, written in place);
    ``temp_gb`` the high-water mark of live bytes the step made beyond
    its arguments, at op boundaries.  ``hlo_flops``, ``hlo_traffic`` and
    the collective fields are ``launch.op_analysis``'s per-device
    figures; ``cost_flops_raw`` the GLOBAL FLOPs of the DTensor-level
    ops (before partitioning); ``cost_bytes_raw`` -1.0 (no such figure,
    as the reference writes when XLA gives none)."""
    arch: str
    shape: str
    mesh: str
    mode: str
    lower_s: float
    compile_s: float
    per_device_bytes: Dict[str, float]
    cost_flops_raw: float
    cost_bytes_raw: float
    hlo_flops: float
    hlo_traffic: float
    collective_bytes: float
    cross_pod_bytes: float
    collective_counts: Dict[str, int]
    roofline: Dict[str, float]
    notes: str = ""


def roofline_terms(n_chips: int, hlo_flops: float, hlo_traffic: float,
                   collective_bytes: float) -> Dict[str, float]:
    """Three-term roofline (seconds) of per-device figures on the H100
    (``launch.mesh``): bf16 tensor-core peak, HBM3 rate and one NVLink 4
    rate for every collective.  On a mesh wider than one 8-GPU node the
    collectives that leave a node run over the slower network, so the
    collective term is then a lower bound."""
    t_compute = hlo_flops / PEAK_FLOPS_BF16
    t_memory = hlo_traffic / HBM_BW
    t_collective = collective_bytes / NVLINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    return terms


def _mesh(multi_pod: bool, mesh_override: Optional[str]):
    if mesh_override is None:
        return make_production_mesh(multi_pod=multi_pod, backend="fake")
    shape = tuple(int(x) for x in mesh_override.split("x"))
    axes = (("pod", "data", "model")[-len(shape):] if len(shape) == 3
            else ("data", "model"))
    return make_auto_mesh(shape, axes, backend="fake")


def _dump_ops(path: str, stats) -> None:
    """The port's stand-in for ``--save-hlo``: the counted figures."""
    with open(path, "w") as f:
        json.dump(asdict(stats), f, indent=2)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            mode: str = "baseline", num_microbatches: Optional[int] = None,
            save_hlo: Optional[str] = None, hints: bool = False,
            lowp_ce: bool = False, mesh_override=None) -> DryRunRecord:
    mesh = _mesh(multi_pod, mesh_override)
    n_chips = mesh.size()
    cfg = get_config(arch)
    if hints:
        cfg = replace(cfg, shard_hints=True)
    model = build_model(cfg)
    info = SHAPES[shape_name]
    kind = info["kind"]
    mb = num_microbatches if num_microbatches is not None else \
        DEFAULT_MICROBATCHES.get(shape_name, 1)
    notes = ""

    t0 = time.perf_counter()
    params = on_meta(model.init, torch.Generator())
    if kind == "train" and mode == "federated":
        if not multi_pod:
            raise ValueError("federated mode rides the pod axis: use "
                             "--multi-pod")
        G = 2  # one federated group per pod
        # each pod trains its own group: rank 0 traces group 0's step on
        # its pod's ("data", "model") sub-mesh, as the reference's vmapped
        # step is local to a pod
        mesh = mesh["data", "model"]
        opt = make_optimizer(arch)
        opt_state = distribute_params(mesh, opt.init(params))
        args = (distribute_params(mesh, params), opt_state,
                input_specs(arch, shape_name, mesh, cfg=cfg,
                            federated_groups=G)["batch"], 0)
        step = make_train_step(model, opt)
        notes = f"federated groups={G} (pod-axis local training)"
    elif kind == "train":
        opt = make_optimizer(arch)
        opt_state = distribute_params(mesh, opt.init(params))
        args = (distribute_params(mesh, params), opt_state,
                input_specs(arch, shape_name, mesh, cfg=cfg)["batch"], 0)
        step = make_train_step(model, opt, num_microbatches=mb,
                               lowp_ce=lowp_ce)
        notes = (("hints " if hints else "") + ("lowp_ce " if lowp_ce else "")
                 + f"microbatches={mb} optimizer="
                 + ("adafactor" if arch in ADAFACTOR_ARCHS else "adamw"))
    elif kind == "prefill":
        args = (distribute_params(mesh, params),
                input_specs(arch, shape_name, mesh, cfg=cfg)["batch"])
        step = make_prefill_step(model, max_cache_len=info["seq_len"])
    else:  # decode
        specs = input_specs(arch, shape_name, mesh, cfg=cfg)
        args = (distribute_params(mesh, params), specs["token"],
                specs["caches"], specs["position"], specs.get("extras"))
        step = make_decode_step(model)
    lower_s = time.perf_counter() - t0

    with use_mesh(mesh):
        _, stats, compile_s = op_analysis.analyze(
            step, *args, pod_size=256 if multi_pod else 1 << 30)
    if save_hlo:
        _dump_ops(save_hlo, stats)
    mem = {"argument_gb": stats.argument_bytes / 1e9,
           "output_gb": stats.output_bytes / 1e9,
           "temp_gb": stats.peak_temp_bytes / 1e9,
           "alias_gb": stats.alias_bytes / 1e9}
    roof = roofline_terms(n_chips, stats.flops, stats.traffic,
                          stats.collective_bytes)
    return DryRunRecord(
        arch=arch, shape=shape_name,
        mesh=(mesh_override or ("2x16x16" if multi_pod else "16x16")),
        mode=mode, lower_s=round(lower_s, 2), compile_s=round(compile_s, 2),
        per_device_bytes=mem, cost_flops_raw=stats.global_flops,
        cost_bytes_raw=-1.0, hlo_flops=stats.flops,
        hlo_traffic=stats.traffic, collective_bytes=stats.collective_bytes,
        cross_pod_bytes=stats.cross_pod_bytes,
        collective_counts=stats.collective_counts, roofline=roof,
        notes=notes)


def should_skip(arch: str, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and arch not in LONG_OK:
        return ("long_500k skipped: pure full-attention KV cache "
                "infeasible")
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all)")
    ap.add_argument("--shape", default=None,
                    help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="baseline",
                    choices=["baseline", "federated"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--hints", action="store_true",
                    help="enable the activation placement hints")
    ap.add_argument("--lowp-ce", action="store_true",
                    help="bf16-logits cross entropy with fp32 accumulation")
    ap.add_argument("--mesh-shape", default=None,
                    help="override mesh, e.g. 32x8 ('data'x'model')")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--save-hlo", default=None,
                    help="write the counted figures of the (last) trace "
                         "here: the port has no HLO")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    for arch in archs:
        for shape in shapes:
            skip = should_skip(arch, shape)
            tag = (f"{arch}__{shape}__"
                   f"{'2x16x16' if args.multi_pod else '16x16'}__{args.mode}")
            if args.hints:
                tag += "__hints"
            if args.lowp_ce:
                tag += "__lowpce"
            if args.mesh_shape:
                tag += f"__mesh{args.mesh_shape}"
            if args.microbatches is not None:
                tag += f"__mb{args.microbatches}"
            out_path = os.path.join(args.out_dir, tag + ".json")
            if skip:
                with open(out_path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "skipped": skip}, f, indent=2)
                print(f"[skip] {tag}: {skip}")
                continue
            print(f"[run ] {tag}", flush=True)
            try:
                rec = run_one(arch, shape, multi_pod=args.multi_pod,
                              mode=args.mode,
                              num_microbatches=args.microbatches,
                              save_hlo=args.save_hlo, hints=args.hints,
                              lowp_ce=args.lowp_ce,
                              mesh_override=args.mesh_shape)
                with open(out_path, "w") as f:
                    json.dump(asdict(rec), f, indent=2)
                r, m = rec.roofline, rec.per_device_bytes
                print(f"   ok lower={rec.lower_s}s trace={rec.compile_s}s "
                      f"args={m['argument_gb']:.3f}GB "
                      f"temp={m['temp_gb']:.3f}GB "
                      f"flops={rec.hlo_flops:.4g} "
                      f"traffic={rec.hlo_traffic:.4g}B "
                      f"coll={rec.collective_bytes:.4g}B "
                      f"{rec.collective_counts} "
                      f"compute={r['compute_s']:.4f}s "
                      f"memory={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s -> {r['bottleneck']}",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - record it, keep going
                with open(out_path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "error": repr(e)}, f, indent=2)
                print(f"   FAIL {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
