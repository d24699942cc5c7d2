"""Fused dequantize → staleness-decay → masked Eq. 1 reduce: the CUDA kernel
and its plain version.

The hand-written Hopper kernel (``csrc/fused_aggregation.cu``) replaces the
TPU kernel ``repro.kernels.fused_aggregation.fused_aggregate`` and takes
its whole contract: a ``[D, ...]`` param tree of float32 / bfloat16
payloads, or int8 codes with per-(device, leaf) float32 ``scales``; raw
Eq. 1 weights with optional staleness decay (none / exp / poly) and
participation mask; ``normalize`` applies the ``masked_normalize`` guard
chain, else the weights go in as-is (the engines' preweighted mode); flat
output ``[...]`` per leaf, or ``[G, ...]`` per segment.  Accumulation is
float32; each output leaf is cast to ``out_dtype`` (default: the leaf's
dtype, float32 for int8 codes).

``fused_aggregate`` is the wrapper ``core.aggregation.aggregate_stacked``
calls.  For tensors on the CPU it runs ``fused_aggregate_plain`` (the port
of ``repro.kernels.ref.fused_agg_ref``); for tensors on the card it
launches the kernel once per group of up to 32 leaves (LeNet has 10), or
raises on what the kernel does not take.  There is no fallback from one to
the other.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import aggregation as agg
from repro_torch.tree import tree_items, tree_leaves, tree_map

launches = 0

DECAY_KINDS = ("none", "exp", "poly")
MAX_LEAVES = 32           # leaf pointers per launch (the kernel's kMaxLeaves)
_SMEM_LIMIT = 227 * 1024 - 2 * 1024   # dynamic shared memory a block may ask
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}


def _check_args(kind, segment_ids, num_segments):
    if kind not in DECAY_KINDS:
        raise ValueError(
            f"unknown staleness decay {kind!r}: use {' | '.join(DECAY_KINDS)}")
    if segment_ids is not None and num_segments is None:
        raise ValueError("segment_ids requires a static num_segments")


def fused_aggregate_plain(stacked, weights, *, staleness=None, mask=None,
                          kind: str = "none", rate: float = 0.5,
                          normalize: bool = True, segment_ids=None,
                          num_segments: Optional[int] = None, scales=None,
                          out_dtype=None):
    """The kernel's function in plain PyTorch: dequantize → weights
    (``staleness_weights`` when ``normalize``, else ``weights · decay ·
    mask``) → ``weighted_sum_stacked`` / ``segment_sum_stacked``."""
    _check_args(kind, segment_ids, num_segments)
    tree = stacked
    if scales is not None:
        tree = tree_map(lambda q, s: q.float() * s.float().reshape(
            (-1,) + (1,) * (q.dim() - 1)), stacked, scales)
        if out_dtype is None:
            out_dtype = torch.float32
    leaf0 = tree_leaves(tree)[0]
    D, dev = leaf0.shape[0], leaf0.device
    s = (torch.zeros(D, device=dev) if staleness is None
         else agg._f32(staleness, dev))
    w0 = agg._f32(weights, dev)
    if normalize:
        w = agg.staleness_weights(w0, s, mask, kind=kind, rate=rate,
                                  segment_ids=segment_ids,
                                  num_segments=num_segments)
    else:
        w = w0 * agg.staleness_decay(s, kind=kind, rate=rate)
        if mask is not None:
            w = w * agg._f32(mask, dev)
    if segment_ids is None:
        return agg.weighted_sum_stacked(tree, w, out_dtype=out_dtype)
    return agg.segment_sum_stacked(tree, w, segment_ids, num_segments,
                                   out_dtype=out_dtype)


_ENTRIES = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("fused_aggregation"),
                     f"fused_aggregate_{_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def fused_aggregate(stacked, weights, *, staleness=None, mask=None,
                    kind: str = "none", rate: float = 0.5,
                    normalize: bool = True, segment_ids=None,
                    num_segments: Optional[int] = None, scales=None,
                    out_dtype=None):
    """One-pass fog aggregation over the stacked device axis (see the module
    docstring for the contract; ``weights``/``staleness``/``mask`` ``[D]``,
    ``segment_ids [D]`` int with ``num_segments`` G)."""
    _check_args(kind, segment_ids, num_segments)
    items = list(tree_items(stacked))
    if not items:
        return stacked
    leaves = [leaf for _, leaf in items]
    dev = leaves[0].device
    if dev.type == "cpu":
        return fused_aggregate_plain(
            stacked, weights, staleness=staleness, mask=mask, kind=kind,
            rate=rate, normalize=normalize, segment_ids=segment_ids,
            num_segments=num_segments, scales=scales, out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"no fused-aggregation kernel for device {dev}")

    dtype, D = leaves[0].dtype, leaves[0].shape[0]
    quantized = scales is not None
    if quantized != (dtype == torch.int8) or dtype not in _DTYPES:
        raise TypeError(f"fused-aggregation kernel takes float32 / bfloat16 "
                        f"payloads, or int8 codes with scales; got {dtype} "
                        f"{'with' if quantized else 'without'} scales")
    for path, leaf in items:
        if (leaf.dtype != dtype or leaf.device != dev or leaf.dim() < 1
                or leaf.shape[0] != D or not leaf.is_contiguous()):
            raise ValueError(f"leaf {path!r}: every payload leaf must be a "
                             f"contiguous [D={D}, ...] {dtype} tensor on {dev}")
    G = 1 if segment_ids is None else int(num_segments)
    if (3 * D + 3 * G) * 4 > _SMEM_LIMIT:
        raise ValueError(f"D={D}, G={G} exceed the kernel's shared memory")

    def vec(v, fill):
        if v is None:
            return torch.full((D,), fill, dtype=torch.float32, device=dev)
        v = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
        if v.shape[0] != D:
            raise ValueError(f"per-device vector of length {v.shape[0]} for "
                             f"D={D}")
        return v.contiguous()

    raw, stale, msk = vec(weights, 1.0), vec(staleness, 0.0), vec(mask, 1.0)
    seg = (torch.zeros(D, dtype=torch.int32, device=dev)
           if segment_ids is None else
           torch.as_tensor(segment_ids, device=dev).to(torch.int32)
           .reshape(-1).contiguous())
    if seg.shape[0] != D:
        raise ValueError(f"segment_ids of length {seg.shape[0]} for D={D}")
    smat = None
    if quantized:
        s_leaves = tree_leaves(scales)
        if len(s_leaves) != len(leaves):
            raise ValueError(f"scales tree has {len(s_leaves)} leaves for "
                             f"{len(leaves)} payload leaves")
        smat = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                            device=dev).reshape(D)
                            for s in s_leaves], dim=1).contiguous()  # [D, L]

    outs = [torch.empty((G,) + tuple(leaf.shape[1:]), dtype=torch.float32,
                        device=dev) for leaf in leaves]
    fn = _entry(dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kind_id = DECAY_KINDS.index(kind)
    global launches
    for base in range(0, len(leaves), MAX_LEAVES):
        grp = range(base, min(base + MAX_LEAVES, len(leaves)))
        offsets = [0]
        for i in grp:
            offsets.append(offsets[-1] + leaves[i][0].numel())
        xs = (ctypes.c_void_p * len(grp))(*[leaves[i].data_ptr() for i in grp])
        os_ = (ctypes.c_void_p * len(grp))(*[outs[i].data_ptr() for i in grp])
        offs = (ctypes.c_longlong * len(offsets))(*offsets)
        err = fn(ctypes.cast(xs, ctypes.c_void_p),
                 ctypes.cast(os_, ctypes.c_void_p),
                 ctypes.cast(offs, ctypes.c_void_p), len(grp), D,
                 raw.data_ptr(), stale.data_ptr(), msk.data_ptr(),
                 seg.data_ptr(), G,
                 None if smat is None else smat.data_ptr(),
                 0 if smat is None else smat.shape[1], base, kind_id,
                 float(rate), int(bool(normalize)), stream)
        if err != 0:
            raise RuntimeError(f"fused-aggregation kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1

    results = iter(outs)

    def finish(leaf):
        out = next(results)
        if segment_ids is None:
            out = out[0]
        dt = out_dtype if out_dtype is not None else (
            torch.float32 if quantized else leaf.dtype)
        return out if dt == torch.float32 else out.to(dt)

    return tree_map(finish, stacked)
