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
launches the kernel once per group of up to 32 leaves (LeNet has 10, each
LM tree 11), or raises on what the kernel does not take.  There is no
fallback from one to the other.  ``launches`` counts kernel launches,
``segment_launches`` those of them in segment form (a fog topology's
intra-fog reduce).

``tile_plan`` is the kernel's tile table for one tree shape, built once
per shape: which columns each tile covers, which leaves are read with
16-byte loads, and how many row groups share a tile.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from repro_torch.core import aggregation as agg
from repro_torch.tree import tree_items, tree_leaves, tree_map

launches = 0
segment_launches = 0

DECAY_KINDS = ("none", "exp", "poly")
MAX_LEAVES = 32           # leaf pointers per launch (the kernel's kMaxLeaves)
THREADS = 256             # threads a block (the kernel's kThreads)
MAX_ROW_GROUPS = 32       # the most row groups that split one tile
TILES_PER_SM = 2          # tiles per SM before rows are split further
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
    from repro_torch.core.topology import segment_sum_stacked
    return segment_sum_stacked(tree, w, segment_ids, num_segments,
                               out_dtype=out_dtype)


_ENTRIES = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("fused_aggregation"),
                     f"fused_aggregate_{_DTYPES[dtype]}")
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = ([ptrs] * 3 + [ctypes.POINTER(ctypes.c_longlong),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_uint]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


@dataclass(frozen=True)
class TilePlan:
    """The kernel's tile table for one tree shape.

    Tile ``t`` of a launch lies in the last leaf ``l`` with
    ``tile_offs[k][l] <= t`` and covers its columns ``[c0, min(c0 +
    tile_cols, n_l))`` with ``c0 = (t - tile_offs[k][l]) * tile_cols``;
    ``row_groups`` groups of ``THREADS / row_groups`` threads share its
    rows.  Bit ``l`` of ``vec_masks[k]`` marks a leaf read with 16-byte
    loads (its rows start on 16-byte boundaries)."""
    row_groups: int
    tile_cols: int
    groups: Tuple[Tuple[int, int], ...]       # leaf [first, stop) a launch
    tile_offs: Tuple[Tuple[int, ...], ...]    # first tile of each leaf, + all
    vec_masks: Tuple[int, ...]
    c_widths: tuple = field(compare=False, repr=False)
    c_tile_offs: tuple = field(compare=False, repr=False)


@functools.lru_cache(maxsize=64)
def tile_plan(widths: Tuple[int, ...], itemsize: int,
              aligned: Tuple[bool, ...], D: int, sms: int) -> TilePlan:
    """The tile table of leaves of ``widths`` columns and ``itemsize``-byte
    elements over ``D`` device rows, on a card of ``sms`` SMs.  ``aligned``
    says which leaves start on a 16-byte boundary.

    A thread owns 16 bytes of columns, so a tile spans ``(THREADS / R) ·
    16 / itemsize`` columns.  The rows of a tile are split over ``R`` row
    groups, R the least power of two (at most ``min(D, 32)``) that gives
    ``TILES_PER_SM`` tiles per SM, which at 3-4 resident blocks an SM is
    one wave: R = 1 over the LM trees at D = 8, R = 8 for LeNet at D = 256
    (487 tiles of 128 float32 columns, 32 rows a row group)."""
    vec = 16 // itemsize

    def tiles(R, n):
        return -(-n // ((THREADS // R) * vec))

    R = 1
    while (2 * R <= min(D, MAX_ROW_GROUPS)
           and sum(tiles(R, n) for n in widths) < TILES_PER_SM * sms):
        R *= 2
    groups, offs, masks = [], [], []
    for first in range(0, len(widths), MAX_LEAVES):
        stop = min(first + MAX_LEAVES, len(widths))
        off, mask = [0], 0
        for l in range(first, stop):
            n = widths[l]
            off.append(off[-1] + tiles(R, n))
            if aligned[l] and n * itemsize % 16 == 0:
                mask |= 1 << (l - first)
        if off[-1] >= 2 ** 31:
            raise ValueError(f"{off[-1]} tiles exceed the kernel's int32 "
                             f"tile index")
        groups.append((first, stop))
        offs.append(tuple(off))
        masks.append(mask)
    return TilePlan(
        row_groups=R, tile_cols=(THREADS // R) * vec, groups=tuple(groups),
        tile_offs=tuple(offs), vec_masks=tuple(masks),
        c_widths=tuple((ctypes.c_longlong * (b - a))(*widths[a:b])
                       for a, b in groups),
        c_tile_offs=tuple((ctypes.c_int * len(o))(*o) for o in offs))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _per_device(v, D, dev, what):
    v = torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
    if v.shape[0] != D:
        raise ValueError(f"{what} of length {v.shape[0]} for D={D}")
    return v.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    itemsize = leaves[0].element_size()
    if (THREADS * 16 // itemsize + 4 * D + 4 * G + 1) * 4 > _SMEM_LIMIT:
        raise ValueError(f"D={D}, G={G} exceed the kernel's shared memory")

    raw = _per_device(weights, D, dev, "weights")
    stale = None if staleness is None else _per_device(staleness, D, dev,
                                                       "staleness")
    msk = None if mask is None else _per_device(mask, D, dev, "mask")
    seg = None
    if segment_ids is not None:
        seg = (torch.as_tensor(segment_ids, device=dev).to(torch.int32)
               .reshape(-1).contiguous())
        if seg.shape[0] != D:
            raise ValueError(f"segment_ids of length {seg.shape[0]} for "
                             f"D={D}")
    sc_ptrs = None
    if quantized:
        s_leaves = [_per_device(s, D, dev, "scales")
                    for s in tree_leaves(scales)]
        if len(s_leaves) != len(leaves):
            raise ValueError(f"scales tree has {len(s_leaves)} leaves for "
                             f"{len(leaves)} payload leaves")
        sc_ptrs = [s.data_ptr() for s in s_leaves]

    x_ptrs = [leaf.data_ptr() for leaf in leaves]
    plan = tile_plan(tuple(math.prod(leaf.shape[1:]) for leaf in leaves),
                     itemsize, tuple(p % 16 == 0 for p in x_ptrs), D,
                     _sm_count(dev.index if dev.index is not None
                               else torch.cuda.current_device()))
    lead = () if segment_ids is None else (G,)
    outs = [torch.empty(lead + tuple(leaf.shape[1:]), dtype=torch.float32,
                        device=dev) for leaf in leaves]
    fn = _entry(dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kind_id = DECAY_KINDS.index(kind)
    global launches, segment_launches
    for k, (first, stop) in enumerate(plan.groups):
        count = stop - first
        arr = ctypes.c_void_p * count
        err = fn(arr(*x_ptrs[first:stop]),
                 arr(*[o.data_ptr() for o in outs[first:stop]]),
                 None if sc_ptrs is None else arr(*sc_ptrs[first:stop]),
                 plan.c_widths[k], plan.c_tile_offs[k], plan.vec_masks[k],
                 count, D, plan.row_groups, raw.data_ptr(), _ptr(stale),
                 _ptr(msk), _ptr(seg), G, kind_id, float(rate),
                 int(bool(normalize)), stream)
        if err != 0:
            raise RuntimeError(f"fused-aggregation kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        segment_launches += seg is not None

    results = iter(outs)

    def finish(leaf):
        out = next(results)
        dt = out_dtype if out_dtype is not None else (
            torch.float32 if quantized else leaf.dtype)
        return out if dt == torch.float32 else out.to(dt)

    return tree_map(finish, stacked)
