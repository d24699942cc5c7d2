"""Mesh-aware activation placement hints (``repro.nn.shard_hints``
ported).

The reference pins activations with ``with_sharding_constraint`` where
GSPMD would otherwise guess, and guess badly: the 8-head gemma2
attention reshape cost thousands of collective-permutes and all-to-alls
a step.  Here a hint redistributes a DTensor to the placements of its
cleaned spec; the values do not change.  Hints are no-ops (the same
object back) when no mesh is active (``use_mesh`` here, which
``launch.mesh`` re-exports), which is every single-device path, and for
a plain tensor.  An entry whose mesh axes are absent or do not divide
its dimension drops out, as in the reference.  The active mesh and
``placements_for`` live here so that the layers read them without
importing the launcher.

The port's activations carry a leading fleet axis ``[D, ...]`` the
reference's do not, so the entries align to the TRAILING dims: a 4-entry
head hint applies to ``[D, B, S, H, hd]`` as to ``[B, S, H, hd]``.

``split_heads`` is the one place where a hint is not optional: DTensor
cannot unflatten a merged ``heads·head_dim`` dim that is sharded over
an axis whose size does not divide ``heads`` (gemma2's 8 heads on a
16-wide ``model`` axis), where GSPMD reshards silently.  It gathers that
dim over the axis first, under a mesh only; ``launch.op_analysis``
counts the collective.  ``merge_heads`` is its inverse, and does the same
for the gradient that flows back through it.

Caches are written in place, op by op, on each rank's LOCAL shards:
``local_placements`` places a tensor so that a dim stays whole (a
cache's slot dim) and no partial sum is left, ``local_of`` and
``placed`` cross between a DTensor and its shard, and ``empty_stack``
and ``copy_into_stack`` make a stacked buffer placed like the units
that fill it and fill a unit's slot.  DTensor's own index copies and
in-place writes through views are not in every torch release, and
rank-local writes need no collective.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Union

import torch

AxisEntry = Union[None, str, Sequence[str]]

_ACTIVE = None               # the mesh ``use_mesh`` activated, or None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the shard hints while the block runs; exit
    restores the mesh that was active before (None: hints are no-ops).
    Inside, a plain tensor that meets a DTensor counts as replicated
    (DTensor's ``implicit_replication``): positions, masks and tables
    the model builds on the fly."""
    from torch.distributed.tensor.experimental import implicit_replication
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh ``use_mesh`` activated, or None."""
    return _ACTIVE


def placements_for(mesh, spec):
    """DTensor placements of ``spec`` (one entry a tensor dim: None, a
    mesh axis name or a tuple of names) over ``mesh``: for each mesh dim,
    ``Shard(d)`` where tensor dim d names it, else ``Replicate()``.  A
    dim naming several axes (``("pod", "data")``) shards over each, in
    the mesh's order, major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _is_dtensor(x) -> bool:
    return hasattr(x, "device_mesh") and hasattr(x, "placements")


def _axis_size(mesh, entry: AxisEntry) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh.size(mesh.mesh_dim_names.index(n)) for n in names)


def hint(x, *entries: AxisEntry):
    """Place ``x`` by the spec ``entries``, aligned to its trailing dims,
    dropping entries whose axes are absent or do not divide the dim."""
    if active_mesh() is None or not _is_dtensor(x) or len(entries) > x.dim():
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    entries = (None,) * (x.dim() - len(entries)) + tuple(entries)
    cleaned = []
    for dim, e in zip(x.shape, entries):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        if (not axes or not all(a in names for a in axes)
                or dim == 0 or dim % _axis_size(mesh, axes) != 0):
            cleaned.append(None)
            continue
        cleaned.append(e if isinstance(e, str) else axes)
    if all(c is None for c in cleaned):
        return x
    return x.redistribute(mesh, placements_for(mesh, tuple(cleaned)))


def hint_heads(x, *, batch_axes: AxisEntry = "data",
               model_axis: str = "model"):
    """Shard a ``[..., B, S, H, hd]`` tensor over heads when the head
    count divides the model axis.  Never head_dim: it is the contraction
    dim of q·k, and pinning it costs a partial-sum all-reduce an
    attention block (the reference's 16x collective regression on
    gemma2 and arctic)."""
    if active_mesh() is None or not _is_dtensor(x) or x.dim() < 4:
        return x
    names = x.device_mesh.mesh_dim_names
    model = (x.device_mesh.size(names.index(model_axis))
             if model_axis in names else 1)
    if x.shape[-2] % model == 0:
        return hint(x, batch_axes, None, model_axis, None)
    return x


def split_heads(y: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``y [..., heads·head_dim]`` → ``[..., heads, head_dim]``; a DTensor
    sharded on that dim over an axis that does not divide ``heads`` is
    gathered over the axis first (module docstring)."""
    if _is_dtensor(y):
        from torch.distributed.tensor import Replicate, Shard
        last = y.dim() - 1
        placements = list(y.placements)
        for i, p in enumerate(placements):
            if (isinstance(p, Shard) and p.dim in (-1, last)
                    and heads % y.device_mesh.size(i) != 0):
                placements[i] = Replicate()
        if placements != list(y.placements):
            y = y.redistribute(y.device_mesh, placements)
    return y.reshape(tuple(y.shape[:-1]) + (heads, head_dim))


class _MergeHeads(torch.autograd.Function):
    """Merge the last two dims; the gradient splits back through
    ``split_heads``."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate, Shard
        ctx.heads, ctx.head_dim = x.shape[-2], x.shape[-1]
        n = x.dim()
        # a merge keeps a shard on the heads dim only, and an even one; no
        # partial sum (DTensor would reshard it onto the merged dim)
        pl = [p if not p.is_partial() and not (isinstance(p, Shard) and (
                  p.dim % n == n - 1 or (p.dim % n == n - 2 and ctx.heads
                                         % x.device_mesh.size(i))))
              else Replicate() for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
        return x.reshape(tuple(x.shape[:-2]) + (ctx.heads * ctx.head_dim,))

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.heads, ctx.head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x [..., heads, head_dim]`` → ``[..., heads·head_dim]``."""
    if _is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(tuple(x.shape[:-2]) + (x.shape[-2] * x.shape[-1],))


def local_placements(x, whole=()):
    """``x``'s placements with partial sums (and strided shards)
    replicated and the dims in ``whole`` kept whole."""
    from torch.distributed.tensor import Replicate, Shard
    keep = {w % x.dim() for w in whole}
    return tuple(p if type(p) is Shard and p.dim % x.dim() not in keep
                 else Replicate() for p in x.placements)


def local_of(x, placements) -> torch.Tensor:
    """This rank's shard of ``x`` placed as ``placements``."""
    return x.redistribute(x.device_mesh, placements).to_local()


def placed(local: torch.Tensor, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard here is ``local``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(tuple(shape), device="meta").stride())


def empty_stack(x: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised ``[x.shape[0], n, *x.shape[1:]]`` buffer on
    ``x``'s device; for a DTensor ``x``, placed as ``local_placements(x)``
    with the new unit dim whole."""
    shape = (x.shape[0], n) + tuple(x.shape[1:])
    if not _is_dtensor(x):
        return torch.empty(shape, dtype=x.dtype, device=x.device)
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = tuple(Shard(p.dim + (p.dim > 0)) if isinstance(p, Shard) else p
               for p in local_placements(x))
    local_shape, _ = compute_local_shape_and_global_offset(
        shape, x.device_mesh, pl)
    return placed(torch.empty(local_shape, dtype=x.dtype,
                              device=x.to_local().device),
                  x.device_mesh, pl, shape)


def copy_into_stack(stack: torch.Tensor, u: int, x: torch.Tensor):
    """``stack[:, u] = x`` for a ``stack`` from ``empty_stack(x, n)``: on
    the local shards for DTensors."""
    if _is_dtensor(x):
        stack.to_local()[:, u].copy_(local_of(x, local_placements(x)))
    else:
        stack[:, u].copy_(x)
    return stack


def write_slot(buf: torch.Tensor, value, dim: int, slot: int):
    """``buf.select(dim, slot) = value.select(dim, 0)`` (a number fills the
    slot), in place.  A DTensor ``buf`` whose ``dim`` is whole is written
    on its local shard; one split over ``dim`` (a sequence-sharded cache)
    through DTensor's own ops."""
    from torch.distributed.tensor import Shard
    split = _is_dtensor(buf) and any(
        isinstance(p, Shard) and p.dim % buf.dim() == dim % buf.dim()
        for p in buf.placements)
    if _is_dtensor(buf) and not split:
        target = buf.to_local().select(dim, slot)
        if isinstance(value, torch.Tensor):
            target.copy_(local_of(value, buf.placements).select(dim, 0))
        else:
            target.fill_(value)
        return buf
    if isinstance(value, torch.Tensor):
        buf.select(dim, slot).copy_(value.select(dim, 0))
    else:
        buf.select(dim, slot).fill_(value)
    return buf


def padded(x: torch.Tensor, pad, value=0.0) -> torch.Tensor:
    """``F.pad(x, pad, value=value)`` (constant); a DTensor is padded on
    its local shard, its padded dims whole."""
    if not _is_dtensor(x):
        return torch.nn.functional.pad(x, pad, value=value)
    n = x.dim()
    grow = {n - 1 - i: pad[2 * i] + pad[2 * i + 1]
            for i in range(len(pad) // 2)}
    pl = local_placements(x, whole=[d for d, g in grow.items() if g])
    loc = torch.nn.functional.pad(local_of(x, pl), pad, value=value)
    shape = [s + grow.get(d, 0) for d, s in enumerate(x.shape)]
    return placed(loc, x.device_mesh, pl, shape)


class _GradPlaced(torch.autograd.Function):
    """The identity; the gradient comes back placed as the input."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is placed as ``x`` before it meets another:
    a tensor read twice (a tied embedding table) otherwise sums two
    gradients DTensor placed apart, which not every torch release can
    reconcile.  The identity for a plain tensor."""
    return _GradPlaced.apply(x) if _is_dtensor(x) else x
