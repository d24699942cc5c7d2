"""The fleet's row layout over a mesh and its collectives (the fleet half
of ``repro.launch.sharding``, with the reference engine's
``_fleet_collectives``).

Under a mesh (``launch.mesh``) each rank holds the rows ``start .. stop −
1`` of every ``[D, ...]`` fleet tensor: params, optimizer state, pool,
``residual``, ``pending``, ``staleness`` and ``live``.  ``FleetShard``
carries that range and the three collectives of the reference, identities
off-mesh:

  * ``gather``: ``all_gather`` of ``[D_local, ...]`` rows into ``[D,
    ...]``, in rank order;
  * ``local``: this rank's rows of a replicated ``[D, ...]`` vector;
  * ``psum``: ``all_reduce(SUM)`` of the partial trees a rank's reduce
    returns from its rows.

and two exact ones the port uses where the reference weights a one-hot
row and psums (which can move a bit): ``rows_at`` (rows at global slots,
broadcast from the ranks that own them) and ``broadcast_tree`` (rank 0's
tree on every rank).

Random draws.  The reference keeps a ``[D]`` vector of keys and a shard
slices its devices'.  The port draws for the whole stacked fleet from one
``torch.Generator``, so a rank that drew at its local shape would get
other numbers than the unsharded run.  While ``fleet_draws(shard)`` is
active, ``rand_rows`` makes every fleet-stacked draw at the GLOBAL shape,
from the same generator on every rank, and keeps the rank's rows: a
sharded run then draws exactly what the unsharded one does, at the cost
of each rank drawing the whole fleet's uniforms (``drawn_bytes`` counts
them).

Model parallelism (the rest of ``repro.launch.sharding``).  The
reference's rule table maps a parameter's ``/``-joined tree path to a
PartitionSpec by substring, first match wins; here ``_RULES`` is the same
table as data, a spec being a tuple with one entry a tensor dim: ``None``
(replicated), a mesh axis name, or a tuple of names.  Specs are
right-aligned to the leaf's rank, so a stacked leaf's leading axes
replicate: the decoder's ``[U, ...]`` units, as in the reference, and
the port's leading fleet axis ``[D, ...]`` (``nn.layers``), which the
reference does not have, both take ``None``.  ``param_shardings`` turns
specs into DTensor placements over a ``DeviceMesh``
(``launch.mesh.make_production_mesh``): ``Shard(dim)`` on each mesh dim
a tensor dim names, ``Replicate()`` on the others; ``distribute_params``
applies them.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import DEVICE_AXIS, FOG_AXIS
from repro_torch.nn.shard_hints import placements_for
from repro_torch.tree import tree_map, tree_map_with_path

# bytes of uniforms drawn at the global shape under a sharded
# ``fleet_draws``, and the share of them this rank keeps
drawn_bytes = {"global": 0, "kept": 0}

_ACTIVE: Optional["FleetShard"] = None


def fleet_axes(mesh=None) -> tuple:
    """Mesh axis names the fleet's leading ``[D]`` slot axis shards over,
    fog-major: ``("fog", "device")`` on a 2-D mesh, ``("device",)`` on a
    1-D one and when no mesh is given."""
    if mesh is None:
        return (DEVICE_AXIS,)
    return tuple(a for a in (FOG_AXIS, DEVICE_AXIS) if a in mesh.axis_names)


def fleet_shards(mesh) -> int:
    """Total shard count of the fleet axis (product over its mesh axes)."""
    if mesh is None:
        return 1
    n = 1
    for a in fleet_axes(mesh):
        n *= mesh.shape[mesh.axis_names.index(a)]
    return n


def device_axis_spec(mesh, num_devices: int) -> slice:
    """This rank's rows of a ``[num_devices, ...]`` fleet tensor."""
    shard = FleetShard(mesh, num_devices)
    return slice(shard.start, shard.stop)


class FleetShard:
    """This rank's rows of a ``num_devices`` fleet over ``mesh`` (None =
    every row, and every collective an identity)."""

    def __init__(self, mesh, num_devices: int):
        self.mesh = mesh
        self.num_devices = num_devices
        shards = fleet_shards(mesh)
        if num_devices % shards:
            raise ValueError(
                f"num_devices={num_devices} must divide evenly over the "
                f"{shards}-way fleet mesh {fleet_axes(mesh)}")
        self.local_rows = num_devices // shards
        self.rank = 0 if mesh is None else mesh.rank
        self.start = self.rank * self.local_rows
        self.stop = self.start + self.local_rows

    @property
    def sharded(self) -> bool:
        """True when the rank holds fewer rows than the fleet."""
        return self.local_rows < self.num_devices

    def local(self, v):
        """This rank's rows of a replicated ``[D, ...]`` tensor or array."""
        return v if self.mesh is None else v[self.start:self.stop]

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """``[D_local, ...]`` rows of every rank → ``[D, ...]``."""
        if self.mesh is None:
            return v
        x = v.contiguous()
        flag = x.dtype == torch.bool
        if flag:
            x = x.to(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(self.mesh.world)]
        dist.all_gather(parts, x, group=self.mesh.group)
        out = torch.cat(parts)
        return out.bool() if flag else out

    def psum(self, flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum a dict of partial tensors over the ranks (in place)."""
        if self.mesh is not None:
            for x in flat.values():
                dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                group=self.mesh.group)
        return flat

    def rows_at(self, flat: Dict[str, torch.Tensor],
                idx: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Rows at the GLOBAL slots ``idx`` of each ``[D_local, ...]`` leaf
        of ``flat``, ``[len(idx), ...]`` on every rank, bit for bit: each
        owner broadcasts its rows."""
        idx = [int(i) for i in idx]
        if self.mesh is None:
            return {p: torch.index_select(x, 0, torch.as_tensor(
                idx, device=x.device)) for p, x in flat.items()}
        owners = [i // self.local_rows for i in idx]
        out = {}
        for p, x in flat.items():
            rows = x.new_empty((len(idx),) + tuple(x.shape[1:]))
            for r in sorted(set(owners)):
                pos = [j for j, o in enumerate(owners) if o == r]
                if r == self.rank:
                    part = torch.index_select(x, 0, torch.as_tensor(
                        [idx[j] - self.start for j in pos],
                        device=x.device)).contiguous()
                else:
                    part = x.new_empty((len(pos),) + tuple(x.shape[1:]))
                dist.broadcast(part, src=r, group=self.mesh.group)
                rows[pos] = part
            out[p] = rows
        return out

    def broadcast_tree(self, tree):
        """Rank 0's ``tree`` on every rank (a copy; the caller's tensors
        are left as they are)."""
        if self.mesh is None:
            return tree

        def bcast(x):
            x = x.clone().contiguous()
            dist.broadcast(x, src=0, group=self.mesh.group)
            return x

        return tree_map(bcast, tree)


# ------------------------------------------------------------ engine state
def _map_state(state, fn):
    """``fn`` over every tensor of an ``EngineState`` (``rng`` passes)."""
    pool = type(state.pool)(*(fn(x) for x in state.pool))
    fields = {f: tree_map(fn, getattr(state, f)) for f in state._fields
              if f not in ("pool", "rng")}
    return state._replace(pool=pool, **fields)


def shard_engine_state(mesh, state):
    """A global ``EngineState`` (every ``[D, ...]`` leaf whole, as one
    process holds it or a checkpoint stores it) → this rank's rows of
    each, ``residual``, ``pending``, ``staleness`` and ``live`` included;
    rank-0 leaves stay replicated."""
    shard = FleetShard(mesh, int(state.pool.n_filled.shape[0]))
    return _map_state(state, lambda x: (
        x[shard.start:shard.stop].clone() if x.dim() else x))


def gather_engine_state(mesh, state):
    """Inverse of ``shard_engine_state``: every rank's rows gathered into
    the unsharded layout, on every rank (a collective: every rank calls
    it).  Reports and checkpoints of a sharded run use it."""
    shard = FleetShard(mesh, int(state.pool.n_filled.shape[0])
                       * fleet_shards(mesh))
    return _map_state(state, lambda x: shard.gather(x) if x.dim() else x)


# ------------------------------------------------------ global-shape draws
@contextlib.contextmanager
def fleet_draws(shard: Optional[FleetShard]):
    """While active, ``rand_rows`` draws fleet-stacked uniforms at the
    global shape of ``shard``'s fleet and keeps its rows."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield
    finally:
        _ACTIVE = prev


def rand_rows(shape, *, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """``torch.rand(shape)`` for a fleet-stacked tensor (leading ``[D,
    ...]`` device axis); under a sharded ``fleet_draws``, this rank's rows
    of the draw at the global shape."""
    shard = _ACTIVE
    if shard is None or not shard.sharded:
        return torch.rand(shape, generator=generator, device=device)
    shape = tuple(shape)
    if shape[0] != shard.local_rows:
        raise ValueError(f"a fleet draw of shape {shape} under a shard of "
                         f"{shard.local_rows} rows")
    full = (shard.num_devices,) + shape[1:]
    u = torch.rand(full, generator=generator, device=device)
    drawn_bytes["global"] += u.numel() * u.element_size()
    drawn_bytes["kept"] += u.numel() * u.element_size() // shard.num_devices \
        * shard.local_rows
    return u[shard.start:shard.stop]


# ============================================================ model parallel
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# (substring, spec of the trailing dims): first match wins, in the
# reference's order; a 2-dim spec on a 3-dim stacked leaf leaves dim 0
# replicated.
_RULES: Tuple[Tuple[str, Spec], ...] = (
    # MoE experts [E, D, F] / [E, F, D]: expert-parallel + FSDP
    ("experts/wi_gate", ("model", None, "data")),
    ("experts/wi_up", ("model", None, "data")),
    ("experts/wo", ("model", "data", None)),
    ("router/kernel", (None, None)),
    # embeddings
    ("embed/embedding", ("model", None)),          # vocab -> model
    ("dec_pos/embedding", (None, None)),
    ("unembed/kernel", (None, "model")),
    # attention (merged head dim columns)
    ("wq/kernel", (None, "model")),
    ("wk/kernel", (None, "model")),
    ("wv/kernel", (None, "model")),
    ("wo/kernel", ("model", None)),
    ("wq/bias", ("model",)),
    ("wv/bias", ("model",)),
    ("wo/bias", (None,)),
    # MLA
    ("wdq/kernel", (None, "model")),
    ("wuq/kernel", (None, "model")),
    ("wdkv/kernel", (None, None)),
    ("wkr/kernel", (None, None)),
    ("wuk/kernel", (None, "model")),
    ("wuv/kernel", (None, "model")),
    # MLPs
    ("wi_gate/kernel", (None, "model")),
    ("wi_up/kernel", (None, "model")),
    ("wi/kernel", (None, "model")),
    ("wi/bias", ("model",)),
    # mamba2
    ("in_proj/kernel", (None, "model")),
    ("out_proj/kernel", ("model", None)),
    ("conv/kernel", (None, "model")),
    ("conv/bias", ("model",)),
    # rg-lru
    ("gate_proj/kernel", (None, "model")),
    ("rnn_proj/kernel", (None, "model")),
    ("wa/kernel", (None, "model")),
    ("wx/kernel", (None, "model")),
    ("wa/bias", ("model",)),
    ("wx/bias", ("model",)),
    ("lambda", ("model",)),
)


def _aligned(entries, ndim: int) -> Spec:
    """``entries`` right-aligned to ``ndim`` dims (leading dims None)."""
    entries = list(entries)
    if len(entries) > ndim:             # e.g. a 2-dim rule on a 1-dim leaf
        entries = entries[-ndim:]       # (ndim 0 keeps all, as the reference)
    return tuple([None] * (ndim - len(entries)) + entries)


def spec_for_path(path_str: str, ndim: int) -> Spec:
    """The spec of the leaf at ``path_str`` with ``ndim`` dims.  An
    adafactor factored moment (``.../vr``, ``.../vc``) takes its
    param's rule less the dim it averages away: ``vr`` the last,
    ``vc`` the second to last."""
    suffix = None
    if path_str.endswith("/vr") or path_str.endswith("/vc"):
        suffix = path_str[-2:]
        path_str = path_str[:-3]
    for pat, spec in _RULES:
        if pat in path_str:
            entries = list(spec)
            if suffix == "vr":
                entries = entries[:-1]
            elif suffix == "vc":
                entries = entries[:-2] + entries[-1:]
            return _aligned(entries, ndim)
    return (None,) * ndim                      # replicate by default


def param_pspecs(params):
    """A spec tree mirroring ``params`` (any tree of tensors)."""
    return tree_map_with_path(lambda path, leaf: spec_for_path(
        path, leaf.dim()), params)


def param_shardings(mesh, params):
    """A placements tree mirroring ``params`` (``param_pspecs`` over
    ``mesh``)."""
    return tree_map_with_path(lambda path, leaf: placements_for(
        mesh, spec_for_path(path, leaf.dim())), params)


def distribute(mesh, x: torch.Tensor, spec: Spec):
    """``x`` (the whole tensor, the same on every rank) as a DTensor of
    ``spec`` over ``mesh``: each rank keeps its own chunk, nothing is
    sent (meta tensors too)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, placements_for(mesh, spec),
                             src_data_rank=None)


def distribute_params(mesh, params):
    """``params`` as DTensors placed by the rule tables."""
    return tree_map_with_path(lambda path, leaf: distribute(
        mesh, leaf, spec_for_path(path, leaf.dim())), params)


# ---------------------------------------------------------------- activations
def batch_spec(mesh, ndim: int, *, batch_dim: int = 0) -> Spec:
    """Dim ``batch_dim`` over ``(pod, data)``, the others replicated."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    entries = [None] * ndim
    entries[batch_dim] = axes if len(axes) > 1 else axes[0]
    return tuple(entries)


def cache_pspec(path_str: str, ndim: int, *, batch_sharded: bool,
                batch_axes=("data",)) -> Spec:
    """Decode-cache specs, right-aligned to the (unit- or layer-stacked)
    leaf rank.

    batch_sharded (decode_32k):    the batch dim over (pod, data);
    sequence-sharded (long_500k, B = 1): the cache's sequence dim over
    data.  The per-head or channel dim shards over model (head_dim,
    latent rank, conv channels); head-count dims do not (gemma2 has 4 kv
    heads, fewer than 16)."""
    b_ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    leaf = path_str.rsplit("/", 1)[-1]
    align = lambda trailing: _aligned(trailing, ndim)
    if leaf == "pos":
        return align([None])
    if leaf in ("k", "v", "ck", "cv"):          # [B, S, Hkv, hd]
        if batch_sharded:
            return align([b_ax, None, None, "model"])
        return align([None, b_ax, None, "model"])
    if leaf == "ckv":                            # [B, S, kv_lora]
        if batch_sharded:
            return align([b_ax, None, "model"])
        return align([None, b_ax, "model"])
    if leaf == "krope":                          # [B, S, rope_dim]
        if batch_sharded:
            return align([b_ax, None, None])
        return align([None, b_ax, None])
    if leaf == "conv":                           # [B, W-1, channels]
        return align([b_ax if batch_sharded else None, None, "model"])
    if leaf == "state" and ndim >= 4:            # mamba [B, H, P, N]
        return align([b_ax if batch_sharded else None, "model", None, None])
    if leaf == "state":                          # rg-lru [B, width]
        return align([b_ax if batch_sharded else None, "model"])
    return (None,) * ndim


def cache_pspecs(caches, *, batch_sharded: bool, batch_axes=("data",)):
    return tree_map_with_path(lambda path, leaf: cache_pspec(
        path, leaf.dim(), batch_sharded=batch_sharded,
        batch_axes=batch_axes), caches)
