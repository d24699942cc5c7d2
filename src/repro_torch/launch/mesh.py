"""Fleet meshes over a ``torch.distributed`` process group (the fleet half
of ``repro.launch.mesh``).

The reference ``shard_map``-s the engine's ``[D, ...]`` fleet over a JAX
mesh of accelerators.  The port runs one process per shard (SPMD): a mesh
is the default process group, every rank calls the same driver with the
same arguments, and rank ``r = f·device_shards + d`` holds the global
slots ``r·D_local .. (r + 1)·D_local − 1``, the reference's fog-major
layout.  All collectives run over the whole group (the reference psums
over every fleet axis at once), so a 2-D ``("fog", "device")`` mesh only
fixes the layout.

Backends: ranks on the card use NCCL and bind ``cuda:LOCAL_RANK``;
``device="cpu"`` uses gloo.  A default group the caller has already
started, with whatever backend, is used as it is.  Without one, the mesh
starts one from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``) when it is set, else a one-rank group over a
``FileStore`` in a temporary directory (no network).  Without a card and
without ``device="cpu"`` the mesh raises, as ``resolve_device`` does.

The reference's ``make_auto_mesh``, ``use_mesh``, ``make_production_mesh``,
``make_debug_mesh``, ``batch_axes`` and its hardware constants serve the
model-parallel launch tools (ROADMAP item 17) and are not here.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Mesh axis name the edge engine shards its fleet over.
DEVICE_AXIS = "device"

# Second fleet mesh axis for the hierarchical fog tier (core.topology): a
# 2-D ("fog", "device") mesh lays the [D] slot axis out fog-major.
FOG_AXIS = "fog"

# seconds a collective waits for a missing rank before it raises, so a
# failed rank fails the group instead of hanging it
MESH_TIMEOUT_S = 120


@dataclass(frozen=True)
class FleetMesh:
    """A fleet mesh: ``axis_names`` and ``shape`` (product = ``world``),
    this process's ``rank``, the torch ``device`` its rows live on, and
    the process ``group`` the collectives run over."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    world: int
    device: torch.device
    group: Any

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def _start_group(device: torch.device) -> None:
    """Start the default group when none is: from torchrun's environment,
    else one rank over a ``FileStore`` in a temporary directory."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = timedelta(seconds=MESH_TIMEOUT_S)
    if _torchrun_env():
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    atexit.register(shutil.rmtree, tmp, True)
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=timeout)


def _bind(device) -> torch.device:
    """The rank's torch device: ``device`` (None = ``"cuda"``), raising
    without a card as ``resolve_device`` does; an unindexed card is
    ``cuda:LOCAL_RANK`` under torchrun, and becomes the current one."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and "LOCAL_RANK" in os.environ
            and (device is None or torch.device(device).index is None)):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def _mesh(axis_names, shape, dev: torch.device) -> FleetMesh:
    world = dist.get_world_size()
    size = 1
    for n in shape:
        size *= n
    if size != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {size} ranks; "
                         f"the process group has {world}")
    return FleetMesh(tuple(axis_names), tuple(shape), dist.get_rank(),
                     world, dev, dist.group.WORLD)


def make_device_mesh(shards: Optional[int] = None, *,
                     device=None) -> FleetMesh:
    """1-D mesh for the federated fleet's device axis
    (``EdgeEngine(mesh=...)``): each rank simulates D/shards edge devices
    and the fog reduce sums the ranks' partial reduces.  ``shards``
    defaults to every rank of the group."""
    dev = _bind(device)
    _start_group(dev)
    n = shards or dist.get_world_size()
    return _mesh((DEVICE_AXIS,), (n,), dev)


def make_fog_mesh(fog_shards: Optional[int] = None,
                  device_shards: Optional[int] = None, *,
                  device=None) -> FleetMesh:
    """2-D ``("fog", "device")`` mesh for hierarchical fleets: global slot
    ``(f·device_shards + d)·D_local + k`` lives on rank ``f·device_shards
    + d``.  Fog groups (``core.topology.FogTopology``) are decoupled from
    the factorization.  Defaults: ``fog_shards × device_shards`` covering
    every rank, fog-major."""
    dev = _bind(device)
    if fog_shards is None or device_shards is None:
        _start_group(dev)
        n = dist.get_world_size()
        if fog_shards is None:
            fog_shards = n // (device_shards or 1) if device_shards else n
            device_shards = device_shards or 1
        else:
            device_shards = n // fog_shards
    if fog_shards < 1 or device_shards < 1:
        raise ValueError(f"mesh shape ({fog_shards}, {device_shards}) "
                         f"must be positive")
    _start_group(dev)
    return _mesh((FOG_AXIS, DEVICE_AXIS), (fog_shards, device_shards), dev)
