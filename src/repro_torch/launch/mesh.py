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

Model-parallel meshes (the rest of ``repro.launch.mesh``) are
``torch.distributed.DeviceMesh``-es over the default group, with the
reference's axis names: ``make_production_mesh`` (16 × 16 ``("data",
"model")``, or 2 × 16 × 16 with a leading ``"pod"``),
``make_debug_mesh`` and ``make_auto_mesh``.  ``backend="fake"`` starts
the group as torch's fake backend (collectives are no-ops, ranks need
not exist): the tools that trace on meta tensors (``launch.dryrun``)
take it, in a process of their own, since it becomes the default group.
Otherwise the group is NCCL on the card and gloo with ``device="cpu"``,
as for a fleet mesh.  ``use_mesh`` (from ``nn.shard_hints``, where the
layers read it) activates a mesh for the shard hints for the length of
a ``with`` block; nested blocks restore the outer mesh.  The hardware
constants are the H100's (``roofline_terms`` in ``launch.dryrun``).
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.nn.shard_hints import active_mesh, use_mesh  # noqa: F401

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


# ============================================================ model parallel
# NVIDIA H100 SXM5 80GB (the roofline of ``launch.dryrun``), per GPU:
PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s (H100 datasheet)
HBM_BW = 3.35e12           # HBM3 bytes/s (H100 SXM5 datasheet)
NVLINK_BW = 450e9          # NVLink 4 bytes/s each way (900 GB/s total)


def _start_fake_group(world: int) -> None:
    """The default group as torch's fake backend: ``world`` ranks of
    which this process is rank 0, every collective a no-op."""
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise ValueError(f"a mesh of {world} ranks over a started group "
                             f"of {dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_auto_mesh(shape, axis_names, *, device=None,
                   backend: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the default
    group, started here when none is: ``backend="fake"`` a fake group of
    ``prod(shape)`` ranks for tracing on meta tensors, else as ``make_device_mesh`` starts one (NCCL on the card,
    gloo with ``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names}")
    if backend == "fake":
        # typed "cuda" so DTensor plans the card's collectives (its "cpu"
        # meshes turn an all-to-all into an all-gather, for gloo); the
        # tensors stay on meta and nothing touches a card
        from torch.distributed.device_mesh import DeviceMesh
        _start_fake_group(math.prod(shape))
        return DeviceMesh("cuda", torch.arange(math.prod(shape)).reshape(
            shape), mesh_dim_names=axis_names)
    if backend is not None:
        raise ValueError(f"unknown mesh backend {backend!r}: use 'fake' or "
                         "None")
    dev = _bind(device)
    _start_group(dev)
    _mesh(axis_names, shape, dev)       # the group's size must match
    return init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         backend: Optional[str] = None):
    """16 × 16 = 256 GPUs a pod; ``multi_pod`` stacks a leading ``pod``
    axis (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_auto_mesh(shape, axes, device=device, backend=backend)


def make_debug_mesh(devices: Optional[int] = None, *, device=None,
                    backend: Optional[str] = None):
    """A ``(1, n)`` ``("data", "model")`` mesh over ``n`` ranks (default:
    the started group's, else one)."""
    n = devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return make_auto_mesh((1, n), ("data", "model"), device=device,
                          backend=backend)


def batch_axes(mesh) -> tuple:
    """Mesh axes a batch dimension shards over."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
