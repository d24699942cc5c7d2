"""Per-device cost of a torch program, for the roofline report (the
counterpart of ``repro.launch.hlo_analysis``).

The reference reads FLOPs, traffic and collectives out of the compiled,
partitioned HLO text.  The port has no HLO to parse: ``analyze`` runs the
program itself under a dispatch mode and counts the ops it issues.  Under
DTensor the mode lets each DTensor op decompose first and counts the
local ops it becomes, so every figure is PER DEVICE, counted on this
rank's local shards (rank 0 under a fake group, whose shards are the
largest where a dim does not divide).  The global-shape fake-tensor runs
DTensor makes to propagate shapes do no work and are not counted:

  * ``flops``: matmul, bmm, einsum (as the bmm it lowers to) and
    convolution, by ``torch.utils.flop_counter``'s formulas, plus the
    flash-attention kernel's op (``kernels.flash_attention``, its
    dense ``4·B·H·Sq·Skv·d``).  The reference counts a convolution as
    2 × its result BYTES (``hlo_analysis.py``, the ``convolution``
    branch), a proxy; here a convolution is counted by its own formula.
  * ``traffic``: operand plus result bytes of every op that is neither a
    view nor an allocation.  Eager PyTorch has no fusion boundaries, so
    this is an upper bound beside XLA's fusion-boundary proxy.  It counts
    the ops the program dispatches; a device's kernels may dispatch a few
    of their own (an index copy's on the CPU), which a trace on meta
    tensors does not see.
  * ``collective_bytes`` and ``collective_counts``: the
    ``_c10d_functional`` ops (and DTensor's all-to-all) that DTensor
    issues, bytes as the result size (the reference's rule), counted
    under the reference's names.
  * ``cross_pod_bytes``: collectives whose group's global ranks span
    more than one ``rank // pod_size``.

An eager trace runs a Python loop as often as it runs, so nothing is
multiplied by a trip count as the reference's while-loop walk does.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# functional-collective op name -> the reference's (HLO) name
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
# ops that hand out uninitialised memory: they move no bytes
_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "empty_permuted",
                "new_empty", "new_empty_strided"}


@dataclass
class CompStats:
    flops: float = 0.0
    traffic: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(default_factory=dict)
    cross_pod_bytes: float = 0.0   # collectives whose groups span pods
    # FLOPs of the DTensor-level ops at their GLOBAL shapes (what
    # ``FlopCounterMode`` reports around DTensors), before partitioning;
    # a convolution, whose formula reads its result, is not in it
    global_flops: float = 0.0
    # op name -> [calls, flops, traffic bytes] of the local ops
    by_op: Dict[str, list] = field(default_factory=dict)
    # this rank's bytes: the arguments, the outputs, the outputs that
    # share an argument's storage (in-place writes), and the high-water
    # mark of live bytes the traced ops made beyond the arguments
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    alias_bytes: float = 0.0
    peak_temp_bytes: float = 0.0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, else ``t``."""
    to_local = getattr(t, "to_local", None)
    return to_local() if to_local is not None else t


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor):
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None, None
    return st._cdata, st


def _group_ranks(group_name) -> Optional[list]:
    """Global ranks of a functional collective's group (name or group)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        pg = (_resolve_process_group(group_name)
              if isinstance(group_name, str) else group_name)
        return dist.get_process_group_ranks(pg)
    except Exception:  # noqa: BLE001 - an unresolvable group: unknown
        return None


def is_cross_pod(ranks, pod_size: int) -> bool:
    """True when the global ``ranks`` of a group span more than one pod
    (``rank // pod_size`` differs); an unknown group counts as crossing,
    the reference's conservative choice."""
    if ranks is None:
        return True
    pods = {r // pod_size for r in ranks}
    return len(pods) > 1


def _collective_group(func, args, kwargs):
    """The ``group_name`` (or ``group``) argument of a collective op."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.name in ("group_name", "group", "tag"):
            return args[i] if i < len(args) else kwargs.get(arg.name)
    return None


class _Counter(TorchDispatchMode):
    """Counts the local ops of a program (module docstring)."""

    def __init__(self, pod_size: int, arg_storages):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._fake = FakeTensor
        self._flops = flop_registry
        self.pod_size = pod_size
        self.stats = CompStats()
        self._args = arg_storages
        self._live: Dict[int, tuple] = {}
        self._live_bytes = 0
        self._peak = 0

    # ---------------------------------------------------------- memory
    def _sweep(self):
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self._live_bytes -= self._live.pop(k)[1]

    def _note_outputs(self, outs):
        from torch.multiprocessing.reductions import StorageWeakRef
        for t in outs:
            key, st = _storage_key(t)
            if key is None or key in self._args or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (StorageWeakRef(st), n)
            self._live_bytes += n
            if self._live_bytes > self._peak:
                self._sweep()
                self._peak = max(self._peak, self._live_bytes)

    # --------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            packet = func._overloadpacket
            if packet in self._flops:
                try:     # the result is not there yet: formulas that read
                    self.stats.global_flops += float(      # it drop out
                        self._flops[packet](*args, **kwargs, out_val=None))
                except (TypeError, AttributeError):
                    pass
            return NotImplemented    # let DTensor decompose; count its ops
        out = func(*args, **kwargs)
        if any(issubclass(t, self._fake) for t in types):
            return out               # DTensor's shape propagation: no work
        st = self.stats
        packet = func._overloadpacket
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        outs = _tensors(out)
        if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVE_NAMES:
            kind = _COLLECTIVE_NAMES[name]
            size = float(sum(nbytes(t) for t in outs))
            st.collective_bytes += size
            st.collective_counts[kind] = st.collective_counts.get(kind, 0) + 1
            ranks = _group_ranks(_collective_group(func, args, kwargs))
            if is_cross_pod(ranks, self.pod_size):
                st.cross_pod_bytes += size
            st.traffic += size
        elif ns == "_c10d_functional":           # wait_tensor and the like
            pass
        else:
            flops = moved = 0.0
            if packet in self._flops:
                flops = float(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
            if not func.is_view and name not in _ALLOCATIONS:
                moved = float(sum(nbytes(t) for t in _tensors(args))
                              + sum(nbytes(t) for t in outs))
            st.flops += flops
            st.traffic += moved
            row = st.by_op.setdefault(str(packet), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += flops
            row[2] += moved
        self._note_outputs(outs)
        return out


def _local_bytes(tensors) -> float:
    return float(sum(nbytes(_local(t)) for t in tensors))


def analyze(fn, *args, pod_size: int = 1 << 30, **kwargs):
    """``(fn(*args, **kwargs), CompStats, seconds)``: the program's
    per-device FLOPs, traffic and collectives (module docstring), and its
    bytes on this rank: ``peak_temp_bytes`` is the most the traced ops
    held live at once beyond the arguments' storages, at op boundaries
    (the garbage collector is off meanwhile, so the figure is the same
    in every run)."""
    inputs = _tensors((args, kwargs))
    arg_storages = {_storage_key(_local(t))[0] for t in inputs} - {None}
    mode = _Counter(pod_size, arg_storages)
    gc_was = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        if gc_was:
            gc.enable()
    secs = time.perf_counter() - t0
    mode._sweep()
    st = mode.stats
    outs = _tensors(out)
    st.peak_temp_bytes = float(mode._peak)
    st.argument_bytes = _local_bytes(inputs)
    st.output_bytes = _local_bytes(outs)
    st.alias_bytes = _local_bytes(
        t for t in outs if _storage_key(_local(t))[0] in arg_storages)
    return out, st, secs


def summarize_collectives(fn, *args, **kwargs) -> Dict[str, int]:
    """The collective counts of one run of ``fn``, every reference name
    present (zeros too); nothing to multiply, as in ``analyze``."""
    _, stats, _ = analyze(fn, *args, **kwargs)
    return {op: stats.collective_counts.get(op, 0) for op in COLLECTIVE_OPS}
