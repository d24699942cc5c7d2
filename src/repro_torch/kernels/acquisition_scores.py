"""Fused MC-dropout acquisition scores: the CUDA kernel and its plain version.

The hand-written Hopper kernel (``csrc/acquisition_scores.cu``) replaces the
TPU kernel ``repro.kernels.acquisition_scores.acquisition_scores_fused``:
from MC log-probs ``[T, N, C]`` — or ``[D, T, N, C]``, devices folded into
the row axis — it computes entropy (Eq. 2), BALD (Eq. 3) and the
variational ratio (Eq. 4) in one pass.

The kernel has two modes, chosen per call by ``launch_plan``: one warp
per pool row for small class counts (the LeNet paths, C = 10), and, at the
LM vocabularies, one block of 256 threads per (row, class slice) with the
S slices of a row joined in one thread-block cluster.

``acquisition_scores`` is the wrapper the engine calls.  For a tensor on
the CPU it runs ``acquisition_scores_plain`` (the port of
``repro.kernels.ref.acquisition_scores_ref``); for a tensor on the card it
launches the kernel, or raises on what the kernel does not take.  There is
no fallback from one to the other.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.core import acquisition as acq

launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
THREADS = 256           # a block, in both modes (8 warps)
SPLIT_MIN_C = 1024      # from here the split mode wins at any row count
MIN_SLICE = 2048        # the fewest classes a slice of a row may have
MAX_SLICES = 8          # the portable thread-block cluster size
SM_COUNT = 132          # H100 SXM
BLOCKS_PER_SM = 4       # the split kernel's launch bounds (64 registers)
RESIDENT_BLOCKS = BLOCKS_PER_SM * SM_COUNT


def acquisition_scores_plain(log_probs: torch.Tensor):
    """``[..., T, N, C]`` → ``(entropy, bald, vr)``, each ``[..., N]``
    float32, through ``core.acquisition`` (the reference's oracle)."""
    lp = log_probs.float()
    return acq.entropy(lp), acq.bald(lp), acq.variational_ratio(lp)


_ENTRIES = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("acquisition_scores"),
                     f"acquisition_scores_{_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


@dataclass(frozen=True)
class LaunchPlan:
    """The kernel's launch for one call.  ``mode`` "warp": one warp per
    pool row.  ``mode`` "split": each row cut into ``slices`` class slices,
    one block a slice and one cluster a row, reading ``vec`` classes a
    load (16 bytes) or one.  ``threads`` is the block size, compiled into
    both modes."""
    mode: str
    slices: int
    threads: int
    vec: int


def launch_plan(rows: int, T: int, C: int, dtype,
                aligned: bool = True) -> LaunchPlan:
    """The launch for ``rows`` pool rows (devices × N) of ``T`` samples and
    ``C`` classes of ``dtype``; ``aligned`` says whether the tensor starts
    on 16 bytes.  Raises on what the kernel does not take.

    Below ``SPLIT_MIN_C`` classes a warp per row (measured by
    ``tools/k1_modes.py``: from 1024 classes on the split mode is faster
    at 256, 800 and 8192 rows; at 256 rows it already is from 256).  From
    there a row is cut into the most slices S in 1,
    2, 4, 8 whose blocks still run in one wave (rows × S at most
    ``RESIDENT_BLOCKS``, four a SM) with every slice ``MIN_SLICE``
    classes or more: a second, partial wave costs more than the slices
    gain.  A thread reads 16 bytes at once (4 float32 or 8 bfloat16
    classes) when C is a multiple of that and the tensor starts on 16
    bytes, else one class."""
    if dtype not in _DTYPES:
        raise TypeError(f"acquisition-score kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if T < 1 or C < 1:
        raise ValueError(f"need T >= 1 and C >= 1, got T={T}, C={C}")
    if C < SPLIT_MIN_C:
        return LaunchPlan("warp", 1, THREADS, 1)
    return _split_plan(rows, C, dtype, aligned)


def _split_plan(rows: int, C: int, dtype, aligned: bool) -> LaunchPlan:
    """``launch_plan``'s split mode at any C."""
    width = 16 // dtype.itemsize
    vec = width if aligned and C % width == 0 else 1
    slices = 1
    while (slices < MAX_SLICES and rows * 2 * slices <= RESIDENT_BLOCKS
           and C >= 2 * slices * MIN_SLICE):
        slices *= 2
    if rows * slices >= 2 ** 31:
        raise ValueError(f"{rows} rows x {slices} slices exceed the grid")
    return LaunchPlan("split", slices, THREADS, vec)


def acquisition_scores(log_probs: torch.Tensor):
    """``(entropy, bald, vr)`` from MC log-probs ``[T, N, C]`` or
    ``[D, T, N, C]`` (float32 or bfloat16); float32 outputs ``[N]`` or
    ``[D, N]``."""
    if log_probs.device.type == "cpu":
        return acquisition_scores_plain(log_probs)
    if log_probs.device.type != "cuda":
        raise ValueError(f"no acquisition-score kernel for device "
                         f"{log_probs.device}")
    if log_probs.dim() not in (3, 4):
        raise ValueError(f"log_probs must be [T, N, C] or [D, T, N, C], got "
                         f"shape {tuple(log_probs.shape)}")
    if not log_probs.is_contiguous():
        raise ValueError("acquisition-score kernel needs a contiguous input")
    D = log_probs.shape[0] if log_probs.dim() == 4 else 1
    T, N, C = log_probs.shape[-3:]
    plan = launch_plan(D * N, T, C, log_probs.dtype,   # checks dtype, T, C
                       log_probs.data_ptr() % 16 == 0)
    return _launch(log_probs, plan)


def _launch(log_probs: torch.Tensor, plan: LaunchPlan):
    """One launch of the kernel under ``plan`` on a contiguous CUDA tensor
    the wrapper has checked; the kernel refuses a plan that does not fit
    the input."""
    lead = log_probs.shape[:-3]
    D = log_probs.shape[0] if lead else 1
    T, N, C = log_probs.shape[-3:]
    fn = _entry(log_probs.dtype)
    out = torch.empty((3,) + tuple(lead) + (N,), dtype=torch.float32,
                      device=log_probs.device)
    err = fn(log_probs.data_ptr(), D, T, N, C, int(plan.mode == "split"),
             plan.slices, plan.vec, out[0].data_ptr(), out[1].data_ptr(),
             out[2].data_ptr(),
             torch.cuda.current_stream(log_probs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"acquisition-score kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out[0], out[1], out[2]
