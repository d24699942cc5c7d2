"""Fused MC-dropout acquisition scores: the CUDA kernel and its plain version.

The hand-written Hopper kernel (``csrc/acquisition_scores.cu``) replaces the
TPU kernel ``repro.kernels.acquisition_scores.acquisition_scores_fused``:
from MC log-probs ``[T, N, C]`` — or ``[D, T, N, C]``, devices folded into
the row axis — it computes entropy (Eq. 2), BALD (Eq. 3) and the
variational ratio (Eq. 4) in one pass.

``acquisition_scores`` is the wrapper the engine calls.  For a tensor on
the CPU it runs ``acquisition_scores_plain`` (the port of
``repro.kernels.ref.acquisition_scores_ref``); for a tensor on the card it
launches the kernel, or raises on what the kernel does not take.  There is
no fallback from one to the other.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import acquisition as acq

launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def acquisition_scores(log_probs: torch.Tensor):
    """``(entropy, bald, vr)`` from MC log-probs ``[T, N, C]`` or
    ``[D, T, N, C]`` (float32 or bfloat16); float32 outputs ``[N]`` or
    ``[D, N]``."""
    if log_probs.device.type == "cpu":
        return acquisition_scores_plain(log_probs)
    if log_probs.device.type != "cuda":
        raise ValueError(f"no acquisition-score kernel for device "
                         f"{log_probs.device}")
    if log_probs.dtype not in _DTYPES:
        raise TypeError(f"acquisition-score kernel takes float32 or bfloat16, "
                        f"got {log_probs.dtype}")
    if log_probs.dim() not in (3, 4):
        raise ValueError(f"log_probs must be [T, N, C] or [D, T, N, C], got "
                         f"shape {tuple(log_probs.shape)}")
    if not log_probs.is_contiguous():
        raise ValueError("acquisition-score kernel needs a contiguous input")
    lead = log_probs.shape[:-3]
    D = log_probs.shape[0] if lead else 1
    T, N, C = log_probs.shape[-3:]
    if T < 1 or C < 1:
        raise ValueError(f"need T >= 1 and C >= 1, got T={T}, C={C}")
    fn = _entry(log_probs.dtype)
    out = torch.empty((3,) + tuple(lead) + (N,), dtype=torch.float32,
                      device=log_probs.device)
    err = fn(log_probs.data_ptr(), D, T, N, C, out[0].data_ptr(),
             out[1].data_ptr(), out[2].data_ptr(),
             torch.cuda.current_stream(log_probs.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"acquisition-score kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out[0], out[1], out[2]
