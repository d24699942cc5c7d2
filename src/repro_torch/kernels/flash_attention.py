"""Blocked online-softmax attention: the CUDA kernel and its plain version.

The hand-written Hopper kernel (``csrc/flash_attention.cu``) replaces the
TPU kernel ``repro.kernels.flash_attention.flash_attention`` with its whole
contract: q ``[B, Sq, H, d]``, k and v ``[B, Skv, Hkv, d]`` (GQA: query
head h reads kv head ``h // (H // Hkv)``, no repeat in memory); causal
masking, a sliding ``window``, a logit ``softcap``, keys past ``Skv``
masked, ``q_offset`` (query i at absolute position ``q_offset + i``);
``scale`` defaulting to ``d ** -0.5``; the ``-2e38`` mask, with a row that
has no valid key giving 0; d of 64, 128 or 256; float32 or bfloat16, the
output in q's dtype, float32 accumulation.

``flash_attention`` is the wrapper ``nn.attention.attention_core`` calls
on its ``"pallas"`` route.  For tensors on the CPU it runs
``flash_attention_plain`` (the port of ``repro.kernels.ref.attention_ref``);
for tensors on the card it launches the kernel, or raises on what the
kernel does not take.  There is no fallback from one to the other.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

launches = 0

NEG = -2.0e38
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: Optional[int],
                   q_offset: int = 0, device=None) -> torch.Tensor:
    """``[Sq, Skv]`` bool: query i (at ``q_offset + i``) may see key j."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    kv_pos = torch.arange(Skv, device=device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, q_offset: int = 0):
    """Full-score masked attention with the kernel's semantics, in float32;
    the output in q's dtype."""
    B, Sq, H, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Sq, Hkv, rep, d).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full((), NEG, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p,
                    torch.zeros((), device=q.device))
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())
    return out.reshape(B, Sq, H, d).to(q.dtype)


_ENTRIES = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("flash_attention"),
                     f"flash_attention_{_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0):
    """q ``[B, Sq, H, d]``; k, v ``[B, Skv, Hkv, d]`` → ``[B, Sq, H, d]``
    (see the module docstring for the contract)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B, Sq, H, d], k and v [B, Skv, Hkv, d]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or Hkv < 1 or H % Hkv:
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash-attention kernel takes head_dim "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash-attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if -(-Sq // 16) * B * H >= 2 ** 31:
        raise ValueError("too many query tiles for one launch")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    err = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, d, float(scale), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
