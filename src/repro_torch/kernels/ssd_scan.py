"""Mamba-2 SSD intra-chunk block: the CUDA kernel and its plain version.

The hand-written Hopper kernel (``csrc/ssd_intra_chunk.cu``) replaces the
TPU kernel ``repro.kernels.ssd_scan.ssd_intra_chunk``.  For every
(batch·chunk z, head) it computes the masked quadratic "attention form" of
the chunk and the chunk-final state contribution:

    y[l]     = Σ_{m ≤ l} (C_l · B_m) · exp(min(la_l − la_m, 0)) · xdt[m]
    state    = Σ_m xdt[m]ᵀ (B_m · exp(la_{L−1} − la_m))

It takes the tensors in the SSD caller's own layout — ``C, B [Z, L, g,
n]``, ``la [Z, L, h]``, ``xdt [Z, L, h, p]`` — and maps each head to its
group (``head // (h // g)``) itself, as the TPU kernel's caller did by
repeating B and C over the heads (64 copies at mamba2-1.3b widths).  The
plain version takes the same inputs.

``ssd_intra_chunk`` is the wrapper ``nn.ssm.ssd_chunked`` calls on its
kernel route.  For tensors on the CPU it runs ``ssd_intra_chunk_plain``;
for tensors on the card it launches the kernel, or raises on what the
kernel does not take.  There is no fallback from one to the other.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SMEM_LIMIT = 227 * 1024
_MAX_P = 256              # y columns: 16 threads × 16 registers


def ssd_intra_chunk_plain(C, B, la, xdt):
    """``(y [Z, L, h, p], state [Z, h, p, n])``, float32, from ``C, B [Z,
    L, g, n]``, ``la [Z, L, h]``, ``xdt [Z, L, h, p]`` — the port of
    ``repro.kernels.ref.ssd_intra_ref`` with the head → group map."""
    Z, L, g, n = C.shape
    h = la.shape[-1]
    rep = h // g
    Cf, Bf, xf = C.float(), B.float(), xdt.float()
    lat = la.float().transpose(1, 2)                         # [Z, h, L]
    cb = torch.einsum("zlgn,zmgn->zglm", Cf, Bf)             # [Z, g, L, L]
    cb = cb.repeat_interleave(rep, dim=1)                    # [Z, h, L, L]
    decay = torch.exp(torch.clamp(lat[..., :, None] - lat[..., None, :],
                                  max=0.0))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=C.device))
    scores = torch.where(mask, cb * decay, torch.zeros((), device=C.device))
    y = torch.einsum("zhlm,zmhp->zlhp", scores, xf)
    seg = torch.exp(la.float()[:, -1:, :] - la.float())      # [Z, L, h]
    Bh = Bf.repeat_interleave(rep, dim=2)                    # [Z, L, h, n]
    state = torch.einsum("zlhp,zlhn->zhpn", xf, Bh * seg[..., None])
    return y, state


_ENTRIES = {}


def _entry(dtype):
    """The C entry point for ``dtype``, its ctypes signature set once."""
    fn = _ENTRIES.get(dtype)
    if fn is None:
        from repro_torch.kernels import _build
        fn = getattr(_build.load("ssd_intra_chunk"),
                     f"ssd_intra_chunk_{_DTYPES[dtype]}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def _smem_bytes(L: int, n: int, p: int) -> int:
    return 4 * (L + 2 * 32 * (n + 1) + 32 * p + 32 * 33)


def ssd_intra_chunk(C, B, la, xdt):
    """Intra-chunk SSD over ``Z`` chunks (see the module docstring);
    ``C``, ``B``, ``xdt`` float32 or bfloat16 (one dtype), ``la`` float32
    (other float dtypes are widened here).  Returns float32 ``(y [Z, L, h,
    p], state [Z, h, p, n])``."""
    if C.device.type == "cpu":
        return ssd_intra_chunk_plain(C, B, la, xdt)
    if C.device.type != "cuda":
        raise ValueError(f"no SSD intra-chunk kernel for device {C.device}")
    if C.dim() != 4 or B.shape != C.shape or la.dim() != 3 or xdt.dim() != 4:
        raise ValueError(f"need C, B [Z, L, g, n], la [Z, L, h], xdt [Z, L, "
                         f"h, p]; got {tuple(C.shape)}, {tuple(B.shape)}, "
                         f"{tuple(la.shape)}, {tuple(xdt.shape)}")
    Z, L, g, n = C.shape
    h, p = xdt.shape[2], xdt.shape[3]
    if la.shape != (Z, L, h) or xdt.shape[:2] != (Z, L) or h % g:
        raise ValueError(f"inconsistent shapes: C {tuple(C.shape)}, la "
                         f"{tuple(la.shape)}, xdt {tuple(xdt.shape)}")
    if C.dtype not in _DTYPES or B.dtype != C.dtype or xdt.dtype != C.dtype:
        raise TypeError(f"SSD kernel takes float32 or bfloat16 C, B, xdt of "
                        f"one dtype; got {C.dtype}, {B.dtype}, {xdt.dtype}")
    if not la.is_floating_point():
        raise TypeError(f"la must be floating point, got {la.dtype}")
    la = la.float()
    for name, t in (("C", C), ("B", B), ("la", la), ("xdt", xdt)):
        if t.device != C.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{C.device}")
    if p > _MAX_P:
        raise ValueError(f"p={p} exceeds the kernel's register tiles (head "
                         f"dim at most {_MAX_P})")
    if _smem_bytes(L, n, p) > _SMEM_LIMIT:
        raise ValueError(f"L={L}, n={n}, p={p} exceed one block's shared "
                         "memory")
    if Z * h >= 2 ** 31:
        raise ValueError(f"Z·h = {Z * h} blocks exceed one launch")
    y = torch.empty((Z, L, h, p), dtype=torch.float32, device=C.device)
    state = torch.empty((Z, h, p, n), dtype=torch.float32, device=C.device)
    err = _entry(C.dtype)(C.data_ptr(), B.data_ptr(), la.data_ptr(),
                          xdt.data_ptr(), Z, L, g, n, h, p, y.data_ptr(),
                          state.data_ptr(),
                          torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD intra-chunk kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return y, state
