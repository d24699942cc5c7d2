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
for tensors on the card it launches the kernel once, or raises on what
the kernel does not take.  There is no fallback from one to the other.
``launches`` counts kernel launches.

``launch_plan`` is the kernel's launch for one call, in plain Python: how
many heads of a group a block owns, the blocks, the shared memory a block
needs and which rows take 16-byte copies and stores.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

launches = 0

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SMEM_LIMIT = 232448       # 227 KB: the most shared memory a block may ask
MAX_P = 256               # head dim: y's register tiles (the kernel's kMaxYQ)
TILE = 32                 # rows of an l tile and of an m tile (kTile)
MAX_HEADS_PER_BLOCK = 16
# the kernel's flags
VEC_BC, VEC_X, VEC_STATE, VEC_Y, BULK_STATE = 1, 2, 4, 8, 16


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
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def smem_bytes(L: int, n: int, p: int, heads: int, itemsize: int,
               bulk: bool) -> int:
    """Shared memory of one block (the kernel's ``Layout``): the group's B
    rows ``[Lp, n4 + 4]``, one C tile ``[32, n4 + 4]``, the C·Bᵀ tile
    ``[32, Lp + 4]``, one score tile ``[32, 36]`` and the slice's log-decays
    ``[heads, Lp]`` in float32; x·seg ``[32, p8]`` (and x as float32 for
    bfloat16 input); two raw x tiles ``[32, p8]`` in the input type; with
    ``bulk``, one head's state ``[p, n]`` for the bulk copy.  Lp is L
    rounded up to 32 rows, n4 and p8 are n and p rounded up to 4 and 8."""
    Lp, nS, p8 = _round_up(L, TILE), _round_up(n, 4) + 4, _round_up(p, 8)
    floats = (Lp * nS + TILE * nS + TILE * (Lp + 4) + TILE * 36
              + Lp * heads + TILE * p8 * (1 if itemsize == 4 else 2))
    return 4 * floats + 2 * TILE * p8 * itemsize + (4 * p * n if bulk else 0)


@dataclass(frozen=True)
class LaunchPlan:
    """The kernel's launch for one call: ``heads_per_block`` heads of one
    group a block (the last block of a group may own fewer), ``blocks``
    blocks of 256 threads, ``smem`` bytes of shared memory each, and the
    kernel's ``flags``: B and C rows, xdt rows, state rows and y rows that
    take 16-byte copies or stores, and whether each head's state leaves
    through one bulk copy of the TMA unit."""
    heads_per_block: int
    blocks: int
    smem: int
    flags: int


def launch_plan(Z: int, L: int, g: int, h: int, n: int, p: int,
                itemsize: int, bc_aligned: bool,
                x_aligned: bool) -> LaunchPlan:
    """The launch for ``C, B [Z, L, g, n]``, ``xdt [Z, L, h, p]`` of
    ``itemsize``-byte elements; ``bc_aligned`` / ``x_aligned`` say whether
    C and B / xdt start on 16 bytes.  Raises ``ValueError`` on what the
    kernel does not take.

    A block owns up to 16 heads of a group: C·Bᵀ is formed once a block
    and reused by each of them.  A row is copied in 16-byte pieces when
    the tensor starts on 16 bytes and a row is a whole number of them.  A
    head's state goes out as one bulk copy when its rows are 16-byte rows,
    one round of register tiles covers it (a warp's tile is 32 k × 32 c, 8
    warps) and its ``p·n·4`` bytes fit in shared memory beside the rest."""
    if g < 1 or h % g:
        raise ValueError(f"h={h} heads do not split into g={g} groups")
    if p > MAX_P:
        raise ValueError(f"p={p} exceeds the kernel's register tiles (head "
                         f"dim at most {MAX_P})")
    hg = h // g
    heads = min(MAX_HEADS_PER_BLOCK, hg)
    one_round = (-(-_round_up(n, 4) // 32)) * (-(-_round_up(p, 8) // 32)) <= 8
    bulk = (n % 4 == 0 and one_round
            and smem_bytes(L, n, p, heads, itemsize, True) <= SMEM_LIMIT)
    smem = smem_bytes(L, n, p, heads, itemsize, bulk)
    if smem > SMEM_LIMIT:
        raise ValueError(f"L={L}, n={n}, p={p} need {smem} bytes of shared "
                         f"memory a block, over the {SMEM_LIMIT} one block "
                         "may use")
    blocks = Z * g * -(-hg // heads)
    if blocks >= 2 ** 31:
        raise ValueError(f"{blocks} blocks exceed one launch")
    flags = ((VEC_BC if bc_aligned and n * itemsize % 16 == 0 else 0)
             | (VEC_X if x_aligned and p * itemsize % 16 == 0 else 0)
             | (VEC_STATE if n % 4 == 0 else 0)
             | (VEC_Y if p % 4 == 0 else 0)
             | (BULK_STATE if bulk else 0))
    return LaunchPlan(heads, blocks, smem, flags)


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
    plan = launch_plan(Z, L, g, h, n, p, C.element_size(),
                       C.data_ptr() % 16 == 0 and B.data_ptr() % 16 == 0,
                       xdt.data_ptr() % 16 == 0)
    y = torch.empty((Z, L, h, p), dtype=torch.float32, device=C.device)
    state = torch.empty((Z, h, p, n), dtype=torch.float32, device=C.device)
    err = _entry(C.dtype)(C.data_ptr(), B.data_ptr(), la.data_ptr(),
                          xdt.data_ptr(), Z, L, g, n, h, p,
                          plan.heads_per_block, plan.flags, y.data_ptr(),
                          state.data_ptr(),
                          torch.cuda.current_stream(C.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"SSD intra-chunk kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return y, state
