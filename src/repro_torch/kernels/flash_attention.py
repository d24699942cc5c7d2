"""Blocked online-softmax attention: the CUDA kernel and its plain version.

The hand-written Hopper kernel (``csrc/flash_attention.cu``) replaces the
TPU kernel ``repro.kernels.flash_attention.flash_attention`` with its whole
contract: q ``[B, Sq, H, d]``, k and v ``[B, Skv, Hkv, d]`` (GQA: query
head h reads kv head ``h // (H // Hkv)``, no repeat in memory); causal
masking, a sliding ``window``, a logit ``softcap``, keys past ``Skv``
masked, ``q_offset`` (query i at absolute position ``q_offset + i``,
negative too); ``scale`` defaulting to ``d ** -0.5``; the ``-2e38`` mask,
with a row that has no valid key giving 0; any head dim d from 1 to
``MAX_HEAD_DIM`` (256); float32 or bfloat16, the output in q's dtype,
float32 accumulation.

One block of the kernel owns one (batch, kv head), the query heads of its
GQA group and up to 64 query rows of them in all (``launch_plan``), so K
and V are read once per group and query tile.  It walks the keys in
double-buffered 32-key tiles (one stage where Skv fits one tile) and
computes scores and P·V from register tiles on CUDA cores in full
float32.  Head dims in ``HEAD_DIMS`` are
compiled with fixed sizes; any other d takes a generic instantiation
padded to a multiple of 32.  Rows that are whole 16-byte pieces of a
tensor that starts on 16 bytes take 16-byte copies; the others take
scalar loads in the same kernel.

``flash_attention`` is the wrapper ``nn.attention.attention_core`` calls
on its ``"pallas"`` route.  For tensors on the CPU it runs
``flash_attention_plain`` (the port of ``repro.kernels.ref.attention_ref``);
for tensors on the card it launches the kernel, or raises on what the
kernel does not take.  There is no fallback from one to the other.
``launches`` counts kernel launches.

``flash_attention_op`` is the same wrapper registered as the torch op
``repro_torch::flash_attention``, so that dispatch modes see it: its
meta kernel gives the output's shape (a trace on meta tensors runs
nothing), and its FLOP formula (``launch.op_analysis``) is the dense
``4·B·H·Sq·Skv·d`` of the two products, masked keys included.  The
attention core calls it on its ``"pallas"`` route under a mesh, on each
rank's local heads.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

launches = 0

NEG = -2.0e38
MAX_HEAD_DIM = 256
HEAD_DIMS = (64, 96, 128, 192, 256)     # compiled with fixed sizes
BLOCK_ROWS = 64                         # query rows a block, over its heads
KV_TILE = 32                            # keys a shared-memory tile
VEC_Q, VEC_K, VEC_V, VEC_O = 1, 2, 4, 8
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
                          scale: Optional[float] = None, q_offset: int = 0,
                          mask: Optional[torch.Tensor] = None):
    """Full-score masked attention with the kernel's semantics, in float32;
    the output in q's dtype.  ``mask [Sq, Skv]`` (bool), where given,
    replaces the mask of ``causal``, ``window`` and ``q_offset``: the
    ``"naive"`` route of ``nn.attention.attention_core`` passes the one it
    builds from positions."""
    B, Sq, H, d = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(B, Sq, Hkv, rep, d).float()
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if mask is None:
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
                          ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
    return fn


@dataclass(frozen=True)
class LaunchPlan:
    """The kernel's launch for one call: each block owns ``rows`` query
    rows of each of ``heads`` query heads of one GQA group (the last head
    slice of a group may own fewer); ``blocks`` blocks of ``threads``
    threads with ``smem`` bytes of shared memory each; ``flags`` name the
    tensors (``VEC_Q``, ``VEC_K``, ``VEC_V``, ``VEC_O``) whose rows take
    16-byte pieces."""
    rows: int
    heads: int
    blocks: int
    threads: int
    smem: int
    flags: int


def launch_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, d: int,
                itemsize: int,
                aligned=(True, True, True, True)) -> LaunchPlan:
    """The launch for q ``[B, Sq, H, d]`` and k, v ``[B, Skv, Hkv, d]`` of
    ``itemsize``-byte elements; ``aligned`` says for q, k, v and o whether
    the tensor starts on 16 bytes.  Raises ``ValueError`` on what the
    kernel does not take.

    A block owns a whole GQA group (up to ``BLOCK_ROWS`` heads; a larger
    group is split into slices) and ``BLOCK_ROWS // heads`` query rows of
    each head, fewer when the sequence is shorter.  Its shared memory
    holds the query rows, two stages of K and V tiles (one when ``Skv``
    fits one tile), the p tiles and a row table.  A tensor's rows take
    16-byte pieces when they are a whole number of them and the tensor
    starts on 16 bytes."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash-attention kernel takes head_dim 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    G = H // Hkv
    heads = max(1, min(G, BLOCK_ROWS))
    rows = max(1, min(Sq, BLOCK_ROWS // heads))
    blocks = -(-Sq // rows) * B * Hkv * -(-G // heads)
    if blocks >= 2 ** 31 - 1:
        raise ValueError(f"{blocks} blocks exceed one launch")
    dp = -(-d // 32) * 32
    threads = 128 if d in HEAD_DIMS and d <= 128 else 256
    stages = 2 if Skv > KV_TILE else 1
    smem = (4 * ((BLOCK_ROWS + 2 * stages * KV_TILE) * (dp + 4)
                 + BLOCK_ROWS * (KV_TILE + 8)) + 12 * BLOCK_ROWS)
    whole = d * itemsize % 16 == 0
    flags = sum(bit for bit, ok in zip((VEC_Q, VEC_K, VEC_V, VEC_O), aligned)
                if ok and whole)
    return LaunchPlan(rows, heads, blocks, threads, smem, flags)


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
    out = torch.empty_like(q)
    plan = launch_plan(B, Sq, Skv, H, Hkv, d, q.element_size(),
                       tuple(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    scale = scale if scale is not None else d ** -0.5
    err = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv,
        H, Hkv, d, float(scale), int(bool(causal)),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), int(q_offset), plan.rows,
        plan.heads, plan.flags,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out


# ------------------------------------------------------ the registered op
def _flash_attention_op(q, k, v, causal, window, softcap, scale, q_offset):
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_offset=q_offset)


flash_attention_op = torch.library.custom_op(
    "repro_torch::flash_attention", _flash_attention_op, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, SymInt? window, "
           "float? softcap, float? scale, SymInt q_offset) -> Tensor")


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap, scale, q_offset):
    return torch.empty_like(q)


def attention_flops(q_shape, k_shape) -> int:
    """FLOPs of the kernel's two products on q ``[B, Sq, H, d]``, k ``[B,
    Skv, Hkv, d]``: ``2·B·H·Sq·Skv·d`` each, every key counted."""
    B, Sq, H, d = q_shape
    return 4 * B * H * Sq * k_shape[1] * d


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, *args, out_shape=None, **kwargs):
        return attention_flops(q_shape, k_shape)


_register_flops()
