"""Grouped-query attention over a leading device axis (``repro.nn.attention``
ported: projections, RoPE, the masked softmax core, the decode caches and
gated cross-attention).

The core has the JAX package's routes, chosen by ``impl``:

* ``"naive"`` — full ``[B, H, Sq, Skv]`` scores in float32,
  differentiable (the training loss takes it), masked as the reference
  masks them (``_mask_block``: empty cache slots carry ``pos = -1``), a
  row with no valid key giving 0: the kernel's plain version
  (``flash_attention_plain``) under that mask;
* ``"blockwise"`` — the reference's online-softmax scan over KV blocks of
  ``block_kv`` keys, here a Python loop of plain, differentiable PyTorch
  (an XLA route in the reference, not a kernel).  ``"auto"`` picks it
  above 2048 keys when there is more than one query;
* ``"pallas"`` — the kernel's wrapper (``kernels.flash_attention``): the
  CUDA kernel for tensors on the card, the plain version on the CPU.  The
  name is the JAX package's; here it means the hand-written kernel.  The
  kernel knows positions only as ``q_offset`` (query i at ``q_offset +
  i``, key j at j), so this route maps the reference's positions onto it
  from the HOST-side ``decode_position`` (an ``int``), never reading a
  position back from the card: keys at the queries' own positions
  (train, prefill, cross-attention) take ``q_offset = 0``; a decode query
  against a cache (slot ``position % size``) takes ``q_offset =
  position`` while ``position < size`` (causality masks the slots not
  yet written), and, once a ring has wrapped, ``causal=False`` and no
  window over every slot in slot order (each holds one of the last
  ``size`` positions).  Positions it cannot map raise ``ValueError``;
  nothing falls back to the plain version.

Under a mesh (DTensor inputs) every route runs on each rank's local
batch rows and heads (``_core_local``), through the registered kernel op
on ``"pallas"`` (``kernels.flash_attention.flash_attention_op``, which
dispatch modes see): attention is independent across rows and heads,
and neither the kernel nor the core's reshapes receive a DTensor.

Decode caches (``init_cache``, ``cache_update_decode``,
``cache_from_prefill``) are the reference's trees: ``{"k", "v": [B,
size, Hkv, hd], "pos": [size]}`` for one model (``full``: ``size =
max_len``; ``ring``: ``size = window``, slot ``t % window``), with any
leading axes in front (``[D, ...]`` stacked over devices, ``pos [D,
size]``).  ``pos`` is one vector for the whole batch.  A decode step
WRITES ITS ONE SLOT IN PLACE and returns the cache it was given: a
functional copy of every layer's cache a token would move the whole
cache a step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (NEG, flash_attention,
                                                 flash_attention_op,
                                                 flash_attention_plain)
from repro_torch.nn import init as initializers
from repro_torch.nn.layers import dense_apply, per_device
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.shard_hints import (hint_heads, local_of,
                                        local_placements, merge_heads,
                                        placed, split_heads, write_slot)

IMPLS = ("auto", "naive", "blockwise", "pallas")


# =============================================================== core
def _mask_block(q_pos, kv_pos, *, causal: bool, window: Optional[int],
                kv_valid=None):
    """Boolean mask ``[Sq, Skv]`` from absolute positions ``[Sq]``,
    ``[Skv]`` (the reference's)."""
    m = torch.ones((q_pos.shape[-1], kv_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    # out of place: under a mesh the positions may be DTensors
    if causal:
        m = m & (kv_pos[None, :] <= q_pos[:, None])
    if window is not None:
        m = m & ((q_pos[:, None] - kv_pos[None, :]) < window)
    m = m & (kv_pos[None, :] >= 0)  # empty cache slots carry pos = -1
    if kv_valid is not None:
        m = m & kv_valid[None, :]
    return m


def _scores(qg, k, *, scale, softcap):
    """qg ``[B, Sq, Hkv, rep, d]`` · k ``[B, Skv, Hkv, d]`` → float32
    ``[B, Hkv, rep, Sq, Skv]``."""
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def _pallas_positions(Sq: int, Skv: int, *, causal: bool,
                     window: Optional[int],
                     decode_position: Optional[int]):
    """``(causal, window, q_offset)`` of the kernel's contract that gives
    the reference's mask (module docstring); raises ``ValueError`` where
    there is none."""
    if decode_position is None:
        return causal, window, 0
    pos = int(decode_position)
    if Sq != 1 or pos < 0:
        raise ValueError(f"the kernel route decodes one query at a position "
                         f">= 0 against a cache; got Sq {Sq} at {pos}")
    if pos < Skv:
        if not causal:
            raise ValueError("a cache that has not wrapped holds empty "
                             "slots, which only a causal mask hides on the "
                             "kernel route")
        return True, window, pos
    if window is not None and window < Skv:
        raise ValueError(f"a wrapped cache of {Skv} slots holds keys beyond "
                         f"the window {window}: the kernel route cannot "
                         "mask them")
    return False, None, 0


def _local_kv_heads(H: int, Hkv: int, m: int, r: int):
    """The kv heads ``[lo, hi)`` that rank ``r``'s ``H / m`` query heads
    read when kv stays whole on the ``m``-wide model axis, or None when
    its query heads do not map onto whole kv groups."""
    hl, rep = H // m, H // Hkv
    if hl % rep and rep % hl:
        return None
    return (r * hl) // rep, ((r + 1) * hl - 1) // rep + 1


def _whole(t):
    """A DTensor's whole value (positions, masks), else ``t``."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _core_local(q, k, v, **kw):
    """The core on this rank's local rows and heads under a mesh: the
    batch dim over the batch axes where they divide it, query heads over
    ``model`` where it divides ``H``, kv heads with them where it divides
    ``Hkv``, else whole kv of which each rank takes the heads its queries
    read.  Sequences stay whole.  Returns a DTensor placed as the
    queries."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    B, H, Hkv = q.shape[0], q.shape[2], k.shape[2]
    batch = [i for i, n in enumerate(names) if n in ("pod", "data")]
    split_b = B % math.prod(mesh.size(i) for i in batch) == 0
    m = mesh.size(names.index("model")) if "model" in names else 1
    kv_range = None
    if "model" in names and H % m == 0 and Hkv % m:
        kv_range = _local_kv_heads(H, Hkv, m, mesh.get_local_rank("model"))
    split_q = "model" in names and H % m == 0 and (
        Hkv % m == 0 or kv_range is not None)
    q_pl, kv_pl = [], []
    for i, n in enumerate(names):
        if i in batch and split_b:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
        elif n == "model" and split_q:
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2) if kv_range is None else Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()
    if split_q and kv_range is not None:
        kl, vl = (t[:, :, kv_range[0]:kv_range[1]] for t in (kl, vl))
    for name in ("q_pos", "kv_pos", "kv_valid"):
        kw[name] = _whole(kw[name])
    out = _core(ql, kl, vl, kernel=flash_attention_op, **kw)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def attention_core(q, k, v, *, q_pos=None, kv_pos=None, causal: bool = True,
                   window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None, impl: str = "auto",
                   kv_valid=None, block_kv: int = 1024,
                   decode_position: Optional[int] = None):
    """q ``[B, Sq, H, d]``; k, v ``[B, Skv, Hkv, d]`` → ``[B, Sq, H, d]``.

    ``q_pos [Sq]`` and ``kv_pos [Skv]`` are absolute token positions and
    ``kv_valid [Skv]`` a key mask, as in the reference; without them the
    queries and the keys sit at consecutive positions from 0.  The
    ``"pallas"`` route reads none of them: it maps from the host-side
    ``decode_position`` (the module docstring), and refuses ``kv_valid``,
    and positions given as tensors without ``decode_position``."""
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
              softcap=softcap, scale=scale, impl=impl, kv_valid=kv_valid,
              block_kv=block_kv, decode_position=decode_position)
    if hasattr(q, "device_mesh"):
        return _core_local(q, k, v, **kw)
    return _core(q, k, v, kernel=flash_attention, **kw)


def _core(q, k, v, *, q_pos, kv_pos, causal, window, softcap, scale, impl,
          kv_valid, block_kv, decode_position, kernel):
    """``attention_core`` on plain tensors; ``kernel`` is the ``"pallas"``
    route's wrapper."""
    B, Sq, H, d = q.shape
    Hkv = k.shape[2]
    if impl == "auto":
        impl = "blockwise" if k.shape[1] > 2048 and Sq > 1 else "naive"
    scale = scale if scale is not None else d ** -0.5
    if impl == "pallas":
        if kv_valid is not None or (decode_position is None and (
                q_pos is not None or kv_pos is not None)):
            raise ValueError("the kernel route maps positions on the host: "
                             "pass decode_position (an int) and no kv_valid")
        causal, window, q_offset = _pallas_positions(
            Sq, k.shape[1], causal=causal, window=window,
            decode_position=decode_position)
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset)
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}: use "
                         + " | ".join(IMPLS))
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, dtype=torch.int32, device=dev)
    if kv_pos is None:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=dev)
    if impl == "naive":
        mask = _mask_block(q_pos, kv_pos, causal=causal, window=window,
                           kv_valid=kv_valid)
        return flash_attention_plain(q, k, v, softcap=softcap, scale=scale,
                                     mask=mask)

    # "blockwise": the online softmax over KV blocks; the padded tail's
    # keys sit at pos = -1, so the mask drops them
    qg = q.reshape(B, Sq, Hkv, H // Hkv, d)
    neg = torch.full((), NEG, device=dev)
    zero = torch.zeros((), device=dev)
    Skv = k.shape[1]
    nb = -(-Skv // block_kv)
    pad = nb * block_kv - Skv
    pad4 = (0, 0, 0, 0, 0, pad)
    kp = torch.nn.functional.pad(k, pad4)
    vp = torch.nn.functional.pad(v, pad4)
    pos_p = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    valid_p = (torch.nn.functional.pad(kv_valid, (0, pad), value=False)
               if kv_valid is not None else None)
    rep = H // Hkv
    m = torch.full((B, Hkv, rep, Sq), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, d), dtype=torch.float32, device=dev)
    for i in range(nb):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        s = _scores(qg, kp[:, blk], scale=scale, softcap=softcap)
        mask = _mask_block(q_pos, pos_p[blk], causal=causal, window=window,
                           kv_valid=None if valid_p is None else valid_p[blk])
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=-1e30)    # rows with no valid key yet
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), zero)
        corr = (torch.exp(torch.clamp(m, min=-1e30) - m_safe)
                * (m > NEG / 2))
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(v.dtype), vp[:, blk])
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, d).to(q.dtype)


# =============================================================== projections
def gqa_init(cfg, generator: torch.Generator, *, dtype=None):
    """GQA projection params for one model."""
    dtype = dtype or cfg.param_dtype
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    ki = initializers.lecun_normal()
    dev = generator.device
    p = {"wq": {"kernel": ki((d, H * hd), generator, dtype)},
         "wk": {"kernel": ki((d, Hkv * hd), generator, dtype)},
         "wv": {"kernel": ki((d, Hkv * hd), generator, dtype)},
         "wo": {"kernel": ki((H * hd, d), generator, dtype)}}
    if cfg.attn_bias:
        p["wq"]["bias"] = torch.zeros((H * hd,), dtype=dtype, device=dev)
        p["wv"]["bias"] = torch.zeros((Hkv * hd,), dtype=dtype, device=dev)
        p["wo"]["bias"] = torch.zeros((d,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, dev)
        p["k_norm"] = rmsnorm_init(hd, dtype, dev)
    return p


def _proj(p, x, heads, hd):
    return split_heads(dense_apply(p, x), heads, hd)


# =============================================================== caches
def _empty_cache(lead, batch: int, size: int, n_kv_heads: int,
                 head_dim: int, dtype, device):
    shape = tuple(lead) + (batch, size, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full(tuple(lead) + (size,), -1, dtype=torch.int32,
                              device=device)}


def init_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int, *,
               kind: str = "full", window: Optional[int] = None,
               dtype=torch.bfloat16, device=None):
    """One model's empty decode cache; ``kind="ring"`` sizes it to the
    window."""
    size = window if kind == "ring" else max_len
    if size is None:
        raise ValueError("a ring cache needs a window")
    return _empty_cache((), batch, size, n_kv_heads, head_dim, dtype, device)


def cache_update_decode(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                        position: int):
    """Write one token (``k_new``, ``v_new [..., B, 1, Hkv, hd]``) at the
    host-side absolute ``position`` (slot ``position % size``) IN PLACE;
    returns ``cache``."""
    slot = position % cache["k"].shape[-3]
    write_slot(cache["k"], k_new, -3, slot)
    write_slot(cache["v"], v_new, -3, slot)
    write_slot(cache["pos"], position, -1, slot)
    return cache


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor, *, kind: str,
                       max_len: int, window: Optional[int],
                       dtype=torch.bfloat16):
    """A cache holding a prefilled sequence ``k``, ``v [..., B, S, Hkv,
    hd]`` (leading axes kept: ``[D, ...]`` stacked).  A ring keeps the last
    ``min(S, window)`` tokens at slots ``pos % window``."""
    S = k.shape[-3]
    lead, (B, _, Hkv, hd) = k.shape[:-4], k.shape[-4:]
    size = window if kind == "ring" else max_len
    if hasattr(k, "device_mesh"):   # under a mesh: each rank its own shard
        pl = local_placements(k, whole=(-3,))           # the slot dim whole
        cache = cache_from_prefill(local_of(k, pl), local_of(v, pl),
                                   kind=kind, max_len=max_len, window=window,
                                   dtype=dtype)
        shape = tuple(lead) + (B, size, Hkv, hd)
        return {"k": placed(cache["k"], k.device_mesh, pl, shape),
                "v": placed(cache["v"], k.device_mesh, pl, shape),
                "pos": cache["pos"]}
    cache = _empty_cache(lead, B, size, Hkv, hd, dtype, k.device)
    take = min(S, size) if kind == "ring" else S
    positions = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slots = (positions % size).long()
    cache["k"].index_copy_(-3, slots, k[..., S - take:, :, :].to(dtype))
    cache["v"].index_copy_(-3, slots, v[..., S - take:, :, :].to(dtype))
    cache["pos"].index_copy_(-1, slots, positions.expand(
        tuple(lead) + (take,)).contiguous())
    return cache


# =============================================================== layer
def gqa_apply(params, x: torch.Tensor, *, cfg, positions: torch.Tensor,
              window: Optional[int] = None, cache=None, decode: bool = False,
              impl: str = "auto", position: Optional[int] = None):
    """Self-attention layer body over stacked params: x ``[D, Nb, S,
    d_model]`` → ``(out [D, Nb, S, d_model], (k, v))``, or in decode
    (``cache`` the layer's ``[D, ...]`` cache, x ``[D, Nb, 1, d_model]``)
    ``(out, cache)`` with the token written into ``cache`` in place.
    Devices and sequences fold into the core's batch axis.

    ``positions [S]`` are the tokens' positions and ``position`` the
    host-side ``int`` of the first one, or None when only the tensor is
    known: decode needs it, and so does ``impl="pallas"``."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(params["wq"], x, H, hd)                    # [D, Nb, S, H, hd]
    k = _proj(params["wk"], x, Hkv, hd)
    v = _proj(params["wv"], x, Hkv, hd)
    if "q_norm" in params:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if cfg.shard_hints and not decode:
        # pin the post-reshape head layout (the reference's hint sites)
        q, k, v = hint_heads(q), hint_heads(k), hint_heads(v)

    Dn, Nb, S = x.shape[:3]
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    if decode:
        if cache is None or position is None:
            raise ValueError("a decode step needs the layer's cache and the "
                             "host-side position")
        cache_update_decode(cache, k, v, position)
        # every device decodes at the same position: the rows of a stacked
        # pos are equal
        kv_pos = cache["pos"].reshape(-1, cache["pos"].shape[-1])[0]
        out = attention_core(
            fold(q), fold(cache["k"]).to(q.dtype),
            fold(cache["v"]).to(q.dtype), q_pos=positions, kv_pos=kv_pos,
            causal=True, window=window, softcap=cfg.attn_logit_softcap,
            impl=impl, decode_position=position)
    else:
        # keys sit at the queries' positions: the masks are relative, so a
        # host-side position needs no position tensors
        rel = None if position is not None else positions
        out = attention_core(fold(q), fold(k).to(q.dtype),
                             fold(v).to(q.dtype), q_pos=rel, kv_pos=rel,
                             causal=True, window=window,
                             softcap=cfg.attn_logit_softcap, impl=impl)
    out = dense_apply(params["wo"], merge_heads(out).reshape(Dn, Nb, S,
                                                             H * hd))
    return out, (cache if decode else (k, v))


# =============================================================== cross-attn
def cross_attn_init(cfg, generator: torch.Generator):
    """GQA projections, plus the zero ``gate_attn`` scalar of
    llama-3.2-vision's tanh gate."""
    p = gqa_init(cfg, generator)
    p["gate_attn"] = torch.zeros((), dtype=cfg.param_dtype,
                                 device=generator.device)
    return p


def cross_attn_apply(params, x: torch.Tensor, kv_src: torch.Tensor, *, cfg,
                     impl: str = "auto") -> torch.Tensor:
    """Cross-attention over stacked params: queries from x ``[D, Nb, Sq,
    d_model]``, keys and values from kv_src ``[D, Nb, Skv, d_model]`` (or
    ``[1, Nb, Skv, d_model]``, shared by every device: encoder output or
    image embeddings).  No RoPE, no causality; the optional ``wo`` bias
    and the ``tanh(gate_attn)`` gate as in the reference."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(params["wq"], x, H, hd)                    # [D, Nb, Sq, H, hd]
    k = _proj(params["wk"], kv_src, Hkv, hd)             # [D, Nb, Skv, ...]
    v = _proj(params["wv"], kv_src, Hkv, hd)
    Dn, Nb, Sq = x.shape[:3]
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k).to(q.dtype), fold(v).to(q.dtype),
                         causal=False, impl=impl)
    y = dense_apply(params["wo"], merge_heads(out).reshape(Dn, Nb, Sq,
                                                           H * hd))
    if "gate_attn" in params:
        y = per_device(torch.tanh(params["gate_attn"].to(y.dtype)), y) * y
    return y
