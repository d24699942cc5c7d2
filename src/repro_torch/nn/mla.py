"""Multi-head Latent Attention (DeepSeek-V2, MiniCPM3) over a leading device
axis (``repro.nn.mla`` ported: the direct and the absorbed form).

The direct form (train and prefill) decompresses the latent to per-head
K and V and runs the shared attention core: K = [k_nope ; k_rope], the
rope key shared by every head.  v is zero-padded to the q/k head dim
``dn + dr`` so the core (and on ``impl="pallas"`` the flash-attention
kernel) takes one head dim, and the output is sliced back to ``dv``.

As in the reference, ``q_norm`` and ``kv_norm`` apply their scales with
``zero_centered=False`` to scales that ``rmsnorm_init`` sets to zero: a
fresh layer gives q = 0 and ckv = 0, so its output is 0 until training
moves the scales.

The absorbed form (decode) attends the latent cache ``{"ckv": [..., B,
S, kv_lora], "krope": [..., B, S, dr], "pos": [..., S]}`` directly:
q_nope is absorbed through W_uk, scores are taken in latent space, and
the output stays there until W_uv.  Its mask is the reference's,
``(pos >= 0) & (pos <= position)``, and it runs no kernel, as in the
reference.  ``mla_decode`` writes the token's slot in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG
from repro_torch.nn import init as initializers
from repro_torch.nn.attention import attention_core
from repro_torch.nn.layers import dense_apply
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope
from repro_torch.nn.shard_hints import (hint_heads, local_of,
                                        local_placements, merge_heads,
                                        padded, placed, split_heads,
                                        write_slot)

def mla_init(cfg, generator: torch.Generator):
    """One layer's MLA params (the reference's shapes and initializers)."""
    dtype = cfg.param_dtype
    dev = generator.device
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    ki = initializers.lecun_normal()
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = {"kernel": ki((d, cfg.q_lora_rank), generator, dtype)}
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, dev)
        p["wuq"] = {"kernel": ki((cfg.q_lora_rank, H * (dn + dr)), generator,
                                 dtype)}
    else:
        p["wq"] = {"kernel": ki((d, H * (dn + dr)), generator, dtype)}
    p["wdkv"] = {"kernel": ki((d, r_kv), generator, dtype)}
    p["kv_norm"] = rmsnorm_init(r_kv, dtype, dev)
    p["wkr"] = {"kernel": ki((d, dr), generator, dtype)}
    p["wuk"] = {"kernel": ki((r_kv, H * dn), generator, dtype)}
    p["wuv"] = {"kernel": ki((r_kv, H * dv), generator, dtype)}
    p["wo"] = {"kernel": ki((H * dv, d), generator, dtype)}
    return p


def _queries(params, x, cfg, positions):
    """``(q_nope [..., S, H, dn], q_rope [..., S, H, dr])``, rope applied."""
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = dense_apply(params["wdq"], x)
        cq = rmsnorm_apply(params["q_norm"], cq, zero_centered=False)
        q = dense_apply(params["wuq"], cq)
    else:
        q = dense_apply(params["wq"], x)
    q = split_heads(q, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, theta=cfg.rope_theta)


def _latents(params, x, cfg, positions):
    """The compressed KV latent ``ckv [..., S, kv_lora]`` and the shared
    rope key ``krope [..., S, dr]`` of a full sequence."""
    ckv = rmsnorm_apply(params["kv_norm"], dense_apply(params["wdkv"], x),
                        zero_centered=False)
    krope = dense_apply(params["wkr"], x)
    krope = apply_rope(krope[..., None, :], positions,
                       theta=cfg.rope_theta)[..., 0, :]
    return ckv, krope


def mla_apply(params, x: torch.Tensor, *, cfg, positions: torch.Tensor,
              impl: str = "auto"):
    """Direct form over stacked params: x ``[D, Nb, S, d_model]`` →
    ``(out [D, Nb, S, d_model], (ckv, krope))``, the latents for a caller
    that builds the decode cache.  Devices and sequences fold into the
    core's batch axis."""
    Dn, Nb, S = x.shape[:3]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _queries(params, x, cfg, positions)
    ckv, krope = _latents(params, x, cfg, positions)

    k_nope = split_heads(dense_apply(params["wuk"], ckv), H, dn)
    v = split_heads(dense_apply(params["wuv"], ckv), H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)               # [D, Nb, S, H, dn+dr]
    k = torch.cat([k_nope, krope[..., None, :].expand(Dn, Nb, S, H, dr)],
                  dim=-1)
    if cfg.shard_hints:
        q, k = hint_heads(q), hint_heads(k)
    # pad v to the q/k head dim so the shared core runs; slice after
    v = padded(v, (0, dn + dr - dv))
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k), fold(v), causal=True,
                         scale=(dn + dr) ** -0.5, impl=impl)
    out = merge_heads(out[..., :dv]).reshape(Dn, Nb, S, H * dv)
    return dense_apply(params["wo"], out), (ckv, krope)


# ------------------------------------------------------------- decode cache
def _empty_cache(lead, batch: int, max_len: int, kv_lora: int, rope: int,
                 dtype, device):
    shape = tuple(lead) + (batch, max_len)
    return {"ckv": torch.zeros(shape + (kv_lora,), dtype=dtype,
                               device=device),
            "krope": torch.zeros(shape + (rope,), dtype=dtype,
                                 device=device),
            "pos": torch.full(tuple(lead) + (max_len,), -1,
                              dtype=torch.int32, device=device)}


def mla_init_cache(batch: int, max_len: int, cfg, *, dtype=torch.bfloat16,
                   device=None):
    """One model's empty latent cache."""
    return _empty_cache((), batch, max_len, cfg.kv_lora_rank,
                        cfg.qk_rope_head_dim, dtype, device)


def mla_cache_from_prefill(ckv: torch.Tensor, krope: torch.Tensor, *,
                           max_len: int, dtype=torch.bfloat16):
    """A latent cache holding a prefill's ``ckv [..., B, S, kv_lora]`` and
    ``krope [..., B, S, dr]`` at slots 0..S-1 (leading axes kept)."""
    lead, (B, S) = ckv.shape[:-3], ckv.shape[-3:-1]
    cache = _empty_cache(lead, B, max_len, ckv.shape[-1], krope.shape[-1],
                         dtype, ckv.device)
    if hasattr(ckv, "device_mesh"):   # under a mesh: each rank its shard
        pls = [local_placements(t, whole=(-2,)) for t in (ckv, krope)]
        local = mla_cache_from_prefill(local_of(ckv, pls[0]),
                                       local_of(krope, pls[1]),
                                       max_len=max_len, dtype=dtype)
        for (name, src), pl in zip((("ckv", ckv), ("krope", krope)), pls):
            local[name] = placed(local[name], src.device_mesh, pl,
                                 cache[name].shape)
        return local
    cache["ckv"][..., :S, :] = ckv.to(dtype)
    cache["krope"][..., :S, :] = krope.to(dtype)
    cache["pos"][..., :S] = torch.arange(S, dtype=torch.int32,
                                         device=ckv.device)
    return cache


def mla_decode(params, x: torch.Tensor, cache, *, cfg, position: int):
    """Absorbed decode step over stacked params: x ``[D, Nb, 1, d_model]``,
    ``cache`` the ``[D, ...]`` latent cache, ``position`` the host-side
    int → ``(out [D, Nb, 1, d_model], cache)``, the token written at slot
    ``position`` in place.

    scores = q_absorbed · ckv + q_rope · krope (latent space), out =
    (softmax · ckv) through W_uv."""
    Dn, Nb = x.shape[:2]
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    positions = torch.arange(position, position + 1, dtype=torch.int32,
                             device=x.device)
    q_nope, q_rope = _queries(params, x, cfg, positions)  # [D, Nb, 1, H, *]
    ckv_new, krope_new = _latents(params, x, cfg, positions)
    write_slot(cache["ckv"], ckv_new, -2, position)
    write_slot(cache["krope"], krope_new, -2, position)
    write_slot(cache["pos"], position, -1, position)

    wuk = split_heads(params["wuk"]["kernel"].to(x.dtype), H, dn)
    q_abs = torch.einsum("dbqhe,dche->dbqhc", q_nope, wuk)  # [D, Nb, 1, H, r]
    ckv = cache["ckv"].to(x.dtype)                           # [D, Nb, S, r]
    krope = cache["krope"].to(x.dtype)                       # [D, Nb, S, dr]
    s = (torch.einsum("dbqhc,dbsc->dbhqs", q_abs.float(), ckv.float())
         + torch.einsum("dbqhe,dbse->dbhqs", q_rope.float(), krope.float()))
    s = s * (dn + dr) ** -0.5
    pos = cache["pos"]                                       # [D, S]
    valid = (pos >= 0) & (pos <= position)
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full((), NEG, device=x.device))
    p = torch.softmax(s, dim=-1)
    out_latent = torch.einsum("dbhqs,dbsc->dbqhc", p.to(x.dtype), ckv)
    wuv = split_heads(params["wuv"]["kernel"].to(x.dtype), H, dv)
    out = torch.einsum("dbqhc,dche->dbqhe", out_latent, wuv)
    return dense_apply(params["wo"], merge_heads(out)), cache
