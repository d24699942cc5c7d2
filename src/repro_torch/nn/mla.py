"""Multi-head Latent Attention (DeepSeek-V2, MiniCPM3) over a leading device
axis (``repro.nn.mla`` ported: the direct form).

The direct form (train and prefill) decompresses the latent to per-head
K and V and runs the shared attention core: K = [k_nope ; k_rope], the
rope key shared by every head.  v is zero-padded to the q/k head dim
``dn + dr`` so the core (and on ``impl="pallas"`` the flash-attention
kernel) takes one head dim, and the output is sliced back to ``dv``.

As in the reference, ``q_norm`` and ``kv_norm`` apply their scales with
``zero_centered=False`` to scales that ``rmsnorm_init`` sets to zero: a
fresh layer gives q = 0 and ckv = 0, so its output is 0 until training
moves the scales.

The absorbed decode form and its latent cache (``mla_init_cache``,
``mla_cache_from_prefill``, ``mla_decode``) arrive with the serve path
(ROADMAP.md Queue 1 item 16) and raise.
"""
from __future__ import annotations

import torch

from repro_torch.nn import init as initializers
from repro_torch.nn.attention import attention_core
from repro_torch.nn.layers import dense_apply
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rope import apply_rope

_UNPORTED = "ROADMAP.md Queue 1 item 16"


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
    q = q.reshape(q.shape[:-1] + (H, dn + dr))
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

    k_nope = dense_apply(params["wuk"], ckv).reshape(Dn, Nb, S, H, dn)
    v = dense_apply(params["wuv"], ckv).reshape(Dn, Nb, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)               # [D, Nb, S, H, dn+dr]
    k = torch.cat([k_nope, krope[..., None, :].expand(Dn, Nb, S, H, dr)],
                  dim=-1)
    # pad v to the q/k head dim so the shared core runs; slice after
    v = torch.nn.functional.pad(v, (0, dn + dr - dv))
    fold = lambda t: t.reshape((Dn * Nb,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k), fold(v), causal=True,
                         scale=(dn + dr) ** -0.5, impl=impl)
    out = out[..., :dv].reshape(Dn, Nb, S, H * dv)
    return dense_apply(params["wo"], out), (ckv, krope)


def _decode_unported(what: str):
    raise NotImplementedError(
        f"MLA {what} (the absorbed decode form and its latent cache) is not "
        f"ported yet: {_UNPORTED}")


def mla_init_cache(*args, **kwargs):
    _decode_unported("mla_init_cache")


def mla_cache_from_prefill(*args, **kwargs):
    _decode_unported("mla_cache_from_prefill")


def mla_decode(*args, **kwargs):
    _decode_unported("mla_decode")
