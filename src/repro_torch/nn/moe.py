"""Mixture-of-Experts layer with sort-based capacity dispatch over a leading
device axis (``repro.nn.moe`` ported).

A group is one (device, batch row) pair, the reference's group under the
engine's ``vmap``.  Within a group the ``S·K`` (token, choice) pairs are
sorted by expert id with a stable sort (``jnp.argsort``'s order), each
pair's rank within its expert is its slot, and pairs past the capacity
``C = max(K, int(S·K/E·router_capacity_factor))`` are dropped.  Kept pairs
are scattered into an ``[E, C, d]`` buffer, pushed through the batched
expert GEMMs and gathered back in token order.  ``impl="dense"`` runs
every expert on every token: the oracle the sort route is tested against.

The router stays float32.  Top-K follows ``jax.lax.top_k``: ties go to
the lower expert id (``core.acquisition.select_topk``, never
``torch.topk``).  The scatter adds a dropped pair's exact zero at slot
``C - 1`` of its expert, as the reference does; every kept slot takes one
pair, so ``index_put(accumulate=True)`` gives the same bits in any order.

Shared experts (DeepSeek-V2) and the dense residual branch (Arctic) add
SwiGLU MLPs beside the routed experts.  The auxiliary loss (load balance
plus router z) is one value a device: its means run over that device's
rows and tokens, as the reference's run inside the engine's ``vmap``.

``cfg.shard_hints`` only places XLA sharding in the reference and changes
no value; the port ignores it (ROADMAP.md Queue 1 item 17).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.acquisition import select_topk
from repro_torch.nn import init as initializers
from repro_torch.nn.layers import device_matmul, mlp_apply, mlp_init

IMPLS = ("sort", "dense")


def moe_init(cfg, generator: torch.Generator):
    """One layer's MoE params (the reference's shapes and initializers)."""
    dtype = cfg.param_dtype
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_hidden
    ki = initializers.lecun_normal()
    p = {
        "router": {"kernel": ki((d, E), generator, torch.float32)},
        "experts": {
            "wi_gate": ki((E, d, f), generator, dtype),
            "wi_up": ki((E, d, f), generator, dtype),
            "wo": ki((E, f, d), generator, dtype),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(d, cfg.n_shared_experts * f, generator,
                               dtype=dtype)
    if cfg.moe_dense_residual:
        p["dense"] = mlp_init(d, cfg.d_ff, generator, dtype=dtype)
    return p


def capacity(cfg, S: int) -> int:
    """Slots an expert has in one group of ``S`` tokens."""
    E, K = cfg.n_experts, cfg.experts_top_k
    return max(K, int(S * K / E * cfg.router_capacity_factor))


def route(params, x: torch.Tensor, cfg):
    """The float32 router: ``(logits [..., E], probs, gates [..., K],
    experts [..., K])``, gates renormalised over the K picks."""
    logits = device_matmul(x.float(), params["router"]["kernel"].float())
    probs = torch.softmax(logits, dim=-1)
    experts = select_topk(probs, cfg.experts_top_k)
    gates = torch.gather(probs, -1, experts)
    return logits, probs, gates / gates.sum(dim=-1, keepdim=True), experts


def _group_dispatch(x_g, experts_g, E: int, C: int):
    """Every group's scatter into its expert buffer.

    x_g ``[G, S, d]`` tokens, experts_g ``[G, S, K]`` ids → ``(buffer [G,
    E, C, d], meta)`` for ``_group_combine``; ``meta``'s last entry is the
    keep mask ``[G, S·K]``, whose zeros are the capacity drops."""
    G, S, d = x_g.shape
    K = experts_g.shape[-1]
    flat_e = experts_g.reshape(G, S * K)
    order = torch.sort(flat_e, dim=-1, stable=True)[1]
    sorted_e = torch.gather(flat_e, 1, order)
    # rank within expert: index minus the first occurrence of the expert id
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(S * K, device=x_g.device) - first
    keep = pos < C
    pos_c = pos.clamp(max=C - 1)
    token_of = order // K
    rows = torch.arange(G, device=x_g.device)[:, None].expand(G, S * K)
    vals = torch.where(keep[..., None], x_g[rows, token_of],
                       torch.zeros((), dtype=x_g.dtype, device=x_g.device))
    buffer = torch.zeros((G, E, C, d), dtype=x_g.dtype,
                         device=x_g.device).index_put(
        (rows, sorted_e, pos_c), vals, accumulate=True)
    return buffer, (rows, order, sorted_e, pos_c, keep)


def _group_combine(out_buf, meta, gates_g):
    """Gather the expert outputs ``[G, E, C, d]`` back to token order and
    weight them by the gates ``[G, S, K]`` → ``[G, S, d]``."""
    rows, order, sorted_e, pos_c, keep = meta
    G, S, K = gates_g.shape
    y_sorted = out_buf[rows, sorted_e, pos_c] * keep[..., None]
    y = torch.empty_like(y_sorted).scatter(
        1, order[..., None].expand(y_sorted.shape), y_sorted)
    y = y.reshape(G, S, K, -1)
    return torch.einsum("gskd,gsk->gsd", y, gates_g.to(y.dtype))


def moe_apply(params, x: torch.Tensor, *, cfg, impl: str = "sort"):
    """x ``[D, Nb, S, d]`` over stacked params → ``(y [D, Nb, S, d], aux
    [D])``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}: use "
                         + " | ".join(IMPLS))
    Dn, Nb, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_top_k
    C = capacity(cfg, S)
    logits, probs, gates, experts = route(params, x, cfg)

    # ---- aux losses (load balance + router z), one a device -------------
    me = probs.mean(dim=(1, 2))                                   # [D, E]
    ce = F.one_hot(experts[..., 0], E).float().mean(dim=(1, 2))
    aux = cfg.router_aux_loss_weight * E * (me * ce).sum(dim=-1)
    aux = aux + 1e-4 * torch.square(torch.logsumexp(logits, dim=-1)).mean(
        dim=(1, 2))

    w = params["experts"]
    wg, wu, wo = (w[k].to(x.dtype) for k in ("wi_gate", "wi_up", "wo"))
    if impl == "dense":
        # every expert on every token: [D, E, Nb·S, ·]
        xs = x.reshape(Dn, 1, Nb * S, d)
        h = F.silu(torch.matmul(xs, wg)) * torch.matmul(xs, wu)
        all_out = torch.matmul(h, wo).reshape(Dn, E, Nb, S, d)
        w_full = (F.one_hot(experts, E).to(x.dtype)
                  * gates[..., None].to(x.dtype)).sum(dim=-2)   # [D, Nb, S, E]
        y = torch.einsum("debsm,dbse->dbsm", all_out, w_full)
    else:
        buffers, meta = _group_dispatch(x.reshape(Dn * Nb, S, d),
                                        experts.reshape(Dn * Nb, S, K), E, C)
        buffers = buffers.reshape(Dn, Nb, E, C, d)
        h = torch.einsum("dbecm,demf->dbecf", buffers, wg)
        h = F.silu(h) * torch.einsum("dbecm,demf->dbecf", buffers, wu)
        out_buf = torch.einsum("dbecf,defm->dbecm", h, wo)
        y = _group_combine(out_buf.reshape(Dn * Nb, E, C, d), meta,
                           gates.reshape(Dn * Nb, S, K)).reshape(Dn, Nb, S, d)

    if "shared" in params:
        y = y + mlp_apply(params["shared"], x, activation="swiglu")
    if "dense" in params:
        y = y + mlp_apply(params["dense"], x, activation="swiglu")
    return y, aux


def moe_router_entropy(params, x: torch.Tensor) -> torch.Tensor:
    """Router entropy ``[D, ...]`` of x ``[D, ..., d]``: an uncertainty
    signal for MoE models (beyond the paper)."""
    logp = torch.log_softmax(device_matmul(
        x.float(), params["router"]["kernel"].float()), dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)
