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

With ``cfg.shard_hints`` under a mesh, the expert buffers, their hidden
states and their outputs are placed groups over ``data`` and experts
over ``model`` (the all-to-all boundary of expert parallelism), the
reference's three hint sites (``nn.shard_hints``); no value changes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.acquisition import select_topk
from repro_torch.nn import init as initializers
from repro_torch.nn.layers import device_matmul, mlp_apply, mlp_init
from repro_torch.nn.shard_hints import hint

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


def _groups_local(fn, *args):
    """``fn`` on this rank's groups: DTensor args (``[G, ...]``) are
    placed with their group dim over the batch axes where those divide
    G, whole elsewhere, and ``fn`` runs on their local tensors; a DTensor
    in, so tensor results come back as DTensors placed so (the rest as
    they are).  The sort, scan and scatter of a dispatch are local to a
    group: DTensor has no sharding rule for them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    ref = next((a for a in args if hasattr(a, "device_mesh")), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    batch = [i for i, n in enumerate(mesh.mesh_dim_names)
             if n in ("pod", "data")]
    split = ref.shape[0] % max(1, math.prod(mesh.size(i)
                                            for i in batch)) == 0
    pl = [Shard(0) if (i in batch and split) else Replicate()
          for i in range(mesh.ndim)]
    local = [a.redistribute(mesh, pl).to_local()
             if hasattr(a, "device_mesh") else a for a in args]
    wrap = lambda t: DTensor.from_local(t, mesh, pl, run_check=False)
    out = fn(*local)
    return (wrap(out[0]),) + tuple(out[1:]) if isinstance(out, tuple) \
        else wrap(out)


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
        buffers, meta = _groups_local(
            lambda xg, eg: _group_dispatch(xg, eg, E, C),
            x.reshape(Dn * Nb, S, d), experts.reshape(Dn * Nb, S, K))
        place = ((lambda t: hint(t, "data", "model", None, None))
                 if cfg.shard_hints else (lambda t: t))
        buffers = place(buffers.reshape(Dn, Nb, E, C, d))
        # batched GEMMs over [D, E, Nb·C, ·]
        xb = buffers.permute(0, 2, 1, 3, 4).reshape(Dn, E, Nb * C, d)
        h = F.silu(torch.matmul(xb, wg)) * torch.matmul(xb, wu)
        if cfg.shard_hints:
            h = hint(h, "model", "data", None)
        out_buf = place(torch.matmul(h, wo).reshape(
            Dn, E, Nb, C, d).permute(0, 2, 1, 3, 4))
        y = _groups_local(
            lambda ob, gg: _group_combine(ob, meta, gg),
            out_buf.reshape(Dn * Nb, E, C, d),
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
