"""Decoder-only LM over a leading device axis (``repro.models.decoder``
ported: every layer type, without the decode caches).

The layer stack is the reference's: unrolled head layers
(``first_k_dense``), a repeating pattern unit (config ``attn_pattern``)
whose parameters are stacked across units, and unrolled tail layers.
``params["units"]`` keeps the unit axis, so weights carry across from the
JAX package leaf by leaf; stacked over devices a unit leaf is ``[D, U,
...]``.  The reference scans over units with ``jax.lax.scan``; here the
scan is a Python loop.

Layer types: ``S`` (global attention) and ``L`` (sliding window), GQA
or MLA (``use_mla``); ``R`` (Griffin's RG-LRU block); ``M`` (a Mamba-2
block on the plain SSD, no MLP); ``X`` (gated cross-attention to
``image_embeds``, with a ``tanh(gate_ffn)``-gated MLP).  The channel mix
is a dense MLP (SwiGLU, GeGLU or GELU) or, with ``n_experts > 0``, MoE
(not in the ``first_k_dense`` head layers, never in ``X`` layers).  Also
optional post-norms, ``residual_scale``, ``scale_embeddings``, the final
logit softcap and an untied unembedding.  The decode caches and the
``"blockwise"`` attention core raise ``NotImplementedError`` (ROADMAP.md
Queue 1 item 16).

Dropout sits where the reference puts it: after the attention branch and
after the MLP branch of every layer, active when ``deterministic`` is
False and ``dropout_rate > 0``.  The reference derives one key per layer
(``fold_in`` of the layer index); here the masks come from one
``torch.Generator`` in layer order — other bits, the same distribution.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn import embeddings as emb
from repro_torch.nn import init as initializers
from repro_torch.nn import layers as L
from repro_torch.nn.attention import (cross_attn_apply, cross_attn_init,
                                      gqa_apply, gqa_init)
from repro_torch.nn.mla import mla_apply, mla_init
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norms import (layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.rglru import recurrent_block_apply, recurrent_block_init
from repro_torch.nn.ssm import mamba2_apply, mamba2_init
from repro_torch.tree import tree_map

_UNPORTED = "ROADMAP.md Queue 1 item 16"
LAYER_TYPES = ("S", "L", "R", "M", "X")


def check_supported(cfg: ModelConfig, *, impl: str = "auto",
                    caches=None, decode: bool = False,
                    collect_prefill_caches: bool = False) -> None:
    """Raise for what the port does not run yet: an unknown layer type
    (``ValueError``, as the reference), and (``NotImplementedError``) the
    decode caches and the ``"blockwise"`` attention core."""
    bad = [t for t in cfg.attn_pattern if t not in LAYER_TYPES]
    if bad:
        raise ValueError(f"unknown decoder layer type {bad[0]!r}: use "
                         + " | ".join(LAYER_TYPES))
    if caches is not None or decode or collect_prefill_caches:
        raise NotImplementedError(
            f"decoder KV caches (prefill and decode) are not ported yet: "
            f"{_UNPORTED}")
    if impl == "blockwise":
        raise NotImplementedError(
            f"attention impl='blockwise' (the XLA scan over KV blocks) is not "
            f"ported yet: {_UNPORTED}")


def _norm_init(cfg, device, dim=None):
    dim = dim or cfg.d_model
    return (rmsnorm_init(dim, device=device) if cfg.norm == "rmsnorm"
            else layernorm_init(dim, device=device))


def _norm_apply(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm_apply(p, x)
    return layernorm_apply(p, x)


# ================================================================ layers
def layer_init(cfg: ModelConfig, ltype: str, generator: torch.Generator, *,
               is_head_layer: bool = False):
    """One layer's params; ``first_k_dense`` head layers take the dense
    MLP, and ``X`` layers never take MoE."""
    dev = generator.device
    p: Dict[str, Any] = {"attn_norm": _norm_init(cfg, dev)}
    if ltype in ("S", "L"):
        p["attn"] = (mla_init(cfg, generator) if cfg.use_mla
                     else gqa_init(cfg, generator))
        if cfg.use_post_norms:
            p["post_attn_norm"] = _norm_init(cfg, dev)
    elif ltype == "R":
        p["recurrent"] = recurrent_block_init(cfg, generator)
    elif ltype == "M":
        p["mamba"] = mamba2_init(cfg, generator)
        return p  # mamba blocks have no separate MLP
    elif ltype == "X":
        p["cross_attn"] = cross_attn_init(cfg, generator)
        p["gate_ffn"] = torch.zeros((), dtype=cfg.param_dtype, device=dev)
    else:
        raise ValueError(ltype)

    p["mlp_norm"] = _norm_init(cfg, dev)
    if cfg.n_experts > 0 and not is_head_layer and ltype != "X":
        p["moe"] = moe_init(cfg, generator)
    else:
        p["mlp"] = (L.mlp_gelu_init(cfg.d_model, cfg.d_ff, generator)
                    if cfg.activation == "gelu"
                    else L.mlp_init(cfg.d_model, cfg.d_ff, generator))
    if cfg.use_post_norms:
        p["post_mlp_norm"] = _norm_init(cfg, dev)
    return p


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig, ltype: str,
                positions: torch.Tensor, image_embeds=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, impl: str = "auto"):
    """One layer over stacked params: x ``[D, Nb, S, d_model]`` → ``(x,
    aux)``, aux the MoE layer's auxiliary loss ``[D]`` (None elsewhere)."""
    aux = None
    res_scale = cfg.residual_scale or 1.0

    def drop(h):
        if deterministic or cfg.dropout_rate == 0.0:
            return h
        return L.dropout(h, cfg.dropout_rate, generator=generator)

    # ---- sequence mixing ------------------------------------------------
    h = _norm_apply(cfg, params["attn_norm"], x)
    if ltype in ("S", "L"):
        if cfg.use_mla:
            h, _ = mla_apply(params["attn"], h, cfg=cfg, positions=positions,
                             impl=impl)
        else:
            window = cfg.sliding_window if ltype == "L" else None
            h = gqa_apply(params["attn"], h, cfg=cfg, positions=positions,
                          window=window, impl=impl)
    elif ltype == "R":
        h, _ = recurrent_block_apply(params["recurrent"], h, cfg=cfg)
    elif ltype == "M":
        # the plain SSD (no impl), as the reference's decoder calls it
        h = mamba2_apply(params["mamba"], h, cfg=cfg)
        return x + res_scale * drop(h), aux
    elif ltype == "X":
        if image_embeds is None:
            raise ValueError("a cross-attention ('X') layer needs "
                             "image_embeds: decoder_forward(image_embeds=...)")
        h = cross_attn_apply(params["cross_attn"], h, image_embeds, cfg=cfg,
                             impl=impl)
    else:
        raise ValueError(ltype)
    if "post_attn_norm" in params:
        h = _norm_apply(cfg, params["post_attn_norm"], h)
    x = x + res_scale * drop(h)

    # ---- channel mixing -------------------------------------------------
    h = _norm_apply(cfg, params["mlp_norm"], x)
    if "moe" in params:
        h, aux = moe_apply(params["moe"], h, cfg=cfg)
    elif cfg.activation == "gelu":
        h = L.mlp_gelu_apply(params["mlp"], h)
    else:
        h = L.mlp_apply(params["mlp"], h, activation=cfg.activation)
    if "post_mlp_norm" in params:
        h = _norm_apply(cfg, params["post_mlp_norm"], h)
    if ltype == "X":
        h = L.per_device(torch.tanh(params["gate_ffn"].to(h.dtype)), h) * h
    return x + res_scale * drop(h), aux


# ================================================================ model
def _layer_plan(cfg: ModelConfig) -> Tuple[List[str], List[str], List[str]]:
    """(head_types, pattern, tail_types), ``first_k_dense`` as head layers."""
    head = [cfg.attn_pattern[i % len(cfg.attn_pattern)]
            for i in range(cfg.first_k_dense)]
    return head, list(cfg.attn_pattern), list(cfg.tail_pattern)


def decoder_init(cfg: ModelConfig, generator: torch.Generator):
    """One model's params, with the reference's tree structure."""
    check_supported(cfg)
    head_types, pattern, tail_types = _layer_plan(cfg)
    U = cfg.pattern_units
    params: Dict[str, Any] = {"embed": emb.embed_init(
        cfg.vocab_size, cfg.d_model, generator, dtype=cfg.param_dtype)}
    params["head_layers"] = [layer_init(cfg, t, generator,
                                        is_head_layer=True)
                             for t in head_types]
    units = []
    for t in pattern:
        stacked = [layer_init(cfg, t, generator) for _ in range(U)]
        units.append(tree_map(lambda *xs: torch.stack(xs), *stacked))
    params["units"] = units
    params["tail_layers"] = [layer_init(cfg, t, generator)
                             for t in tail_types]
    params["final_norm"] = _norm_init(cfg, generator.device)
    if not cfg.tie_embeddings:
        params["unembed"] = {"kernel": initializers.lecun_normal()(
            (cfg.d_model, cfg.vocab_size), generator, cfg.param_dtype)}
    return params


def decoder_forward(params, tokens: torch.Tensor, *, cfg: ModelConfig,
                    image_embeds: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True, impl: str = "auto",
                    last_logit_only: bool = False, caches=None,
                    decode: bool = False,
                    collect_prefill_caches: bool = False):
    """Stacked params, tokens ``[D, Nb, S]`` (or ``[1, Nb, S]``, shared by
    every device) → ``(logits [D, Nb, S or 1, vocab], aux [D])``.

    ``aux`` is each device's sum of its MoE layers' auxiliary losses (0
    without MoE): the reference computes it inside the engine's ``vmap``,
    so its means run over one device's rows and tokens.  ``image_embeds``
    ``[D or 1, Nb, Skv, d_model]`` feed the ``X`` layers' keys and values.
    The decode caches (``caches``, ``decode``, ``collect_prefill_caches``)
    are not ported and raise."""
    check_supported(cfg, impl=impl, caches=caches, decode=decode,
                    collect_prefill_caches=collect_prefill_caches)
    head_types, pattern, tail_types = _layer_plan(cfg)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = emb.embed_apply(params["embed"], tokens, scale=cfg.scale_embeddings,
                        dtype=cfg.dtype)
    aux_total = None

    def run(p, x, t):
        nonlocal aux_total
        x, aux = layer_apply(p, x, cfg=cfg, ltype=t, positions=positions,
                             image_embeds=image_embeds, generator=generator,
                             deterministic=deterministic, impl=impl)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        return x

    for p, t in zip(params["head_layers"], head_types):
        x = run(p, x, t)
    for u in range(cfg.pattern_units):
        for p_idx, t in enumerate(pattern):
            x = run(tree_map(lambda a: a[:, u], params["units"][p_idx]), x, t)
    for p, t in zip(params["tail_layers"], tail_types):
        x = run(p, x, t)

    if last_logit_only:
        x = x[..., -1:, :]        # only the next-token logit is needed
    x = _norm_apply(cfg, params["final_norm"], x)
    logits = (emb.unembed_apply(params["embed"], x, tied=True)
              if cfg.tie_embeddings
              else L.device_matmul(x, params["unembed"]["kernel"].to(x.dtype)))
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if aux_total is None:
        aux_total = torch.zeros(x.shape[0], dtype=torch.float32,
                                device=x.device)
    return logits, aux_total
