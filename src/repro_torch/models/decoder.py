"""Decoder-only LM over a leading device axis (``repro.models.decoder``
ported for dense global and sliding-window attention layers).

The layer stack is the reference's: unrolled head layers
(``first_k_dense``), a repeating pattern unit (config ``attn_pattern``)
whose parameters are stacked across units, and unrolled tail layers.
``params["units"]`` keeps the unit axis, so weights carry across from the
JAX package leaf by leaf; stacked over devices a unit leaf is ``[D, U,
...]``.  The reference scans over units with ``jax.lax.scan``; here the
scan is a Python loop.

Ported layer types: ``S`` (global attention) and ``L`` (sliding window),
each with a dense MLP (SwiGLU, GeGLU or GELU), optional post-norms,
``residual_scale``, ``scale_embeddings``, the final logit softcap and an
untied unembedding.  MoE, MLA, the ``R`` / ``M`` / ``X`` layers and the
decode caches raise ``NotImplementedError`` (ROADMAP.md Queue 1 item 16).

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
from repro_torch.nn.attention import gqa_apply, gqa_init
from repro_torch.nn.norms import (layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.tree import tree_map

_UNPORTED = "ROADMAP.md Queue 1 item 16"
LAYER_TYPES = ("S", "L")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the decoder families the port does
    not run yet."""
    bad = [t for t in cfg.attn_pattern if t not in LAYER_TYPES]
    what = None
    if cfg.n_experts > 0:
        what = "mixture-of-experts layers"
    elif cfg.use_mla:
        what = "multi-head latent attention"
    elif bad:
        what = {"R": "RG-LRU recurrent layers", "M": "Mamba-2 decoder layers",
                "X": "cross-attention layers"}.get(bad[0],
                                                   f"layer type {bad[0]!r}")
    if what is not None:
        raise NotImplementedError(
            f"decoder with {what} is not ported yet: {_UNPORTED}")


def _norm_init(cfg, device, dim=None):
    dim = dim or cfg.d_model
    return (rmsnorm_init(dim, device=device) if cfg.norm == "rmsnorm"
            else layernorm_init(dim, device=device))


def _norm_apply(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm_apply(p, x)
    return layernorm_apply(p, x)


# ================================================================ layers
def layer_init(cfg: ModelConfig, ltype: str, generator: torch.Generator):
    """One ``S`` or ``L`` layer's params."""
    if ltype not in LAYER_TYPES:
        check_supported(cfg)
        raise ValueError(ltype)
    dev = generator.device
    p: Dict[str, Any] = {"attn_norm": _norm_init(cfg, dev),
                         "attn": gqa_init(cfg, generator)}
    if cfg.use_post_norms:
        p["post_attn_norm"] = _norm_init(cfg, dev)
    p["mlp_norm"] = _norm_init(cfg, dev)
    p["mlp"] = (L.mlp_gelu_init(cfg.d_model, cfg.d_ff, generator)
                if cfg.activation == "gelu"
                else L.mlp_init(cfg.d_model, cfg.d_ff, generator))
    if cfg.use_post_norms:
        p["post_mlp_norm"] = _norm_init(cfg, dev)
    return p


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig, ltype: str,
                positions: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, impl: str = "auto"):
    """One layer over stacked params: x ``[D, Nb, S, d_model]``."""
    res_scale = cfg.residual_scale or 1.0

    def drop(h):
        if deterministic or cfg.dropout_rate == 0.0:
            return h
        return L.dropout(h, cfg.dropout_rate, generator=generator)

    h = _norm_apply(cfg, params["attn_norm"], x)
    window = cfg.sliding_window if ltype == "L" else None
    h = gqa_apply(params["attn"], h, cfg=cfg, positions=positions,
                  window=window, impl=impl)
    if "post_attn_norm" in params:
        h = _norm_apply(cfg, params["post_attn_norm"], h)
    x = x + res_scale * drop(h)

    h = _norm_apply(cfg, params["mlp_norm"], x)
    if cfg.activation == "gelu":
        h = L.mlp_gelu_apply(params["mlp"], h)
    else:
        h = L.mlp_apply(params["mlp"], h, activation=cfg.activation)
    if "post_mlp_norm" in params:
        h = _norm_apply(cfg, params["post_mlp_norm"], h)
    return x + res_scale * drop(h)


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
    params["head_layers"] = [layer_init(cfg, t, generator)
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
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True, impl: str = "auto",
                    last_logit_only: bool = False, caches=None,
                    decode: bool = False,
                    collect_prefill_caches: bool = False):
    """Stacked params, tokens ``[D, Nb, S]`` (or ``[1, Nb, S]``, shared by
    every device) → ``(logits [D, Nb, S or 1, vocab], aux_loss)``.  The
    dense layers add no auxiliary loss, so ``aux_loss`` is 0.  The decode
    caches (``caches``, ``decode``, ``collect_prefill_caches``) are not
    ported and raise."""
    if caches is not None or decode or collect_prefill_caches:
        raise NotImplementedError(
            f"decoder KV caches (prefill and decode) are not ported yet: "
            f"{_UNPORTED}")
    check_supported(cfg)
    head_types, pattern, tail_types = _layer_plan(cfg)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = emb.embed_apply(params["embed"], tokens, scale=cfg.scale_embeddings,
                        dtype=cfg.dtype)
    run = lambda p, x, t: layer_apply(
        p, x, cfg=cfg, ltype=t, positions=positions, generator=generator,
        deterministic=deterministic, impl=impl)

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
    return logits, torch.zeros((), device=logits.device)
