"""Decoder-only LM over a leading device axis (``repro.models.decoder``
ported: every layer type, train, prefill and decode).

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
logit softcap and an untied unembedding.

Decode caches are the reference's tree ``{"head": [...], "units": [...],
"tail": [...]}``, one cache a layer and, under ``units``, each pattern
position's caches stacked over units: GQA ``{"k", "v", "pos"}`` (a ring
on ``L`` layers), MLA ``{"ckv", "krope", "pos"}``, ``R`` and ``M``
``{"conv", "state"}`` and ``X`` ``{}`` (its keys come from the image
tokens).  ``decoder_caches_init`` gives one model's; ``decoder_forward``
takes and returns them stacked over devices (``[D, ...]``, a unit leaf
``[D, U, ...]``).  Only the attention and latent caches take
``cache_dtype``: ``R`` and ``M`` prefill caches keep the conv tail in
the activation dtype and the state as computed, and their empty caches
are float32.  A decode step writes each layer's new entries INTO the
caches it is given and returns that same tree: do not reuse a cache
after a step expecting the old contents.

Dropout sits where the reference puts it: after the attention branch and
after the MLP branch of every layer, active when ``deterministic`` is
False and ``dropout_rate > 0``.  The reference derives one key per layer
(``fold_in`` of the layer index); here the masks come from one
``torch.Generator`` in layer order — other bits, the same distribution.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn import embeddings as emb
from repro_torch.nn import init as initializers
from repro_torch.nn import layers as L
from repro_torch.nn.attention import (IMPLS, cache_from_prefill,
                                      cross_attn_apply, cross_attn_init,
                                      gqa_apply, gqa_init, init_cache)
from repro_torch.nn.mla import (mla_apply, mla_cache_from_prefill,
                                mla_decode, mla_init, mla_init_cache)
from repro_torch.nn.moe import moe_apply, moe_init
from repro_torch.nn.norms import (layernorm_apply, layernorm_init,
                                  rmsnorm_apply, rmsnorm_init)
from repro_torch.nn.shard_hints import copy_into_stack, empty_stack
from repro_torch.nn.rglru import (recurrent_block_apply,
                                  recurrent_block_init,
                                  recurrent_block_init_cache)
from repro_torch.nn.ssm import (mamba2_apply, mamba2_decode, mamba2_init,
                                mamba2_init_cache)
from repro_torch.tree import tree_map

LAYER_TYPES = ("S", "L", "R", "M", "X")


def check_supported(cfg: ModelConfig, *, impl: str = "auto") -> None:
    """Raise ``ValueError`` on an unknown layer type (as the reference)
    or attention route."""
    bad = [t for t in cfg.attn_pattern if t not in LAYER_TYPES]
    if bad:
        raise ValueError(f"unknown decoder layer type {bad[0]!r}: use "
                         + " | ".join(LAYER_TYPES))
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}: use "
                         + " | ".join(IMPLS))


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
                positions: torch.Tensor, position: Optional[int] = None,
                cache=None, decode: bool = False, image_embeds=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, impl: str = "auto",
                collect_cache: bool = False):
    """One layer over stacked params: x ``[D, Nb, S, d_model]`` → ``(x,
    new_cache, aux)``.  ``new_cache`` is the layer's updated cache in
    decode, its prefill output with ``collect_cache`` (GQA ``(k, v)``, MLA
    ``(ckv, krope)``, ``R`` / ``M`` their decode cache, ``X`` ``{}``),
    else None; aux the MoE layer's auxiliary loss ``[D]`` (None
    elsewhere).  ``position`` is the host-side int of the first token
    (``gqa_apply``)."""
    aux = new_cache = None
    res_scale = cfg.residual_scale or 1.0

    def drop(h):
        if deterministic or cfg.dropout_rate == 0.0:
            return h
        return L.dropout(h, cfg.dropout_rate, generator=generator)

    # ---- sequence mixing ------------------------------------------------
    h = _norm_apply(cfg, params["attn_norm"], x)
    if ltype in ("S", "L"):
        if cfg.use_mla and decode:
            h, new_cache = mla_decode(params["attn"], h, cache, cfg=cfg,
                                      position=position)
        elif cfg.use_mla:
            h, new_cache = mla_apply(params["attn"], h, cfg=cfg,
                                     positions=positions, impl=impl)
        else:
            window = cfg.sliding_window if ltype == "L" else None
            h, new_cache = gqa_apply(params["attn"], h, cfg=cfg,
                                     positions=positions, window=window,
                                     cache=cache, decode=decode, impl=impl,
                                     position=position)
    elif ltype == "R":
        h, new_cache = recurrent_block_apply(params["recurrent"], h, cfg=cfg,
                                             cache=cache, decode=decode)
    elif ltype == "M":
        # the plain SSD (no impl), as the reference's decoder calls it
        if decode:
            h, new_cache = mamba2_decode(params["mamba"], h, cache, cfg=cfg)
        elif collect_cache:
            h, new_cache = mamba2_apply(params["mamba"], h, cfg=cfg,
                                        return_cache=True)
        else:
            h = mamba2_apply(params["mamba"], h, cfg=cfg)
        return x + res_scale * drop(h), new_cache, aux
    elif ltype == "X":
        if image_embeds is None:
            raise ValueError("a cross-attention ('X') layer needs "
                             "image_embeds: decoder_forward(image_embeds=...)")
        h = cross_attn_apply(params["cross_attn"], h, image_embeds, cfg=cfg,
                             impl=impl)
        new_cache = {}
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
    return x + res_scale * drop(h), new_cache, aux


def layer_cache_init(cfg: ModelConfig, ltype: str, batch: int, max_len: int,
                     *, dtype=torch.bfloat16, device=None):
    """One layer's empty decode cache for one model."""
    if ltype in ("S", "L"):
        if cfg.use_mla:
            return mla_init_cache(batch, max_len, cfg, dtype=dtype,
                                  device=device)
        window = cfg.sliding_window if ltype == "L" else None
        return init_cache(batch, max_len, cfg.n_kv_heads,
                          cfg.resolved_head_dim,
                          kind="full" if window is None else "ring",
                          window=window, dtype=dtype, device=device)
    if ltype == "R":
        return recurrent_block_init_cache(batch, cfg, device=device)
    if ltype == "M":
        return mamba2_init_cache(batch, cfg, device=device)
    if ltype == "X":
        return {}  # cross-attention keys come from the image tokens
    raise ValueError(ltype)


def _cacheify(cfg: ModelConfig, ltype: str, out, max_len: int, dtype):
    """A layer's prefill output → its decode cache (``[D, ...]``)."""
    if ltype in ("S", "L") and cfg.use_mla:
        ckv, krope = out
        return mla_cache_from_prefill(ckv, krope, max_len=max_len,
                                      dtype=dtype)
    if ltype in ("S", "L"):
        k, v = out
        window = cfg.sliding_window if ltype == "L" else None
        return cache_from_prefill(k, v,
                                  kind="full" if window is None else "ring",
                                  max_len=max_len, window=window, dtype=dtype)
    return out  # R, M: already {"conv", "state"}; X: {}


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


def decoder_caches_init(cfg: ModelConfig, batch: int, max_len: int, *,
                        dtype=torch.bfloat16, device=None):
    """One model's empty decode caches, the reference's tree (stack them
    over devices for ``decoder_forward``)."""
    head_types, pattern, tail_types = _layer_plan(cfg)
    one = lambda t: layer_cache_init(cfg, t, batch, max_len, dtype=dtype,
                                     device=device)
    U = cfg.pattern_units
    return {"head": [one(t) for t in head_types],
            "units": [tree_map(lambda a: torch.stack([a] * U), one(t))
                      for t in pattern],
            "tail": [one(t) for t in tail_types]}


def decoder_forward(params, tokens: torch.Tensor, *, cfg: ModelConfig,
                    positions: Union[None, int, torch.Tensor] = None,
                    caches=None, decode: bool = False,
                    image_embeds: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    deterministic: bool = True, impl: str = "auto",
                    collect_prefill_caches: bool = False,
                    max_cache_len: int = 0, cache_dtype=torch.bfloat16,
                    last_logit_only: bool = False):
    """Stacked params, tokens ``[D, Nb, S]`` (or ``[1, Nb, S]``, shared by
    every device) → ``(logits [D, Nb, S or 1, vocab], new_caches, aux
    [D])``, the reference's triple:

    * train: ``new_caches`` None;
    * prefill (``collect_prefill_caches``): the decode caches holding the
      sequence, ``max_cache_len`` slots (a ring: the window), attention
      and latent caches in ``cache_dtype``;
    * decode (``decode=True``, ``caches`` given, tokens ``[D, Nb, 1]``):
      ``caches`` itself, each layer's slot written in place.

    ``positions`` is the host-side ``int`` position of the first token
    (None: 0), or a tensor ``[S]`` of positions as the reference takes
    them; decode and ``impl="pallas"`` need the int (the kernel route
    maps positions on the host).

    ``aux`` is each device's sum of its MoE layers' auxiliary losses (0
    without MoE): the reference computes it inside the engine's ``vmap``,
    so its means run over one device's rows and tokens.  ``image_embeds``
    ``[D or 1, Nb, Skv, d_model]`` feed the ``X`` layers' keys and values."""
    check_supported(cfg, impl=impl)
    head_types, pattern, tail_types = _layer_plan(cfg)
    S = tokens.shape[-1]
    if positions is None or isinstance(positions, int):
        position = positions or 0
        positions = torch.arange(position, position + S, dtype=torch.int32,
                                 device=tokens.device)
    else:
        position = None
        if decode or impl == "pallas":
            raise ValueError("decode and impl='pallas' need the host-side "
                             "position: pass positions as an int")
    if decode and caches is None:
        raise ValueError("decode=True needs caches")
    x = emb.embed_apply(params["embed"], tokens, scale=cfg.scale_embeddings,
                        dtype=cfg.dtype)
    aux_total = None

    def run(p, x, t, cache):
        nonlocal aux_total
        x, nc, aux = layer_apply(
            p, x, cfg=cfg, ltype=t, positions=positions, position=position,
            cache=cache, decode=decode, image_embeds=image_embeds,
            generator=generator, deterministic=deterministic, impl=impl,
            collect_cache=collect_prefill_caches)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
        if collect_prefill_caches and not decode:
            return x, _cacheify(cfg, t, nc, max_cache_len, cache_dtype)
        return x, None

    collected: Dict[str, Any] = {"head": [], "units": [], "tail": []}
    for i, (p, t) in enumerate(zip(params["head_layers"], head_types)):
        x, c = run(p, x, t, caches["head"][i] if decode else None)
        collected["head"].append(c)
    U = cfg.pattern_units
    stacks: List[Any] = [None] * len(pattern)
    for u in range(U):
        for p_idx, t in enumerate(pattern):
            # views of the [D, U, ...] stacks: decode writes land in them
            c = (tree_map(lambda a: a[:, u], caches["units"][p_idx])
                 if decode else None)
            x, c = run(tree_map(lambda a: a[:, u], params["units"][p_idx]),
                       x, t, c)
            if c is not None:   # a prefill's cache, into its unit's slot
                if stacks[p_idx] is None:
                    stacks[p_idx] = tree_map(lambda a: empty_stack(a, U),
                                             c)
                tree_map(lambda st, a: copy_into_stack(st, u, a),
                         stacks[p_idx], c)
    collected["units"] = stacks
    for i, (p, t) in enumerate(zip(params["tail_layers"], tail_types)):
        x, c = run(p, x, t, caches["tail"][i] if decode else None)
        collected["tail"].append(c)

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
    new_caches = (caches if decode
                  else collected if collect_prefill_caches else None)
    return logits, new_caches, aux_total
