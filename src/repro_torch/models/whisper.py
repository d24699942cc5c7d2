"""Whisper-style encoder-decoder over a leading device axis
(``repro.models.whisper`` ported, arXiv:2212.04356).

The conv / mel frontend is a stub, as in the reference: the model takes
frame embeddings ``[D or 1, B, S_enc, d_model]``.  Downstream of it:
sinusoidal encoder positions, a bidirectional encoder, a causal decoder
with cross-attention to the encoder output, learned decoder positions,
pre-LayerNorm, biased projections (``wq``, ``wv`` and ``wo``; ``wk``
has none) and GELU MLPs with biases, and the tied unembedding.

Params are the reference's tree: ``embed``, ``dec_pos``, ``encoder`` and
``decoder`` (every leaf stacked over layers, ``[L, ...]``),
``enc_final_norm`` and ``dec_final_norm``, so ``interop.params_from_jax``
carries the reference's weights across unchanged.  Stacked over devices
a layer leaf is ``[D, L, ...]``; the reference scans over layers, here a
Python loop takes the layer slices.  ``remat`` changes no value and is
ignored.

Decode caches are the reference's tree, one entry a decoder layer
stacked over layers: ``{"self": {"k", "v": [L, B, max_len, Hkv, hd],
"pos": [L, max_len]}, "ck", "cv": [L, B, enc_len, Hkv, hd]}`` (``[D,
...]`` in front here).  Prefill projects the cross keys and values once
from the encoder output and stores them in ``cache_dtype``; a decode
step writes only the ``"self"`` slot of its position, in place, and
returns the tree it was given.

``impl`` chooses the attention route of every call (``nn.attention``);
``_attend`` says how each attention meets the kernel route, which knows
positions only as a host-side ``q_offset``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.nn import embeddings as emb
from repro_torch.nn import layers as L
from repro_torch.nn.attention import (_proj, attention_core,
                                      cache_from_prefill,
                                      cache_update_decode, gqa_init,
                                      init_cache)
from repro_torch.nn.norms import layernorm_apply, layernorm_init
from repro_torch.nn.shard_hints import merge_heads
from repro_torch.tree import tree_map


def _attend(params, q, k, v, *, causal: bool, impl: str, q_pos=None,
            kv_pos=None, decode_position: Optional[int] = None):
    """Attention of q ``[D, B, Sq, H, hd]`` over k, v ``[D, B, Skv, Hkv,
    hd]``, then ``wo``: → ``[D, B, Sq, d_model]``.

    The reference passes position tensors everywhere; where the queries
    and the keys sit at consecutive positions from 0, or the mask is
    non-causal over keys that fill every slot, they change nothing, and
    the core's default (none) gives the same mask on every route.  The
    kernel route refuses position tensors without ``decode_position``
    (the host-side int), so: the encoder and every cross-attention
    ``causal=False`` with no positions; train and prefill self-attention
    ``causal=True`` with none (``q_offset`` 0); decode self-attention
    ``decode_position`` against the full cache (``q_offset =
    position``), with the reference's tensors (``q_pos``, and the
    cache's ``pos`` that marks the empty slots) for the other routes.
    The cross-attention of a decode step takes no ``decode_position``:
    a non-causal query with one is refused against a cache that has not
    wrapped (``_pallas_positions``)."""
    Dn, B, Sq = q.shape[:3]
    fold = lambda t: t.reshape((Dn * B,) + tuple(t.shape[2:]))
    out = attention_core(fold(q), fold(k), fold(v), q_pos=q_pos,
                         kv_pos=kv_pos, causal=causal, impl=impl,
                         decode_position=decode_position)
    return L.dense_apply(params["wo"], merge_heads(out).reshape(Dn, B, Sq,
                                                                -1))


def _attn(params, x, kv, *, cfg: ModelConfig, causal: bool, impl: str):
    """Queries from x ``[D, B, Sq, d]``, keys and values from kv ``[D, B,
    Skv, d]``, both at consecutive positions from 0."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(params["wq"], x, H, hd)
    k = _proj(params["wk"], kv, Hkv, hd)
    v = _proj(params["wv"], kv, Hkv, hd)
    return _attend(params, q, k, v, causal=causal, impl=impl)


def _layer(params, l: int):
    """Layer ``l`` of a ``[D, L, ...]`` stack (views)."""
    return tree_map(lambda a: a[:, l], params)


# ================================================================ init
def _enc_layer_init(cfg: ModelConfig, generator: torch.Generator):
    dev = generator.device
    return {"attn_norm": layernorm_init(cfg.d_model, device=dev),
            "attn": gqa_init(cfg, generator),
            "mlp_norm": layernorm_init(cfg.d_model, device=dev),
            "mlp": L.mlp_gelu_init(cfg.d_model, cfg.d_ff, generator)}


def _dec_layer_init(cfg: ModelConfig, generator: torch.Generator):
    dev = generator.device
    return {"attn_norm": layernorm_init(cfg.d_model, device=dev),
            "attn": gqa_init(cfg, generator),
            "cross_norm": layernorm_init(cfg.d_model, device=dev),
            "cross": gqa_init(cfg, generator),
            "mlp_norm": layernorm_init(cfg.d_model, device=dev),
            "mlp": L.mlp_gelu_init(cfg.d_model, cfg.d_ff, generator)}


def whisper_init(cfg: ModelConfig, generator: torch.Generator):
    """One model's params, the reference's tree, leaves and dtypes (the
    LayerNorms and the MLPs float32, the rest ``param_dtype``)."""
    stack = lambda layers: tree_map(lambda *xs: torch.stack(xs), *layers)
    dev = generator.device
    return {
        "embed": emb.embed_init(cfg.vocab_size, cfg.d_model, generator,
                                dtype=cfg.param_dtype),
        "dec_pos": emb.learned_positions_init(cfg.max_seq_len, cfg.d_model,
                                              generator,
                                              dtype=cfg.param_dtype),
        "encoder": stack([_enc_layer_init(cfg, generator)
                          for _ in range(cfg.n_encoder_layers)]),
        "decoder": stack([_dec_layer_init(cfg, generator)
                          for _ in range(cfg.n_layers)]),
        "enc_final_norm": layernorm_init(cfg.d_model, device=dev),
        "dec_final_norm": layernorm_init(cfg.d_model, device=dev),
    }


# ================================================================ forward
def encode(params, frames: torch.Tensor, *, cfg: ModelConfig,
           impl: str = "auto") -> torch.Tensor:
    """Stacked params, frames ``[D or 1, B, S_enc, d_model]`` (the stub
    frontend's output) → encoder states ``[D, B, S_enc, d_model]``."""
    S = frames.shape[2]
    x = frames.to(cfg.dtype) + emb.sinusoidal_positions(
        S, cfg.d_model, dtype=cfg.dtype, device=frames.device)
    for l in range(cfg.n_encoder_layers):
        p = _layer(params["encoder"], l)
        h = layernorm_apply(p["attn_norm"], x)
        x = x + _attn(p["attn"], h, h, cfg=cfg, causal=False, impl=impl)
        h = layernorm_apply(p["mlp_norm"], x)
        x = x + L.mlp_gelu_apply(p["mlp"], h)
    return layernorm_apply(params["enc_final_norm"], x)


def _embed(params, tokens, rows, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings plus the learned positions ``rows`` (a slice for
    a sequence, an int for a decode step), both in ``cfg.dtype``.  An
    index past ``dec_pos`` raises (the reference clamps it)."""
    x = emb.embed_apply(params["embed"], tokens, dtype=cfg.dtype)
    pos = params["dec_pos"]["embedding"][:, rows].to(cfg.dtype)
    if pos.dim() == 2:          # a decode step's one row
        pos = pos[:, None]
    return x + pos[:, None]


def _final(params, x) -> torch.Tensor:
    x = layernorm_apply(params["dec_final_norm"], x)
    return emb.unembed_apply(params["embed"], x, tied=True)


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                 cfg: ModelConfig, impl: str = "auto") -> torch.Tensor:
    """Teacher-forced decoder pass: tokens ``[D or 1, B, S]`` against
    ``enc_out [D, B, S_enc, d_model]`` → logits ``[D, B, S, vocab]``."""
    x = _embed(params, tokens, slice(0, tokens.shape[-1]), cfg)
    for l in range(cfg.n_layers):
        p = _layer(params["decoder"], l)
        h = layernorm_apply(p["attn_norm"], x)
        x = x + _attn(p["attn"], h, h, cfg=cfg, causal=True, impl=impl)
        h = layernorm_apply(p["cross_norm"], x)
        x = x + _attn(p["cross"], h, enc_out, cfg=cfg, causal=False,
                      impl=impl)
        h = layernorm_apply(p["mlp_norm"], x)
        x = x + L.mlp_gelu_apply(p["mlp"], h)
    return _final(params, x)


def whisper_caches_init(cfg: ModelConfig, batch: int, max_len: int,
                        enc_len: int, *, dtype=torch.bfloat16, device=None):
    """One model's empty decode caches, the reference's tree."""
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    zeros = lambda: torch.zeros((batch, enc_len, Hkv, hd), dtype=dtype,
                                device=device)
    one = {"self": init_cache(batch, max_len, Hkv, hd, kind="full",
                              dtype=dtype, device=device),
           "ck": zeros(), "cv": zeros()}
    return tree_map(lambda a: torch.stack([a] * cfg.n_layers), one)


def prefill(params, tokens: torch.Tensor, frames: torch.Tensor, *,
            cfg: ModelConfig, max_cache_len: int,
            cache_dtype=torch.bfloat16, impl: str = "auto"):
    """Encode, then the teacher-forced decoder over the prompt: →
    ``(logits [D, B, 1, vocab]`` of the last token, the decode caches
    ``[D, L, ...]``).  The self and cross keys and values are projected
    once, attended to as computed and stored in ``cache_dtype``."""
    enc_out = encode(params, frames, cfg=cfg, impl=impl)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = _embed(params, tokens, slice(0, tokens.shape[-1]), cfg)
    caches = None
    for l in range(cfg.n_layers):
        p = _layer(params["decoder"], l)
        h = layernorm_apply(p["attn_norm"], x)
        k = _proj(p["attn"]["wk"], h, Hkv, hd)
        v = _proj(p["attn"]["wv"], h, Hkv, hd)
        x = x + _attend(p["attn"], _proj(p["attn"]["wq"], h, H, hd), k, v,
                        causal=True, impl=impl)
        h = layernorm_apply(p["cross_norm"], x)
        ck = _proj(p["cross"]["wk"], enc_out, Hkv, hd)
        cv = _proj(p["cross"]["wv"], enc_out, Hkv, hd)
        x = x + _attend(p["cross"], _proj(p["cross"]["wq"], h, H, hd), ck,
                        cv, causal=False, impl=impl)
        h = layernorm_apply(p["mlp_norm"], x)
        x = x + L.mlp_gelu_apply(p["mlp"], h)
        cache = {"self": cache_from_prefill(k, v, kind="full",
                                            max_len=max_cache_len,
                                            window=None, dtype=cache_dtype),
                 "ck": ck.to(cache_dtype), "cv": cv.to(cache_dtype)}
        if caches is None:      # [D, L, ...], filled a layer at a time
            caches = tree_map(lambda a: a.new_empty(
                (a.shape[0], cfg.n_layers) + tuple(a.shape[1:])), cache)
        tree_map(lambda st, a: st[:, l].copy_(a), caches, cache)
    return _final(params, x[..., -1:, :]), caches   # next-token logit only


def decode_step(params, token: torch.Tensor, caches, *, cfg: ModelConfig,
                position: int, impl: str = "auto"):
    """One decoder token ``[D or 1, B, 1]`` at the host-side ``position``
    against the stacked caches → ``(logits [D, B, 1, vocab], caches)``,
    each layer's ``"self"`` slot written in place."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = _embed(params, token, position, cfg)
    q_pos = torch.arange(position, position + 1, dtype=torch.int32,
                         device=x.device)     # built on the device, no copy
    for l in range(cfg.n_layers):
        p, cache = _layer(params["decoder"], l), _layer(caches, l)
        h = layernorm_apply(p["attn_norm"], x)
        q = _proj(p["attn"]["wq"], h, H, hd)
        sc = cache_update_decode(cache["self"],
                                 _proj(p["attn"]["wk"], h, Hkv, hd),
                                 _proj(p["attn"]["wv"], h, Hkv, hd),
                                 position)
        # every device decodes at the same position: the rows of a
        # stacked pos are equal
        kv_pos = sc["pos"].reshape(-1, sc["pos"].shape[-1])[0]
        x = x + _attend(p["attn"], q, sc["k"].to(q.dtype),
                        sc["v"].to(q.dtype), causal=True, impl=impl,
                        q_pos=q_pos, kv_pos=kv_pos, decode_position=position)
        h = layernorm_apply(p["cross_norm"], x)
        q = _proj(p["cross"]["wq"], h, H, hd)
        x = x + _attend(p["cross"], q, cache["ck"].to(q.dtype),
                        cache["cv"].to(q.dtype), causal=False, impl=impl)
        h = layernorm_apply(p["mlp_norm"], x)
        x = x + L.mlp_gelu_apply(p["mlp"], h)
    return _final(params, x), caches
