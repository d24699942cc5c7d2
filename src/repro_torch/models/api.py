"""Unified model API (``repro.models.api`` ported): ``build_model(cfg)``
→ a ``Model`` with init / apply / prefill / decode_step, for the
decoder families and for whisper (``family="encdec"``).

A ``Model`` speaks for ONE model, as the reference's does: params are
``decoder_init``'s or ``whisper_init``'s tree, tokens ``[B, S]``, caches
the reference's tree (``decoder_caches_init``,
``whisper_caches_init``).  Each call stacks them over a device axis of
one (views, no copies) for ``models.decoder`` or ``models.whisper`` and
hands back the unstacked results.  ``decode_step`` takes ``position``
as an int or a 0-dim tensor, reads it once on the host, writes the
token into the caches it is given, in place, and returns them.

``impl`` on ``apply``, ``prefill`` and ``decode_step`` chooses among the
reference's attention routes (``nn.attention``): ``"pallas"`` puts the
flash-attention kernel on the serve path.  ``extras`` carries the
modality inputs (``extra_input_shapes``): ``image_embeds`` of the VLM
family, whisper's ``frames``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.models import whisper as W
from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (decoder_caches_init, decoder_forward,
                                        decoder_init)
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (generator) -> params
    apply: Callable         # (params, tokens, *, generator, deterministic, extras, impl) -> (logits, aux)
    prefill: Callable       # (params, tokens, *, extras, max_cache_len, cache_dtype, impl) -> (last_logits, caches)
    decode_step: Callable   # (params, token, caches, *, position, extras, impl) -> (logits, caches)
    caches_init: Callable   # (batch, max_len, *, extras_shape, dtype, device) -> caches

    def extra_input_shapes(self, batch: int, seq_len: int) -> Dict[str, tuple]:
        """Shapes of the modality inputs this family takes."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return {"frames": (batch, seq_len, cfg.d_model)}
        if cfg.family == "vlm":
            return {"image_embeds": (batch, cfg.n_image_tokens, cfg.d_model)}
        return {}


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        return _build_whisper(cfg)
    return _build_decoder(cfg)


def _stacked(tree):
    return tree_map(lambda a: a[None], tree)


def _image(extras):
    image = (extras or {}).get("image_embeds")
    return None if image is None else image[None]


def _build_decoder(cfg: ModelConfig) -> Model:
    def init(generator: torch.Generator):
        return decoder_init(cfg, generator)

    def apply(params, tokens, *, generator=None, deterministic=True,
              extras=None, impl="auto"):
        logits, _, aux = decoder_forward(
            _stacked(params), tokens[None], cfg=cfg, image_embeds=_image(extras),
            generator=generator, deterministic=deterministic, impl=impl)
        return logits[0], aux[0]

    def prefill(params, tokens, *, extras=None, max_cache_len: int,
                cache_dtype=torch.bfloat16, impl="auto"):
        logits, caches, _ = decoder_forward(
            _stacked(params), tokens[None], cfg=cfg,
            image_embeds=_image(extras), collect_prefill_caches=True,
            max_cache_len=max_cache_len, cache_dtype=cache_dtype,
            last_logit_only=True, impl=impl)
        return logits[0], tree_map(lambda a: a[0], caches)

    def decode_step(params, token, caches, *, position, extras=None,
                    impl="auto"):
        # an int or a 0-dim tensor: read once a step, on the host
        position = int(position)
        logits, _, _ = decoder_forward(
            _stacked(params), token[None], cfg=cfg, positions=position,
            caches=_stacked(caches), decode=True,
            image_embeds=_image(extras), impl=impl)
        return logits[0], caches

    def caches_init(batch: int, max_len: int, *, extras_shape=None,
                    dtype=torch.bfloat16, device=None):
        return decoder_caches_init(cfg, batch, max_len, dtype=dtype,
                                   device=device)

    return Model(cfg=cfg, init=init, apply=apply, prefill=prefill,
                 decode_step=decode_step, caches_init=caches_init)


def _build_whisper(cfg: ModelConfig) -> Model:
    def init(generator: torch.Generator):
        return W.whisper_init(cfg, generator)

    def apply(params, tokens, *, generator=None, deterministic=True,
              extras=None, impl="auto"):
        p = _stacked(params)
        enc_out = W.encode(p, extras["frames"][None], cfg=cfg, impl=impl)
        logits = W.decode_train(p, tokens[None], enc_out, cfg=cfg,
                                impl=impl)
        return logits[0], torch.zeros((), device=logits.device)

    def prefill(params, tokens, *, extras=None, max_cache_len: int,
                cache_dtype=torch.bfloat16, impl="auto"):
        logits, caches = W.prefill(
            _stacked(params), tokens[None], extras["frames"][None], cfg=cfg,
            max_cache_len=max_cache_len, cache_dtype=cache_dtype, impl=impl)
        return logits[0], tree_map(lambda a: a[0], caches)

    def decode_step(params, token, caches, *, position, extras=None,
                    impl="auto"):
        logits, _ = W.decode_step(_stacked(params), token[None],
                                  _stacked(caches), cfg=cfg,
                                  position=int(position), impl=impl)
        return logits[0], caches

    def caches_init(batch: int, max_len: int, *, extras_shape=None,
                    dtype=torch.bfloat16, device=None):
        enc_len = (extras_shape["frames"][1] if extras_shape
                   else cfg.encoder_seq_len)
        return W.whisper_caches_init(cfg, batch, max_len, enc_len,
                                     dtype=dtype, device=device)

    return Model(cfg=cfg, init=init, apply=apply, prefill=prefill,
                 decode_step=decode_step, caches_init=caches_init)
