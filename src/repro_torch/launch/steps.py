"""Step factories (``repro.launch.steps`` ported, the serving half):
``make_prefill_step`` and ``make_decode_step``.  The train, federated and
score steps are ROADMAP.md Queue 1 item 16d."""
from __future__ import annotations

import torch

from repro_torch.models.api import Model


def make_prefill_step(model: Model, *, max_cache_len: int,
                      cache_dtype=torch.bfloat16, impl: str = "auto"):
    def prefill_step(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return model.prefill(params, batch["tokens"], extras=extras or None,
                             max_cache_len=max_cache_len,
                             cache_dtype=cache_dtype, impl=impl)

    return prefill_step


def make_decode_step(model: Model, *, impl: str = "auto"):
    def decode_step(params, token, caches, position, extras=None):
        return model.decode_step(params, token, caches, position=position,
                                 extras=extras, impl=impl)

    return decode_step
