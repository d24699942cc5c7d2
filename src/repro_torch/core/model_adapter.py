"""Model-adapter layer (``repro.core.model_adapter`` ported, LeNet only).

The engines never look inside the model; they need init / forward /
stochastic forward / loss, bundled as a ``ModelAdapter``.  In the port
every forward takes STACKED params ``[D, ...]`` and returns ``[D, N, C]``
logits, and ``loss`` returns one masked mean NLL per device ``[D]`` — the
engine differentiates their sum, which gives every device its own gradient
(the written-out form of the reference's ``vmap(grad)``).

The LM adapters (``DecoderLMAdapter``, ``SSMAdapter``) and
``excluded_paths`` arrive with the LM slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.nn.lenet import LeNet, LeNetConfig


class ModelAdapter:
    """Base adapter: shared masked-NLL loss + no excluded leaves."""

    config: Any = None

    def init(self, generator: torch.Generator):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError

    def stochastic_apply(self, params, x, generator: torch.Generator):
        raise NotImplementedError

    def loss(self, params, x, y, mask, generator: torch.Generator):
        """Masked mean NLL per device: x ``[D, M, ...]``, y and mask
        ``[D, M]`` → ``[D]``, with dropout active."""
        logp = torch.log_softmax(self.stochastic_apply(params, x, generator),
                                 dim=-1)
        nll = -torch.gather(logp, 2, y.long().unsqueeze(-1))[..., 0]
        return (nll * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)

    def aggregate_mask(self, path: str) -> bool:
        """True = leaf at flat key ``path`` stays per-device (out of Eq. 1)."""
        return False

    @property
    def num_classes(self) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class LeNetAdapter(ModelAdapter):
    """The paper's Bayesian LeNet (Table I) — the default adapter."""

    config: LeNetConfig = field(default_factory=LeNetConfig)

    def init(self, generator):
        return LeNet.init(generator, self.config)

    def apply(self, params, x):
        return LeNet.apply(params, x, cfg=self.config, deterministic=True)

    def stochastic_apply(self, params, x, generator):
        return LeNet.apply(params, x, cfg=self.config, generator=generator,
                           deterministic=False)

    @property
    def num_classes(self) -> int:
        return self.config.num_classes
