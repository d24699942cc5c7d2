"""Model-adapter layer (``repro.core.model_adapter`` ported): LeNet, the
decoder LM and the Mamba-2 SSM LM.

The engines never look inside the model; they need init / forward /
stochastic forward / loss, bundled as a ``ModelAdapter``.  In the port
every forward takes STACKED params ``[D, ...]`` and returns ``[D, N, C]``
logits, and ``loss`` returns one masked mean NLL per device ``[D]`` — the
engine differentiates their sum, which gives every device its own gradient
(the written-out form of the reference's ``vmap(grad)``).

``sample_ndim`` is the rank of one sample: 3 for LeNet's ``[28, 28, 1]``
images, 1 for the LM adapters' ``[S]`` int32 token sequences.  Inputs are
``[D, N, *sample]`` per device or ``[N, *sample]`` shared by every device
(a validation set).  ``eval_rows`` bounds the device-rows of one batched
no-grad forward.

LM adapters score the NEXT-TOKEN distribution at the final position, so a
"label" is the target continuation token.  ``impl`` selects the attention
or SSD core of the no-grad forwards (evaluation and MC scoring):
``"pallas"`` routes them through the hand-written kernels
(``kernels.flash_attention`` / ``kernels.ssd_scan``), the name the JAX
package uses for its Pallas kernels.  The differentiated loss always takes
the plain, differentiable cores, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.decoder import (check_supported, decoder_forward,
                                        decoder_init)
from repro_torch.nn import embeddings as emb
from repro_torch.nn import layers
from repro_torch.nn.lenet import LeNet, LeNetConfig
from repro_torch.nn.norms import rmsnorm_apply, rmsnorm_init
from repro_torch.nn.ssm import mamba2_apply, mamba2_init, ssm_dims
from repro_torch.tree import tree_items


def masked_nll(logits: torch.Tensor, y: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Masked mean NLL per device: logits ``[D, M, C]``, y and mask ``[D,
    M]`` → ``[D]``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, y.long().unsqueeze(-1))[..., 0]
    return (nll * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)


class ModelAdapter:
    """Base adapter: shared masked-NLL loss + no excluded leaves."""

    config: Any = None
    sample_ndim: ClassVar[int] = 3
    eval_rows: ClassVar[int] = 16384

    def init(self, generator: torch.Generator):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError

    def stochastic_apply(self, params, x, generator: torch.Generator):
        raise NotImplementedError

    def loss(self, params, x, y, mask, generator: torch.Generator):
        """Masked mean NLL per device: x ``[D, M, ...]``, y and mask
        ``[D, M]`` → ``[D]``, with dropout active."""
        return masked_nll(self.stochastic_apply(params, x, generator), y,
                          mask)

    def aggregate_mask(self, path: str) -> bool:
        """True = leaf at flat key ``path`` stays per-device (out of Eq. 1)."""
        return False

    @property
    def num_classes(self) -> int:
        raise NotImplementedError


def excluded_paths(adapter: ModelAdapter, params) -> tuple:
    """Sorted flat key paths of ``params`` that ``adapter.aggregate_mask``
    keeps per device (empty for LeNet and the decoder)."""
    return tuple(sorted(p for p, _ in tree_items(params)
                        if adapter.aggregate_mask(p)))


def _batched(x: torch.Tensor, sample_ndim: int) -> torch.Tensor:
    """``[N, *sample]`` shared inputs gain a leading device axis of 1."""
    return x.unsqueeze(0) if x.dim() == sample_ndim + 1 else x


# =============================================================== LeNet (paper)
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


# ======================================================== decoder LM (models/)
@dataclass(frozen=True)
class DecoderLMAdapter(ModelAdapter):
    """Decoder-only LM from the model zoo (``models.decoder``: dense, MoE,
    MLA, the RG-LRU hybrid and Mamba-2 layers).  One sample is an int32
    token sequence ``[S]``; the logits are the next-token distribution at
    the final position.  MC scoring needs ``config.dropout_rate > 0``.
    ``loss`` adds each device's MoE auxiliary loss ``[D]`` to its NLL, as
    the reference adds its per-device scalar inside the engine's
    ``vmap``.  Cross-attention (``X``) layers need ``image_embeds``, which
    the adapter does not carry: a forward raises ``ValueError``."""

    config: ModelConfig = field(default_factory=ModelConfig)
    impl: str = "auto"
    sample_ndim: ClassVar[int] = 1
    eval_rows: ClassVar[int] = 4096

    def __post_init__(self):
        check_supported(self.config, impl=self.impl)

    def init(self, generator):
        return decoder_init(self.config, generator)

    def _last_logits(self, params, tokens, *, generator=None,
                     deterministic=True, impl="auto"):
        logits, _, _ = decoder_forward(
            params, _batched(tokens, 1), cfg=self.config,
            generator=generator, deterministic=deterministic, impl=impl,
            last_logit_only=True)
        return logits[:, :, 0, :]

    def apply(self, params, x):
        return self._last_logits(params, x, impl=self.impl)

    def stochastic_apply(self, params, x, generator):
        return self._last_logits(params, x, generator=generator,
                                 deterministic=False, impl=self.impl)

    def loss(self, params, x, y, mask, generator):
        logits, _, aux = decoder_forward(
            params, x, cfg=self.config, generator=generator,
            deterministic=False, impl="auto", last_logit_only=True)
        return masked_nll(logits[:, :, 0, :], y, mask) + aux

    @property
    def num_classes(self) -> int:
        return self.config.vocab_size


# ================================================================ SSM LM (SSD)
@dataclass(frozen=True)
class SSMAdapter(ModelAdapter):
    """Single-block Mamba-2 (SSD) LM with a CARRIED per-device recurrent
    state, the adapter that exercises ``aggregate_mask``.

    ``params["recurrent"]["state"]`` ``[H, P, N]`` is the SSD scan's
    initial state: it feeds every forward (broadcast over the batch),
    receives gradient like any other leaf, and is named by
    ``aggregate_mask`` so the engine keeps each device's copy out of
    Eq. 1.  ``impl="pallas"`` routes the intra-chunk SSD block of the
    no-grad forwards through the SSD kernel."""

    config: ModelConfig = field(default_factory=lambda: ModelConfig(
        family="ssm", attn_pattern=("M",)))
    impl: str = "ref"
    sample_ndim: ClassVar[int] = 1
    eval_rows: ClassVar[int] = 4096

    def init(self, generator):
        cfg = self.config
        _, H, P, N, _ = ssm_dims(cfg)
        dev = generator.device
        return {
            "embed": emb.embed_init(cfg.vocab_size, cfg.d_model, generator,
                                    dtype=cfg.param_dtype),
            "mamba": mamba2_init(cfg, generator),
            "final_norm": rmsnorm_init(cfg.d_model, device=dev),
            "recurrent": {"state": torch.zeros((H, P, N), dtype=torch.float32,
                                               device=dev)},
        }

    def _forward(self, params, tokens, *, generator=None, impl="ref"):
        cfg = self.config
        x = emb.embed_apply(params["embed"], _batched(tokens, 1),
                            dtype=cfg.dtype)               # [D, Nb, S, d]
        state = params["recurrent"]["state"].to(x.dtype)  # [D, H, P, N]
        init_state = state.unsqueeze(1).expand(
            (state.shape[0], x.shape[1]) + tuple(state.shape[1:]))
        # Residual around the block, as in models/decoder.py: the gated
        # RMSNorm inside mamba2_apply starts at zero scale, so without the
        # skip a fresh adapter would emit all-zero logits.
        h = x + mamba2_apply(params["mamba"], x, cfg=cfg,
                             initial_state=init_state, impl=impl)
        h = h[:, :, -1, :]
        if generator is not None and cfg.dropout_rate > 0.0:
            h = layers.dropout(h, cfg.dropout_rate, generator=generator)
        h = rmsnorm_apply(params["final_norm"], h)
        return emb.unembed_apply(params["embed"], h, tied=True)

    def apply(self, params, x):
        return self._forward(params, x, impl=self.impl)

    def stochastic_apply(self, params, x, generator):
        return self._forward(params, x, generator=generator, impl=self.impl)

    def loss(self, params, x, y, mask, generator):
        return masked_nll(self._forward(params, x, generator=generator,
                                        impl="ref"), y, mask)

    def aggregate_mask(self, path: str) -> bool:
        return path.startswith("recurrent")

    @property
    def num_classes(self) -> int:
        return self.config.vocab_size
