"""LeNet-5 (paper Table I) with MC-dropout, over a leading device axis.

The port of ``repro.nn.lenet``: conv6@5x5 (SAME) → avgpool2 → conv16@5x5 →
avgpool2 → conv120@5x5 → FC84 → FC10 on 28x28x1 images, tanh activations,
dropout after each pooling stage (``p_conv``) and after FC84 (``p_fc``).
61,706 parameters at the paper's widths.

``LeNet.init`` returns ONE model (a nested dict with the JAX package's key
names and layouts); ``LeNet.apply`` takes STACKED params ``[D, ...]`` and
images ``[D, N, 28, 28, 1]`` (or ``[N, 28, 28, 1]`` shared by all devices)
and returns logits ``[D, N, num_classes]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.nn import init as initializers
from repro_torch.nn import layers


@dataclass(frozen=True)
class LeNetConfig:
    num_classes: int = 10
    p_conv: float = 0.25
    p_fc: float = 0.5
    dtype: torch.dtype = torch.float32


class LeNet:
    """Namespace class bundling init/apply for the paper's model."""

    @staticmethod
    def init(generator: torch.Generator, cfg: LeNetConfig = LeNetConfig()):
        """One model's params, drawn from ``generator`` on its device."""
        dt = cfg.dtype
        ki = initializers.he_normal()
        zeros = lambda n: torch.zeros((n,), dtype=dt, device=generator.device)
        return {
            "conv1": layers.conv2d_init(1, 6, 5, generator, dtype=dt),
            "conv2": layers.conv2d_init(6, 16, 5, generator, dtype=dt),
            "conv3": layers.conv2d_init(16, 120, 5, generator, dtype=dt),
            "fc1": {"kernel": ki((120, 84), generator, dt), "bias": zeros(84)},
            "fc2": {"kernel": ki((84, cfg.num_classes), generator, dt),
                    "bias": zeros(cfg.num_classes)},
        }

    @staticmethod
    def apply(params, x: torch.Tensor, *, cfg: LeNetConfig = LeNetConfig(),
              generator: Optional[torch.Generator] = None,
              keep_masks: Optional[Sequence[torch.Tensor]] = None,
              deterministic: bool = True) -> torch.Tensor:
        """Stacked params, images → logits ``[D, N, num_classes]``.

        ``deterministic=False`` gives one MC-dropout draw per row, with
        masks from ``generator`` or the three given ``keep_masks`` (shaped
        like the activations after pool1, pool2 and FC84)."""
        if not deterministic and generator is None and keep_masks is None:
            raise ValueError("stochastic apply needs a generator or keep_masks")
        m1, m2, m3 = keep_masks if keep_masks is not None else (None,) * 3
        drop = lambda h, p, m: layers.dropout(
            h, p, generator=generator, keep_mask=m,
            deterministic=deterministic)

        h = torch.tanh(layers.conv2d_apply(params["conv1"], x, padding="SAME"))
        h = drop(layers.avg_pool(h), cfg.p_conv, m1)              # 14x14x6
        h = torch.tanh(layers.conv2d_apply(params["conv2"], h))
        h = drop(layers.avg_pool(h), cfg.p_conv, m2)              # 5x5x16
        h = torch.tanh(layers.conv2d_apply(params["conv3"], h))   # 1x1x120
        h = h.reshape(h.shape[0], h.shape[1], -1)                 # [D, N, 120]
        h = torch.tanh(layers.dense_apply(params["fc1"], h))
        h = drop(h, cfg.p_fc, m3)
        return layers.dense_apply(params["fc2"], h)
