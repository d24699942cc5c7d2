"""Learning-rate schedules as step -> lr callables (``repro.optim.schedules``
ported).

``step`` is a Python int or a tensor; each schedule returns a float32
0-d tensor on the CPU, computed in float32 as the reference computes it,
which the optimizers multiply into their updates on any device.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32).cpu()


def constant(lr: float):
    def sched(step):
        return torch.tensor(lr, dtype=torch.float32)

    return sched


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def sched(step):
        t = torch.clamp(_step(step) / max(1, decay_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return sched


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    cos = cosine_decay(lr, max(1, decay_steps - warmup_steps), alpha)

    def sched(step):
        s = _step(step)
        warm = lr * s / max(1, warmup_steps)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return sched


def warmup_linear(lr: float, warmup_steps: int, total_steps: int):
    def sched(step):
        s = _step(step)
        warm = lr * s / max(1, warmup_steps)
        frac = 1.0 - (s - warmup_steps) / max(1, total_steps - warmup_steps)
        return torch.where(s < warmup_steps, warm,
                           lr * torch.clamp(frac, 0.0, 1.0))

    return sched
