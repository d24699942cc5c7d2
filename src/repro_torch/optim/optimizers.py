"""Functional optimizers over nested-dict params (``repro.optim.optimizers``).

An ``Optimizer`` holds ``init(params) -> state`` and ``update(grads, state,
params, step) -> (new_params, new_state)``, the JAX package's functional
form: it is elementwise, so it runs unchanged over stacked ``[D, ...]``
params.  ``step`` is the 0-based step index (an int); Adam's bias
correction uses ``t = step + 1`` like the reference.  Updates return new
tensors and run without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)


def _as_sched(lr) -> Callable:
    return lr if callable(lr) else (lambda step: float(lr))


def sgd(lr) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        return tree_map(lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype),
                        params, grads), state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False,
             state_dtype=torch.float32) -> Optimizer:
    sched = _as_sched(lr)

    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype),
                              params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        m = tree_map(lambda g, m: beta * m.float() + g.float(), grads,
                     state["m"])
        d = tree_map(lambda g, m: g.float() + beta * m, grads, m) \
            if nesterov else m
        new_p = tree_map(lambda p, d: (p.float() - lr_t * d).to(p.dtype),
                         params, d)
        return new_p, {"m": tree_map(lambda a: a.to(state_dtype), m)}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """Adam; with ``weight_decay > 0`` this is AdamW (decoupled decay)."""
    sched = _as_sched(lr)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=state_dtype)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        # bias corrections in float32, as the reference computes them
        t = np.float32(step) + np.float32(1.0)
        c1 = float(np.float32(1.0) - np.float32(b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(b2) ** t)
        # The in-place steps act only on fresh temporaries, and do the
        # reference's operations in its order, so the bits are those of the
        # plain expressions; they hold one [D, ...] temporary fewer at the
        # largest leaf, where an LM fleet's update peaks.
        m = tree_map(lambda g, m: (b1 * m.float()).add_((1 - b1) * g.float()),
                     grads, state["m"])
        v = tree_map(lambda g, v: (b2 * v.float()).add_(
            (g.float() ** 2).mul_(1 - b2)), grads, state["v"])

        def upd(p, m, v):
            p32 = p.float()
            step_vec = torch.div(v, c2).sqrt_().add_(eps)
            step_vec = torch.div(m, c1).div_(step_vec)
            step_vec.add_(weight_decay * p32)
            return (p32 - step_vec.mul_(lr_t)).to(p.dtype)

        new_p = tree_map(upd, params, m, v)
        cast = lambda a: a.to(state_dtype)
        return new_p, {"m": tree_map(cast, m), "v": tree_map(cast, v)}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, state_dtype=torch.float32) -> Optimizer:
    """Adam with decoupled weight decay, at the reference's defaults."""
    return adam(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                state_dtype=state_dtype)
