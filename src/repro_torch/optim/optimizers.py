"""Functional optimizers over nested-dict params (``repro.optim.optimizers``).

An ``Optimizer`` holds ``init(params) -> state`` and ``update(grads, state,
params, step) -> (new_params, new_state)``, the JAX package's functional
form.  ``sgd``, ``momentum`` and ``adam`` are elementwise, so they run
unchanged over stacked ``[D, ...]`` params.  ``adafactor`` and
``clip_by_global_norm`` are not: adafactor factors a leaf by its rank and
clips its update by the leaf's RMS, and the clip takes one norm over the
whole tree.  Apply them to ONE model's tree (a decoder's stacked
``[U, ...]`` units are part of that tree, as in the reference), never to a
fleet's or a group's ``[D, ...]`` stack.  ``step`` is the 0-based step
index (an int); Adam's bias correction and adafactor's decay use ``t =
step + 1`` in float32, like the reference.  Updates return new tensors
and run without autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params, step) -> (params, state)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``, a 0-d tensor on the
    leaves' device (no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)``: each
    leaf scaled in float32 and cast back to its own dtype."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


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


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moments (Shazeer & Stern), the reference's form:
    a leaf of two or more axes keeps float32 row and column means ``{"vr":
    [..., n], "vc": [..., m]}`` of ``g² + eps`` over its last two axes, any
    other leaf a full float32 ``{"v"}``; the state is ``{"v": tree}``.
    ``beta2t = 1 - t^-decay`` (0 at the first step), the row factor
    ``1/sqrt(vr / (mean(vr) + eps))``, the column factor ``1/sqrt(vc)``,
    and each leaf's update divided by ``max(1, RMS / clip_threshold)``
    (RMS with 1e-12 under the root).  Leaves are visited in the sorted-key
    flatten order; each is updated alone."""
    sched = _as_sched(lr)

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def z(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}

        return {"v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = sched(step)
        t = np.float32(step) + np.float32(1.0)
        beta2t = np.float32(1.0) - t ** np.float32(-decay)
        keep, fresh = float(beta2t), float(np.float32(1.0) - beta2t)

        def upd(p, g, v):
            g32 = g.float()
            g2 = torch.square(g32).add_(eps)
            if _factored(p.shape):
                vr = (keep * v["vr"]).add_(fresh * g2.mean(dim=-1))
                vc = (keep * v["vc"]).add_(fresh * g2.mean(dim=-2))
                rfac = torch.reciprocal(torch.sqrt(
                    vr / (vr.mean(dim=-1, keepdim=True) + eps)))
                cfac = torch.reciprocal(torch.sqrt(vc))
                u = g32 * rfac[..., None] * cfac[..., None, :]
                newv = {"vc": vc, "vr": vr}
            else:
                vv = (keep * v["v"]).add_(fresh * g2)
                u = g32 * torch.reciprocal(torch.sqrt(vv))
                newv = {"v": vv}
            del g2
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (p.float() - lr_t * u).to(p.dtype), newv

        # tree_map walks ``params``: at a leaf, ``v`` is its state dict
        outs = tree_map(upd, params, grads, state["v"])
        return (tree_map(lambda _, o: o[0], params, outs),
                {"v": tree_map(lambda _, o: o[1], params, outs)})

    return Optimizer(init, update)

