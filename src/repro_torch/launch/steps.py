"""Step factories (``repro.launch.steps`` ported): the train, prefill,
decode, federated and score steps of one ``models.api.Model``.

* ``make_train_step``: the language-model loss (``softmax_cross_entropy``
  with its ``z_loss``, plus the MoE aux), gradients by
  ``torch.autograd.grad`` over the param leaves, ``clip_by_global_norm``
  over the tree, then the optimiser.  With ``num_microbatches > 1`` the
  gradients of the batch slices are summed into float32 zeros and
  divided by M, and stay float32: the clip and the optimiser get float32
  gradients even for bfloat16 params, as in the reference.
* ``make_federated_train_step`` and ``federated_sync`` (Eq. 1 of the
  paper with uniform α), ``federated_sync_weighted`` and
  ``cascade_shift``: the paper's technique over G model replicas whose
  params carry a leading group axis ``[G, ...]``.  The federated step
  runs the base step on each group alone, so each group has its own
  global norm and its own optimiser (adafactor's factors and RMS clip
  are per model); the syncs are plain float32 means over the group axis.
* ``make_score_step``: the acquisition step, MC-dropout sequence scores
  (``core.selection``) through the acquisition-score kernel.
* ``make_prefill_step`` and ``make_decode_step``: the serving half.

Steps take a ``torch.Generator`` where the reference takes a key; the
train step is deterministic when it is None (``deterministic = rng is
None`` in the reference).  The train and score steps run ``model.apply``
on its default attention route, ``"auto"``, as the reference does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.selection import mc_sequence_logprobs, sequence_scores
from repro_torch.models.api import Model
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.tree import (tree_leaves, tree_map, tree_map_with_path,
                              tree_unflatten_like)


def _extras(batch):
    return {k: v for k, v in batch.items()
            if k not in ("tokens", "targets")} or None


def _target_logit(logits, idx):
    """``logits[..., idx]`` of each row, ``[...]``.  A DTensor (under a
    mesh, the vocab sharded over ``model``) takes a masked sum, each rank
    over its own vocab slice, then one small all-reduce: the vocabulary
    parallel form, exact (one term is not zero).  DTensor's own gather
    on a sharded dim does not run on these shapes."""
    if hasattr(logits, "device_mesh"):
        iota = torch.arange(logits.shape[-1], device=idx.device)
        return torch.where(iota == idx, logits,
                           torch.zeros((), dtype=logits.dtype,
                                       device=idx.device)).sum(dim=-1)
    return torch.gather(logits, -1, idx)[..., 0]


def softmax_cross_entropy(logits, targets, *, z_loss: float = 1e-4,
                          lowp: bool = False):
    """Token-level cross entropy ``[...]`` plus ``z_loss · lse²``.

    The default casts the logits to float32 first.  ``lowp=True`` keeps
    them in their own dtype for the max-subtracted ``exp`` and sums it in
    float32, adding the max cast to float32."""
    idx = targets[..., None].long()
    if not lowp:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ce = lse - _target_logit(logits, idx)
        return ce + z_loss * torch.square(lse)
    m = torch.amax(logits, dim=-1, keepdim=True)
    sumexp = torch.sum(torch.exp(logits - m), dim=-1, dtype=torch.float32)
    lse = torch.log(sumexp) + m[..., 0].float()
    ce = lse - _target_logit(logits, idx).float()
    return ce + z_loss * torch.square(lse)


def make_loss_fn(model: Model, *, lowp_ce: bool = False):
    """``loss_fn(params, batch, generator=None) -> (loss, metrics)``: the
    mean cross entropy plus the model's aux loss."""
    def loss_fn(params, batch, generator=None):
        logits, aux = model.apply(params, batch["tokens"],
                                  generator=generator,
                                  deterministic=generator is None,
                                  extras=_extras(batch))
        ce = softmax_cross_entropy(logits, batch["targets"], lowp=lowp_ce)
        loss = torch.mean(ce) + aux
        return loss, {"loss": loss, "ce": torch.mean(ce), "aux": aux}

    return loss_fn


def _value_and_grad(loss_fn, params, batch, generator):
    """``(loss, metrics, grads)`` of ``loss_fn`` at ``params``, detached;
    a leaf the loss does not reach gets zeros, as under ``jax.grad``."""
    p = tree_map(lambda a: a.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(p, batch, generator)
    grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten_like(params, list(grads)))


def _microbatch(v, M: int, i: int):
    """Slice ``i`` of ``M`` along the batch axis.  A DTensor batch (under
    a mesh) is cut on each rank's local rows, so no row moves between
    ranks: the slices then hold other rows than a whole-batch cut, and
    the summed gradients are the same."""
    if hasattr(v, "device_mesh"):
        from torch.distributed.tensor import DTensor
        loc = v.to_local()
        loc = loc.reshape((M, loc.shape[0] // M) + tuple(loc.shape[1:]))[i]
        return DTensor.from_local(loc, v.device_mesh, v.placements,
                                  run_check=False)
    return v.reshape((M, v.shape[0] // M) + v.shape[1:])[i]


def make_train_step(model: Model, optimizer: Optimizer, *,
                    clip_norm: float = 1.0, num_microbatches: int = 1,
                    batch_axes: tuple = (), lowp_ce: bool = False):
    """``train_step(params, opt_state, batch, step, generator=None) ->
    (params, opt_state, metrics)`` on ONE model's tree.

    ``num_microbatches = M > 1`` splits the batch axis in M slices,
    accumulating their gradients in float32 (which the clip and the
    optimiser then receive) and their losses, each with its aux;
    ``metrics["ce"]`` is then the mean loss and ``aux`` a float32 zero.
    ``batch_axes`` is the reference's sharding constraint on the slices;
    it changes no value, and the port takes it and ignores it: under a
    mesh the slices are cut on each rank's rows (``_microbatch``)."""
    loss_fn = make_loss_fn(model, lowp_ce=lowp_ce)
    del batch_axes

    def train_step(params, opt_state, batch, step, generator=None):
        if num_microbatches == 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch,
                                                   generator)
        else:
            M = num_microbatches
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(M):
                mb = {k: _microbatch(v, M, i) for k, v in batch.items()}
                l_i, _, g_i = _value_and_grad(loss_fn, params, mb, generator)
                tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                loss = loss + l_i
                del g_i
            # the reference's (g / M).astype(g.dtype) with g its float32
            # accumulator: the gradients stay float32
            grads = tree_map(lambda g: g.div_(M), grads)
            loss = loss / M
            metrics = {"loss": loss, "ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=loss.device)}
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


# ------------------------------------------------------------------ serving
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


# ------------------------------------------------------------------ federated
def _stack(*xs):
    return torch.stack(xs)


def make_federated_train_step(model: Model, optimizer: Optimizer, *,
                              clip_norm: float = 1.0):
    """``federated_step(params_g, opt_state_g, batch_g, step,
    generators_g=None)`` over group-stacked trees ``[G, ...]``: the base
    train step on each group's own slice in turn (the reference vmaps it),
    so the clip's norm and the optimiser's per-leaf state never mix
    groups; metrics come back ``[G]``."""
    base = make_train_step(model, optimizer, clip_norm=clip_norm)

    def federated_step(params_g, opt_state_g, batch_g, step,
                       generators_g=None):
        G = tree_leaves(params_g)[0].shape[0]
        outs = []
        for g in range(G):
            pick = lambda a: a[g]
            outs.append(base(tree_map(pick, params_g),
                             tree_map(pick, opt_state_g),
                             tree_map(pick, batch_g), step,
                             None if generators_g is None
                             else generators_g[g]))
        return (tree_map(_stack, *(o[0] for o in outs)),
                tree_map(_stack, *(o[1] for o in outs)),
                tree_map(_stack, *(o[2] for o in outs)))

    return federated_step


def _broadcast(mean: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A ``[1, ...]`` float32 mean as every group's row, in the leaf's
    dtype: one tensor, so every group holds the same values."""
    return mean.expand(leaf.shape).to(leaf.dtype).contiguous()


def federated_sync(params_g, *,
                   exclude: Optional[Callable[[str], bool]] = None):
    """FedAvg over the group axis (paper Eq. 1, uniform α): every group
    gets the float32 mean, cast back to the leaf's dtype.  ``exclude``
    takes a leaf's ``"a/b/0"`` path and keeps that leaf per group."""
    def avg(path, leaf):
        if exclude is not None and exclude(path):
            return leaf
        # the sum times the float32 1/G: XLA's float32 mean, bit for bit
        mean = leaf.float().sum(dim=0, keepdim=True) * (1.0 / leaf.shape[0])
        return _broadcast(mean, leaf)

    return tree_map_with_path(avg, params_g)


def federated_sync_weighted(params_g, weights):
    """Performance-weighted α: the ``weights [G]``, normalised, weigh the
    groups' float32 params."""
    weights = torch.as_tensor(weights)
    w = weights / torch.sum(weights)

    def avg(leaf):
        wb = w.to(leaf.device, torch.float32).reshape(
            (-1,) + (1,) * (leaf.dim() - 1))
        return _broadcast(torch.sum(leaf.float() * wb, dim=0, keepdim=True),
                          leaf)

    return tree_map(avg, params_g)


def cascade_shift(params_g):
    """Ring hand-off of the massive-regime cascade: group g receives group
    g-1's params."""
    return tree_map(lambda leaf: torch.roll(leaf, 1, dims=0), params_g)


# ------------------------------------------------------------------ scoring
def make_score_step(model: Model, *, mc_samples: int = 4,
                    acquisition_fn: str = "entropy"):
    """``score_step(params, batch, generator) -> [B]``: ``mc_samples``
    forwards with dropout active (``core.selection.mc_sequence_logprobs``,
    float32 log-probs ``[T, B, S, V]``), then ``sequence_scores``, one
    acquisition-score kernel launch a step on the card.  With a
    ``dropout_rate`` of 0 (every published config) the T passes are equal
    and the score is the deterministic entropy, as the reference accepts."""
    def score_step(params, batch, generator):
        extras = _extras(batch)

        def one(p, tokens, gen):
            logits, _ = model.apply(p, tokens, generator=gen,
                                    deterministic=False, extras=extras)
            return logits.float()

        logp = mc_sequence_logprobs(one, params, batch["tokens"], generator,
                                    mc_samples)
        return sequence_scores(logp, acquisition_fn=acquisition_fn)

    return score_step
