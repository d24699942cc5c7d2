"""Weights carried across between the JAX package and the port.

Both sides keep the same layouts (NHWC images, HWIO conv kernels, ``[in,
out]`` dense kernels, ``[B, S, H, d]`` attention heads) and the same key
names, so carrying a tree across is a leafwise copy: ``params_from_jax``
takes the JAX side's tree with every leaf turned into a numpy array
(``jax.tree_util.tree_map(np.asarray, tree)`` on that side) and returns
torch tensors on ``device``; ``params_to_jax`` returns numpy leaves that
the JAX side wraps with ``jnp.asarray``.  Single and stacked ``[D, ...]``
params and the optimiser states (adamw's ``{"m": tree, "v": tree}``,
adafactor's ``{"v": tree}`` whose leaves are ``{"vr", "vc"}`` or
``{"v"}`` dicts, all float32) are nested dicts,
lists and tuples (the decoder's ``head_layers`` / ``units`` /
``tail_layers`` are lists; the SSM adapter's ``recurrent/state`` is a leaf
like any other); ``VPool`` is a named tuple on both sides and converts
field by field.  This module
imports no JAX: the numpy arrays are the interface.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.vpool import VPool
from repro_torch.tree import tree_map

# JAX → torch dtypes for the dtypes the port's trees hold
_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
          np.dtype(np.int8): torch.int8}


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _TORCH:
        raise TypeError(f"cannot carry a {a.dtype} leaf across (convert "
                        "bfloat16 to float32 on the JAX side first)")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device) -> dict:
    """Tree of numpy leaves (params, stacked params, an optimiser state)
    → the same tree of torch tensors on ``device``."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def params_to_jax(tree) -> dict:
    """Tree of torch tensors → the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def vpool_from_jax(pool, device) -> VPool:
    """A JAX ``VPool`` (fields as numpy arrays, stacked ``[D, ...]``) → the
    port's ``VPool`` on ``device``."""
    fields = pool._asdict() if hasattr(pool, "_asdict") else pool
    return VPool(**{k: _leaf_to_torch(fields[k], device)
                    for k in VPool._fields})


def vpool_to_jax(pool: VPool) -> Mapping[str, np.ndarray]:
    """The port's ``VPool`` → its fields as numpy arrays (the JAX side
    rebuilds its ``VPool(**fields)``)."""
    return {k: getattr(pool, k).detach().cpu().numpy()
            for k in VPool._fields}
