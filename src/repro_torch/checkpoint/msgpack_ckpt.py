"""msgpack checkpoints of parameter trees and engine states
(``repro.checkpoint.msgpack_ckpt`` ported; the files are the reference's).

Flat-key encoding: a tree is flattened to ``{"a/b/c": leaf}``, lists and
tuples leaving a ``__list__`` / ``__tuple__`` tag with their length, and
each leaf is stored as ``{"kind": "array", "dtype", "shape", "data"}``
(raw little-endian bytes) or ``{"kind": "py", "value"}``.  The bytes are
written by the port's own msgpack codec (``_msgpack``) to a ``.tmp`` file
that ``os.replace`` moves into place, so a crashed save never leaves a
torn checkpoint.  bfloat16 leaves are written as dtype ``"bfloat16"`` with
their raw 2-byte data and read back through ``torch.frombuffer``.

Engine states (``save_engine_state`` / ``load_engine_state``) are laid out
as the reference lays them out, so each package reads the other's files
(leaf layouts are equal, ``repro_torch.interop``).  The port's generator
is not a key array: the port writes ``rng_key_data`` as a ``uint32 [D,
2]`` array of zeros, which the reference's loader wraps as keys, and its
own loader ignores the field.  Both packages require ``resume_state``
before a restored state runs, which installs the generator of the next
round.  (The reference's own key data for round r is ``[0, seed +
7919·(d+1) + 104729·r]`` for device d, which a writer could store for
real.)
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import resolve_device

_SEP = "/"
_TAGS = ("__list__", "__tuple__")


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        tag = "__list__" if isinstance(tree, list) else "__tuple__"
        out[f"{prefix}{tag}"] = len(tree)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = tree
    return out


def _encode_leaf(x) -> dict:
    if isinstance(x, (int, float, str, bool)) or x is None:
        return {"kind": "py", "value": x}
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"kind": "array", "dtype": "bfloat16",
                    "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    arr = np.asarray(x)
    return {"kind": "array", "dtype": str(arr.dtype),
            "shape": list(arr.shape), "data": arr.tobytes()}


def _decode_leaf(d: dict, device):
    if d["kind"] == "py":
        return d["value"]
    shape = tuple(d["shape"])
    if d["dtype"] == "bfloat16":
        data = bytearray(d["data"])
        t = (torch.frombuffer(data, dtype=torch.bfloat16) if data
             else torch.empty((0,), dtype=torch.bfloat16))
        return t.reshape(shape).to(device)
    arr = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"])).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device)


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors, numpy
    arrays and Python scalars) to ``path``, atomically."""
    payload = {k: ({"kind": "py", "value": v} if k.endswith(_TAGS)
                   else _encode_leaf(v))
               for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
    os.replace(tmp, path)


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def resolve(node):
        if not isinstance(node, dict):
            return node
        for tag in _TAGS:
            if tag in node:
                items = [resolve(node[str(i)]) for i in range(node[tag])]
                return items if tag == "__list__" else tuple(items)
        return {k: resolve(v) for k, v in node.items()}

    return resolve(root)


def load_pytree(path: str, *, device=None):
    """The tree saved at ``path``, arrays as tensors on ``device`` (default
    ``"cuda"``, ``repro_torch.device``)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    return _unflatten({k: (d["value"] if k.endswith(_TAGS)
                           else _decode_leaf(d, device))
                       for k, d in payload.items()})


# ------------------------------------------------ federated round snapshots
def save_round(ckpt_dir: str, round_idx: int, *, fog_model, device_models=None,
               opt_states=None, metadata=None) -> str:
    payload = {"fog_model": fog_model, "metadata": metadata or {}}
    if device_models is not None:
        payload["device_models"] = list(device_models)
    if opt_states is not None:
        payload["opt_states"] = list(opt_states)
    path = os.path.join(ckpt_dir, f"round_{round_idx:06d}.msgpack")
    save_pytree(path, payload)
    return path


def latest_round(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    rounds = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"round_(\d+)\.msgpack$", name)
        if m:
            rounds.append(int(m.group(1)))
    return max(rounds) if rounds else None


def load_round(ckpt_dir: str, round_idx: int, *, device=None):
    return load_pytree(os.path.join(ckpt_dir, f"round_{round_idx:06d}.msgpack"),
                       device=device)


# --------------------------------------------- full engine-state checkpoints
def save_engine_state(path: str, state, *, metadata=None) -> None:
    """Checkpoint a full ``core.engine.EngineState``: params, optimizer
    state, pool and every extension buffer (``residual``, ``pending``,
    ``staleness``, ``live``; an empty ``()`` round-trips as ``()``), in
    the reference's layout.  ``rng_key_data`` is written as zeros (see
    the module docstring).  ``metadata`` (a dict of Python scalars,
    strings and arrays; put ``next_round`` there) rides along.  Resume
    with ``state, meta = load_engine_state(path)`` and
    ``engine.resume_state(state, next_round=meta["next_round"])``."""
    fields = dict(state._asdict())
    fields.pop("rng")
    pool = fields.pop("pool")
    D = int(pool.n_filled.shape[0])
    payload = {
        "kind": "engine_state",
        "fields": fields,
        "pool": dict(pool._asdict()),
        "rng_key_data": np.zeros((D, 2), np.uint32),
        "metadata": metadata or {},
    }
    save_pytree(path, payload)


def load_engine_state(path: str, *, device=None):
    """``(EngineState, metadata)`` from a file of ``save_engine_state``
    (this package's or the reference's), on ``device`` (default
    ``"cuda"``).  The state's ``rng`` is None: ``EdgeEngine.resume_state``
    installs the next round's generator, and the engine refuses to run the
    state before."""
    from repro_torch.core.engine import EngineState
    from repro_torch.core.vpool import VPool

    payload = load_pytree(path, device=device)
    if payload.get("kind") != "engine_state":
        raise ValueError(f"{path} is not an engine-state checkpoint "
                         f"(kind={payload.get('kind')!r}); use load_pytree")
    state = EngineState(rng=None, pool=VPool(**payload["pool"]),
                        **payload["fields"])
    # an empty metadata dict has no leaves, so the file holds none
    return state, payload.get("metadata", {})
