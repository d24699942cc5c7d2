"""Token embedding, the tied unembedding over stacked tables, and
whisper's sinusoidal and learned positions (``repro.nn.embeddings``
ported).  The table is ``[D, vocab, dim]``."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.nn import init as initializers
from repro_torch.nn.layers import device_matmul
from repro_torch.nn.shard_hints import grad_placed


def embed_init(vocab: int, dim: int, generator: torch.Generator, *,
               dtype=torch.float32):
    return {"embedding": initializers.normal(0.02)((vocab, dim), generator,
                                                   dtype)}


def embed_apply(params, tokens: torch.Tensor, *, scale: bool = False,
                dtype=torch.float32) -> torch.Tensor:
    """tokens ``[D, ...]`` (or ``[1, ...]``, shared by every device) →
    ``[D, ..., dim]``: each device looks up its own table."""
    table = grad_placed(params["embedding"])
    D = table.shape[0]
    rows = torch.arange(D, device=table.device).reshape(
        (D,) + (1,) * (tokens.dim() - 1))
    emb = table[rows, tokens.long()].to(dtype)
    if scale:
        emb = emb * torch.tensor(math.sqrt(emb.shape[-1]), dtype=dtype)
    return emb


def unembed_apply(params, x: torch.Tensor, *, tied: bool = True):
    """Project ``x [D, ..., dim]`` to the vocabulary.  With ``tied=True``
    ``params`` is the embedding dict and the table is used transposed."""
    if tied:
        return device_matmul(x, grad_placed(params["embedding"]).to(x.dtype)
                             .transpose(-1, -2))
    return device_matmul(x, params["kernel"].to(x.dtype))


def sinusoidal_positions(seq_len: int, dim: int, *, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal table ``[seq_len, dim]``, built in numpy
    as the reference builds it (float64 angles into a float32 table, sin
    on the even columns, cos on the odd), so the two tables are
    bit-equal."""
    pos = np.arange(seq_len)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    table = np.zeros((seq_len, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def learned_positions_init(seq_len: int, dim: int,
                           generator: torch.Generator, *,
                           dtype=torch.float32):
    return {"embedding": initializers.normal(0.02)((seq_len, dim), generator,
                                                   dtype)}
