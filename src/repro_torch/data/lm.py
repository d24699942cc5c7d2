"""Synthetic language-model token pipeline (a copy of ``repro.data.lm``:
byte-equal arrays for the same seeds).

The assigned pod-scale architectures are LMs; for smoke tests, examples and
the selection subsystem we need token streams. We synthesize a Zipfian token
source with local n-gram structure (a tiny Markov chain) so losses actually
decrease and uncertainty varies across sequences — required for the
uncertainty-driven selection demo to have signal.

``make_lm_dataset`` / ``lm_federated_split`` package the stream into the
engine's shard contract (the ``SyntheticDigits`` duck type): one sample
"image" is an int32 token prefix ``[seq_len]`` and its "label" the next
token at the final position, so the LM adapters
(``repro_torch.core.model_adapter``) run through the pool/scoring/Eq. 1
machinery unchanged — the fused engine is rank-generic and
dtype-preserving over the sample axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.data.digits import SyntheticDigits
from repro_torch.data.federated_split import _partition_sizes


def synthetic_lm_batch(batch: int, seq_len: int, vocab: int, *, seed: int = 0):
    """One batch of (tokens, targets): Zipf-distributed ids with a shift target."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@dataclass
class SyntheticLMStream:
    """Markov-chain token stream with per-shard mixing weights.

    Each federated group gets a different transition temperature so their
    local distributions differ (the paper's 'same distribution, unbalanced'
    analogue for LM data).
    """
    vocab: int
    order_states: int = 64
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._proj = rng.integers(0, self.order_states, size=self.vocab)
        logits = rng.normal(0.0, 2.0, size=(self.order_states, self.vocab))
        self._cond = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)

    def sample(self, batch: int, seq_len: int, *, seed: int = 0, temperature: float = 1.0):
        rng = np.random.default_rng(seed)
        out = np.empty((batch, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, self.vocab, size=batch)
        out[:, 0] = state
        for t in range(1, seq_len + 1):
            p = self._cond[self._proj[state]]
            if temperature != 1.0:
                p = p ** (1.0 / temperature)
                p /= p.sum(-1, keepdims=True)
            cum = np.cumsum(p, axis=-1)
            u = rng.random((batch, 1))
            state = (u < cum).argmax(-1)
            out[:, t] = state
        return out[:, :-1], out[:, 1:]


# ------------------------------------------------- engine shard contract
def make_lm_dataset(n: int, *, seq_len: int = 32, vocab: int = 256,
                    seed: int = 0, temperature: float = 1.0,
                    stream: Optional[SyntheticLMStream] = None,
                    stream_seed: int = 0):
    """One LM shard in the engine's ``SyntheticDigits`` contract.

    ``images`` is the int32 token-prefix array ``[n, seq_len]`` and
    ``labels`` the next token at the FINAL position ``[n]`` — the LM
    adapters score/train on the last-position next-token distribution, so
    a "label" is the target continuation token and the whole AL pipeline
    (pool, MC scoring, Eq. 1) applies verbatim.

    All shards of one experiment must share one Markov chain (pass the
    same ``stream`` or the same ``stream_seed``): per-shard variation
    comes from ``seed`` (which sequences) and ``temperature`` (how
    peaked), not from different chains — the paper's "same distribution,
    different proportions" regime.
    """
    if stream is None:
        stream = SyntheticLMStream(vocab, seed=stream_seed)
    if n == 0:
        return SyntheticDigits(np.zeros((0, seq_len), np.int32),
                               np.zeros((0,), np.int32))
    toks, targets = stream.sample(n, seq_len, seed=seed,
                                  temperature=temperature)
    return SyntheticDigits(toks.astype(np.int32),
                           targets[:, -1].astype(np.int32))


def lm_federated_split(num_devices: int, samples_per_device: int, *,
                       seq_len: int = 32, vocab: int = 256, seed: int = 0,
                       unbalance: float = 0.3,
                       temperature_spread: float = 0.5) -> List:
    """Per-device LM shards for the fused engine: one shared Markov chain,
    unbalanced shard sizes, and a per-device sampling temperature ramp.

    Mirrors ``federated_split.federated_split`` for token data: every
    device sees the SAME source distribution (one chain seeded from
    ``seed``) in different proportions (``unbalance`` jitters the shard
    sizes around ``samples_per_device``) and at a different temperature in
    ``[1 − spread/2, 1 + spread/2]`` — hotter shards carry more
    high-entropy sequences, so uncertainty-driven acquisition has
    cross-device signal (the lever the LM bench gate measures).
    """
    rng = np.random.default_rng(seed)
    stream = SyntheticLMStream(vocab, seed=seed)
    raw = np.maximum(
        1.0 + rng.uniform(-unbalance, unbalance, size=num_devices), 0.05)
    sizes = _partition_sizes(raw, samples_per_device * num_devices)
    temps = np.linspace(1.0 - temperature_spread / 2,
                        1.0 + temperature_spread / 2, num_devices)
    return [make_lm_dataset(int(sizes[d]), seq_len=seq_len, vocab=vocab,
                            seed=seed + 101 * (d + 1),
                            temperature=float(temps[d]), stream=stream)
            for d in range(num_devices)]
