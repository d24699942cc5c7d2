"""Host-side dispatch accounting (``repro.core.counters`` ported).

The JAX package counts one dispatch per call of a compiled program.  The
port runs eagerly, so it counts one dispatch per engine entry (a round, a
fused multi-round call, a fit) — the same places the reference counts, so
reports stay comparable.  Kernel launches are counted separately, by each
kernel wrapper (``repro_torch.kernels``).
"""
from __future__ import annotations

_DISPATCHES = 0


def count_dispatch(n: int = 1) -> None:
    global _DISPATCHES
    _DISPATCHES += n


def reset_dispatches() -> None:
    global _DISPATCHES
    _DISPATCHES = 0


def dispatch_count() -> int:
    return _DISPATCHES
