"""Device policy of the port: entry points run on the card.

Every entry point (``run_experiment``, ``run_federated_round(s)``,
``EdgeEngine``, ``Trainer``, ``FogNode``) takes ``device=`` and defaults to
``"cuda"``.  Without a CUDA card that default raises instead of quietly
running on the CPU; a caller who wants the CPU (the parity tests) says
``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (None = ``"cuda"``) → a ``torch.device``; raises when a
    CUDA device is asked for and torch sees no card."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and torch sees "
                "none; pass device='cpu' to run the plain PyTorch versions "
                "on the CPU")
        if dev.index is None:  # "cuda" means the current card, explicitly
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
