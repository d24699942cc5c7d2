"""Published-architecture registry (``repro.configs`` ported):
``get_config(name)``.

Each module defines ``config()`` with the exact published hyperparameters
(source cited in the module docstring), field for field the JAX package's,
with ``torch.bfloat16`` where the reference has ``jnp.bfloat16``; every
``ModelConfig`` inherits ``.reduced()`` for small runs.  Configurations
only: no weights.  ``lenet`` returns the paper's ``LeNetConfig`` and is
not in the LM registry, as in the reference.
"""
from __future__ import annotations

import importlib
from typing import List

_ARCHS = [
    "gemma2_2b",
    "recurrentgemma_9b",
    "gemma_7b",
    "whisper_small",
    "qwen3_8b",
    "deepseek_v2_236b",
    "arctic_480b",
    "llama32_vision_11b",
    "minicpm3_4b",
    "mamba2_13b",
]

# public ids → module names
ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "gemma-7b": "gemma_7b",
    "whisper-small": "whisper_small",
    "qwen3-8b": "qwen3_8b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "arctic-480b": "arctic_480b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "minicpm3-4b": "minicpm3_4b",
    "mamba2-1.3b": "mamba2_13b",
}

ARCH_IDS: List[str] = list(ALIASES.keys())


def get_config(name: str):
    """The published config of ``name``: a public id (``ALIASES``) or a
    module name."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()
