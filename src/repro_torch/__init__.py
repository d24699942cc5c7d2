"""PyTorch / CUDA port of the federated active-learning system.

A second package beside the JAX reference ``repro``: the same algorithm
(paper Algorithm 1 on LeNet), with every TPU kernel on the ported path
rewritten by hand for NVIDIA Hopper (``repro_torch/csrc``).  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``
(``repro_torch.device``).
"""
