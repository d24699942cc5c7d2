"""Functional optimizers over nested-dict params."""
from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd
