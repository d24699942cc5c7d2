"""Functional optimizers over nested-dict params, and learning-rate
schedules."""
from repro_torch.optim.optimizers import (Optimizer, adafactor, adam, adamw,
                                          clip_by_global_norm, global_norm,
                                          momentum, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,
                                         warmup_cosine, warmup_linear)
