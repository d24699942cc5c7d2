"""The paper's own model: LeNet-5 (Table I) with MC-dropout.

Not an LM — returned as a LeNetConfig for the fog/edge pipeline
(repro_torch.core.federated), not a ModelConfig. Kept in the registry module
namespace for discoverability: ``repro_torch.configs.lenet.config()``.
"""
from repro_torch.nn.lenet import LeNetConfig


def config() -> LeNetConfig:
    return LeNetConfig(num_classes=10, p_conv=0.25, p_fc=0.5)
