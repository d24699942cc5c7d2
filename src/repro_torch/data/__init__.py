"""Synthetic digits, LM token shards and their federated splits (numpy
only)."""
from repro_torch.data.digits import SyntheticDigits, make_digit_dataset
from repro_torch.data.federated_split import dirichlet_split, federated_split
