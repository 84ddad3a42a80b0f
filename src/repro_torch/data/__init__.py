"""Synthetic data (numpy): the federated lifelong ReID benchmark and the
LM token streams (``data.tokens``)."""
from repro_torch.data.synthetic import FederatedReIDBenchmark, Task

__all__ = ["FederatedReIDBenchmark", "Task"]
