"""Synthetic federated lifelong ReID benchmark (numpy)."""
from repro_torch.data.synthetic import FederatedReIDBenchmark, Task

__all__ = ["FederatedReIDBenchmark", "Task"]
