"""The federated engines of the port (host and stacked) and FedAvg."""
from repro_torch.federated.simulation import SimulationResult, run_simulation
from repro_torch.federated.strategies import FedAvg

__all__ = ["FedAvg", "SimulationResult", "run_simulation"]
