"""The federated engines of the port (host and stacked) and the Table II
federated baselines."""
from repro_torch.federated.base import ClientState, Strategy
from repro_torch.federated.simulation import SimulationResult, run_simulation
from repro_torch.federated.strategies import FedAvg, FedCurv, FedProx, FedWeIT

__all__ = ["ClientState", "FedAvg", "FedCurv", "FedProx", "FedWeIT",
           "SimulationResult", "Strategy", "run_simulation"]
