"""The federated engine of the port (stacked over clients)."""
from repro_torch.federated.simulation import SimulationResult, run_simulation

__all__ = ["SimulationResult", "run_simulation"]
