"""Layouts and the mesh of the port's sharded federated engine (the engine
half of ``repro/sharding``; the model half waits for the LM scale-out)."""
from repro_torch.sharding.specs import (ENGINE_AXES, EngineMesh, engine_mesh,
                                        engine_world, padded_clients)

__all__ = ["ENGINE_AXES", "EngineMesh", "engine_mesh", "engine_world",
           "padded_clients"]
