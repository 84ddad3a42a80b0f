"""Meshes and layouts of the port over ``torch.distributed``: the federated
engine's (``EngineMesh``, the client-row layouts) and the LM's (the
parameter, batch and decode-cache specs of tensor / data / FSDP parallel,
``shard_tree`` / ``gather_tree``)."""
from repro_torch.sharding.specs import (ENGINE_AXES, EngineMesh, batch_axes,
                                        batch_specs, cache_specs, engine_mesh,
                                        engine_world, gather_tree,
                                        padded_clients, param_spec,
                                        shard_tree, tree_param_specs)

__all__ = ["ENGINE_AXES", "EngineMesh", "batch_axes", "batch_specs",
           "cache_specs", "engine_mesh", "engine_world", "gather_tree",
           "padded_clients", "param_spec", "shard_tree", "tree_param_specs"]
