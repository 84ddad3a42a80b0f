"""Meshes and layouts of the port over ``torch.distributed``: the federated
engine's (``EngineMesh``, the client-row layouts) and the LM's (the
parameter, batch and decode-cache specs of tensor / data / FSDP parallel,
``shard_tree`` / ``gather_tree``); and the production lowering's cost
model: ``OpCounter`` (FLOPs, collectives and peak bytes a program
dispatches), ``Roofline`` on the H100's constants, ``analytic_roofline``
(the reference's analytic model)."""
from repro_torch.sharding.analysis import OpCounter, Roofline
from repro_torch.sharding.analytic import analytic_roofline
from repro_torch.sharding.specs import (ENGINE_AXES, EngineMesh, batch_axes,
                                        batch_specs, cache_specs, engine_mesh,
                                        engine_world, gather_tree,
                                        padded_clients, param_spec,
                                        shard_tree, tree_param_specs)

__all__ = ["ENGINE_AXES", "EngineMesh", "OpCounter", "Roofline",
           "analytic_roofline", "batch_axes", "batch_specs", "cache_specs",
           "engine_mesh", "engine_world", "gather_tree", "padded_clients",
           "param_spec", "shard_tree", "tree_param_specs"]
