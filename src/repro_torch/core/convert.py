"""Weight carry between the JAX package's stacked pytrees and the port.

The JAX package keeps a stacked head as a nested dict of ``(C, ...)``
arrays (``theta["l1"]["w"]``); the port keeps a flat dict under dotted keys
(``theta["l1.w"]``). Values cross as numpy arrays, bit for bit. An LM's
parameters keep the reference's nested layout on both sides
(``lm_params_from_jax``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def theta_from_jax(theta_np: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy, or anything ``np.asarray`` takes) ->
    the port's flat dict of tensors on ``device``."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v)).to(device)

    walk(theta_np, "")
    return out


def theta_numpy(theta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's flat dict (tensors on any device) -> flat dict of numpy."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in theta.items()}


def theta_to_jax(theta: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of ``theta_from_jax``: the port's flat dict -> the JAX
    package's nested dict of numpy arrays."""
    out: Dict[str, Any] = {}
    for key, v in theta_numpy(theta).items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def init_params_from_jax(g_params: Dict[str, Any], thetas0) -> Dict[str, Any]:
    """The JAX package's initial weights -> the port's ``init_params`` of
    ``federated.simulation.run_simulation``: the extraction params
    (``{"w1", "w2"}``) and a list of C per-client heads (nested JAX
    dicts), all as numpy, the heads under the port's dotted keys."""
    return {"extraction": {k: np.array(v) for k, v in g_params.items()},
            "theta0": [theta_numpy(theta_from_jax(t, "cpu")) for t in thetas0]}


def _tensor_from_numpy(x, device) -> torch.Tensor:
    """One array -> a tensor on ``device``, bit for bit; bf16 (an
    ml_dtypes array, dtype name ``bfloat16``) crosses as its 16 bits, so
    nothing here needs ml_dtypes."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_jax(params_np, device):
    """The JAX package's LM parameter tree (nested dicts of arrays, layers
    stacked on a leading L dim), of any family and any ``init_params(tp=k)``
    (q heads padded for k), or its decode cache (int8 codes and bf16
    scales included) -> the same tree of tensors on ``device``, every leaf
    bit for bit in its own dtype (a mesh's shards come from
    ``sharding.specs.shard_tree``)."""
    if isinstance(params_np, dict):
        return {k: lm_params_from_jax(v, device) for k, v in params_np.items()}
    return _tensor_from_numpy(params_np, device)
