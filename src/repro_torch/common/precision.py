"""Precision policy of the sharded engine: bf16 on the wire, fp32 in state.

The port of ``repro/common/precision.py``. The flattened (Cp, P) upload
rows that the sharded server aggregates travel as bf16 (``FedSTIL(...,
wire_dtype="bfloat16")``, the default) and are upcast back to fp32 before
the relevance-weighted aggregate; optimizer and BN state stay fp32.

``to_bf16`` / ``to_f32`` cast every floating leaf of a tree (nested dicts
or a single tensor) and pass int8, int32 and bool leaves through
untouched, so they are safe on mixed codec buffer dicts. torch rounds
fp32 -> bf16 to nearest even, as XLA does.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map

# the (src, dst) casts the analysis convert-churn lint accepts in programs
# that declare them: the wire cast down and its matching upcast
WIRE_CASTS = frozenset({("float32", "bfloat16"), ("bfloat16", "float32")})


def _cast_floating(x, dtype: torch.dtype):
    t = torch.as_tensor(x)
    return t.to(dtype) if t.is_floating_point() else x


def to_bf16(tree):
    """Cast every floating leaf to bfloat16 (the wire / cross-rank form)."""
    return tree_map(lambda x: _cast_floating(x, torch.bfloat16), tree)


def to_f32(tree):
    """Cast every floating leaf to float32 (the state / accumulate form)."""
    return tree_map(lambda x: _cast_floating(x, torch.float32), tree)
