"""Axis context of the model code: the port of ``repro/common/axes.py`` in
its unsharded regime only.

The layers take an ``AxisCtx`` as the reference's do, so their signatures
and call sites carry over; every collective helper is the identity. A
context that names a mesh axis raises ``NotImplementedError``: the sharded
regime (tensor, data and FSDP parallel over ``torch.distributed``) is
ROADMAP Queue 1 item 3, the LM scale-out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Names of mesh axes (None = unsharded, the only regime ported)."""

    tp: Optional[str] = None
    dp: Optional[str] = None
    pod: Optional[str] = None
    fsdp: bool = False
    dp2: Optional[str] = None
    decode_ws: bool = False

    def __post_init__(self):
        named = [f.name for f in dataclasses.fields(self)
                 if getattr(self, f.name)]
        if named:
            raise NotImplementedError(
                f"AxisCtx({', '.join(named)}): sharded model code is not "
                "ported yet (ROADMAP Queue 1 item 3, the LM scale-out); use "
                "UNSHARDED")

    def tp_index(self) -> int:
        return 0

    def psum_tp(self, x):
        return x

    def pmean_dp(self, x):
        return x

    def all_gather_param(self, w, axis: int):
        return w


UNSHARDED = AxisCtx()
