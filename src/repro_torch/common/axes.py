"""Axis context threading mesh-axis names through the model code: the port
of ``repro/common/axes.py``.

The same forward and backward code runs in two regimes:

  * unsharded (``AxisCtx()``, all axis names None): every collective
    helper is the identity and every size 1;
  * on a mesh (``AxisCtx(tp="model", dp="data", ..., mesh=m)``, ``m`` an
    ``sharding.specs.EngineMesh``): explicit SPMD. Every rank runs the
    same Python on its local shards, and each named axis is that mesh's
    process group along the axis. The helpers call
    ``torch.distributed._functional_collectives`` over it.

Gradients follow the transposes that JAX's ``shard_map(check_vma=True)``
gives its collectives, so a sharded step's gradient is the unsharded
one's:

  * ``psum_*``: all-reduce forward, identity backward (its output is the
    same on every rank of the axis, and so is that output's cotangent);
  * ``pvary_*``: identity forward, all-reduce backward. JAX inserts it
    implicitly wherever a value that is the same on every rank of an axis
    (an activation, a replicated weight) first meets arithmetic that
    differs between the ranks; the port inserts it by hand at each such
    place, once per value (the layers name each one);
  * ``pmean_dp``: the mean over the data axes, its cotangent divided by
    their size;
  * ``all_gather_param`` (FSDP): all-gather forward, reduce-scatter (sum)
    backward.

``pmax_tp`` / ``pmin_tp`` and the decode gathers carry no gradient. An
axis of one rank runs no collective: each helper is the identity over it.
``vary`` / ``vary_dp`` only type a value for JAX's checker: the identity
here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol


# the newer names where this torch has them (2.13 deprecates the older,
# which 2.11 alone offers); the signatures are the same
_ALL_GATHER = (getattr(funcol, "all_gather_single", None)
               or funcol.all_gather_tensor)
_REDUCE_SCATTER = (getattr(funcol, "reduce_scatter_single", None)
                   or funcol.reduce_scatter_tensor)


def _done(t):
    """A functional collective's result as a plain tensor (waited on)."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _reduce(x, op: str, groups: Sequence):
    """``x`` reduced with ``op`` ("sum", "max", "min") over every group."""
    x = x.contiguous()
    for g in groups:
        x = _done(funcol.all_reduce(x, op, g))
    return x


def _gather(x, dim: int, group):
    """The ranks' blocks of ``x`` concatenated along ``dim``, in rank
    order."""
    return _done(_ALL_GATHER(x.contiguous(), dim, group))


def _scatter_sum(x, dim: int, group):
    """The sum over the ranks of ``x``, of which this rank keeps its block
    along ``dim``."""
    return _done(_REDUCE_SCATTER(x.contiguous(), "sum", dim, group))


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", ctx.groups), None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        return _reduce(x, "sum", groups) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Names of mesh axes (None = unsharded) and the mesh they name."""

    tp: Optional[str] = None      # tensor / expert parallel axis ("model")
    dp: Optional[str] = None      # data / client parallel axis ("data")
    pod: Optional[str] = None     # cross-pod data axis ("pod")
    fsdp: bool = False            # params split over dp, gathered on use
    dp2: Optional[str] = None     # extra batch axis (the small-model dp
                                  # layout: "model" carries batch instead)
    decode_ws: bool = False       # weight-stationary decode (no FSDP weight
                                  # gathers; activations move instead)
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def _check(self, axes):
        if self.mesh is None:
            raise ValueError(f"{self} names mesh axes {tuple(axes)} but "
                             "holds no mesh: build it with mesh=")

    def _groups(self, axes):
        """The process groups of ``axes``, leaving out those of one rank
        (a collective over one rank is the identity, so none runs)."""
        self._check(axes)
        return tuple(self.mesh.group(a) for a in axes
                     if self.mesh.size(a) > 1)

    def _size(self, axes) -> int:
        self._check(axes)
        n = 1
        for a in axes:
            n *= self.mesh.size(a)
        return n

    @property
    def tp_size(self) -> int:
        return self._size((self.tp,)) if self.tp else 1

    @property
    def dp_size(self) -> int:
        return self._size((self.dp,)) if self.dp else 1

    def tp_index(self) -> int:
        return self.mesh.coords[self.tp] if self.tp else 0

    def dp_index(self) -> int:
        return self.mesh.coords[self.dp] if self.dp else 0

    @property
    def dp_axes(self):
        return tuple(a for a in (self.dp, self.pod, self.dp2) if a)

    # ---- collectives (identities when unsharded) ----
    def _tp(self):
        return self._groups((self.tp,)) if self.tp else ()

    def _dp(self):
        return self._groups((self.dp,)) if self.dp else ()

    def psum_tp(self, x):
        g = self._tp()
        return _Psum.apply(x, g) if g else x

    def pvary_tp(self, x):
        """A TP-invariant value entering TP-varying arithmetic."""
        return self.pvary(x, (self.tp,) if self.tp else ())

    def pvary(self, x, axes):
        """``x`` marked varying over ``axes``: its cotangent is summed
        over them."""
        g = self._groups(axes) if axes else ()
        return _Pvary.apply(x, g) if g else x

    def pmax_tp(self, x):
        """The largest over the TP ranks, gradient-free."""
        return _reduce(x.detach(), "max", self._tp())

    def pmin_tp(self, x):
        """The smallest over the TP ranks, gradient-free."""
        return _reduce(x.detach(), "min", self._tp())

    def psum_dp(self, x):
        axes = self.dp_axes
        g = self._groups(axes) if axes else ()
        return _Psum.apply(x, g) if g else x

    def pmean_dp(self, x):
        axes = self.dp_axes
        g = self._groups(axes) if axes else ()
        return _Pmean.apply(x, g, self._size(axes)) if g else x

    def all_gather_param(self, w, axis: int):
        """FSDP weight gather: params stored split over dp on ``axis``."""
        g = self._dp() if self.fsdp else ()
        return _GatherParam.apply(w, axis, g[0]) if g else w

    def all_gather_tp(self, x, axis: int):
        """Every TP rank's block of ``x`` along ``axis`` (no gradient: the
        decode's q / k / v gathers)."""
        g = self._tp()
        return _gather(x.detach(), axis, g[0]) if g else x

    def all_gather_dp(self, x, axis: int):
        """Every data rank's block of ``x`` along ``axis`` (no gradient:
        the weight-stationary decode)."""
        g = self._dp()
        return _gather(x.detach(), axis, g[0]) if g else x.detach()

    def psum_data(self, x):
        """The sum over the "data" axis alone (the weight-stationary
        decode's partial contractions; no gradient)."""
        return _reduce(x.detach(), "sum", self._dp())

    def vary(self, x):
        return x

    def vary_dp(self, x):
        return x


UNSHARDED = AxisCtx()
