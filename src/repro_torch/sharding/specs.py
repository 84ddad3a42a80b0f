"""The federated engine's mesh and layouts over ``torch.distributed``.

The port of the engine half of ``repro/sharding/specs.py``. The reference
lets GSPMD partition its jitted programs from ``PartitionSpec`` layouts;
PyTorch has no such partitioner that reaches hand-written kernels, so the
port runs explicit SPMD: every rank runs the same Python on plain local
tensors (its block of each layout) and calls the named collectives of
``EngineMesh`` where GSPMD would insert them.

Axis names are the reference's: "data" shards the client dim (every
stacked (C, ...) leaf puts its leading dim there), "model" the flattened
parameter dim of the (C, P) server matrices. The engine runs model = 1
today; the axis exists so the layouts carry over to meshes that split P.

A spec is a tuple with one entry per dim: an axis name (that dim is
split over the axis in contiguous blocks, rank r of the axis holding
block r, as GSPMD's row sharding does) or None (whole on every rank).
``place`` cuts a global tensor (or tree) to this rank's block of a spec.

C is padded to Cp, a multiple of the data-axis size
(``padded_clients``); rows [C, Cp) are padding (``pad_client_rows`` in
``federated/base.py``).

``engine_world`` gives ``run_simulation(engine="sharded")`` its world: the
initialized default group when there is one, else the world ``torchrun``
describes in the environment (joined for the rest of the process), else a
world of one on the run's device, destroyed at the end. NCCL goes with
CUDA tensors and gloo with CPU ones; a group whose backend does not match
the run's device raises.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_map

ENGINE_AXES = ("data", "model")
# every process group of the port waits at most this long in a collective:
# a rank that raised must not hang the others for the default 30 minutes
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

Spec = Tuple[Optional[str], ...]


def _quiet(fn, *args, **kw):
    """Call a collective under a filter for its deprecation notice: the
    ``*_tensor`` collectives are the ones that exist in every torch the
    port supports (2.11 and 2.13); 2.13 names a successor for each."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=".*is deprecated")
        return fn(*args, **kw)


class EngineMesh:
    """Named axes over the ranks of the current world (a
    ``torch.distributed.device_mesh.DeviceMesh``), the rank's coordinate
    on each, and the collectives the engine calls along them.

    ``shape``: {axis name: size}, in mesh order; ranks are laid out
    row-major over it. Every rank of the world must build the same mesh,
    in the same order (each axis's process groups are created once, by
    every rank, with ``GROUP_TIMEOUT``). ``close`` (or leaving a ``with``
    block) destroys the groups this rank belongs to; the world stays up,
    so a caller's long-lived world does not collect the communicators of
    every mesh built in it."""

    def __init__(self, shape: Dict[str, int], device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh
        names, sizes = tuple(shape), tuple(shape.values())
        world = dist.get_world_size()
        n = 1
        for s in sizes:
            n *= s
        if n != world:
            raise ValueError(f"mesh {dict(shape)} needs {n} ranks, the "
                             f"world has {world}")
        backend = dist.get_backend()
        if BACKENDS[device.type] != backend:
            raise ValueError(f"the world's backend is {backend!r} but the "
                             f"run's device is {device}: {device.type} "
                             f"tensors need {BACKENDS[device.type]!r}")
        self.device = device
        self.rank = dist.get_rank()
        layout = torch.arange(world).reshape(sizes)
        groups = []
        for dim in range(len(sizes)):
            lines = layout.movedim(dim, -1).reshape(-1, sizes[dim]).tolist()
            for ranks in lines:
                g = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
                if self.rank in ranks:
                    groups.append(g)
        self._groups = groups
        # the DeviceMesh names the groups: every collective below looks its
        # axis's group up there
        self.device_mesh = DeviceMesh.from_group(
            groups, device.type, mesh=layout, mesh_dim_names=names)
        self.coords = {n: self.device_mesh.get_local_rank(n) for n in names}
        self.shape = dict(shape)

    def __repr__(self):
        return f"EngineMesh({self.shape}, rank={self.rank}, {self.device})"

    def close(self) -> None:
        """Destroy this rank's groups of the mesh (once; a local call, no
        collective). The mesh takes no collective after it."""
        for g in self._groups:
            dist.destroy_process_group(g)
        self._groups = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self.device_mesh.get_group(axis)

    def block(self, n: int, axis: str = "data") -> Tuple[int, int]:
        """[lo, hi): this rank's contiguous block of ``n`` (a multiple of
        the axis size) along ``axis``."""
        return row_block(n, self.shape[axis], self.coords[axis])

    # ---- collectives ---------------------------------------------------------
    def all_gather_rows(self, t: torch.Tensor, axis: str = "data"):
        """Every rank's (n, ...) block along ``axis`` -> the (d n, ...)
        concatenation in rank order, on every rank of the axis."""
        t = t.contiguous()
        out = torch.empty((self.shape[axis] * t.shape[0],) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        _quiet(dist.all_gather_into_tensor, out, t, group=self.group(axis))
        return out

    def reduce_scatter_rows(self, t: torch.Tensor, axis: str = "data"):
        """The sum over the ranks of ``axis`` of their (d n, ...) tensors,
        of which this rank keeps its own (n, ...) row block."""
        t = t.contiguous()
        d = self.shape[axis]
        out = torch.empty((t.shape[0] // d,) + t.shape[1:], dtype=t.dtype,
                          device=t.device)
        _quiet(dist.reduce_scatter_tensor, out, t, group=self.group(axis))
        return out

    def all_sum(self, t: torch.Tensor, axis: str = "data"):
        """The sum over the ranks of ``axis`` (a new tensor)."""
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t

    def all_max(self, value: int, axis: str = "data") -> int:
        """The largest of the ranks' integers."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group(axis))
        return int(t.item())


def row_block(n: int, d: int, r: int) -> Tuple[int, int]:
    """[lo, hi): block ``r`` of ``n`` rows split into ``d`` contiguous
    blocks of n / d (n a multiple of d), GSPMD's row sharding."""
    if n % d:
        raise ValueError(f"{n} rows do not split into {d} blocks")
    return r * n // d, (r + 1) * n // d


def engine_mesh(*, model: int = 1, device=None) -> EngineMesh:
    """The engine's ("data", "model") mesh over every rank of the current
    world: all ranks on the client axis by default. ``device`` defaults to
    the current CUDA device under NCCL, the CPU under gloo."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return EngineMesh(dict(zip(ENGINE_AXES, (n // model, model))),
                      torch.device(device))


def padded_clients(C: int, mesh: EngineMesh) -> int:
    """Smallest Cp >= C divisible by the data-axis size. Clients [C, Cp)
    are padding: their validity is 0, they never enter the relevance ring
    (so their W rows and columns are zero and their base is kept), and
    evaluation and byte accounting count only the C real clients."""
    d = mesh.shape["data"]
    return -(-C // d) * d


def client_row_spec(ndim: int, *, client_axis: str = "data") -> Spec:
    """Leading-client-dim spec: rows over ``client_axis``, the rest whole."""
    return (client_axis,) + (None,) * (ndim - 1)


def stacked_tree_specs(tree, *, client_axis: str = "data"):
    """Spec tree of any stacked (C, ...) state / batch / buffer tree: every
    leaf's leading client dim over ``client_axis``."""
    return tree_map(lambda t: client_row_spec(t.dim(), client_axis=client_axis),
                    tree)


def place(t: torch.Tensor, spec: Sequence[Optional[str]], mesh: EngineMesh,
          device=None) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (the
    counterpart of ``jax.device_put`` with a ``NamedSharding``), moved to
    ``device`` (the mesh's by default)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            lo, hi = mesh.block(t.shape[dim], axis)
            t = t.narrow(dim, lo, hi - lo)
    return t.contiguous().to(mesh.device if device is None else device)


def place_tree(tree, spec_tree, mesh: EngineMesh, device=None):
    """``place`` over corresponding leaves of a tree and its spec tree (the
    counterpart of ``named_shardings`` + ``jax.device_put``)."""
    return tree_map(lambda t, s: place(t, s, mesh, device), tree, spec_tree)


# ---------------------------------------------------------------------------
# the server's stacked (C, P) aggregate and the batched evaluation
# ---------------------------------------------------------------------------


def stacked_aggregate_specs(*, client_axis: str = "data",
                            param_axis: Optional[str] = "model"):
    """Layouts of the server aggregate B = Wn @ Theta.

    Theta (C, P) splits its client rows over ``client_axis`` and its
    parameter columns over ``param_axis``; Wn (C, C) is replicated, and
    each rank contracts the columns of its own client block, ``w``
    (C, C / d), against its rows of Theta: per-rank partial products and
    one reduce-scatter over the client axis. The (C, P) output B is
    row-sharded like Theta, so each rank ends the round holding exactly
    its own clients' new bases (Cp / d x P live bytes, not C x P)."""
    return {"w": (None, client_axis), "thetas": (client_axis, param_axis),
            "out": (client_axis, param_axis), "wn": (None, None)}


def stacked_eval_specs(*, client_axis: str = "data"):
    """Layouts of the batched (C x tasks) retrieval evaluation: every input
    and output leads with the client dim, split over ``client_axis``; the
    task, query and gallery dims stay whole. Each rank evaluates its own
    clients end to end with no collective but the final gather of the
    (C, T) metrics."""
    def row(nd):
        return client_row_spec(nd, client_axis=client_axis)

    return {"qf": row(4), "qids": row(3), "task_mask": row(2),
            "gf": row(3), "gids": row(2), "gmask": row(2), "metrics": row(2)}


def stacked_eval_theta_specs(theta, *, client_axis: str = "data"):
    """Spec tree of a stacked (C, ...) eval-time head: client rows over
    ``client_axis``, everything else whole."""
    return stacked_tree_specs(theta, client_axis=client_axis)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def world_device(device) -> torch.device:
    """The device a rank of an initialized world runs on: ``cuda`` means
    ``cuda:LOCAL_RANK`` (0 without the variable), set as the current CUDA
    device; ``cpu`` and an explicit ``cuda:N`` are taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def torchrun_world(device) -> bool:
    """Join the world ``torchrun`` describes (RANK, WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT in the environment) with the backend of ``device``, for
    the rest of the process: a default group destroyed and made again over
    torchrun's store hangs in its rendezvous. Returns False, and does
    nothing, outside ``torchrun`` or when the default group is already
    up."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    dev = world_device(device)
    dist.init_process_group(BACKENDS[dev.type], init_method="env://",
                            timeout=GROUP_TIMEOUT)
    return True


@contextlib.contextmanager
def engine_world(device):
    """Yield the run's device inside a ``torch.distributed`` world.

    Inside an initialized default group (a caller's
    ``init_process_group``, or an earlier run's ``torchrun_world``) the run
    joins it. Otherwise it joins the world ``torchrun`` describes, or,
    outside ``torchrun``, creates a world of one on the run's device (an
    in-memory store: nothing is written anywhere), destroyed on exit. NCCL
    goes with CUDA, gloo with the CPU; a joined group of the other backend
    raises."""
    dev = world_device(device)
    want = BACKENDS[dev.type]
    if dist.is_initialized() or torchrun_world(dev):
        if dist.get_backend() != want:
            raise ValueError(
                f"the default process group runs {dist.get_backend()!r}, but "
                f"the run's device is {dev}: {dev.type} needs {want!r}")
        yield dev
        return
    dist.init_process_group(want, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
