"""Meshes and layouts over ``torch.distributed``: the port of
``repro/sharding/specs.py``, the federated engine's half and the model's.

The reference lets GSPMD partition its jitted programs from
``PartitionSpec`` layouts; PyTorch has no such partitioner that reaches
hand-written kernels, so the port runs explicit SPMD: every rank runs the
same Python on plain local tensors (its block of each layout) and calls
the named collectives of ``EngineMesh`` (the model code: of
``common.axes.AxisCtx``) where GSPMD would insert them.

Axis names are the reference's: "data" shards the client dim (every
stacked (C, ...) leaf puts its leading dim there), "model" the flattened
parameter dim of the (C, P) server matrices. The engine runs model = 1
today; the axis exists so the layouts carry over to meshes that split P.

A spec is a tuple with one entry per dim: an axis name (that dim is
split over the axis in contiguous blocks, rank r of the axis holding
block r, as GSPMD's row sharding does), a tuple of axis names (split
over their product, the first the major one, as ``P(("pod", "data"))``)
or None (whole on every rank). ``place`` / ``shard_tree`` cut a global
tensor (or tree) to this rank's block of a spec; ``gather_tree`` puts the
ranks' blocks back together.

The model half (``param_spec``, ``tree_param_specs``, ``batch_specs``,
``cache_specs``, ``serving_index_specs``) maps every leaf of an LM's
parameter, batch and decode-cache trees to its spec by its path, with the
reference's rules: Megatron tensor parallel over "model" (q / k / v and
the MLP's input projections split by column, the output projections by
row, experts and SSM heads over it, the vocab of the embedding and the
head), FSDP over "data" for the configs that ask for it, batches over
"data" (and "pod"), decode caches by sequence over "model".

C is padded to Cp, a multiple of the data-axis size
(``padded_clients``); rows [C, Cp) are padding (``pad_client_rows`` in
``federated/base.py``).

``engine_world`` gives ``run_simulation(engine="sharded")`` its world: the
initialized default group when there is one, else the world ``torchrun``
describes in the environment (joined for the rest of the process), else a
world of one on the run's device, destroyed at the end. NCCL goes with
CUDA tensors and gloo with CPU ones; a group whose backend does not match
the run's device raises. Meta tensors go with torch's "fake" backend
(``launch.mesh.fake_world``): a world of any size in one process, whose
collectives move nothing, where ``launch/dryrun.py`` runs rank 0's program
on the production meshes.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.pytree import (leaf_paths, tree_from_paths,
                                       tree_leaves, tree_map)
from repro_torch.configs.base import ModelConfig

ENGINE_AXES = ("data", "model")
# every process group of the port waits at most this long in a collective:
# a rank that raised must not hang the others for the default 30 minutes
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
# meta tensors run in a fake world (``launch.mesh.fake_world``): its
# collectives move nothing and return results of the right shapes
BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}

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
        self._axis_groups = {n: self.device_mesh.get_group(n) for n in names}

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
        """This rank's process group along ``axis`` (looked up once: the
        model code asks for it at every collective)."""
        return self._axis_groups[axis]

    def block(self, n: int, axis="data") -> Tuple[int, int]:
        """[lo, hi): this rank's contiguous block of ``n`` (a multiple of
        the axis size) along ``axis``, or along a tuple of axes (their
        product, the first the major one)."""
        d, r = 1, 0
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            d, r = d * self.shape[a], r * self.shape[a] + self.coords[a]
        return row_block(n, d, r)

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


def place(t: torch.Tensor, spec: Sequence, mesh: EngineMesh,
          device=None, parts: int = 1) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` (the
    counterpart of ``jax.device_put`` with a ``NamedSharding``), moved to
    ``device`` (the mesh's by default). ``parts`` > 1: the last dim is
    that many equal parts side by side, and the rank takes its block of
    each (``_PARTED``)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            k = parts if dim == t.dim() - 1 else 1
            t = t.unflatten(dim, (k, -1))
            lo, hi = mesh.block(t.shape[dim + 1], axis)
            t = t.narrow(dim + 1, lo, hi - lo).flatten(dim, dim + 1)
    return t.contiguous().to(mesh.device if device is None else device)


def place_tree(tree, spec_tree, mesh: EngineMesh, device=None):
    """``place`` over corresponding leaves of a tree and its spec tree (the
    counterpart of ``named_shardings`` + ``jax.device_put``)."""
    return tree_map(lambda t, s: place(t, s, mesh, device), tree, spec_tree)


# leaves whose last dim is equal parts side by side, each split over its
# axis on its own: mamba's w_zx (d, 2 d_inner) is [z | x], and a rank's
# channels need their z and x columns both, [z_r | x_r]. (The reference
# splits the concatenation by contiguous columns, so that at TP 2 one rank
# holds z and the other x: ROADMAP Queue 3.) The spec stays the
# reference's; the split and the gather deal the parts.
_PARTED = {("mamba", "w_zx"): 2}


def _parts_tree(tree):
    """The parts of each leaf of ``tree``, by its path's last two keys."""
    paths = leaf_paths(tree)
    return tree_from_paths(paths, [
        _PARTED.get(tuple(str(k) for k in p[-2:]), 1) for p in paths])


def shard_tree(tree, spec_tree, mesh: EngineMesh):
    """A global tree -> this rank's shards under ``spec_tree``, on the
    mesh's device (meta tensors stay meta)."""
    return tree_map(lambda t, s, k: place(
        t, s, mesh, t.device if t.is_meta else None, k), tree, spec_tree,
        _parts_tree(tree))


def _gather_dim(t: torch.Tensor, dim: int, axis, mesh: EngineMesh):
    for a in reversed(axis if isinstance(axis, tuple) else (axis,)):
        t = mesh.all_gather_rows(t.movedim(dim, 0), a).movedim(0, dim)
    return t.contiguous()


def gather_tree(tree, spec_tree, mesh: EngineMesh):
    """Inverse of ``shard_tree``: every rank's shards -> the global tree,
    on every rank (a collective: every rank of the mesh calls it)."""
    def one(t, spec, parts):
        t = t.detach()
        for dim, axis in enumerate(spec):
            if axis is not None:
                g = _gather_dim(t, dim, axis, mesh)
                if parts > 1 and dim == t.dim() - 1:
                    # the ranks' [z_r | x_r] blocks -> [z | x]
                    n = g.shape[dim] // t.shape[dim]
                    g = g.unflatten(dim, (n, parts, -1)).transpose(
                        dim, dim + 1).flatten(dim, dim + 2)
                t = g
        return t.contiguous()
    return tree_map(one, tree, spec_tree, _parts_tree(tree))


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
# the model half: parameters, batches and decode caches of an LM
# ---------------------------------------------------------------------------

# stacked-subtree prefixes (leading layer dim)
_STACKED = ("layers", "adaptive_layers", "enc_layers")


def _path_str(path) -> str:
    """A leaf's key path (``common.pytree.leaf_paths``) as "a/b/c"."""
    return "/".join(str(p) for p in path)


def param_spec(cfg: ModelConfig, path: str, shape, *, tp_axis="model",
               fsdp_axis: Optional[str] = "data", tp_size: int = 16) -> Spec:
    """The spec of one parameter leaf, identified by its path string. The
    path may carry any prefix (trainable/alpha/..., optimizer m / v, B):
    the rules match its trailing components."""
    fs = fsdp_axis if cfg.fsdp else None
    parts = path.split("/")
    stacked = any(s in parts for s in _STACKED)
    kv_split = cfg.n_kv_heads >= tp_size   # else replicated, group-sliced

    def lead(*spec):
        return ((None,) + spec) if stacked else spec

    def whole():
        return lead(*([None] * (len(shape) - (1 if stacked else 0))))

    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    if parent in ("attn", "cross"):
        if name == "wq":
            return lead(fs, tp_axis)
        if name in ("wk", "wv"):
            return lead(fs, tp_axis) if kv_split else lead(fs, None)
        if name == "wo":
            return lead(tp_axis, fs)
        if name == "bq":
            return lead(tp_axis)
        if name in ("bk", "bv"):
            return lead(tp_axis) if kv_split else lead(None)
        if name in ("qnorm", "knorm"):
            return lead(None)
    if parent in ("mlp", "dense"):            # dense MLP, MoE dense residual
        if name in ("wi", "wg"):
            return lead(fs, tp_axis)
        if name == "wo":
            return lead(tp_axis, fs)
    if parent == "moe":
        if name == "router":
            return lead(None, None)
        if name in ("wi", "wg"):                # (E, d, f)
            return lead(tp_axis, None, fs)
        if name == "wo":                        # (E, f, d)
            return lead(tp_axis, fs, None)
    if parent == "mamba":
        if name in ("w_zx", "w_dt"):
            return lead(fs, tp_axis)
        if name == "w_bc":
            return lead(fs, None)
        if name in ("dt_bias", "A_log", "D", "conv_b", "norm"):
            return lead(tp_axis)
        if name == "conv_w":
            return lead(None, tp_axis)
        if name == "w_out":
            return lead(tp_axis, fs)
    if parent == "time":                        # rwkv time mix
        if name in ("wr", "wk", "wv", "wg"):
            return lead(fs, tp_axis)
        if name == "wo":
            return lead(tp_axis, fs)
        if name in ("u", "ln_scale", "ln_bias"):
            return lead(tp_axis)
        if name in ("mu", "w0", "Aw", "Bw"):
            return whole()
    if parent == "chan":                        # rwkv channel mix
        if name == "wk":
            return lead(fs, tp_axis)
        if name == "wv":
            return lead(tp_axis, fs)
        if name in ("wr", "mu"):
            return whole()
    if parent == "embed" and name == "table":
        return (tp_axis, None)
    if parent == "head" and name == "w":
        return (None, tp_axis)
    # norms, scalars, anything else: replicated
    return (None,) * len(shape)


def tree_param_specs(cfg: ModelConfig, tree, **kw):
    """The spec tree of a parameter tree (of tensors, meta ones too)."""
    return tree_from_paths(leaf_paths(tree), [
        param_spec(cfg, _path_str(p), t.shape, **kw)
        for p, t in zip(leaf_paths(tree), tree_leaves(tree))])


def batch_axes(global_batch: int, dp: int, multi_pod: bool):
    """The axes the batch dim splits over: ("pod", "data") or "data", or
    None (replicated, e.g. long_500k's batch of 1) when they do not divide
    it."""
    axes = ("pod", "data") if multi_pod else ("data",)
    total = dp * (2 if multi_pod else 1)
    if global_batch % total == 0:
        return axes if multi_pod else "data"
    if global_batch % dp == 0:                  # over data alone
        return "data"
    return None


def batch_specs(cfg: ModelConfig, batch_tree, global_batch: int, dp: int,
                multi_pod: bool):
    """Every batch leaf split over ``batch_axes`` on its leading dim."""
    b = batch_axes(global_batch, dp, multi_pod)
    return tree_map(lambda t: (b,) + (None,) * (len(t.shape) - 1),
                    batch_tree)


def cache_specs(cfg: ModelConfig, cache_tree, global_batch: int, dp: int,
                multi_pod: bool, *, tp_axis="model"):
    """Decode caches: (L, B, S, KV, hd) k / v by batch over data and by
    SEQUENCE over model (the flash-decoding layout); the recurrent states
    by heads / channels over model."""
    b = batch_axes(global_batch, dp, multi_pod)
    rules = {"k": (None, b, tp_axis, None, None),
             "v": (None, b, tp_axis, None, None),
             "k_scale": (None, b, tp_axis, None),
             "v_scale": (None, b, tp_axis, None),
             "h": (None, b, tp_axis, None, None),        # mamba
             "conv": (None, b, None, tp_axis),
             "S": (None, b, tp_axis, None, None),        # rwkv
             "x_att": (None, b, None), "x_ffn": (None, b, None)}
    return tree_from_paths(leaf_paths(cache_tree), [
        rules.get(p[-1], (None,) * len(t.shape))
        for p, t in zip(leaf_paths(cache_tree), tree_leaves(cache_tree))])


def serving_index_specs(*, client_axis: str = "data"):
    """Layouts of the serving index's device image (``serving/``): every
    resident array (query batches, the flat int8 image, the IVF bucket
    image) leads with the client dim, split over ``client_axis``; each
    rank serves its own clients' galleries end to end with no
    cross-client collective."""
    def row(nd):
        return client_row_spec(nd, client_axis=client_axis)

    return {"qp": row(3), "qmask": row(2), "bn_mu": row(2), "bn_sd": row(2),
            "gq": row(3), "gscale": row(2), "gn2": row(2), "gids": row(2),
            "gf": row(3), "cent": row(3), "cn2": row(2), "bq": row(4),
            "pack": row(4), "binv": row(3)}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def world_device(device) -> torch.device:
    """The device a rank of an initialized world runs on: ``cuda`` means
    ``cuda:LOCAL_RANK`` (0 without the variable), set as the current CUDA
    device; ``cpu`` and an explicit ``cuda:N`` are taken as given; ``meta``
    only inside a fake world (``launch.mesh.fake_world``)."""
    dev = torch.device(device)
    if dev.type == "meta":
        if not (dist.is_initialized()
                and dist.get_backend() == BACKENDS["meta"]):
            raise ValueError("device 'meta' runs only inside a fake world "
                             "(repro_torch.launch.mesh.fake_world)")
    elif dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda, cpu "
                         "or, in a fake world, meta")
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
