"""Per-device bytes, counted costs and collective traffic of the port's
per-rank programs, priced against the H100's roofline: the port of
``repro/sharding/analysis.py``.

The reference lowers a step with XLA and reads its FLOPs from
``cost_analysis`` and its collectives from the HLO text. The port has no
HLO: ``launch/dryrun.py`` runs the per-rank program on meta tensors in a
fake world (``launch.mesh.fake_world``), and ``OpCounter``, a
``TorchDispatchMode``, counts what it dispatches:

  * FLOPs: each op by ``torch.utils.flop_counter``'s formulas (mm, bmm,
    addmm, baddbmm, convolutions, SDPA), the flash kernels' ops by the
    kernels' own arithmetic (``kernels/ops.py``);
  * collectives: every ``_c10d_functional`` and ``c10d`` collective, with
    its kind, result bytes and group ranks, priced by the reference's ring
    formulas (``CollectiveStats``);
  * peak live bytes: the storages the program makes, each live until it is
    freed. An estimate: the caching allocator's rounding, library
    workspaces and the kernels' own scratch are not seen.

The same counter runs on the card around the same code, so a count on meta
and one on the card can be held equal. ``count_scale(n)`` multiplies what
is counted inside by n: ``repeat_step`` costs a time loop of n identical
steps by one step on meta tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# numpy / ml_dtypes name -> HLO short name (the reference's width table)
_NP_TO_HLO = {
    "float64": "f64", "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
    "int64": "s64", "uint64": "u64", "int32": "s32", "uint32": "u32",
    "int16": "s16", "uint16": "u16", "int8": "s8", "uint8": "u8",
    "bool": "pred", "complex64": "c64", "complex128": "c128",
}


def dtype_bytes(dtype) -> int:
    """Bytes per element of a torch dtype or a numpy / ml_dtypes dtype or
    name (table-driven, ``itemsize`` as the fallback)."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = getattr(dtype, "name", str(dtype))
    hlo = _NP_TO_HLO.get(name, name)
    if hlo in _DTYPE_BYTES:
        return _DTYPE_BYTES[hlo]
    return int(getattr(dtype, "itemsize", 4))


def aval_bytes(shape, dtype) -> int:
    """Total bytes of an abstract value (shape x dtype width)."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype_bytes(dtype)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def moved_bytes(kind: str, size: int, g: int) -> int:
    """Per-device wire bytes of one collective, the reference's ring
    formulas (size = result buffer bytes, g = group size):
      all-gather:     result is gathered -> moves size*(g-1)/g
      all-reduce:     2 * size * (g-1)/g
      reduce-scatter: input = result*g   -> moves size*(g-1)  [input-relative]
      all-to-all:     size * (g-1)/g
      collective-permute: size
    """
    g = max(g, 1)
    if kind == "all-gather":
        return size * (g - 1) // g
    if kind == "all-reduce":
        return 2 * size * (g - 1) // g
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-to-all":
        return size * (g - 1) // g
    return size


# ---------------------------------------------------------------------------
# the H100's roofline
# ---------------------------------------------------------------------------

# NVIDIA H100 80GB HBM3, 700 W (H100 SXM5 data sheet): dense bf16 tensor
# cores 989 TFLOP/s; HBM3 3.35 TB/s
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
# NVLink 4 within a node of 8 cards (NVSwitch): 900 GB/s a card, 450 GB/s
# a direction; between nodes one NDR InfiniBand port a card, 400 Gb/s =
# 50 GB/s
NVLINK_BW = 450e9
INTERNODE_BW = 50e9
NODE_SIZE = 8


def in_one_node(ranks) -> bool:
    """Whether a group's ranks lie in one node of ``NODE_SIZE`` consecutive
    ranks."""
    return len({r // NODE_SIZE for r in ranks}) <= 1


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    model_flops: float = 0.0       # analytic (global, all devices)
    # of the collective bytes, those whose group lies in one node (NVLink);
    # the rest cross nodes
    nvlink_bytes_per_device: float = 0.0

    @property
    def internode_bytes_per_device(self) -> float:
        return self.collective_bytes_per_device - self.nvlink_bytes_per_device

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.nvlink_bytes_per_device / NVLINK_BW
                + self.internode_bytes_per_device / INTERNODE_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return (self.model_flops / total) if total else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "nvlink_bytes_per_device": self.nvlink_bytes_per_device,
            "internode_bytes_per_device": self.internode_bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analytic_model_flops(cfg, shape) -> float:
    """Theoretical-minimum model FLOPs: 2*N_active*D forward; training adds
    backward ONLY over the FedSTIL-adaptive slice (frozen trunk!), i.e.
    +4*N_adaptive*D. (Plain 6*N*D would be the full-fine-tune number.)"""
    n_active = cfg.active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    if shape.mode == "train":
        return (2.0 * n_active + 4.0 * cfg.adaptive_active_params()) * tokens
    return 2.0 * n_active * tokens


# ---------------------------------------------------------------------------
# counting what a program dispatches
# ---------------------------------------------------------------------------

_SCALE = [1]


@contextlib.contextmanager
def count_scale(n: int):
    """Everything an ``OpCounter`` counts inside is counted ``n`` times
    (nested scales multiply)."""
    _SCALE.append(_SCALE[-1] * int(n))
    try:
        yield
    finally:
        _SCALE.pop()


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str                  # one of the reference's five kinds
    result_bytes: int          # the result buffer's bytes on this rank
    ranks: Tuple[int, ...]     # the group's global ranks
    times: int = 1             # the count_scale it ran under

    @property
    def moved(self) -> int:
        return moved_bytes(self.kind, self.result_bytes, len(self.ranks))


# op name -> kind and whether the result is the op's output (True) or its
# first tensor argument, written in place (False)
_KINDS = {
    "_c10d_functional.all_reduce": ("all-reduce", True),
    "_c10d_functional.all_reduce_": ("all-reduce", True),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", True),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", True),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", True),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", True),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", True),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", True),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         True),
    "_c10d_functional.all_to_all_single": ("all-to-all", True),
    "c10d.allreduce_": ("all-reduce", False),
    "c10d.allreduce_coalesced_": ("all-reduce", False),
    "c10d._allgather_base_": ("all-gather", False),
    "c10d.allgather_": ("all-gather", False),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", False),
    "c10d._reduce_scatter_base_": ("reduce-scatter", False),
    "c10d.reduce_scatter_": ("reduce-scatter", False),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", False),
    "c10d.alltoall_base_": ("all-to-all", False),
    "c10d.alltoall_": ("all-to-all", False),
    "c10d.send": ("collective-permute", False),
}

# metadata queries: no work, no storage (FlopCounterMode's list)
_NO_WORK = {torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_ranks(func, args, kwargs) -> Tuple[int, ...]:
    """The global ranks of a collective's group: a functional op names it
    (``group_name``), a c10d op passes the group itself."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for i, a in enumerate(func._schema.arguments):
        v = kwargs.get(a.name, args[i] if i < len(args) else None)
        if a.name == "group_name":
            return tuple(dist.get_process_group_ranks(
                _resolve_process_group(v)))
        if a.name == "process_group":
            return tuple(dist.get_process_group_ranks(
                dist.ProcessGroup.unbox(v)))
    raise ValueError(f"{func}: no group argument")


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it (``with OpCounter() as c:``):
    ``flops``, ``collectives`` (a list of ``Collective``) and
    ``peak_live_bytes`` / ``live_bytes``, the bytes of the storages made
    inside and not yet freed (at their largest, and now)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.collectives: List[Collective] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _NO_WORK:
            return NotImplemented
        # a composite op the dispatcher hands over whole: count its parts,
        # as FlopCounterMode does
        if func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        scale = _SCALE[-1]
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n * scale
            key = str(packet)
            self.flops_by_op[key] = self.flops_by_op.get(key, 0) + n * scale
        name = str(packet)
        if name in _KINDS:
            kind, from_out = _KINDS[name]
            result = out if from_out else args[0]
            self.collectives.append(Collective(
                kind, _nbytes(result), _group_ranks(func, args, kwargs),
                scale))
        if not func.is_view:
            self._track(args, kwargs, out)
        return out

    def _track(self, args, kwargs, out) -> None:
        seen = {id(t.untyped_storage()) for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            s = t.untyped_storage()
            key = id(s)
            if key in seen or key in self._live:
                continue
            self._live[key] = s.nbytes()
            self.live_bytes += s.nbytes()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(s, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def stats(self) -> CollectiveStats:
        """Per-kind wire bytes and counts, the reference's record."""
        by_bytes = {k: 0 for k in _COLLECTIVES}
        by_count = {k: 0 for k in _COLLECTIVES}
        for c in self.collectives:
            by_bytes[c.kind] += c.moved * c.times
            by_count[c.kind] += c.times
        return CollectiveStats(by_bytes, by_count)

    def nvlink_bytes(self) -> int:
        """Of the wire bytes, those of groups that lie in one node."""
        return sum(c.moved * c.times for c in self.collectives
                   if in_one_node(c.ranks))

    def ledger(self):
        """The collectives as sorted (kind, result bytes, group size,
        times) rows: what two runs of one program must agree on."""
        return sorted((c.kind, c.result_bytes, len(c.ranks), c.times)
                      for c in self.collectives)


# ---------------------------------------------------------------------------
# time loops on meta tensors
# ---------------------------------------------------------------------------


class _Repeated(torch.autograd.Function):
    """One step standing for n: forward and backward under
    ``count_scale(n)``, outputs of the full loop's shapes."""

    @staticmethod
    def forward(ctx, step, n, shapes, *args):
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(a.requires_grad) for a in args]
            with count_scale(n):
                outs = step(*ins)
        ctx.n, ctx.ins, ctx.outs = n, ins, outs
        return tuple(o.new_empty(s) for o, s in zip(outs, shapes))

    @staticmethod
    def backward(ctx, *grads):
        want = [a for a in ctx.ins if a.requires_grad]
        pairs = [(o, g.new_empty(o.shape)) for o, g in zip(ctx.outs, grads)
                 if o.requires_grad]
        got = []
        if want and pairs:
            with count_scale(ctx.n):
                got = torch.autograd.grad([o for o, _ in pairs], want,
                                          [g for _, g in pairs],
                                          allow_unused=True)
        got = iter(got)
        return (None, None, None) + tuple(
            next(got) if a.requires_grad else None for a in ctx.ins)


def repeat_step(step, n: int, shapes, *args):
    """A time loop of ``n`` steps of equal cost on meta tensors, costed by
    one: ``step(*args)`` runs once (and its backward once, when a gradient
    is asked for) with every count scaled by ``n``, and the outputs take
    ``shapes``, the whole loop's (values on meta are never read)."""
    if not (torch.is_grad_enabled()
            and any(a.requires_grad for a in args)):
        with count_scale(n):
            outs = step(*args)
        return tuple(o.new_empty(s) for o, s in zip(outs, shapes))
    return _Repeated.apply(step, n, shapes, *args)
