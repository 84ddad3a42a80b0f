"""Program registry: every hot entry point of the port, traceable on meta
tensors (the port of ``repro/analysis/registry.py``).

A *program* is a callable plus the metadata the lint passes need: its
abstract inputs (a thunk returning ``(args, kwargs)``, the tensors on the
``meta`` device, where JAX has ``ShapeDtypeStruct``s; kwargs are static
config), which positional args are round-carried state (``carry``) and
which the program updates in place (``donate``: JAX's donated buffers), a
peak-bytes budget, the dtype set the program is allowed to touch, and the
dotted path of its retained host oracle.

Module-level functions register with the decorator::

    @register_program("kernels.fused_relevance_aggregate",
                      abstract_args=lambda: ((meta(100, 100),
                                              meta(100, 4096)), {}),
                      oracle="repro_torch.kernels.ref."
                             "fused_relevance_aggregate_ref",
                      budget_bytes=16 << 20)
    def fused_relevance_aggregate(w, thetas): ...

Programs the port builds inside methods (the ring relevance, the stacked
server round, the stacked local train, the codec's stages) are composed in
``analysis/manifest.py`` from the production pieces and registered through
``register_runtime`` when ``load_all()`` runs.

Registering is free at import time: the decorator only records metadata.
``trace(spec)`` runs the program once on its meta inputs under a
``Recorder``, a ``TorchDispatchMode`` built on the production lowering's
``sharding.analysis.OpCounter`` (one count of FLOPs and peak live bytes for
the lint and ``launch/dryrun.py``), which also records every dispatched op:
its name, the storages it reads, makes and writes, their dtypes, and the
first port frame outside ``analysis/`` that called it. Backward ops that a
program dispatches are part of its trace. Meta tensors hold no data, so
nothing runs on any device; an op that needs data on the host (``.item()``,
a shape set by the data, a copy to the CPU) raises on meta, so the
recorder stops the trace there and records it as a host sync.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import sys
import sysconfig
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.sharding.analysis import OpCounter

# dtypes a program may touch unless it declares otherwise: the measured
# wire / compute dtypes (bf16 / int8 / f32) plus the index and mask types
# every program needs. int64 is in, where the reference leaves it out:
# torch's index dtype (``topk``, ``argsort``, ``sort``, ``arange``,
# ``gather``'s index) is int64 where JAX's is int32, so an int64 index is
# the port's idiom, not a widened payload. float64 and complex are NEVER in
# a default set: f64 creep is exactly what the dtype lint exists to catch.
DEFAULT_ALLOWED_DTYPES = frozenset({
    "float32", "bfloat16", "float16", "int8", "uint8", "int32", "uint32",
    "int64", "bool",
})

# default peak-bytes budget (the reference's): the bench configs keep
# their live intermediates well under it
DEFAULT_BUDGET_BYTES = 256 << 20

# modules whose import registers the programs; the manifest composes the
# ones built inside methods
PROGRAM_MODULES = (
    "repro_torch.core",
    "repro_torch.kernels.ops",
    "repro_torch.evalreid.batched",
    "repro_torch.federated.base",
    "repro_torch.serving.engine",
    "repro_torch.serving.index",
    "repro_torch.analysis.manifest",
)


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registered program and the invariants the lints check."""

    name: str
    fn: Callable
    abstract_args: Callable[[], Tuple[tuple, dict]]
    module: str
    oracle: Optional[str] = None          # dotted path of the host oracle
    carry: Tuple[int, ...] = ()           # round-carried positional args
    donate: Tuple[int, ...] = ()          # args updated in place
    budget_bytes: int = DEFAULT_BUDGET_BYTES
    allowed_dtypes: frozenset = DEFAULT_ALLOWED_DTYPES
    # a device-to-host sync (``.item()``, a data-shaped op, a copy to the
    # CPU) is allowed: torch's twin of the reference's host callback
    allow_syncs: bool = False
    # (src, dst) dtype casts this program performs on purpose (the bf16
    # wire cast of common/precision.py). The convert-churn lint skips
    # A->B->A round-trips whose both legs are sanctioned.
    sanctioned_casts: frozenset = frozenset()

    def build_args(self) -> Tuple[tuple, dict]:
        return self.abstract_args()


_REGISTRY: Dict[str, ProgramSpec] = {}
_LOADED = False


def _register(spec: ProgramSpec) -> None:
    prev = _REGISTRY.get(spec.name)
    if prev is not None and prev.module != spec.module:
        raise ValueError(
            f"program {spec.name!r} registered twice "
            f"({prev.module} and {spec.module})")
    _REGISTRY[spec.name] = spec


def _spec(name, fn, abstract_args, module, oracle=None, carry=(), donate=(),
          budget_bytes=DEFAULT_BUDGET_BYTES,
          allowed_dtypes=DEFAULT_ALLOWED_DTYPES, allow_syncs=False,
          sanctioned_casts=()) -> ProgramSpec:
    return ProgramSpec(
        name=name, fn=fn, abstract_args=abstract_args, module=module,
        oracle=oracle, carry=tuple(carry), donate=tuple(donate),
        budget_bytes=budget_bytes, allowed_dtypes=frozenset(allowed_dtypes),
        allow_syncs=allow_syncs, sanctioned_casts=frozenset(sanctioned_casts))


def register_program(name: str, *, abstract_args, **kw):
    """Decorator: record ``fn`` as the traceable program ``name`` (the
    keywords are ``ProgramSpec``'s fields)."""

    def wrap(fn):
        _register(_spec(name, fn, abstract_args,
                        getattr(fn, "__module__", "<runtime>"), **kw))
        return fn

    return wrap


def register_runtime(name: str, fn: Callable, *, abstract_args, module: str,
                     **kw) -> None:
    """Manifest entry point for programs composed at runtime."""
    _register(_spec(name, fn, abstract_args, module, **kw))


def load_all() -> Dict[str, ProgramSpec]:
    """Import every program module (running the decorators + manifest)
    and return the full registry. Idempotent."""
    global _LOADED
    if not _LOADED:
        for mod in PROGRAM_MODULES:
            importlib.import_module(mod)
        _LOADED = True
    return dict(_REGISTRY)


def iter_programs() -> List[ProgramSpec]:
    return [load_all()[k] for k in sorted(load_all())]


def get_program(name: str) -> ProgramSpec:
    reg = load_all()
    if name not in reg:
        raise KeyError(f"unknown program {name!r}; registered: {sorted(reg)}")
    return reg[name]


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def meta(*shape, dtype=torch.float32) -> torch.Tensor:
    """An abstract input: a tensor of ``shape`` and ``dtype`` on the meta
    device (no data)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_like(tree, lead: Optional[int] = None):
    """Every tensor of a tree (dicts, tuples, lists) as a meta tensor of
    its shape and dtype, the leading dim replaced by ``lead`` if given."""
    def one(t):
        shape = tuple(t.shape) if lead is None else (lead,) + tuple(
            t.shape[1:])
        return meta(*shape, dtype=t.dtype)
    return torch.utils._pytree.tree_map_only(torch.Tensor, one, tree)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def tensors(tree) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


@dataclasses.dataclass(frozen=True)
class Sync:
    """A device-to-host sync the program dispatched: ``kind`` says which
    (a value read, a data-shaped output, a copy), ``op`` the aten op."""

    kind: str
    op: str
    site: str


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: the storages it reads and returns (storage ids,
    unique over the trace, and dtype names), the storages it writes in
    place, whether its outputs are views, and its call site."""

    name: str
    ins: Tuple[Tuple[int, str], ...]
    outs: Tuple[Tuple[int, str], ...]
    writes: Tuple[int, ...]
    view: bool
    effect: bool
    site: str


@dataclasses.dataclass
class Trace:
    """A program's run on its abstract inputs: ``ops`` in dispatch order,
    ``inputs`` its input tensors (storage id, dtype), ``arg_storages`` the
    storage ids of each positional arg, ``outputs`` the output storage
    ids, ``syncs`` the host syncs seen, ``stopped`` the one that ended the
    trace (meta holds no data to read), and the counter's peak live bytes
    of the storages made inside and its FLOPs."""

    ops: List[OpRecord]
    inputs: List[Tuple[int, str]]
    arg_storages: List[List[int]]
    outputs: List[int]
    syncs: List[Sync]
    stopped: Optional[Sync]
    peak_bytes: int
    flops: int


class Stopped(BaseException):
    """Raised through the program where it needs data that meta tensors do
    not hold (a BaseException: a program's ``except Exception`` does not
    swallow it)."""

    def __init__(self, sync: Sync):
        super().__init__(f"{sync.kind} at {sync.site}")
        self.sync = sync


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = (os.path.join(_PKG, "analysis") + os.sep,
         os.path.join(_PKG, "sharding", "analysis.py"))
_OUTSIDE = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
            sysconfig.get_paths()["stdlib"] + os.sep)
_ROOT = os.path.dirname(os.path.dirname(_PKG))


def _site() -> str:
    """The first ``repro_torch`` frame outside ``analysis/`` (the lint's
    own machinery), else the first frame outside torch and the standard
    library (a program defined in a test), as ``path:line``."""
    f, other = sys._getframe(2), None
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.startswith(_SKIP):
            return f"{os.path.relpath(path, _ROOT)}:{f.f_lineno}"
        if other is None and not path.startswith(_OUTSIDE + _SKIP):
            other = f"{os.path.relpath(path, _ROOT)}:{f.f_lineno}"
        f = f.f_back
    return other or "<unknown>"


# ops that read a device value to the host, and ops whose output shape
# depends on the data (the host must read a count first)
_VALUE_READS = {"aten._local_scalar_dense", "aten.equal", "aten.is_nonzero"}
_DATA_SHAPED = {"aten.nonzero", "aten.masked_select", "aten._unique",
                "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
                "aten.unique_dim_consecutive", "aten.bincount"}
_MASK_INDEXED = {"aten.index", "aten.index_put", "aten.index_put_",
                 "aten._index_put_impl_"}


def _device(x) -> Optional[str]:
    return None if x is None else torch.device(x).type


def _off_host(ts) -> bool:
    return any(t.device.type != "cpu" for t in ts)


def sync_kind(func, args, kwargs) -> Optional[str]:
    """What host sync ``func`` on these operands is, or None. Ops on host
    tensors alone sync nothing; a blocking copy from the host to the
    device counts: torch's sync debug mode calls it one."""
    name = str(func.overloadpacket)
    if not _off_host(tensors(args)):
        if name == "aten._to_copy" and _device(kwargs.get("device")) not in (
                None, "cpu") and not kwargs.get("non_blocking", False):
            return "blocking copy from the host"
        return None
    if name in _VALUE_READS:
        return "value read to the host"
    if name in _DATA_SHAPED or (name == "aten.repeat_interleave"
                                and kwargs.get("output_size") is None
                                and func._overloadname.startswith("Tensor")):
        return "output shaped by the data"
    if name in _MASK_INDEXED and any(
            t.dtype in (torch.bool, torch.uint8)
            for t in tensors(args[1] if len(args) > 1 else ())):
        return "boolean-mask index (output shaped by the data)"
    if name == "aten._to_copy" and _device(kwargs.get("device")) == "cpu":
        return "copy to the host"
    if name == "aten.copy_":
        dst, src = args[0].device.type, args[1].device.type
        blocking = not (args[2] if len(args) > 2
                        else kwargs.get("non_blocking", False))
        if dst == "cpu" and src != "cpu":
            return "copy to the host"
        if src == "cpu" and dst != "cpu" and blocking:
            return "blocking copy from the host"
    return None


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The operands ``func``'s schema says it writes in place."""
    out, pos = [], 0
    for a in func._schema.arguments:
        if a.kwarg_only:
            v = kwargs.get(a.name)
        else:
            v = args[pos] if pos < len(args) else kwargs.get(a.name)
            pos += 1
        if a.alias_info is not None and a.alias_info.is_write:
            out.extend(tensors(v))
    return out


class Recorder(OpCounter):
    """``OpCounter`` that also records every op it runs on a device (meta
    or a card: ops on host tensors alone, such as a mesh's layout, are the
    host's bookkeeping, not the program's) in ``ops``, and every host sync
    in ``syncs``. On meta operands a sync that needs data raises
    ``Stopped`` before the op runs; on real tensors it is recorded and the
    op runs."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.syncs: List[Sync] = []
        self._ids: Dict[int, int] = {}
        self._next = 0

    def storage_id(self, t: torch.Tensor) -> int:
        """A storage's id, unique over this recording (a freed storage's
        address may come back for a new one)."""
        s = t.untyped_storage()
        key = s._cdata
        sid = self._ids.get(key)
        if sid is None:
            sid = self._ids[key] = self._next
            self._next += 1
            weakref.finalize(s, self._ids.pop, key, None)
        return sid

    def _refs(self, ts) -> Tuple[Tuple[int, str], ...]:
        return tuple((self.storage_id(t), dtype_name(t.dtype)) for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = sync_kind(func, args, kwargs)
        if kind is not None:
            sync = Sync(kind, str(func.overloadpacket), _site())
            self.syncs.append(sync)
            if kind != "blocking copy from the host" and any(
                    t.device.type == "meta" for t in tensors((args, kwargs))):
                raise Stopped(sync)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def on_op(self, func, args, kwargs, out) -> None:
        if not _off_host(tensors((args, kwargs, out))):
            return
        writes = tuple(self.storage_id(t) for t in _written(func, args, kwargs))
        self.ops.append(OpRecord(
            name=str(func.overloadpacket),
            ins=self._refs(tensors((args, kwargs))),
            outs=self._refs(tensors(out)), writes=writes,
            view=bool(func.is_view),
            effect=bool(writes) or func.namespace in ("c10d",
                                                       "_c10d_functional"),
            site=_site()))


def record(fn: Callable, args: tuple, kwargs: dict) -> Trace:
    """Run ``fn(*args, **kwargs)`` under a ``Recorder`` -> its ``Trace``
    (meta operands: nothing runs; real ones: the program runs)."""
    rec = Recorder()
    inputs = list(rec._refs(tensors((args, kwargs))))
    arg_storages = [[rec.storage_id(t) for t in tensors(a)] for a in args]
    out, stopped = None, None
    try:
        with rec:
            out = fn(*args, **kwargs)
    except Stopped as e:
        stopped = e.sync
    outputs = [rec.storage_id(t) for t in tensors(out)]
    return Trace(ops=rec.ops, inputs=inputs, arg_storages=arg_storages,
                 outputs=outputs, syncs=rec.syncs, stopped=stopped,
                 peak_bytes=rec.peak_live_bytes, flops=rec.flops)


def trace(spec: ProgramSpec) -> Trace:
    """The program's ``Trace`` over its abstract (meta) args."""
    args, kwargs = spec.build_args()
    return record(spec.fn, args, kwargs)


def resolve_oracle(path: str) -> Any:
    """Import the dotted ``module.attr[.attr...]`` oracle path."""
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            break
        return obj
    raise ImportError(f"oracle path {path!r} does not resolve")


def coverage() -> Dict[str, Any]:
    """Registry coverage: how many of the registered programs trace
    cleanly right now. A program silently dropping out of analysis shows
    up as traced < registered."""
    traced, failed = [], []
    for spec in iter_programs():
        try:
            trace(spec)
            traced.append(spec.name)
        except Exception as e:                      # noqa: BLE001
            failed.append({"name": spec.name, "error": repr(e)[:200]})
    out = {"programs_registered": len(traced) + len(failed),
           "programs_traced": len(traced), "traced": traced}
    if failed:
        out["failed"] = failed
    return out
