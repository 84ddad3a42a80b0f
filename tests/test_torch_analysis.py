"""The port's static analyzer (``repro_torch.analysis``) on the CPU.

  * each trace pass fires on its known-bad toy program on meta tensors,
    and stays quiet where the program is right (the reference's
    ``tests/test_analysis.py`` restated as torch programs, plus the
    port's own cases: data-shaped ops and copies to the host, in-place
    carried updates, the sanctioned bf16 wire cast, backward ops);
  * the same toys' verdicts from the reference's passes (JAX programs)
    and the port's are the same codes. ``jax.core`` lost ``Var``,
    ``ClosedJaxpr``, ``Jaxpr``, ``Literal`` and ``DropVar`` in JAX 0.9,
    which the reference's passes read: the comparisons hand those names
    back from ``jax._src.core`` for their own duration, so the
    reference's code runs as written. Its donation-by-trace check looks
    for a ``pjit`` equation that JAX 0.9 names ``jit``, so that half of
    ``undonated-carry`` is held on the torch toys alone;
  * the registry equals the reference's: the same 34 names (and the
    port's own ``PORT_ONLY`` besides), and per name the same carry,
    donate, budget and sanctioned casts, the dtype set plus int64, the
    module's twin;
  * the convention passes and the baseline partition give the
    reference's findings on the same synthetic trees, spelled for each
    package;
  * the real port is clean: ``python -m repro_torch.analysis.lint --json``
    in a subprocess, and the full lint again in a worker process
    (``tests/torch_analysis_worker.py``: a process holds one default
    group, and the sharded programs make theirs).
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import conventions, lint, lints, registry
from repro_torch.analysis.lints import Finding
from repro_torch.analysis.registry import ProgramSpec, meta
from repro_torch.common.precision import WIRE_CASTS

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
LINT_TIMEOUT_S = 600

# the reference's registered programs (``repro.analysis.registry``)
NAMES = (
    "comm.batched_decode", "comm.batched_encode",
    "comm.batched_encode_keyframe", "evalreid.batched_retrieval_metrics",
    "federated.fedstil_server_flatten", "federated.fedstil_server_relevance",
    "federated.fedstil_server_round", "federated.sharded_aggregate",
    "federated.sharded_eval", "federated.sharded_server_round",
    "federated.stacked_eval", "federated.stacked_local_train",
    "kernels.adaptive_combine", "kernels.batched_cluster_assign",
    "kernels.batched_dequantize", "kernels.batched_idx_bitpack",
    "kernels.batched_idx_bitunpack", "kernels.batched_int8_pairwise_dist",
    "kernels.batched_ivf_shortlist", "kernels.batched_pairwise_dist",
    "kernels.batched_quantize", "kernels.batched_topk_pack",
    "kernels.batched_topk_unpack", "kernels.flash_attention",
    "kernels.fused_relevance_aggregate", "kernels.kl_similarity",
    "kernels.pairwise_dist", "kernels.relevance_aggregate",
    "serving.index_refresh", "serving.index_refresh_ivf",
    "serving.query_fp32", "serving.query_int8", "serving.query_ivf",
    "serving.query_ivf_metrics",
)
# the port's programs the reference has no counterpart of: the decode
# attention kernel (the reference decodes with jnp einsums)
PORT_ONLY = ("kernels.decode_attention",)


def _spec(fn, args, name="toy", **kw):
    return ProgramSpec(name=name, fn=fn, abstract_args=lambda: (args, {}),
                       module="tests.test_torch_analysis", **kw)


def _lint(fn, args, **kw):
    spec = _spec(fn, args, **kw)
    tr = registry.trace(spec)
    fs, stats = lints.run_jaxpr_lints(tr, spec)
    return fs, stats, tr


def _codes(findings):
    return {f.code for f in findings}


# ---------------------------------------------------------------------------
# trace passes on known-bad toy programs (the reference's tests, restated)
# ---------------------------------------------------------------------------


def test_dtype_widen_fires_on_f64():
    fs, _, _ = _lint(lambda x: torch.sum(x.double()), (meta(8),))
    widen = [f for f in fs if f.code == "dtype-widen"]
    assert widen and "float64" in widen[0].message
    # the first op and its site: this file
    assert "aten._to_copy" in widen[0].message
    assert "tests/test_torch_analysis.py:" in widen[0].message


def test_dtype_widen_quiet_when_declared():
    fs, _, _ = _lint(lambda x: torch.sum(x.double()), (meta(8),),
                     allowed_dtypes=frozenset({"float32", "float64"}))
    assert "dtype-widen" not in _codes(fs)


def test_int64_indices_are_allowed_by_default():
    """torch's index dtype is int64 (sort, topk, arange): in the default
    set, where the reference's int32 is."""
    def f(x):
        v, i = torch.sort(x, stable=True)
        return torch.gather(x, 0, i[:4]) + torch.arange(4, device=x.device)
    fs, _, _ = _lint(f, (meta(16),))
    assert not fs


def test_convert_churn_fires_on_roundtrip():
    fs, _, _ = _lint(lambda x: x.bfloat16().float() + 1.0, (meta(16),))
    churn = [f for f in fs if f.code == "convert-churn"]
    assert churn and "float32 -> bfloat16 -> float32" in churn[0].message


def test_sanctioned_wire_roundtrip_is_quiet():
    """The sharded engine's f32 -> bf16 -> f32 wire cast, declared."""
    fs, _, _ = _lint(lambda x: x.bfloat16().float() + 1.0, (meta(16),),
                     sanctioned_casts=WIRE_CASTS)
    assert "convert-churn" not in _codes(fs)


def test_one_way_casts_are_not_churn():
    fs, _, _ = _lint(lambda x: x.bfloat16() * 2, (meta(16),))
    assert "convert-churn" not in _codes(fs)


def _item_in_loop(xs):
    c = xs.new_zeros(())
    for i in range(xs.shape[0]):
        c = c + xs[i].item()
    return c


def test_host_sync_in_loop_body_fires():
    """``.item()`` in a loop: one host round-trip an iteration (the
    reference's callback in a scan body). On meta the trace stops there."""
    fs, _, tr = _lint(_item_in_loop, (meta(4),))
    sync = [f for f in fs if f.code == "host-transfer"]
    assert sync and "value read to the host" in sync[0].message
    assert "aten._local_scalar_dense" in sync[0].message
    assert "the trace stops here" in sync[0].message
    assert tr.stopped is not None and tr.stopped.op == \
        "aten._local_scalar_dense"
    # and the escape hatch silences it
    fs_ok, _, _ = _lint(_item_in_loop, (meta(4),), allow_syncs=True)
    assert "host-transfer" not in _codes(fs_ok)


def test_undonated_carry_by_declaration():
    spec = _spec(lambda s, x: s + x, (meta(8), meta(8)), carry=(0,),
                 donate=())
    fs = lints.lint_donation(spec)
    assert [f.code for f in fs] == ["undonated-carry"]


def test_undonated_carry_by_trace():
    """Declared donate, but the carried state comes back out of place."""
    fs, _, _ = _lint(lambda s, x: s + x, (meta(8), meta(8)), carry=(0,),
                     donate=(0,))
    assert any(f.code == "undonated-carry"
               and "come back out of place" in f.message for f in fs)


def test_in_place_carried_update_is_quiet():
    def step(s, x):
        s.add_(x)
        return s
    fs, _, _ = _lint(step, (meta(8), meta(8)), carry=(0,), donate=(0,))
    assert not fs


def test_in_place_update_of_a_tree_counts_every_leaf():
    """One leaf of a donated tree rebuilt: the finding says 1 of 2."""
    def step(tree, x):
        tree["a"].mul_(x)
        return {"a": tree["a"], "b": tree["b"] + x}
    fs, _, _ = _lint(step, ({"a": meta(8), "b": meta(8)}, meta(8)),
                     carry=(0,), donate=(0,))
    assert [f.code for f in fs] == ["undonated-carry"]
    assert "1 of the 2 tensors of arg 0" in fs[0].message


def test_dead_code_fires_on_unused_intermediate():
    def f(x):
        _ = x @ x.T                  # never reaches an output
        return torch.sum(x)
    fs, _, _ = _lint(f, (meta(32, 32),))
    dead = [f_ for f_ in fs if f_.code == "dead-code"]
    assert dead and "aten.mm" in dead[0].message


def test_writes_keep_their_inputs_alive():
    """An op that writes a tensor is an effect: what feeds it is live."""
    def f(x, buf):
        buf.copy_(x @ x.T)
        return torch.sum(x)
    fs, _, _ = _lint(f, (meta(32, 32), meta(32, 32)))
    assert "dead-code" not in _codes(fs)


def test_peak_bytes_budget():
    def f(x):
        return torch.sum(torch.outer(x, x))   # (4096, 4096) f32 = 64 MiB
    fs, stats, _ = _lint(f, (meta(4096),), budget_bytes=1 << 20)
    assert "peak-bytes" in _codes(fs)
    assert stats["peak_bytes"] >= 64 * 1024 * 1024


def test_peak_is_the_counters_count():
    """The lint's peak and the production lowering's are one count:
    ``sharding.analysis.OpCounter`` over the same program."""
    from repro_torch.sharding.analysis import OpCounter

    def f(x):
        y = torch.outer(x, x)
        z = y * 2.0
        return torch.sum(z) + torch.sum(y)
    x = meta(1024)
    with OpCounter() as c:
        f(x)
    _, stats, tr = _lint(f, (x,))
    assert stats["peak_bytes"] == c.peak_live_bytes
    assert 2 * 1024 * 1024 * 4 <= c.peak_live_bytes < 2 * 1024 * 1024 * 4 + 64
    assert tr.flops == c.flops


# ---------------------------------------------------------------------------
# the port's own cases: syncs, copies, backward ops, host bookkeeping
# ---------------------------------------------------------------------------


SYNC_TOYS = {
    "nonzero": (lambda x: torch.nonzero(x), "output shaped by the data"),
    "mask_index": (lambda x: x[x > 0], "boolean-mask index"),
    "masked_select": (lambda x: torch.masked_select(x, x > 0),
                      "output shaped by the data"),
    "unique": (lambda x: torch.unique(x), "output shaped by the data"),
    "cpu": (lambda x: x.cpu(), "copy to the host"),
    "tolist": (lambda x: x.tolist(), "copy to the host"),
    "bool": (lambda x: bool(x.sum() > 0), "value read to the host"),
}


@pytest.mark.parametrize("name", sorted(SYNC_TOYS))
def test_host_syncs_fire_and_stop_the_trace(name):
    fn, kind = SYNC_TOYS[name]
    fs, _, tr = _lint(lambda x: fn(x * 2.0), (meta(4, 3),))
    assert [f.code for f in fs] == ["host-transfer"], fs
    assert kind in fs[0].message and "the trace stops here" in fs[0].message
    assert tr.stopped is not None
    # nothing else is judged on a trace that stopped early
    fs_ok, _, _ = _lint(lambda x: fn(x * 2.0), (meta(4, 3),),
                        allow_syncs=True)
    assert not fs_ok


def test_blocking_copy_from_the_host_fires_and_the_trace_goes_on():
    """A host tensor copied to the device: a sync in torch's sync debug
    mode. Meta needs no data for it, so the trace continues."""
    def f(x):
        return x + torch.arange(3.0).to(x.device)
    fs, _, tr = _lint(f, (meta(3),))
    assert [f_.code for f_ in fs] == ["host-transfer"]
    assert "blocking copy from the host" in fs[0].message
    assert tr.stopped is None and tr.ops[-1].name == "aten.add"
    fs_nb, _, _ = _lint(
        lambda x: x + torch.arange(3.0).to(x.device, non_blocking=True),
        (meta(3),))
    assert not fs_nb


def test_host_bookkeeping_is_not_the_program():
    """Ops on host tensors alone (a mesh's layout, an .item() of a host
    scalar) are neither recorded nor syncs."""
    def f(x):
        n = int(torch.arange(6).reshape(2, 3).sum().item())
        return x * n
    fs, _, tr = _lint(f, (meta(3),))
    assert not fs
    assert [op.name for op in tr.ops] == ["aten.mul"]


def test_backward_ops_are_part_of_the_trace():
    """A program that takes a gradient: its backward ops are dispatched
    inside it and recorded, and the counter counts their FLOPs."""
    def step(w, x):
        w = w.detach().requires_grad_(True)
        loss = torch.sum(torch.tanh(x @ w))
        loss.backward()
        return w - 0.1 * w.grad
    fs, _, tr = _lint(step, (meta(16, 16), meta(8, 16)))
    names = [op.name for op in tr.ops]
    assert names.count("aten.mm") == 2          # x @ w, x^T @ dY
    assert "aten.tanh_backward" in names
    assert tr.flops == 2 * (2 * 8 * 16 * 16)
    assert not fs


def test_storage_ids_are_fresh_after_a_free():
    """A freed storage's address may come back for a new one: the trace
    gives it a new id, so no cast is paired with an unrelated later op."""
    def f(x):
        out = x
        for _ in range(64):
            y = x.bfloat16()
            out = out + y.float().sum()     # f32 -> bf16 -> f32: churn
            del y
            z = torch.zeros_like(x, dtype=torch.int32)
            out = out + z.float()           # int32 -> f32 alone: no churn
        return out
    fs, _, tr = _lint(f, (meta(64),))
    churn = [f_ for f_ in fs if f_.code == "convert-churn"]
    assert len(churn) == 64
    assert all("float32 -> bfloat16 -> float32" in f_.message for f_ in churn)
    casts = [op.outs[0][0] for op in tr.ops if op.name == "aten._to_copy"]
    assert len(casts) == 3 * 64 and len(set(casts)) == len(casts)


def test_sites_point_at_the_port_not_the_lint():
    """A registered program's finding names its production line."""
    spec = registry.get_program("serving.index_refresh")
    fs, _ = lints.run_jaxpr_lints(registry.trace(spec), spec)
    sites = [f.message.rsplit(" at ", 1)[1] for f in fs
             if f.code == "convert-churn"]
    assert sites == ["src/repro_torch/serving/index.py:98"]


def test_cli_one_program(capsys):
    """``--program`` lints one program's trace (its baseline's other
    entries would read as stale, as in the reference: hence
    ``--no-baseline`` here)."""
    assert lint.main(["--program", "kernels.kl_similarity", "--json",
                      "--no-baseline"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["programs_registered"] == out["programs_traced"] == 1
    assert out["findings"] == []
    assert out["programs"]["kernels.kl_similarity"]["ops"] > 0


# ---------------------------------------------------------------------------
# the same toys through the reference's passes
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_analysis(monkeypatch):
    """The reference's lints and registry with ``jax.core``'s old names
    handed back (module docstring)."""
    import jax
    from jax._src import core as jcore
    for n in ("Var", "ClosedJaxpr", "Jaxpr", "Literal", "DropVar"):
        monkeypatch.setattr(jax.core, n, getattr(jcore, n), raising=False)
    from repro.analysis import lints as RL
    from repro.analysis import registry as RR
    return RL, RR


def _jax_toys():
    import jax
    import jax.numpy as jnp
    S = jax.ShapeDtypeStruct

    def body(c, x):
        y = jax.pure_callback(lambda v: np.asarray(v), S((), jnp.float32), x)
        return c + y, y

    def scan_cb(xs):
        return jax.lax.scan(body, jnp.float32(0.0), xs)[0]

    def unused(x):
        _ = jnp.dot(x, x.T)
        return jnp.sum(x)

    f32 = jnp.float32
    return {
        "clean": (lambda x: x * 2.0, (S((8,), f32),), {}),
        "f64": (lambda x: jnp.sum(x.astype(jnp.float64)), (S((8,), f32),),
                {}),
        "f64_declared": (lambda x: jnp.sum(x.astype(jnp.float64)),
                         (S((8,), f32),),
                         {"allowed_dtypes": frozenset({"float32",
                                                       "float64"})}),
        "churn": (lambda x: x.astype(jnp.bfloat16).astype(f32) + 1.0,
                  (S((16,), f32),), {}),
        "churn_sanctioned": (lambda x: x.astype(jnp.bfloat16).astype(f32)
                             + 1.0, (S((16,), f32),),
                             {"sanctioned_casts": "WIRE"}),
        "sync_in_loop": (scan_cb, (S((4,), f32),), {}),
        "sync_allowed": (scan_cb, (S((4,), f32),), {"allow": True}),
        "dead": (unused, (S((32, 32), f32),), {}),
        "peak": (lambda x: jnp.sum(jnp.outer(x, x)), (S((4096,), f32),),
                 {"budget_bytes": 1 << 20}),
        "carry_undeclared": (lambda s, x: s + x, (S((8,), f32),) * 2,
                             {"carry": (0,)}),
    }


TORCH_TOYS = {
    "clean": (lambda x: x * 2.0, (meta(8),), {}),
    "f64": (lambda x: torch.sum(x.double()), (meta(8),), {}),
    "f64_declared": (lambda x: torch.sum(x.double()), (meta(8),),
                     {"allowed_dtypes": frozenset({"float32", "float64"})}),
    "churn": (lambda x: x.bfloat16().float() + 1.0, (meta(16),), {}),
    "churn_sanctioned": (lambda x: x.bfloat16().float() + 1.0, (meta(16),),
                         {"sanctioned_casts": "WIRE"}),
    "sync_in_loop": (_item_in_loop, (meta(4),), {}),
    "sync_allowed": (_item_in_loop, (meta(4),), {"allow": True}),
    "dead": (lambda x: (x @ x.T, torch.sum(x))[1], (meta(32, 32),), {}),
    "peak": (lambda x: torch.sum(torch.outer(x, x)), (meta(4096),),
             {"budget_bytes": 1 << 20}),
    "carry_undeclared": (lambda s, x: s + x, (meta(8),) * 2, {"carry": (0,)}),
}
# the reference's host callback is the port's host sync
TWIN_CODE = {"host-callback": "host-transfer"}


@pytest.mark.parametrize("case", sorted(TORCH_TOYS))
def test_toy_verdicts_match_reference(ref_analysis, case):
    import jax
    from repro.common.precision import WIRE_CASTS as REF_WIRE_CASTS
    RL, RR = ref_analysis

    def kw_for(kw, ref):
        kw = dict(kw)
        if kw.pop("allow", False):
            kw["allow_callbacks" if ref else "allow_syncs"] = True
        if kw.get("sanctioned_casts") == "WIRE":
            kw["sanctioned_casts"] = REF_WIRE_CASTS if ref else WIRE_CASTS
        return kw

    jfn, jargs, jkw = _jax_toys()[case]
    jspec = RR.ProgramSpec(name="toy", fn=jfn,
                           abstract_args=lambda: (jargs, {}),
                           module="tests", **kw_for(jkw, True))
    with jax.enable_x64(case.startswith("f64")):
        jfs, _ = RL.run_jaxpr_lints(RR.trace(jspec), jspec)
    fn, args, kw = TORCH_TOYS[case]
    tfs, _, _ = _lint(fn, args, **kw_for(kw, False))
    want = {TWIN_CODE.get(f.code, f.code) for f in jfs}
    assert _codes(tfs) == want, (jfs, tfs)
    assert bool(want) == (case not in ("clean", "f64_declared",
                                       "churn_sanctioned", "sync_allowed"))


# ---------------------------------------------------------------------------
# the registry against the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def registries():
    from repro.analysis import registry as RR
    return registry.load_all(), RR.load_all()


def test_registry_names_equal_reference(registries):
    port, ref = registries
    assert sorted(ref) == sorted(NAMES)
    assert sorted(port) == sorted(NAMES + PORT_ONLY)


@pytest.mark.parametrize("name", NAMES)
def test_registry_metadata_matches_reference(registries, name):
    port, ref = registries
    p, r = port[name], ref[name]
    assert p.carry == r.carry and p.donate == r.donate
    assert p.budget_bytes == r.budget_bytes
    assert p.sanctioned_casts == r.sanctioned_casts
    assert p.allowed_dtypes == r.allowed_dtypes | {"int64"}
    assert p.allow_syncs == r.allow_callbacks
    assert p.module == r.module.replace("repro.", "repro_torch.", 1)
    assert p.oracle.startswith("repro_torch.")
    args, _ = p.build_args()
    assert all(t.device.type == "meta" for t in registry.tensors(args))


def test_registered_programs_declare_resolvable_oracles():
    fs = conventions.lint_fast_path_oracles(registry.iter_programs())
    assert not fs, [f.as_dict() for f in fs]


# ---------------------------------------------------------------------------
# convention passes on synthetic trees, spelled for each package
# ---------------------------------------------------------------------------


def _write_bad_repo(root, pkg):
    """The reference's known-bad tree, its ops.py in the package's idiom:
    ``backend=`` for the reference, ``_on_cuda(`` for the port."""
    k = root / "src" / pkg / "kernels"
    k.mkdir(parents=True)
    (root / "src" / pkg / "__init__.py").write_text("")
    (k / "__init__.py").write_text("")
    (k / "ref.py").write_text("def wired_ref(x):\n    return x\n")
    if pkg == "repro":
        ops = """\
            from repro.kernels import ref as REF
            from repro.kernels.wired import wired as _w

            def wired(x, *, backend=None):
                if backend == "ref":
                    return REF.wired_ref(x)
                return _w(x)

            def orphan(x, *, backend=None):
                return x
        """
        test = "test_wired.py"
    else:
        ops = """\
            from repro_torch.kernels import ref as REF
            from repro_torch.kernels.wired import wired as _w

            def _on_cuda(*ts):
                return False

            def wired(x):
                if _on_cuda(x):
                    return _w(x)
                return REF.wired_ref(x)

            def orphan(x):
                if _on_cuda(x):
                    return x
                return x
        """
        test = "test_torch_wired.py"
        (root / "chip_smoke.py").write_text("# wired orphan\n")
    (k / "ops.py").write_text(textwrap.dedent(ops))
    (k / "wired.py").write_text("def wired(x):\n    return x\n")
    (k / "lonely.py").write_text("def lonely(x):\n    return x\n")
    (root / "tests").mkdir()
    (root / "tests" / test).write_text(
        "import os\n\ndef test_wired():\n    assert True  # wired\n")
    return root


@pytest.fixture
def bad_repos(tmp_path):
    return (_write_bad_repo(tmp_path / "ref", "repro"),
            _write_bad_repo(tmp_path / "port", "repro_torch"))


def _normal(findings, root):
    """(code, program, message) with the tree's root, the package name
    and the test file's prefix taken out."""
    def one(m):
        m = m.replace(str(root), "<root>").replace("repro_torch", "repro")
        return m.replace("test_torch_", "test_")
    return sorted((f.code, f.program, one(f.message)) for f in findings)


def test_kernel_conventions_fire(bad_repos):
    from repro.analysis import conventions as RC
    ref_root, port_root = bad_repos
    fs = conventions.lint_kernel_conventions(port_root)
    codes = _codes(fs)
    # orphan: no plain version, no parity test; lonely.py: not wired
    assert "kernel-no-ref" in codes
    assert "kernel-no-parity-test" in codes
    assert any(f.code == "kernel-module-unwired" and "lonely" in f.message
               for f in fs)
    assert not any("`wired`" in f.message for f in fs)
    assert _normal(fs, port_root) == _normal(
        RC.lint_kernel_conventions(ref_root), ref_root)


def test_port_only_kernel_conventions_fire(bad_repos):
    """No card check, a plain version never reached, a CUDA source no
    module names."""
    _, root = bad_repos
    k = root / "src" / "repro_torch" / "kernels"
    (root / "chip_smoke.py").write_text("# orphan only\n")
    (k / "ref.py").write_text("def wired_ref(x):\n    return x\n\n"
                              "def orphan_ref(x):\n    return x\n")
    (k / "csrc").mkdir()
    (k / "csrc" / "wired.cu").write_text("// wired\n")
    (k / "csrc" / "stray.cu").write_text("// stray\n")
    (k / "wired.py").write_text(
        "def wired(x):\n    return _build.kernel(\"wired\", \"w\", ())\n")
    fs = conventions.lint_kernel_conventions(root)
    by_code = {}
    for f in fs:
        by_code.setdefault(f.code, []).append(f.message)
    assert by_code["kernel-no-smoke"] == [
        "chip_smoke.py never names kernel dispatcher `wired` (its kernel is "
        "not held on the card)"]
    assert by_code["kernel-ref-unwired"] == [
        "ops dispatcher `orphan` never routes to `REF.orphan_ref` (the CPU "
        "path missing)"]
    assert by_code["kernel-source-unnamed"] == [
        "kernel source kernels/csrc/stray.cu is named by no kernel module "
        "(never built or launched)"]


def test_unused_imports_fire(bad_repos):
    from repro.analysis import conventions as RC
    ref_root, port_root = bad_repos
    fs = conventions.lint_unused_imports(port_root)
    assert any(f.code == "unused-import" and "os" in f.message for f in fs)
    assert _normal(fs, port_root) == _normal(
        RC.lint_unused_imports(ref_root), ref_root)


def test_fast_path_oracle_checks(ref_analysis):
    RL, RR = ref_analysis
    from repro.analysis import conventions as RC

    def both(oracle):
        port = _spec(lambda x: x, (meta(2),),
                     oracle=oracle and oracle.replace("PKG", "repro_torch"))
        ref = RR.ProgramSpec(name="toy", fn=lambda x: x,
                             abstract_args=lambda: ((), {}), module="tests",
                             oracle=oracle and oracle.replace("PKG", "repro"))
        return port, ref

    cases = [both(None), both("PKG.kernels.ref.does_not_exist"),
             both("PKG.kernels.ref.pairwise_dist_ref")]
    fs = conventions.lint_fast_path_oracles([p for p, _ in cases])
    ref_fs = RC.lint_fast_path_oracles([r for _, r in cases])
    assert sorted(f.code for f in fs) == sorted(f.code for f in ref_fs) == [
        "fast-path-no-oracle", "fast-path-oracle-unresolved"]
    # a path into the reference is not even imported by the port
    out = conventions.lint_fast_path_oracles([_spec(
        lambda x: x, (meta(2),), oracle="repro.kernels.ref.pairwise_dist_ref")])
    assert [f.message for f in out] == [
        "declared oracle 'repro.kernels.ref.pairwise_dist_ref' lies outside "
        "repro_torch"]


def _configs(root, pkg, init="", extra=()):
    cfg = root / "src" / pkg / "configs"
    cfg.mkdir()
    (cfg / "__init__.py").write_text(init.replace("PKG", pkg))
    for name, text in extra:
        (cfg / name).write_text(text)
    return cfg


def test_dead_module_detection(bad_repos):
    from repro.analysis import conventions as RC
    from repro.analysis.registry import ProgramSpec as RefSpec
    got = []
    for root, pkg, Spec, C in zip(bad_repos, ("repro", "repro_torch"),
                                  (RefSpec, ProgramSpec), (RC, conventions)):
        _configs(root, pkg, extra=(("orphaned.py", "X = 1\n"),
                                   ("testonly.py", "Y = 2\n")))
        (root / "tests" / "test_cfg.py").write_text(
            f"from {pkg}.configs import testonly\n")
        spec = Spec(name="kernels.wired", fn=lambda x: x,
                    abstract_args=lambda: ((), {}),
                    module=f"{pkg}.kernels.ops")
        fs = C.lint_dead_modules(root, [spec])
        by_code = {f.code: f.message for f in fs}
        assert "orphaned" in by_code["dead-module"]
        assert "testonly" in by_code["seed-module"]
        got.append(_normal(fs, root))
    assert got[0] == got[1]


def test_dead_module_init_fanout_does_not_keep_alive(bad_repos):
    """A scope package init re-exporting a submodule (the registry
    pattern) must NOT count as registry reachability: only an import by
    name does. Tests importing the init still reach it (full graph), so
    the finding is seed-module, not dead-module."""
    from repro.analysis import conventions as RC
    from repro.analysis.registry import ProgramSpec as RefSpec
    got = []
    for root, pkg, Spec, C in zip(bad_repos, ("repro", "repro_torch"),
                                  (RefSpec, ProgramSpec), (RC, conventions)):
        _configs(root, pkg, init="from PKG.configs.fanout import X\n",
                 extra=(("fanout.py", "X = 1\n"),))
        (root / "src" / pkg / "uses_cfg.py").write_text(
            f"import {pkg}.configs\n")
        (root / "tests" / "test_cfg.py").write_text(f"import {pkg}.configs\n")
        spec = Spec(name="kernels.wired", fn=lambda x: x,
                    abstract_args=lambda: ((), {}), module=f"{pkg}.uses_cfg")
        fs = C.lint_dead_modules(root, [spec])
        assert any(f.code == "seed-module" and "fanout" in f.message
                   for f in fs)
        got.append(_normal(fs, root))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# baseline mechanics
# ---------------------------------------------------------------------------


def test_baseline_partition_and_stale():
    from repro.analysis.lint import partition_findings as ref_partition
    from repro.analysis.lints import Finding as RefFinding
    rows = [("dead-code", "p1", "x is dead"),
            ("dtype-widen", "p2", "float64 crept in"),
            ("dead-code", "p3", "y is dead")]
    sups = [{"code": "dead-code", "program": "p1", "match": "dead",
             "reason": "known"},
            {"code": "host-callback", "program": "p9", "reason": "gone"},
            {"code": "dead-code", "program": "p3", "reason": "no match key"}]
    new, base, stale = lint.partition_findings([Finding(*r) for r in rows],
                                               sups)
    assert [f.code for f in new] == ["dtype-widen"]
    assert [f.program for f in base] == ["p1", "p3"]
    assert stale == [sups[1]]
    rnew, rbase, rstale = ref_partition([RefFinding(*r) for r in rows], sups)
    assert ([f.as_dict() for f in new], [f.as_dict() for f in base], stale) \
        == ([f.as_dict() for f in rnew], [f.as_dict() for f in rbase], rstale)


def test_baseline_entries_give_reasons_that_cite_real_lines():
    for s in lint.load_baseline(lint.BASELINE_PATH):
        assert s.get("reason"), s
        for path, line in re.findall(r"([\w/]+\.py):(\d+)", s["reason"]):
            full = ROOT / "src" / "repro_torch" / path
            assert full.exists(), (path, s)
            assert int(line) <= len(full.read_text().splitlines()), (path, s)


# ---------------------------------------------------------------------------
# the real port is clean
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(HERE)] + ([env["PYTHONPATH"]]
                                          if env.get("PYTHONPATH") else []))
    return env


def test_repo_programs_trace_and_lint_clean():
    """The CLI gate in a subprocess: every registered program traces on
    meta, nothing new, nothing stale, every suppression with its reason,
    no oracle into the reference."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--json"],
        cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=LINT_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout)
    assert out["programs_registered"] == out["programs_traced"] == \
        len(NAMES + PORT_ONLY)
    assert sorted(out["programs"]) == sorted(NAMES + PORT_ONLY)
    assert out["findings"] == [] and out["stale_suppressions"] == []
    for s in lint.load_baseline(lint.BASELINE_PATH):
        assert s.get("reason"), s
    assert not any(spec.oracle.startswith("repro.")
                   for spec in registry.iter_programs())


def test_full_lint_twice_in_one_worker_process(tmp_path):
    """The full lint, then each sharded program again, in one process:
    each sharded trace makes and destroys its fake world of one."""
    out = tmp_path / "runs.json"
    subprocess.run([sys.executable, str(HERE / "torch_analysis_worker.py"),
                    str(out)], cwd=ROOT, env=_env(), check=True,
                   timeout=LINT_TIMEOUT_S)
    full, *sharded = json.loads(out.read_text())
    assert all(p["traced"] for p in full["programs"].values())
    assert len(full["programs"]) == len(NAMES + PORT_ONLY)
    assert full["findings"] == [] and full["stale_suppressions"] == []
    for run in sharded:
        (name, stats), = run["programs"].items()
        assert stats["traced"] and run["findings"] == []
        assert stats == full["programs"][name]
    assert not any(run["world_left_up"] for run in [full, *sharded])


def test_convention_lints_clean_in_process():
    fs = conventions.run_convention_lints(conventions.repo_root(),
                                          registry.iter_programs())
    new, _, _ = lint.partition_findings(
        fs, lint.load_baseline(lint.BASELINE_PATH))
    assert not new, [f.as_dict() for f in new]
