"""Runs both sides of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py`` and holds their outputs together.

``run_all`` starts the JAX oracle (``tests/jax_tp_oracle.py``,
``ORACLES`` subprocesses with 8 host devices each, the cases dealt out
among them by their cost), waits for them to write the weights, then
spawns one gloo world of the port per world size the cases need
(``repro_torch.launch.mesh.spawn``, ranks in ``torch_tp_workers.py``) in
background threads while the oracle computes the JAX side. No JAX here:
the comparisons are numpy.
"""
import concurrent.futures
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

import torch_tp_workers as W
import tp_cases as TC
from repro_torch.launch.mesh import spawn

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT_S = 600.0
ORACLES = 3
# a JAX case's rough cost: one unit a compiled step
COST = {"sgd": 2, "pin": 1, "adam": 1, "full": 2}
FWD_TOL = 1e-5          # losses, fp32 caches (of a leaf's largest magnitude)
GRAD_TOL = 1e-4         # each gradient leaf, of its largest magnitude
# rwkv's: the port's unsharded gradient is itself 5.1e-4 of a leaf's
# largest magnitude from JAX's on these inputs (time/u: the WKV loop's
# fp32 sums over time in another order), where JAX's own sharded and
# unsharded gradients part by 1e-4
SSM_GRAD_TOL = 1e-3
LEAF_FLOOR = 1e-3
# the ring's caches hold k at positions ~8192: jitted JAX's rope there is
# 1.6e-4 from its eager rope (XLA's sin / cos at large angles), which the
# port matches to 2.4e-7 (test_torch_tp.py::test_jitted_rope_at_the_ring)
RING_TOL = 1e-4


def grad_tol(case):
    return SSM_GRAD_TOL if case["variant"] == "ssm" else GRAD_TOL


def run_all(names, out_dir):
    """-> ({case: the oracle's flat outputs}, {case: [each rank's flat
    outputs]})."""
    out_dir = str(out_dir)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    shares = [[] for _ in range(ORACLES)]
    load = [0.0] * ORACLES
    for n in sorted(names, key=lambda n: -_cost(TC.CASES[n])):
        i = load.index(min(load))
        shares[i].append(n)
        load[i] += _cost(TC.CASES[n])
    shares = [s for s in shares if s]
    procs = []
    for tag, share in enumerate(shares):
        with open(os.path.join(out_dir, f"oracle.{tag}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "tests", "jax_tp_oracle.py"), out_dir,
                 str(tag), *share], stdout=subprocess.DEVNULL, stderr=log,
                env=env, start_new_session=True))

    def failed(tag, proc):
        with open(os.path.join(out_dir, f"oracle.{tag}.log")) as f:
            return RuntimeError(f"JAX oracle {tag} exited with "
                                f"{proc.returncode}:\n{f.read()[-4000:]}")

    deadline = time.monotonic() + TIMEOUT_S
    try:
        for tag, proc in enumerate(procs):
            done = os.path.join(out_dir, f"params.{tag}.done")
            while not os.path.exists(done):
                if proc.poll() is not None:
                    raise failed(tag, proc)
                if time.monotonic() > deadline:
                    raise RuntimeError("the JAX oracle wrote no weights in "
                                       "time")
                time.sleep(0.1)
        by_world = {}
        for n in names:
            by_world.setdefault(TC.world_size(TC.CASES[n]), []).append(n)
        with concurrent.futures.ThreadPoolExecutor(len(by_world)) as pool:
            futs = {n: pool.submit(spawn, W.run, n, cs, out_dir,
                                   timeout=TIMEOUT_S)
                    for n, cs in by_world.items()}
            for tag, proc in enumerate(procs):
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
                if proc.returncode:
                    raise failed(tag, proc)
            port = {}
            for n, f in futs.items():
                ranks = f.result()
                port.update({c: [W.decode_flat(r[c]) for r in ranks]
                             for c in by_world[n]})
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    jax_out = {n: W.load(os.path.join(out_dir, f"{n}.npz")) for n in names}
    return jax_out, port


def _cost(case):
    return (sum(COST[m] for m in case["train"]) + 0.5 * case["prefill"]
            + len(case["decode"]) * (1 + case["ws"]))


def under(flat, prefix):
    """{key below prefix/: value} of a flat output dict."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def _np(v):
    return v.float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def close_leaves(got, want, tol, what=""):
    """Every leaf of ``want`` within ``tol`` of its largest magnitude, or
    of ``LEAF_FLOOR`` x the tree's largest, where that is more (a bias on
    k whose gradient is 0 but for rounding: encdec's bk reads 2.5e-10)."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    top = max(float(np.abs(_np(v)).max()) for v in want.values())
    for k in want:
        a, b = _np(got[k]), _np(want[k])
        scale = max(float(np.abs(b).max()), LEAF_FLOOR * top, 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (what, k, err, scale)


def close_cache(got, want, tol=FWD_TOL):
    """fp32 leaves within ``tol`` of their largest magnitude (and
    relative), int8 codes within 1 with under 1e-3 of them off, bf16
    scales bit for bit."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    differ = n = 0
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, torch.Tensor):            # bf16 scales, as bits
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(torch.int16).numpy(),
                                          err_msg=k)
        elif b.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, k
            differ, n = differ + int((d > 0).sum()), n + d.size
        else:
            scale = max(float(np.abs(b).max()), 1.0)
            np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol,
                                       err_msg=k)
    assert differ <= 1e-3 * max(n, 1), differ


def bits_of(flat):
    """A flat output dict with every bf16 leaf as its bits."""
    return {k: (v.view(torch.int16).numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flat.items()}
