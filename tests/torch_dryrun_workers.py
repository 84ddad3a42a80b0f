"""The worlds of ``tests/test_torch_dryrun.py`` and of the ``--arch`` tests
in ``tests/test_torch_sharded.py``: each fake world runs in a subprocess of
its own (a process holds one default group), and the gloo worlds come from
``repro_torch.launch.mesh.spawn``.

    python tests/torch_dryrun_workers.py JOB OUT.json

runs one job (``JOBS``) and writes its result as JSON. ``count_step`` and
``count_round`` run on a rank of either kind of world: meta tensors in a
fake world, the same program on small random CPU tensors in a gloo one.
The reference job (``ref_args``) is the only one that imports JAX.
"""
import json
import os
import signal
import subprocess
import sys

import torch

import tp_cases as TC

HERE = os.path.dirname(os.path.abspath(__file__))
JOB_TIMEOUT_S = 600.0

# (tp_cases variant, mesh): the meshes on which a fake world's count must
# equal a gloo world's
STEP_CASES = {
    "dense_2x2": ("dense", TC.M22),
    "dense_1x4": ("dense", TC.M14),
    "dense_pod": ("dense", TC.POD),
    "moe_2x2": ("moe", TC.M22),
    "hybrid_2x2": ("hybrid", TC.M22),
    "ssm_2x2": ("ssm", TC.M22),
}
MODES = ("train", "decode")
ROUND_ARCH = "qwen1.5-0.5b"
# one run_combo a family at 16 x 16, and one at 2 x 16 x 16; and those
# whose counted FLOPs part from the analytic model by a recorded
# mechanism (ROADMAP Queue 3)
COMBOS = (("qwen1.5-0.5b", "train_4k", False),
          ("qwen3-moe-235b-a22b", "decode_32k", False),
          ("rwkv6-1.6b", "prefill_32k", False),
          ("zamba2-2.7b", "long_500k", False),
          ("qwen3-1.7b", "decode_32k", True),
          ("qwen3-1.7b", "train_4k", False),
          ("rwkv6-1.6b", "decode_32k", False))
# collectives of each kind at these group sizes, in a fake world of 16
GROUP_SIZES = (2, 4, 16)
COLL_SHAPE = (24, 40)


def _real(tree, cfg, gen):
    """Small random CPU tensors in place of a tree of meta ones."""
    from repro_torch.common.pytree import tree_map

    def one(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=gen)).to(t.dtype)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             dtype=t.dtype)
    return tree_map(one, tree)


def _summary(counter):
    stats = counter.stats()
    return {"flops": counter.flops, "ledger": counter.ledger(),
            "bytes": stats.bytes_by_kind, "count": stats.count_by_kind}


def count_step(name, mode, device):
    """This rank's counted train or decode step of a case, on ``device``
    (meta in a fake world, cpu in a gloo one)."""
    from repro_torch import configs as CFG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.analysis import OpCounter
    from repro_torch.sharding.specs import shard_tree

    variant, m = STEP_CASES[name]
    cfg = TC.config(CFG, TC._case(variant, m))
    multi_pod = "pod" in m
    with make_debug_mesh(tp=m["model"], dp=m["data"], multi_pod=multi_pod,
                         device=device) as mesh:
        if mode == "train":
            step, args, specs = steps.build_train_step(
                cfg, mesh, ShapeConfig("train", TC.S, TC.B, "train"),
                multi_pod=multi_pod)
        else:
            step, args, specs = steps.build_decode_step(
                cfg, mesh, ShapeConfig("decode", TC.SLOTS, TC.B, "decode"),
                multi_pod=multi_pod)
        if device == "cpu":
            gen = torch.Generator().manual_seed(0)
            args = [_real(a, cfg, gen) for a in args]
        local = [shard_tree(a, s, mesh) for a, s in zip(args, specs)]
        if mode == "decode":
            local[3] = TC.SLOTS - 1
        with OpCounter() as counter:
            step(*local)
    return _summary(counter)


def count_round(device, multi_pod=False):
    """This rank's counted federated round of ``ROUND_ARCH`` reduced on a
    (2, 2) mesh, or (2, 1, 2) with ``multi_pod``."""
    from repro_torch import configs as CFG
    from repro_torch.launch.fed_round import lower_round
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = CFG.get_config(ROUND_ARCH).reduced()
    with make_debug_mesh(tp=2, dp=1 if multi_pod else 2, multi_pod=multi_pod,
                         device=device) as mesh:
        counter, B0 = lower_round(cfg, mesh, multi_pod=multi_pod, D=16, k=3)
    return _summary(counter)


def gloo_rank(names):
    """A gloo rank's part: each of ``names`` ("case/mode" of
    ``STEP_CASES`` x ``MODES``, or "round/single", "round/pod") counted on
    CPU tensors."""
    out = {}
    for name in names:
        a, b = name.split("/")
        out[name] = (count_round("cpu", b == "pod") if a == "round"
                     else count_step(a, b, "cpu"))
    return out


def _fake(n, fn, *args):
    from repro_torch.launch.mesh import fake_world
    with fake_world(n):
        return fn(*args)


def job_meta_steps():
    return {f"{n}/{m}": _fake(4, count_step, n, m, "meta")
            for n in STEP_CASES for m in MODES}


def job_meta_rounds():
    return {f"round/{p}": _fake(4, count_round, "meta", p == "pod")
            for p in ("single", "pod")}


def job_combos():
    from repro_torch.launch.dryrun import run_combo
    return [run_combo(a, s, mp, verbose=False) for a, s, mp in COMBOS]


def job_collectives():
    """Each kind of collective, functional and c10d, on meta tensors at
    every group size of a fake world of 16, each under its own counter:
    [(kind, api, g, shape of the result, its dtype, bytes, count)]."""
    import warnings

    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.mesh import fake_world
    from repro_torch.sharding.analysis import OpCounter

    warnings.filterwarnings("ignore", category=FutureWarning)
    rows = []
    with fake_world(16):
        for g in GROUP_SIZES:
            grp = dist.new_group(list(range(g)))
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.empty(COLL_SHAPE, dtype=dtype, device="meta")
                big = torch.empty((COLL_SHAPE[0] * g, COLL_SHAPE[1]),
                                  dtype=dtype, device="meta")

                def _w(t):
                    return t.wait() if hasattr(t, "wait") else t

                calls = {
                    ("all-reduce", "functional"): (
                        lambda: _w(funcol.all_reduce(x, "sum", grp)), x),
                    ("all-reduce", "c10d"): (
                        lambda: dist.all_reduce(x, group=grp), x),
                    ("all-gather", "functional"): (
                        lambda: _w(funcol.all_gather_tensor(x, 0, grp)), big),
                    ("all-gather", "c10d"): (
                        lambda: dist.all_gather_into_tensor(big, x,
                                                            group=grp), big),
                    ("reduce-scatter", "functional"): (
                        lambda: _w(funcol.reduce_scatter_tensor(
                            big, "sum", 0, grp)), x),
                    ("reduce-scatter", "c10d"): (
                        lambda: dist.reduce_scatter_tensor(
                            torch.empty_like(x), big, group=grp), x),
                    ("all-to-all", "functional"): (
                        lambda: _w(funcol.all_to_all_single(
                            big, None, None, grp)), big),
                    ("all-to-all", "c10d"): (
                        lambda: dist.all_to_all_single(torch.empty_like(big),
                                                       big, group=grp), big),
                    ("collective-permute", "c10d"): (
                        lambda: dist.send(x, dst=1, group=grp), x),
                }
                for (kind, api), (call, result) in calls.items():
                    with OpCounter() as c:
                        call()
                    stats = c.stats()
                    rows.append((kind, api, g, list(result.shape),
                                 str(dtype).removeprefix("torch."),
                                 stats.bytes_by_kind, stats.count_by_kind))
    return rows


def job_ref_args():
    """The reference's ``_tree_device_bytes`` of every arch's train and
    decode inputs at 16 x 16 (JAX: 512 host devices, set by importing the
    reference's dryrun module first)."""
    import repro.launch.dryrun as RD
    from repro.configs import ARCH_IDS, get_config
    from repro.launch import steps as RSTEPS
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False)
    out = {}
    for arch in ARCH_IDS:
        for shape in ("train_4k", "decode_32k"):
            _, args, specs = RSTEPS.build_step(get_config(arch), mesh, shape,
                                               multi_pod=False)
            out[f"{arch}/{shape}"] = RD._tree_device_bytes(args, specs, mesh)
    return out


def job_ref_payloads():
    """The reference's adaptive payload a client: the bytes of
    ``abstract_train_state``'s B0, on one CPU device."""
    import numpy as np

    import jax
    from repro.configs import ARCH_IDS, get_config
    from repro.launch.steps import abstract_train_state

    return {arch: int(sum(np.prod(l.shape) * l.dtype.itemsize for l in
                          jax.tree.leaves(abstract_train_state(
                              get_config(arch), 16)[1])))
            for arch in ARCH_IDS}


def start(job, out_dir):
    """Start ``job`` in a subprocess of its own session -> (the process,
    the path of its result)."""
    path = os.path.join(str(out_dir), job + ".json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE, env.get("PYTHONPATH", "")])
    log = open(path + ".log", "w")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), job,
                             path], stdout=log, stderr=log, env=env,
                            start_new_session=True)
    log.close()
    return proc, path


def collect(started, timeout=JOB_TIMEOUT_S):
    """A started job's result; its log's tail if it failed."""
    proc, path = started
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode:
        with open(path + ".log") as f:
            raise RuntimeError(f"{os.path.basename(path)}: exit "
                               f"{proc.returncode}\n{f.read()[-4000:]}")
    with open(path) as f:
        return json.load(f)


JOBS = {"meta_steps": job_meta_steps, "meta_rounds": job_meta_rounds,
        "combos": job_combos, "collectives": job_collectives,
        "ref_args": job_ref_args, "ref_payloads": job_ref_payloads}


if __name__ == "__main__":
    job, out = sys.argv[1], sys.argv[2]
    with open(out, "w") as f:
        json.dump(JOBS[job](), f)
