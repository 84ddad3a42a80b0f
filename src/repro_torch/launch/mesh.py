"""Meshes and worlds of the port's scale-out, over torch.distributed.

The port of ``repro/launch/mesh.py``. Functions, not module constants:
importing this module starts no process group.

Axis semantics (the reference's):
  * "model": tensor parallel within a pod row (the engine splits the
    flattened parameter columns of the server matrices over it);
  * "data":  batch and federated-client parallel;
  * "pod":   cross-pod client parallel (pods = spatial regions of edge
    clients in the FedSTIL deployment story).

A world comes from ``torchrun`` (``sharding.specs.torchrun_world`` reads
its environment), or from ``spawn``, which starts ``nprocs`` processes on this host, joins
them in one world (gloo on the CPU over a ``file://`` rendezvous in a
fresh temporary directory, NCCL with one card a rank), runs a function on
every rank and returns each rank's result. Every group waits at most
``sharding.specs.GROUP_TIMEOUT`` in a collective, and ``spawn`` kills the
world when a rank fails or the whole call outlasts its timeout, so a rank
that raised never leaves the others hanging.

Hardware figures, where the port needs them, are the H100's as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` names
the card; none is carried over from the reference's TPU constants.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.specs import (BACKENDS, GROUP_TIMEOUT, EngineMesh,
                                        world_device)

SPAWN_TIMEOUT_S = 600.0


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         model: int = 1) -> EngineMesh:
    """A mesh over every rank of the current world (one card a rank):
    ("data", "model") with ``model`` ranks on the model axis, or with
    ``multi_pod`` ("pod", "data", "model") over two pods."""
    n = dist.get_world_size()
    pods = 2 if multi_pod else 1
    if n % (pods * model):
        raise ValueError(f"{n} ranks do not split into {pods} pod(s) x "
                         f"model={model}")
    shape = {"data": n // (pods * model), "model": model}
    if multi_pod:
        shape = {"pod": pods, **shape}
    return EngineMesh(shape, world_device(device))


def make_debug_mesh(tp: int = 2, dp: int = 2, multi_pod: bool = False,
                    device="cpu") -> EngineMesh:
    """A small mesh over the current world, which must hold exactly
    dp x tp ranks (2 x dp x tp with ``multi_pod``)."""
    shape = {"data": dp, "model": tp}
    if multi_pod:
        shape = {"pod": 2, **shape}
    return EngineMesh(shape, world_device(device))


def _rank_main(rank, nprocs, device, tmp, results):
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        os.environ["LOCAL_RANK"] = str(rank)     # one card a rank
        if dev.type == "cuda":
            torch.cuda.set_device(rank)
        else:
            # the ranks share this host's cores: intra-op threads beyond
            # a rank's share only spin against each other
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        dist.init_process_group(BACKENDS[dev.type],
                                init_method="file://" + os.path.join(
                                    tmp, "rendezvous"), rank=rank,
                                world_size=nprocs, timeout=GROUP_TIMEOUT)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                                # report, then die
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, nprocs: int, *args, device="cpu",
          timeout: float = SPAWN_TIMEOUT_S):
    """Run ``fn(*args)`` on every rank of a fresh world of ``nprocs``
    processes; returns the ranks' results in rank order. ``fn`` must be
    importable by name (a module-level function) and its result
    picklable. Raises RuntimeError with the failing rank's traceback when
    a rank raises, and kills every process when one fails or the call
    takes longer than ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    # the call goes through a file, not the process arguments: a start
    # blocks until its child has read arguments larger than a pipe's
    # buffer, which would start the ranks one after another
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, str(device), tmp, results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"world of {nprocs} did not finish within "
                                   f"{timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and len(got) < nprocs and results.empty():
                    raise RuntimeError(f"a rank of {nprocs} exited with "
                                       f"{dead[0]} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
