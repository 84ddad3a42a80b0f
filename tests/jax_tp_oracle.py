"""The JAX side of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: the JAX package's sharded steps on a
debug mesh of host devices, its unsharded ones, and the weights, written
to npz files for the port to be held against.

Run in a process of its own (the host device count is fixed at JAX's
first use):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src:tests python tests/jax_tp_oracle.py OUT TAG CASE...

It writes ``OUT/params_<variant>_tp<k>.npz`` (``init_params(tp=k)`` at
PRNGKey(0)) for every case first, then the file ``OUT/params.TAG.done``,
then ``OUT/<case>.npz`` case by case (see ``tp_cases.py`` for the modes).
Several processes may share OUT, each with its own TAG and cases.
bf16 leaves are stored as their 16 bits under ``<key>@bf16``. The sharded
steps of a mamba model take its w_zx dealt by parts, as the port deals it
(``tp_cases.dealt``), and their gradients are read back in the global
layout.
"""
import concurrent.futures
import functools
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

import tp_cases as TC
from repro import configs as JCFG
from repro.common.axes import AxisCtx
from repro.common.compat import set_mesh, shard_map
from repro.configs.base import ShapeConfig
from repro.core.adaptive import (combine, init_adaptive, merge_params,
                                 split_params)
from repro.launch import steps as STEPS
from repro.launch.mesh import make_debug_mesh
from repro.models import lm as JLM
from repro.sharding import specs as SPECS
from repro.train import trainer as TR
from repro.train.optimizer import adam, sgd


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def save(path, tree):
    out = {}
    for k, v in TC.flat(_np(tree)).items():
        if v.dtype.name == "bfloat16":
            out[k + "@bf16"] = v.view(np.uint16)
        else:
            out[k] = v
    np.savez(path, **out)


def jbatch(nb, labels=True):
    return {k: jnp.asarray(v) for k, v in nb.items()
            if labels or k != "labels"}


def mesh_of(case):
    m = case["mesh"]
    return make_debug_mesh(tp=m["model"], dp=m["data"],
                           multi_pod="pod" in m)


def _rep(tree):
    return jax.tree.map(lambda l: P(*([None] * l.ndim)), tree)


def train_fn(cfg, mesh, case, opt, tie, args, full=False):
    """The JAX package's sharded split (or full) step, laid out as
    ``steps.build_train_step`` lays it out, with ``opt`` and ``tie``."""
    multi_pod = "pod" in case["mesh"]
    tp, dp = mesh.shape["model"], mesh.shape["data"]
    batch = args[-1]
    metrics = {"loss": P(), "ce": P(), "grad_norm": P()}
    if not full:
        metrics["moe_aux"] = P()
    if case["layout"] == "dp":
        ax = AxisCtx(tp=None, dp="data", pod="pod" if multi_pod else None,
                     dp2="model", fsdp=False)
        baxes = ("pod", "data", "model") if multi_pod else ("data", "model")
        sp = _rep
        bspec = jax.tree.map(
            lambda l: P(*((baxes,) + (None,) * (l.ndim - 1))), batch)
    else:
        ax = STEPS.axis_ctx(cfg, multi_pod)
        sp = functools.partial(SPECS.tree_param_specs, cfg, tp_size=tp)
        bspec = SPECS.batch_specs(cfg, batch, TC.B, dp, multi_pod)
    in_specs = tuple(sp(a) for a in args[:-1]) + (bspec,)
    if full:
        step = TR.make_full_train_step(cfg, optimizer=opt, ax=ax)
        out_specs = (sp(args[0]), sp(args[1]), metrics)
    else:
        step = TR.make_train_step(cfg, optimizer=opt, ax=ax, tie_lambda=tie)
        out_specs = (sp(args[2]), sp(args[3]), metrics)
    return jax.jit(shard_map(step, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=True))


def read_grads(old, new):
    return jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                        / TC.READ_LR, old, new)


_SHARED, _SHARED_LOCK = {}, threading.Lock()


def shared(key, fn):
    """``fn()`` once per key across the cases (and their threads)."""
    with _SHARED_LOCK:
        if key not in _SHARED:
            _SHARED[key] = concurrent.futures.Future()
            mine = True
        else:
            mine = False
    if mine:
        try:
            _SHARED[key].set_result(fn())
        except BaseException as e:
            _SHARED[key].set_exception(e)
    return _SHARED[key].result()


def split_grads(cfg, frozen, B, trainable, batch, tie):
    """JAX's unsharded gradient of the split step's objective."""
    def lf(tr):
        params = merge_params(frozen, combine(B, tr["alpha"], tr["A"]))
        total, _ = JLM.loss_fn(cfg, params, batch)
        if tie:
            total = total + tie * sum(jnp.sum(jnp.abs(a))
                                      for a in jax.tree.leaves(tr["A"]))
        return total
    return jax.jit(jax.grad(lf))(trainable)


def run_train(cfg, case, mesh, params, out):
    frozen, adaptive = split_params(cfg, params)
    ad = init_adaptive(adaptive)
    B, tr = ad.B, ad.trainable()
    # the sharded steps take mamba's w_zx dealt by parts, as the port's
    # shard_tree deals it (a no-op without mamba or at TP 1)
    tp = TC.tp_of(case)
    dfrozen, dB, dtr = (TC.dealt(t, tp) for t in (frozen, B, tr))
    nb = TC.numpy_batch(cfg, 0)
    batch = jbatch(nb)
    modes = case["train"]
    # the unsharded steps outside the mesh's context (under it, the MoE's
    # jnp.repeat asks for an explicit sharding)
    if "sgd" in modes or "pin" in modes:
        out["train/grad_unsharded"] = shared(
            ("split_grads", TC.same_model_key(cfg, case)),
            lambda: _np(split_grads(cfg, frozen, B, tr, batch, TC.TIE)))
    if "full" in modes:
        out["full/grad_unsharded"] = jax.jit(jax.grad(
            lambda p: JLM.loss_fn(cfg, p, batch)[0]))(params)
    with set_mesh(mesh):
        for mode, tie in (("sgd", 0.0), ("pin", TC.TIE)):
            if mode in modes:
                opt = sgd(TC.READ_LR)
                fn = train_fn(cfg, mesh, case, opt, tie,
                              (dfrozen, dB, dtr, opt.init(dtr), batch))
                new, _, m = fn(dfrozen, dB, dtr, opt.init(dtr), batch)
                out[f"train/{mode}/loss"] = m["loss"]
                out[f"train/{mode}/grad"] = read_grads(
                    tr, TC.dealt(new, tp, inverse=True))
                if mode == "sgd" and case["variant"] == "hybrid" and tp > 1:
                    # the reference's own layout: w_zx by contiguous columns
                    m = fn(frozen, B, tr, opt.init(tr), batch)[2]
                    out["train/contiguous/loss"] = m["loss"]
        if "adam" in modes:
            opt = adam(lr=1e-3, weight_decay=1e-5)
            os_ = opt.init(dtr)
            fn = train_fn(cfg, mesh, case, opt, 0.0,
                          (dfrozen, dB, dtr, os_, batch))
            t, losses = dtr, []
            for i in range(TC.ADAM_STEPS):
                t, os_, m = fn(dfrozen, dB, t, os_, jbatch(
                    TC.numpy_batch(cfg, 10 + i)))
                losses.append(float(m["loss"]))
            out["train/adam/losses"] = np.asarray(losses)
        if "full" in modes:
            opt = sgd(TC.READ_LR)
            dparams = TC.dealt(params, tp)
            fn = train_fn(cfg, mesh, case, opt, 0.0,
                          (dparams, opt.init(dparams), batch), full=True)
            new, _, m = fn(dparams, opt.init(dparams), batch)
            out["full/loss"] = m["loss"]
            out["full/grad"] = read_grads(params,
                                          TC.dealt(new, tp, inverse=True))


def run_prefill(cfg, case, mesh, params, out):
    multi_pod = "pod" in case["mesh"]
    fn, _, _ = STEPS.build_prefill_step(
        cfg, mesh, ShapeConfig("prefill", TC.S, TC.B, "prefill"),
        multi_pod=multi_pod)
    with set_mesh(mesh):
        out["prefill/tokens"] = fn(TC.dealt(params, TC.tp_of(case)),
                                   jbatch(TC.numpy_batch(cfg, 0),
                                          labels=False))


def empty_cache(cfg, params, kv, slots=TC.SLOTS):
    cache = JLM.init_cache(cfg, TC.B, slots, enc_seq_local=STEPS.ENC_PAD,
                           dtype=kv, tp=1)
    if cfg.family == "encdec":
        frames = jnp.asarray(TC.numpy_batch(cfg, 0)["frames"])
        cache, _ = JLM.prefill_cross_cache(cfg, params, frames, cache)
    return cache


def decode_run(step, params, cache, tokens, start=0):
    got = []
    for t in range(TC.DECODE_STEPS):
        n, cache = step(params, cache, tokens[:, t:t + 1],
                        jnp.int32(start + t))
        got.append(np.asarray(n))
    return np.concatenate(got, 1), cache


def run_decode(cfg, case, mesh, params, out):
    multi_pod = "pod" in case["mesh"]
    tokens = jnp.asarray(TC.numpy_batch(cfg, 5)["tokens"])
    unsharded = jax.jit(lambda p, c, t, pos: JLM.decode_step(
        cfg, p, c, t, pos, enc_len=STEPS.ENC_PAD))
    dparams = TC.dealt(params, TC.tp_of(case))
    for name in case["decode"]:
        kv_name, shape_name, start = TC.decode_mode(name)
        kv = getattr(jnp, kv_name)
        shape = ShapeConfig(shape_name, TC.SLOTS, TC.B, "decode")
        slots = TC.RING_WINDOW if shape_name == "long_500k" else TC.SLOTS
        # FSDP decode without weight-stationary does not lower on this JAX
        # (Unsupported pcast), and its weight-stationary decode joins rows
        # of different data ranks: the unsharded step is the oracle there
        if case["fsdp"]:
            toks, cache = shared(
                ("decode", TC.same_model_key(cfg, case), name),
                lambda: _np(decode_run(unsharded, params,
                                       empty_cache(cfg, params, kv), tokens)))
        else:
            fn, _, _ = STEPS.build_decode_step(cfg, mesh, shape,
                                               multi_pod=multi_pod,
                                               kv_dtype=kv)
            with set_mesh(mesh):
                toks, cache = decode_run(
                    fn, dparams, empty_cache(cfg, params, kv, slots), tokens,
                    start)
        out[f"decode/{name}/tokens"] = toks
        out[f"decode/{name}/cache"] = cache
        if case["ws"]:
            fn, _, _ = STEPS.build_decode_step(cfg, mesh, shape,
                                               multi_pod=multi_pod,
                                               weight_stationary=True,
                                               kv_dtype=kv)
            with set_mesh(mesh):
                toks, _ = decode_run(fn, dparams,
                                     empty_cache(cfg, params, kv), tokens)
            out[f"decode_ws_sharded/{name}/tokens"] = toks


def main(out_dir, tag, names):
    cases = {n: TC.CASES[n] for n in names}
    params = {}
    for case in cases.values():
        key = TC.params_key(case)
        if key not in params:
            cfg = TC.config(JCFG, case)
            params[key] = JLM.init_params(cfg, jax.random.PRNGKey(0),
                                          tp=TC.tp_of(case))
            save(os.path.join(out_dir, f"params_{key}.npz"), params[key])
    open(os.path.join(out_dir, f"params.{tag}.done"), "w").close()

    def one(name):
        case = cases[name]
        cfg = TC.config(JCFG, case)
        mesh = mesh_of(case)
        p = params[TC.params_key(case)]
        out = {}
        if case["train"]:
            run_train(cfg, case, mesh, p, out)
        if case["prefill"]:
            run_prefill(cfg, case, mesh, p, out)
        if case["decode"]:
            run_decode(cfg, case, mesh, p, out)
        save(os.path.join(out_dir, f"{name}.npz"), out)

    # XLA compiles with the GIL released: cases overlap in threads
    with concurrent.futures.ThreadPoolExecutor(THREADS) as pool:
        for f in [pool.submit(one, n) for n in cases]:
            f.result()


THREADS = 2

if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
