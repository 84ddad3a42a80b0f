"""Rank-side halves of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``.

``run`` executes on every rank of a gloo world that
``repro_torch.launch.mesh.spawn`` starts: for each case of
``tp_cases.py`` it builds the case's mesh over the world, runs the port's
steps (``launch/steps.py``) on the rank's shards of the JAX package's
weights (read from the oracle's npz files) and of the numpy inputs, and
returns what it gathered back, flattened as the oracle writes it. This
module imports only the port, so a spawned rank does not import JAX.
"""
import os

import numpy as np
import torch

import tp_cases as TC
from repro_torch import configs as CFG
from repro_torch.common.pytree import tree_map
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.sharding.specs import (batch_specs, gather_tree,
                                        shard_tree, tree_param_specs)
from repro_torch.train import trainer as TR
from repro_torch.train.optimizer import adam, sgd


def decode_flat(flat):
    """{key: numpy} with bf16 leaves as their bits under ``key@bf16`` ->
    {key: numpy, or a torch bf16 tensor for those}."""
    return {(k[:-5] if k.endswith("@bf16") else k):
            (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
             if k.endswith("@bf16") else v) for k, v in flat.items()}


def load(path):
    """An npz of the oracle -> {key: numpy array, or a torch bf16 tensor
    for a bf16 leaf}."""
    with np.load(path) as f:
        return decode_flat({k: f[k] for k in f.files})


def flat_np(tree, prefix):
    """A tree of tensors (or one tensor) -> {prefix/key: numpy} (bf16 as
    its bits, under ``@bf16``, as the oracle stores it)."""
    out = {}
    items = (TC.flat(tree, prefix).items() if isinstance(tree, dict)
             else [(prefix, tree)])
    for k, v in items:
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            out[k + "@bf16"] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            out[k] = v.numpy()
    return out


def tbatch(nb, labels=True):
    return {k: torch.from_numpy(v) for k, v in nb.items()
            if labels or k != "labels"}


def _mesh(case):
    m = case["mesh"]
    return make_debug_mesh(tp=m["model"], dp=m["data"], multi_pod="pod" in m)


def _train(cfg, case, mesh, params, out):
    multi_pod = "pod" in case["mesh"]
    shape = ShapeConfig("train", TC.S, TC.B, "train")
    tp = 1 if case["layout"] == "dp" else mesh.size("model")
    st = TR.train_state_from_params(cfg, params)
    batch = tbatch(TC.numpy_batch(cfg, 0))
    modes = case["train"]

    def build(opt, tie):
        step, _, specs = steps.build_train_step(
            cfg, mesh, shape, multi_pod=multi_pod, layout=case["layout"],
            optimizer=opt, tie_lambda=tie)
        return step, specs

    def local(args, specs):
        return [shard_tree(a, s, mesh) for a, s in zip(args, specs)]

    if "sgd" in modes or "pin" in modes:
        opt = sgd(TC.READ_LR)
        init = TR.init_opt_state(opt, st.trainable)
        for mode, tie in (("sgd", 0.0), ("pin", TC.TIE)):
            if mode not in modes:
                continue
            step, specs = build(opt, tie)
            args = local((st.frozen, st.B, st.trainable, init, batch), specs)
            new, _, m = step(*args)
            new = gather_tree(new, step.out_specs[0], mesh)
            out.update(flat_np(m["loss"], f"train/{mode}/loss"))
            out.update(flat_np(m["ce"], f"train/{mode}/ce"))
            out.update(flat_np(m["grad_norm"], f"train/{mode}/grad_norm"))
            out.update(flat_np(tree_map(lambda a, b: (a - b) / TC.READ_LR,
                                        st.trainable, new),
                               f"train/{mode}/grad"))
        # the gradient on the mesh itself, at the reference's tie_lambda
        (_, _, _), g = TR.adaptive_loss_and_grads(
            cfg, args[0], args[1], args[2], args[4], step.ax,
            tie_lambda=TC.TIE)
        out.update(flat_np(gather_tree(g, step.out_specs[0], mesh),
                           "train/mesh_grad"))
    if "adam" in modes:
        opt = adam(lr=1e-3, weight_decay=1e-5)
        step, specs = build(opt, 0.0)
        args = local((st.frozen, st.B, st.trainable,
                      TR.init_opt_state(opt, st.trainable), batch), specs)
        tr, os_, losses = args[2], args[3], []
        for i in range(TC.ADAM_STEPS):
            b = shard_tree(tbatch(TC.numpy_batch(cfg, 10 + i)), specs[4],
                           mesh)
            tr, os_, m = step(args[0], args[1], tr, os_, b)
            losses.append(float(m["loss"]))
        out["train/adam/losses"] = np.asarray(losses)
    if "full" in modes:
        opt = sgd(TC.READ_LR)
        ax = steps.axis_ctx(cfg, multi_pod, mesh)
        p_specs = tree_param_specs(cfg, params, tp_size=tp)
        b_specs = batch_specs(cfg, batch, TC.B, mesh.size("data"), multi_pod)
        full = TR.make_full_train_step(cfg, optimizer=opt, ax=ax)
        new, _, m = full(shard_tree(params, p_specs, mesh),
                         TR.init_opt_state(opt, {}),
                         shard_tree(batch, b_specs, mesh))
        new = gather_tree(new, p_specs, mesh)
        out.update(flat_np(m["loss"], "full/loss"))
        out.update(flat_np(tree_map(lambda a, b: (a - b) / TC.READ_LR,
                                    params, new), "full/grad"))


def _prefill(cfg, case, mesh, params, out):
    step, _, specs = steps.build_prefill_step(
        cfg, mesh, ShapeConfig("prefill", TC.S, TC.B, "prefill"),
        multi_pod="pod" in case["mesh"])
    batch = tbatch(TC.numpy_batch(cfg, 0), labels=False)
    tok = step(*[shard_tree(a, s, mesh)
                 for a, s in zip((params, batch), specs)])
    out.update(flat_np(gather_tree(tok, step.out_specs, mesh),
                       "prefill/tokens"))


def _decode(cfg, case, mesh, params, out):
    tokens = torch.from_numpy(TC.numpy_batch(cfg, 5)["tokens"])
    for name in case["decode"]:
        kv, shape_name, start = TC.decode_mode(name)
        step, args, specs = steps.build_decode_step(
            cfg, mesh, ShapeConfig(shape_name, TC.SLOTS, TC.B, "decode"),
            multi_pod="pod" in case["mesh"], weight_stationary=case["ws"],
            kv_dtype=getattr(torch, kv))
        cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                         args[1])
        if cfg.family == "encdec":
            frames = torch.from_numpy(TC.numpy_batch(cfg, 0)["frames"])
            cache, _ = lm.prefill_cross_cache(cfg, params, frames, cache)
        p, c = shard_tree(params, specs[0], mesh), shard_tree(cache, specs[1],
                                                              mesh)
        got = []
        for t in range(TC.DECODE_STEPS):
            n, c = step(p, c, shard_tree(tokens[:, t:t + 1], specs[2], mesh),
                        start + t)
            got.append(gather_tree(n, step.out_specs[0], mesh))
        out.update(flat_np(torch.cat(got, 1), f"decode/{name}/tokens"))
        out.update(flat_np(gather_tree(c, step.out_specs[1], mesh),
                           f"decode/{name}/cache"))


def run(names, params_dir):
    """Every case of ``names`` on this rank -> {case: {key: numpy}}."""
    results = {}
    for name in names:
        case = TC.CASES[name]
        cfg = TC.config(CFG, case)
        params = lm_params_from_jax(TC.nested(load(os.path.join(
            params_dir, f"params_{TC.params_key(case)}.npz"))), "cpu")
        out = {}
        with _mesh(case) as mesh:
            if case["train"]:
                _train(cfg, case, mesh, params, out)
            if case["prefill"]:
                _prefill(cfg, case, mesh, params, out)
            if case["decode"]:
                _decode(cfg, case, mesh, params, out)
        results[name] = out
    return results
