"""The port's LM scale-out against the JAX package: the dense arch on every
mesh and layout of the reference's steps, and the model half of the
sharding specs.

Steps (``tp_cases.TP_CASES``): reduced qwen3-1.7b (fp32) on (dp, tp) =
(1, 2), (2, 2) and (1, 4), multi-pod (pod, dp, tp) = (2, 1, 2), the dp
layout at (2, 2), FSDP at (2, 2), weight-stationary FSDP decode at (2, 2);
a GQA variant with one kv head at tp 2 (reduced qwen1.5-0.5b: the kv
heads replicated and group-sliced, their biases too) and one with 3 q
heads at tp 2 (padded to 4). Weights: the JAX package's
``init_params(tp=k)``, carried across; inputs: numpy from a seed. The JAX
side runs in one subprocess on 8 host devices (``jax_tp_oracle.py``), the
port's in gloo worlds of 2 and 4 ranks (``torch_tp_workers.py``), both
driven by ``tp_harness.py``.

Bars: the loss within 1e-5 of the JAX package's sharded step and of the
port's unsharded one; each gradient leaf within 1e-4 of its largest
magnitude against JAX's sharded step at tie_lambda 0 (one SGD step, read
as (old - new) / lr) and, the gradient on the mesh, against JAX's
unsharded ``jax.grad`` at tie_lambda 1e-4; three Adam steps' losses within
1e-5; prefill and decode tokens equal, fp32 caches within 1e-5, int8
codes within 1 and scales bit for bit; every rank's gathered outputs the
same. FSDP decode is held to JAX's unsharded ``decode_step``: its sharded
one does not lower on JAX 0.9.0 without weight-stationary, and its
weight-stationary one joins rows of different data ranks (pinned below,
ROADMAP Queue 3), as does the reference's sharded gradient under
tie_lambda (x TP).

Specs, from shapes alone (JAX ``eval_shape`` against the port's meta
tensors): the parameter, train-state, batch and cache specs and the step
structs of all 7 full configs at tp 16, with and without FSDP and
multi-pod.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_tp_workers as W
import tp_cases as TC
import tp_harness as H
from repro import configs as JCFG
from repro.launch import steps as JSTEPS
from repro.models import layers as JL
from repro.sharding import specs as JSPECS
from repro_torch import configs as CFG
from repro_torch.common.pytree import leaf_paths, tree_leaves
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.launch import steps as STEPS
from repro_torch.models import layers as PL
from repro_torch.sharding import specs as S
from repro_torch.train import trainer as TR

CASES = TC.TP_CASES
TRAIN = [n for n, c in CASES.items() if "sgd" in c["train"]]
ADAM = [n for n, c in CASES.items() if "adam" in c["train"]]
PREFILL = [n for n, c in CASES.items() if c["prefill"]]
DECODE = [f"{n}-{kv}" for n, c in CASES.items() for kv in c["decode"]]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    jax_out, port = H.run_all(list(CASES), out)
    return jax_out, port, out


def unsharded_port_loss(out_dir, name):
    """The port's unsharded split-step (loss, ce) on the case's weights."""
    case = TC.CASES[name]
    cfg = TC.config(CFG, case)
    params = lm_params_from_jax(TC.nested(W.load(
        out_dir / f"params_{TC.params_key(case)}.npz")), "cpu")
    st = TR.train_state_from_params(cfg, params)
    (loss, ce, _), _ = TR.adaptive_loss_and_grads(
        cfg, st.frozen, st.B, st.trainable,
        W.tbatch(TC.numpy_batch(cfg, 0)), tie_lambda=TC.TIE)
    return float(loss), float(ce)


def check_train(results, name, vs_unsharded=True):
    jax_out, port, out_dir = results
    j, p = jax_out[name], port[name][0]
    assert abs(float(p["train/sgd/loss"]) - float(j["train/sgd/loss"])) \
        <= H.FWD_TOL
    if vs_unsharded:
        loss, ce = unsharded_port_loss(out_dir, name)
        assert abs(float(p["train/sgd/loss"]) - loss) <= H.FWD_TOL
        assert abs(float(p["train/sgd/ce"]) - ce) <= H.FWD_TOL
    # no clip under TP: the step reports a norm of 0 (the dp layout clips)
    layout_tp = TC.CASES[name]["layout"] == "tp"
    assert (float(p["train/sgd/grad_norm"]) == 0.0) == layout_tp


@pytest.mark.parametrize("name", TRAIN)
def test_train_loss_matches_jax_and_unsharded(results, name):
    check_train(results, name)


@pytest.mark.parametrize("name", TRAIN)
def test_train_grads_match_jax_sharded_step(results, name):
    jax_out, port, _ = results
    H.close_leaves(H.under(port[name][0], "train/sgd/grad"),
                   H.under(jax_out[name], "train/sgd/grad"), H.GRAD_TOL,
                   name)


@pytest.mark.parametrize("name", TRAIN)
def test_mesh_grads_match_jax_unsharded(results, name):
    """At tie_lambda 1e-4, the reference's own: the gradient on the mesh
    is the unsharded one."""
    jax_out, port, _ = results
    H.close_leaves(H.under(port[name][0], "train/mesh_grad"),
                   H.under(jax_out[name], "train/grad_unsharded"),
                   H.GRAD_TOL, name)


@pytest.mark.parametrize("name", ADAM)
def test_adam_steps_match_jax(results, name):
    jax_out, port, _ = results
    np.testing.assert_allclose(port[name][0]["train/adam/losses"],
                               jax_out[name]["train/adam/losses"],
                               atol=H.FWD_TOL, rtol=0)


def test_full_step_matches_jax(results):
    jax_out, port, _ = results
    j, p = jax_out["dense_2x2"], port["dense_2x2"][0]
    assert abs(float(p["full/loss"]) - float(j["full/loss"])) <= H.FWD_TOL
    H.close_leaves(H.under(p, "full/grad"), H.under(j, "full/grad"),
                   H.GRAD_TOL, "full vs sharded")
    H.close_leaves(H.under(p, "full/grad"), H.under(j, "full/grad_unsharded"),
                   H.GRAD_TOL, "full vs unsharded")


def test_sharded_gradient_is_the_unsharded_one_under_tie_lambda(results):
    """The port's TP step at tie_lambda 1e-4 reads the unsharded gradient
    (ratio 1), where the reference's reads the cross-entropy's x TP."""
    jax_out, port, _ = results
    H.close_leaves(H.under(port["dense_1x2"][0], "train/pin/grad"),
                   H.under(jax_out["dense_1x2"], "train/grad_unsharded"),
                   H.GRAD_TOL, "port pin")


def test_jax_sharded_step_scales_the_ce_gradient_by_tp(results):
    """The reference's fault (ROADMAP Queue 3): at tie_lambda 1e-4 and tp
    = 2 its l1 term is summed over local shards, so the loss is TP-varying
    and the invariant cross-entropy's cotangent is summed over TP: every
    alpha leaf's gradient (no l1 there) comes out ~2x the unsharded one."""
    j = results[0]["dense_1x2"]
    pin, ref = H.under(j, "train/pin/grad"), H.under(j, "train/grad_unsharded")
    ratios = {k: float(np.vdot(pin[k], ref[k]) / np.vdot(ref[k], ref[k]))
              for k in ref if k.startswith("alpha/")}
    assert all(1.99 <= r <= 2.001 for r in ratios.values()), ratios


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_matches_jax(results, name):
    jax_out, port, _ = results
    np.testing.assert_array_equal(port[name][0]["prefill/tokens"],
                                  jax_out[name]["prefill/tokens"])


@pytest.mark.parametrize("name_kv", DECODE)
def test_decode_matches_jax(results, name_kv):
    name, kv = name_kv.rsplit("-", 1)
    if kv == "ring":            # long_500k's window, as both packages set it
        assert TC.RING_WINDOW == CFG.LONG_CONTEXT_WINDOW \
            == JCFG.LONG_CONTEXT_WINDOW
    jax_out, port, _ = results
    j, p = jax_out[name], port[name][0]
    np.testing.assert_array_equal(p[f"decode/{kv}/tokens"],
                                  j[f"decode/{kv}/tokens"])
    H.close_cache(H.under(p, f"decode/{kv}/cache"),
                  H.under(j, f"decode/{kv}/cache"),
                  H.RING_TOL if kv == "ring" else H.FWD_TOL)


def test_jitted_rope_at_the_ring():
    """Why the ring's caches are held at ``RING_TOL``: at position 8190
    jitted JAX's rope (XLA's sin / cos at large angles) leaves its eager
    rope by more than 1e-4, which the port's matches to 1e-6."""
    import jax.numpy as jnp
    import torch
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    x = np.random.default_rng(0).standard_normal((4, 1, 4, 64)).astype(
        np.float32)
    pos = np.full((4, 1), TC.RING_START + 2, np.int32)
    theta = CFG.get_config("qwen3-1.7b").rope_theta
    eager = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    jitted = np.asarray(jax.jit(lambda a, b: JL.apply_rope(a, b, theta))(
        jnp.asarray(x), jnp.asarray(pos)))
    port = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                         theta).numpy()
    assert np.abs(jitted - eager).max() > 1e-4
    assert np.abs(port - eager).max() <= 1e-6
    assert np.abs(port - jitted).max() <= H.RING_TOL * np.abs(jitted).max()


def test_jax_weight_stationary_decode_joins_rows(results):
    """The reference's weight-stationary decode with the batch split over
    data (ROADMAP Queue 3): its row-split output projection gathers the
    columns of each rank's own rows, so its tokens leave the unsharded
    decode's; the port's are the unsharded ones (test_decode_matches_jax)."""
    j = results[0]["dense_ws"]
    for kv in TC.CASES["dense_ws"]["decode"]:
        assert (j[f"decode_ws_sharded/{kv}/tokens"]
                != j[f"decode/{kv}/tokens"]).any()


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same(results, name):
    ranks = [H.bits_of(r) for r in results[1][name]]
    assert len(ranks) == TC.world_size(TC.CASES[name])
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# specs and structs from shapes alone: all 7 full configs at tp 16
# ---------------------------------------------------------------------------

ARCHS = list(JCFG.ARCH_IDS)
TP16, DP16 = 16, 16


def jax_specs(tree):
    """A JAX spec tree -> {path: tuple}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {JSPECS._path_str(p): tuple(s) for p, s in flat}


def jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {JSPECS._path_str(p): (tuple(l.shape), str(l.dtype))
            for p, l in flat}


def port_specs(tree):
    return {"/".join(p): s for p, s in zip(leaf_paths(tree),
                                           tree_leaves(tree))}


def port_shapes(tree):
    return {"/".join(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in zip(leaf_paths(tree), tree_leaves(tree))}


def cfgs(arch, fsdp=None):
    jc, pc = JCFG.get_config(arch), CFG.get_config(arch)
    if fsdp is not None:
        jc, pc = (dataclasses.replace(c, fsdp=fsdp) for c in (jc, pc))
    return jc, pc


@functools.lru_cache(maxsize=None)
def jax_state(arch):
    return JSTEPS.abstract_train_state(cfgs(arch)[0], TP16)


@functools.lru_cache(maxsize=None)
def port_state(arch):
    return STEPS.abstract_train_state(cfgs(arch)[1], TP16)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, fsdp):
    """Every leaf of (frozen, B, trainable) of ``init_train_state(tp=16)``
    (the whole parameter tree, padded heads and all) and of the Adam state:
    shapes, dtypes and specs equal (a port moment leads with the stack of
    one's 1, laid out whole)."""
    jc, pc = cfgs(arch, fsdp)
    js, ps = jax_state(arch), port_state(arch)
    for jt, pt in zip(js[:3], ps[:3]):
        assert port_shapes(pt) == jax_shapes(jt)
        assert port_specs(S.tree_param_specs(pc, pt, tp_size=TP16)) == \
            jax_specs(JSPECS.tree_param_specs(jc, jt, tp_size=TP16))
    jo = jax_specs(JSPECS.tree_param_specs(jc, js[3], tp_size=TP16))
    po = port_specs(STEPS.opt_state_specs(pc, ps[3], tp_size=TP16))
    assert sorted(po) == sorted(jo)
    assert all(po[k][0] is None and po[k][1:] == jo[k] for k in jo)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, multi_pod):
    jc, pc = cfgs(arch)
    for name in ("decode_32k", "long_500k"):
        shape = JCFG.INPUT_SHAPES[name]
        jcache = JSTEPS.decode_inputs_struct(jc, shape)[0]
        pcache = STEPS.decode_inputs_struct(pc, CFG.get_shape(name))[0]
        assert port_shapes(pcache) == jax_shapes(jcache)
        assert port_specs(S.cache_specs(
            pc, pcache, shape.global_batch, DP16, multi_pod)) == jax_specs(
            JSPECS.cache_specs(jc, jcache, shape.global_batch, DP16,
                               multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch, multi_pod):
    jc, pc = cfgs(arch)
    for name in ("train_4k", "prefill_32k"):
        shape = JCFG.INPUT_SHAPES[name]
        jb = JSTEPS.input_specs(jc, name)
        pb = STEPS.input_specs(pc, name)
        assert port_specs(S.batch_specs(
            pc, pb, shape.global_batch, DP16, multi_pod)) == jax_specs(
            JSPECS.batch_specs(jc, jb, shape.global_batch, DP16, multi_pod))


@pytest.mark.parametrize("shape", list(JCFG.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_step_structs_match_jax(arch, shape):
    """``input_specs``: the port's meta tensors have the shapes and dtypes
    of the reference's ``ShapeDtypeStruct`` stand-ins."""
    jc, pc = cfgs(arch)
    assert port_shapes(STEPS.input_specs(pc, shape)) == jax_shapes(
        JSTEPS.input_specs(jc, shape))


def test_batch_axes_and_serving_specs_match_jax():
    for gb in (1, 2, 16, 24, 32, 128):
        for dp in (1, 2, 16):
            for mp in (False, True):
                assert S.batch_axes(gb, dp, mp) == JSPECS.batch_axes(gb, dp,
                                                                     mp)
    assert S.serving_index_specs() == {
        k: tuple(v) for k, v in JSPECS.serving_index_specs().items()}


def test_dp_layout_refuses_a_batch_the_axes_do_not_divide():
    class Mesh:                                   # sizes are all it reads
        shape = {"data": 2, "model": 2}

        def size(self, axis):
            return self.shape[axis]

    with pytest.raises(ValueError, match="divisible by all axes"):
        STEPS.build_train_step(CFG.get_config("qwen3-1.7b").reduced(), Mesh(),
                               ShapeConfig("t", 16, 6, "train"),
                               multi_pod=False, layout="dp")


def test_sgd_matches_jax():
    """The port's ``sgd`` (no momentum) is the reference's at momentum 0:
    the same update and an empty state."""
    from repro.train.optimizer import sgd as jsgd
    from repro_torch.train.optimizer import sgd
    g = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    want, jstate = jsgd(0.25).update({"w": jnp.asarray(g)},
                                     jsgd(0.25).init({"w": jnp.asarray(g)}))
    opt = sgd(0.25)
    got, state = opt.update({"w": torch.from_numpy(g)},
                            opt.init({"w": torch.from_numpy(g)}))
    assert state == {} and jstate == {}
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
