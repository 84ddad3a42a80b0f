"""The port's dense LM slice against the JAX package on the same inputs:
configs, token batches, forward / loss from carried weights, the FedSTIL
split train step (gradients in (alpha, A), then three steps), the full
fine-tuning step, checkpoints both ways, and the launcher on the CPU.

Weights: the reference's ``init_params`` at PRNGKey(0), carried across
bit for bit (``core.convert.lm_params_from_jax``). Batches: numpy
(``synthetic_lm_batch`` from one seed) handed to both. Every config is
``reduced()`` (fp32 weights and compute); the GQA variant is reduced
qwen3-1.7b with 2 kv heads (R = 2).

Tolerances: hidden states and losses 1e-5 (fp32; the port attends with
one softmax where the reference scans 1024-key chunks, and its rope
``pow`` / ``cos`` may differ by an ulp); gradients of (alpha, A) 1e-4 of
their largest magnitude (fp32 sums through two layers in another order);
the loss of each of three steps 1e-4 (Adam's first steps move by ~lr *
sign(g), so small gradient differences carry into the weights).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCKPT
from repro import configs as JCFG
from repro.core import adaptive as JAD
from repro.data.tokens import synthetic_lm_batch as j_batch
from repro.models import lm as JLM
from repro.train import trainer as JTR
from repro.train.optimizer import adam as j_adam
from repro.train.optimizer import cosine_schedule as j_cosine
from repro_torch import checkpoint as CKPT
from repro_torch import configs as CFG
from repro_torch.common.pytree import leaf_paths, tree_leaves
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.kernels import ops
from repro_torch.launch import train as LAUNCH
from repro_torch.models import lm
from repro_torch.train import trainer as TR
from repro_torch.train.optimizer import adam, cosine_schedule

DENSE = ["qwen1.5-0.5b", "qwen3-1.7b", "llama3-405b", "gqa"]
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4


def _cfgs(arch):
    """(JAX config, port config) of a reduced dense arch (or the GQA
    variant of qwen3-1.7b: 4 q heads over 2 kv heads)."""
    name = "qwen3-1.7b" if arch == "gqa" else arch
    jc, pc = JCFG.get_config(name).reduced(), CFG.get_config(name).reduced()
    if arch == "gqa":
        jc = dataclasses.replace(jc, n_kv_heads=2)
        pc = dataclasses.replace(pc, n_kv_heads=2)
    return jc, pc


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, B=2, S=16, seed=0):
    jc, pc = _cfgs(arch)
    jparams = JLM.init_params(jc, jax.random.PRNGKey(0))
    params = lm_params_from_jax(_np_tree(jparams), "cpu")
    toks, labels = synthetic_lm_batch(np.random.default_rng(seed), B, S,
                                      pc.vocab_size)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    return jc, pc, jparams, params, jbatch, batch


def test_configs_equal_the_reference():
    assert CFG.ARCH_IDS == JCFG.ARCH_IDS
    for arch in JCFG.ARCH_IDS:
        for jc, pc in ((JCFG.get_config(arch), CFG.get_config(arch)),
                       (JCFG.get_config(arch).reduced(),
                        CFG.get_config(arch).reduced())):
            assert dataclasses.asdict(jc) == dataclasses.asdict(pc), arch
            assert (jc.hd, jc.padded_vocab(), jc.n_params(),
                    jc.active_params(), jc.adaptive_active_params()) == \
                (pc.hd, pc.padded_vocab(), pc.n_params(), pc.active_params(),
                 pc.adaptive_active_params())
    assert {k: dataclasses.asdict(v) for k, v in JCFG.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in CFG.INPUT_SHAPES.items()}
    assert JCFG.LONG_CONTEXT_WINDOW == CFG.LONG_CONTEXT_WINDOW
    with pytest.raises(KeyError):
        CFG.get_config("nope")


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lm_batch_equals_the_reference(seed):
    a = synthetic_lm_batch(np.random.default_rng(seed), 3, 40, 1000)
    b = j_batch(np.random.default_rng(seed), 3, 40, 1000)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_weights_carry_bit_for_bit():
    jc, pc, jparams, params, _, _ = _setup("qwen3-1.7b")
    jl = jax.tree.leaves(jparams)
    pl = tree_leaves(params)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    bf = np.asarray(jnp.asarray([1.0, -2.5, 3e-3], jnp.bfloat16))
    t = lm_params_from_jax({"x": bf}, "cpu")["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_jax(arch):
    jc, pc, jparams, params, jbatch, batch = _setup(arch)
    jx, _ = JLM.forward(jc, jparams, jbatch)
    x, aux = lm.forward(pc, params, batch)
    assert x.shape == (2, 16, pc.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=FWD_TOL,
                               rtol=FWD_TOL)
    jtot, (jce, _) = JLM.loss_fn(jc, jparams, jbatch)
    tot, (ce, _) = lm.loss_fn(pc, params, batch)
    np.testing.assert_allclose(float(tot), float(jtot), atol=FWD_TOL,
                               rtol=FWD_TOL)
    np.testing.assert_allclose(float(ce), float(jce), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_greedy_readout_matches_jax():
    from repro.models import layers as JL
    from repro_torch.models import layers as PL
    jc, pc, jparams, params, jbatch, batch = _setup("qwen1.5-0.5b")
    jx, _ = JLM.forward(jc, jparams, jbatch)
    jid, jval = JL.lm_head_logits(jc, jparams["head"], jx, JL.UNSHARDED)
    tid, tval = PL.lm_head_logits(pc, params["head"],
                                  torch.from_numpy(np.array(jx)))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_init_params_builds_every_family():
    """Every registered arch (dense, moe, ssm, hybrid) and the vlm and
    encdec variants: ``init_params`` builds its family's tree, finite,
    with the trunk / adaptive split the split step trains."""
    from repro_torch.core.adaptive import split_params
    cfgs = [CFG.get_config(a).reduced() for a in CFG.ARCH_IDS]
    base = CFG.get_config("qwen1.5-0.5b").reduced()
    cfgs += [dataclasses.replace(base, family="vlm", n_vision_tokens=8),
             dataclasses.replace(base, family="encdec", n_enc_layers=2,
                                 enc_seq=16, rope_theta=0.0)]
    assert {c.family for c in cfgs} == {"dense", "moe", "ssm", "hybrid",
                                        "vlm", "encdec"}
    for cfg in cfgs:
        params = lm.init_params(cfg, torch.Generator().manual_seed(0))
        assert all(torch.isfinite(t).all() for t in tree_leaves(params))
        frozen, adaptive = split_params(cfg, params)
        want = {"hybrid": {"head", "final_norm", "shared_attn"}}.get(
            cfg.family, {"head", "final_norm", "adaptive_layers"})
        assert set(adaptive) == want, cfg.name
        assert "embed" in frozen and "layers" in frozen


def _jax_split_grads(jc, st, jbatch, tie_lambda):
    """The reference train step's differentiated function
    (``repro/train/trainer.py:make_train_step``, ``lf``), unsharded."""
    def lf(tr):
        theta = JAD.combine(st.B, tr["alpha"], tr["A"])
        total, _ = JLM.loss_fn(jc, JAD.merge_params(st.frozen, theta), jbatch)
        l1 = sum(jnp.sum(jnp.abs(a)) for a in jax.tree.leaves(tr["A"]))
        return total + tie_lambda * l1
    return jax.grad(lf)(st.trainable)


def _port_state(pc, jst, opt):
    frozen = lm_params_from_jax(_np_tree(jst.frozen), "cpu")
    B = lm_params_from_jax(_np_tree(jst.B), "cpu")
    trainable = lm_params_from_jax(_np_tree(jst.trainable), "cpu")
    return TR.TrainState(frozen=frozen, B=B, trainable=trainable,
                         opt_state=TR.init_opt_state(opt, trainable))


@pytest.mark.parametrize("arch", DENSE)
def test_split_step_grads_then_three_steps_match_jax(arch):
    jc, pc, _, _, _, _ = _setup(arch)
    jst = JTR.init_train_state(jc, jax.random.PRNGKey(0))
    opt = adam(lr=1e-3, weight_decay=1e-5)
    st = _port_state(pc, jst, opt)
    rng = np.random.default_rng(1)
    batches = [synthetic_lm_batch(rng, 2, 16, pc.vocab_size)
               for _ in range(3)]
    jb = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(l)}
          for t, l in batches]
    tb = [{"tokens": torch.from_numpy(t), "labels": torch.from_numpy(l)}
          for t, l in batches]

    jg = _jax_split_grads(jc, jst, jb[0], 1e-4)
    _, g = TR.adaptive_loss_and_grads(pc, st.frozen, st.B, st.trainable,
                                      tb[0], tie_lambda=1e-4)
    assert leaf_paths(g) == leaf_paths(st.trainable)
    jl, gl = jax.tree.leaves(jg), tree_leaves(g)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in jl)
    for a, b in zip(jl, gl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=GRAD_TOL * scale, rtol=0)

    jstep = jax.jit(JTR.make_train_step(jc, tie_lambda=1e-4))
    step = TR.make_train_step(pc, optimizer=opt, tie_lambda=1e-4)
    jtr, jopt = jst.trainable, jst.opt_state
    tr, opt_state = st.trainable, st.opt_state
    for i in range(3):
        jtr, jopt, jm = jstep(jst.frozen, jst.B, jtr, jopt, jb[i])
        tr, opt_state, m = step(st.frozen, st.B, tr, opt_state, tb[i])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
    assert int(opt_state["count"][0]) == int(jopt["count"]) == 3


def test_schedule_and_full_step_match_jax():
    """``make_full_train_step`` with the launcher's cosine schedule: the
    loss of three steps and every parameter after them."""
    jc, pc, jparams, params, _, _ = _setup("gqa")
    jopt = j_adam(lr=3e-4, weight_decay=1e-5, schedule=j_cosine(2, 10))
    opt = adam(lr=3e-4, weight_decay=1e-5, schedule=cosine_schedule(2, 10))
    counts = np.arange(13, dtype=np.int32)
    np.testing.assert_array_equal(
        cosine_schedule(2, 10)(torch.from_numpy(counts)).numpy(),
        np.asarray(j_cosine(2, 10)(jnp.asarray(counts))))
    jstep = jax.jit(JTR.make_full_train_step(jc, optimizer=jopt))
    step = TR.make_full_train_step(pc, optimizer=opt)
    jos, os_ = jopt.init(jparams), TR.init_opt_state(opt, params)
    rng = np.random.default_rng(3)
    for _ in range(3):
        t, l = synthetic_lm_batch(rng, 2, 16, pc.vocab_size)
        jparams, jos, jm = jstep(jparams, jos, {"tokens": jnp.asarray(t),
                                                "labels": jnp.asarray(l)})
        params, os_, m = step(params, os_, {"tokens": torch.from_numpy(t),
                                            "labels": torch.from_numpy(l)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=STEP_TOL, rtol=STEP_TOL)
    for a, b in zip(jax.tree.leaves(jparams), tree_leaves(params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=STEP_TOL,
                                   rtol=0)


def test_train_step_uses_the_kernel_stages_it_should():
    """Trunk layers take the forward stage alone, the adaptive layer the
    differentiable op: count the stage calls of one split step."""
    _, pc, _, params, _, batch = _setup("gqa")
    st = TR.train_state_from_params(pc, params)
    seen = []
    names = ("flash_attention_fwd", "flash_attention_fwd_lse",
             "flash_attention_dq", "flash_attention_dkv")
    orig = {n: getattr(ops, n) for n in names}

    def counting(name):
        def call(*a, **kw):
            seen.append(name)
            return orig[name](*a, **kw)
        return call

    try:
        for n in names:
            setattr(ops, n, counting(n))
        TR.make_train_step(pc, tie_lambda=1e-4)(st.frozen, st.B, st.trainable,
                                                st.opt_state, batch)
    finally:
        for n, fn in orig.items():
            setattr(ops, n, fn)
    n_trunk = pc.n_layers - pc.n_adaptive_layers
    assert sorted(seen) == sorted(["flash_attention_fwd"] * n_trunk + [
        "flash_attention_fwd_lse", "flash_attention_dq",
        "flash_attention_dkv"] * pc.n_adaptive_layers)


def test_checkpoints_cross_both_ways(tmp_path):
    _, pc, jparams, params, _, _ = _setup("qwen1.5-0.5b")
    tree = {"params": params, "steps": [torch.tensor(3)]}
    CKPT.save_checkpoint(str(tmp_path / "port.npz"), tree, {"arch": "x"})
    back, meta = JCKPT.load_checkpoint(str(tmp_path / "port"))
    assert meta == {"arch": "x"} and int(back["steps"][0]) == 3
    for a, b in zip(jax.tree.leaves(jparams),
                    jax.tree.leaves(back["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    JCKPT.save_checkpoint(str(tmp_path / "jax.npz"),
                          {"params": jparams,
                           "bf16": jnp.asarray([1.5, -2.0], jnp.bfloat16)},
                          {"k": [1, 2]})
    got, meta = CKPT.load_checkpoint(str(tmp_path / "jax.npz"))
    assert meta == {"k": [1, 2]}
    assert leaf_paths(got["params"]) == leaf_paths(params)
    for a, b in zip(tree_leaves(params), tree_leaves(got["params"])):
        assert torch.equal(a, b)
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].tolist() == [1.5, -2.0]
    # bf16 is written as the reference writes it (two raw bytes a value;
    # the JAX loader itself cannot read such a leaf back)
    CKPT.save_checkpoint(str(tmp_path / "pbf.npz"), {"bf16": got["bf16"]})
    with np.load(str(tmp_path / "pbf.npz")) as a, \
            np.load(str(tmp_path / "jax.npz")) as b:
        assert a["bf16"].dtype == b["bf16"].dtype
        assert a["bf16"].tobytes() == b["bf16"].tobytes()
    with pytest.raises(FileNotFoundError):
        CKPT.load_checkpoint(str(tmp_path / "missing"))
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="bad.npz"):
        CKPT.load_checkpoint(str(tmp_path / "bad.npz"))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    losses = LAUNCH.main(["--device", "cpu", "--steps", "20",
                          "--log-every", "5",
                          "--ckpt", str(tmp_path / "ck.npz")])
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2
    out = capsys.readouterr().out
    assert "step    19" in out and "checkpoint ->" in out
    tree, meta = CKPT.load_checkpoint(str(tmp_path / "ck.npz"))
    assert meta == {"arch": "qwen3-1.7b", "steps": 20}
    assert set(tree) == {"trainable", "B"}


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        LAUNCH.main(["--steps", "1"])


def test_bf16_combine_plain_matches_eager_jax_bit_for_bit():
    """The full-width adaptive leaves are bf16: the combine (product and
    sum each rounded to bf16) equals JAX's eager ``b * al + a``, and its
    autograd Function keeps the nested tree's structure."""
    rng = np.random.default_rng(4)
    b, al, a = (rng.standard_normal((37, 129)).astype(np.float32)
                for _ in range(3))
    tb, tal, ta = (torch.from_numpy(x).bfloat16() for x in (b, al, a))
    jb, jal, ja = (jnp.asarray(x).astype(jnp.bfloat16) for x in (b, al, a))
    got = ops.adaptive_combine(tb, tal, ta)
    want = np.asarray((jb * jal + ja).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    from repro_torch.core.adaptive import combine
    tree = {"x": {"w": tb}, "y": ta}
    out = combine(tree, {"x": {"w": tal}, "y": tal}, {"x": {"w": ta}, "y": tb})
    assert torch.equal(out["x"]["w"], got)
    assert leaf_paths(out) == [("x", "w"), ("y",)]
