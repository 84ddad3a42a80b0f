"""The port's LM zoo against the JAX package on the same inputs: every
family's parameter tree, forward and loss, the split train step's
gradients, sliding-window attention in the forward and the train step,
the MoE block (capacity, gates, a forced capacity drop, the aux loss, the
tie rule), the rwkv and mamba blocks with and without state, the token
loader, and the training launcher on a non-dense arch.

The families: the 7 registered archs (dense qwen1.5-0.5b, qwen3-1.7b and
llama3-405b; moe qwen3-moe-235b-a22b and arctic-480b; ssm rwkv6-1.6b;
hybrid zamba2-2.7b), each ``reduced()``, plus two variants built with the
same ``dataclasses.replace`` on each side: ``vlm`` (reduced qwen3-1.7b
with 8 stub vision tokens) and ``encdec`` (reduced qwen1.5-0.5b as a
whisper: 2 encoder layers over 16 stub frames, sinusoidal positions,
layernorm, gelu). Weights: the reference's ``init_params`` at
PRNGKey(0), carried across bit for bit (``lm_params_from_jax``); inputs
numpy from a seed.

Tolerances (fp32): losses 1e-5; hidden states and block outputs 1e-5 of
their largest magnitude (sums in another order: one softmax where the
reference scans chunks, einsums against matmuls, the recurrences'
contractions); gradients of (alpha, A) 1e-4 of their largest magnitude,
as ``test_torch_lm.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.common.axes import UNSHARDED as JUNSHARDED
from repro.core import adaptive as JAD
from repro.data import loader as JLOADER
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.models import rwkv as JRWKV
from repro.models import ssm as JSSM
from repro.train import trainer as JTR
from repro.train.optimizer import adam as j_adam
from repro_torch import configs as CFG
from repro_torch.common.pytree import leaf_paths, tree_leaves
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.data import loader as LOADER
from repro_torch.launch import train as LAUNCH
from repro_torch.models import lm
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv as RWKV
from repro_torch.models import ssm as SSM
from repro_torch.train import trainer as TR
from repro_torch.train.optimizer import adam

ARCHS = list(JCFG.ARCH_IDS) + ["vlm", "encdec"]
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def family_cfgs(arch):
    """(JAX config, port config) of a reduced arch or of the vlm / encdec
    variant, built by the same ``dataclasses.replace`` on each side."""
    out = []
    for C in (JCFG, CFG):
        if arch == "vlm":
            c = dataclasses.replace(C.get_config("qwen3-1.7b").reduced(),
                                    family="vlm", n_vision_tokens=8)
        elif arch == "encdec":
            c = dataclasses.replace(C.get_config("qwen1.5-0.5b").reduced(),
                                    family="encdec", n_enc_layers=2,
                                    enc_seq=16, rope_theta=0.0,
                                    norm="layernorm", act="gelu")
        else:
            c = C.get_config(arch).reduced()
        out.append(c)
    return tuple(out)


def numpy_batch(cfg, B, S, seed):
    """Token ids and labels, plus vision embeds (vlm) or frames (encdec),
    as numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return b


def both(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """(JAX config, port config, the reference's params at PRNGKey(0)),
    made once an arch (the reference's init takes seconds)."""
    jc, pc = family_cfgs(arch)
    return jc, pc, JLM.init_params(jc, jax.random.PRNGKey(0))


def jax_train_state(jc, jparams):
    """``JTR.init_train_state``'s state around the cached params."""
    frozen, adaptive = JAD.split_params(jc, jparams)
    ad = JAD.init_adaptive(adaptive)
    opt = j_adam(lr=1e-3, weight_decay=1e-5)
    return JTR.TrainState(frozen=frozen, B=ad.B, trainable=ad.trainable(),
                          opt_state=opt.init(ad.trainable()))


def setup(arch, B=2, S=16, seed=0):
    jc, pc, jparams = jax_params(arch)
    params = lm_params_from_jax(np_tree(jparams), "cpu")
    jb, tb = both(numpy_batch(pc, B, S, seed))
    return jc, pc, jparams, params, jb, tb


def close(got, want, tol=FWD_TOL, scale=1.0):
    """Within tol (absolute, times ``scale``, and relative)."""
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol * scale,
        rtol=tol)


def close_block(got, want):
    """Activations: 1e-5 of their largest magnitude (and relative), since
    fp32 sums in another order err in proportion to the terms summed: up
    to ~1e3 in a reduced MoE block (its experts' weights have std
    1/sqrt(E) = 0.5), a few units in hidden states after the final norm
    (through zamba2's mamba scans the port's reads 1.7e-5 off at a
    largest |x| of 3.9)."""
    close(got, want, scale=float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """The port's tree has the reference's paths, shapes and dtypes, and
    carries the reference's weights leaf for leaf."""
    _, pc, want = jax_params(arch)
    params = lm.init_params(pc, torch.Generator().manual_seed(0))
    paths = [tuple(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert leaf_paths(params) == paths
    for a, b in zip(jax.tree.leaves(want), tree_leaves(params)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert all(torch.isfinite(t.float()).all() for t in tree_leaves(params))


@functools.lru_cache(maxsize=None)
def jax_reference(arch):
    """The reference on ``setup(arch)``'s batch, in one jit an arch: the
    forward (hidden, aux), the loss (total, ce), and the split step's
    gradients in (alpha, A) with its loss (tie_lambda 1e-4)."""
    jc, _, jparams, _, jb, _ = setup(arch)
    jst = jax_train_state(jc, jparams)

    def ref(p, b, tr):
        return (JLM.forward(jc, p, b), JLM.loss_fn(jc, p, b),
                split_grads_fn(jc, jst, b, 1e-4)(tr))
    return jax.jit(ref)(jparams, jb, jst.trainable)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    _, pc, _, params, _, tb = setup(arch)
    (jx, jaux), (jtot, (jce, _)), _ = jax_reference(arch)
    x, aux = lm.forward(pc, params, tb)
    extra = pc.n_vision_tokens if pc.family == "vlm" else 0
    assert x.shape == (2, 16 + extra, pc.d_model)
    close_block(x, jx)
    close(aux, jaux)
    tot, (ce, _) = lm.loss_fn(pc, params, tb)
    close(tot, jtot)
    close(ce, jce)


def split_grads_fn(jc, st, jbatch, tie_lambda, window=0):
    """The reference train step's differentiated function, unsharded:
    trainable -> (grads, loss without the tying term)."""
    def lf(tr):
        theta = JAD.combine(st.B, tr["alpha"], tr["A"])
        total, _ = JLM.loss_fn(jc, JAD.merge_params(st.frozen, theta), jbatch,
                               window=window)
        l1 = sum(jnp.sum(jnp.abs(a)) for a in jax.tree.leaves(tr["A"]))
        return total + tie_lambda * l1, total
    return jax.grad(lf, has_aux=True)


def port_state(jst, opt):
    trainable = lm_params_from_jax(np_tree(jst.trainable), "cpu")
    return TR.TrainState(frozen=lm_params_from_jax(np_tree(jst.frozen), "cpu"),
                         B=lm_params_from_jax(np_tree(jst.B), "cpu"),
                         trainable=trainable,
                         opt_state=TR.init_opt_state(opt, trainable))


def close_grads(g, jg):
    assert leaf_paths(g) == [tuple(str(getattr(k, "key", k)) for k in p)
                             for p, _ in jax.tree_util.tree_flatten_with_path(
                                 jg)[0]]
    jl = jax.tree.leaves(jg)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in jl)
    assert scale > 0
    for a, b in zip(jl, tree_leaves(g)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=GRAD_TOL * scale, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_grads_match_jax(arch):
    jc, pc, jparams, _, _, tb = setup(arch)
    st = port_state(jax_train_state(jc, jparams),
                    adam(lr=1e-3, weight_decay=1e-5))
    jg, jloss = jax_reference(arch)[2]
    (loss, _, _), g = TR.adaptive_loss_and_grads(
        pc, st.frozen, st.B, st.trainable, tb, tie_lambda=1e-4)
    close_grads(g, jg)
    close(loss, jloss)


def test_window_forward_and_train_step_match_jax():
    """``forward(window=)`` and ``make_train_step(window=)``: a sliding
    window of 4 over 16 positions (every row sees at most 4 keys)."""
    jc, pc, jparams, params, jb, tb = setup("qwen1.5-0.5b", seed=2)
    jx, _ = jax.jit(lambda p, b: JLM.forward(jc, p, b, window=4))(jparams, jb)
    x, _ = lm.forward(pc, params, tb, window=4)
    close_block(x, jx)
    full, _ = lm.forward(pc, params, tb)
    assert float((x - full).abs().max()) > 1e-3      # the window bites
    jst = jax_train_state(jc, jparams)
    opt = adam(lr=1e-3, weight_decay=1e-5)
    st = port_state(jst, opt)
    close_grads(TR.adaptive_loss_and_grads(pc, st.frozen, st.B, st.trainable,
                                           tb, window=4, tie_lambda=1e-4)[1],
                jax.jit(split_grads_fn(jc, jst, jb, 1e-4, window=4))(
                    jst.trainable)[0])
    jstep = jax.jit(JTR.make_train_step(jc, window=4, tie_lambda=1e-4))
    step = TR.make_train_step(pc, optimizer=opt, window=4, tie_lambda=1e-4)
    jtr, jopt, tr, os_ = jst.trainable, jst.opt_state, st.trainable, \
        st.opt_state
    for _ in range(2):
        jtr, jopt, jm = jstep(jst.frozen, jst.B, jtr, jopt, jb)
        tr, os_, m = step(st.frozen, st.B, tr, os_, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_setup(arch="qwen3-moe-235b-a22b", seed=3, B=2, S=16, **replace):
    jc, pc = family_cfgs(arch)
    jc, pc = (dataclasses.replace(c, **replace) for c in (jc, pc))
    jp = jax.jit(JMOE.moe_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), jc, jc.n_experts)
    p = lm_params_from_jax(np_tree(jp), "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, pc.d_model)).astype(np.float32)
    return jc, pc, jp, p, x


def jax_moe_block(jc, jp, x):
    return jax.jit(lambda p, xx: JMOE.moe_block(jc, p, xx, JUNSHARDED))(
        jp, jnp.asarray(x))


def test_expert_capacity_matches_jax():
    jc, pc = family_cfgs("qwen3-moe-235b-a22b")
    for t in (1, 8, 64, 100, 1024, 4096, 100_000):
        assert MOE.expert_capacity(pc, t) == JMOE.expert_capacity(jc, t)
        c = MOE.expert_capacity(pc, t)
        assert (c % 128 == 0 or c == 8) and c >= t * pc.top_k / pc.n_experts


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b"])
def test_moe_block_and_aux_match_jax(arch):
    """The block's output and aux loss; arctic adds its dense residual."""
    jc, pc, jp, p, x = moe_setup(arch)
    jy, jaux = jax_moe_block(jc, jp, x)
    y, aux = MOE.moe_block(pc, p, torch.from_numpy(x))
    close_block(y, jy)
    close(aux, jaux)
    assert float(aux) >= 0.99      # ~1 at balance, E * sum(me * ce)


def test_moe_gates_normalize_and_ties_go_to_the_lowest_expert():
    """Top-k gates sum to 1 per token; on exact ties (an all-zero router:
    every expert at 1/E) the lowest ids win, as ``lax.top_k``."""
    jc, pc, jp, p, x = moe_setup(B=1, S=8)
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, pc.d_model)
                          @ p["router"], -1)
    gv, gi = MOE.top_k_lowest(probs, pc.top_k)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), pc.top_k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    gv = gv / gv.sum(-1, keepdim=True)
    np.testing.assert_allclose(gv.sum(-1).numpy(), 1.0, atol=1e-6)
    tied = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                         [0.5, 0.1, 0.5, 0.1]])
    _, ti = MOE.top_k_lowest(tied, 2)
    _, tj = jax.lax.top_k(jnp.asarray(tied.numpy()), 2)
    assert ti.tolist() == np.asarray(tj).tolist() == [[0, 1], [1, 2], [0, 2]]
    jp["router"] = jnp.zeros_like(jp["router"])
    p["router"] = torch.zeros_like(p["router"])
    jy, jaux = jax_moe_block(jc, jp, x)
    y, aux = MOE.moe_block(pc, p, torch.from_numpy(x))
    close_block(y, jy)
    close(aux, jaux)


def test_moe_forced_capacity_drop_matches_jax():
    """Every token routed to expert 0 (top-1 of 4): 512 tokens against a
    capacity of 256, so the last 256 tokens are dropped (their output is
    exactly 0), as in the reference."""
    jc, pc, jp, p, x = moe_setup(B=1, S=512, top_k=1)
    assert MOE.expert_capacity(pc, 512) == 256
    jp["router"] = jnp.zeros_like(jp["router"]).at[:, 0].set(10.0)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 0] = 10.0
    x = np.abs(x)       # positive inputs: the router's column 0 wins
    jy, jaux = jax_moe_block(jc, jp, x)
    y, aux = MOE.moe_block(pc, p, torch.from_numpy(x))
    close_block(y, jy)
    close(aux, jaux)
    kept = y[0].abs().sum(-1) > 0
    assert kept[:256].all() and not kept[256:].any()
    assert float(aux) > 3.9        # E * 1 * ~1 under total imbalance


# ---------------------------------------------------------------------------
# rwkv and mamba blocks, with and without state
# ---------------------------------------------------------------------------


def _state_pair(shapes, seed):
    rng = np.random.default_rng(seed)
    st = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
          for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_blocks_match_jax(with_state):
    jc, pc = family_cfgs("rwkv6-1.6b")
    key = jax.random.PRNGKey(4)
    jt = JRWKV.rwkv_time_params(key, jc)
    jch = JRWKV.rwkv_channel_params(jax.random.PRNGKey(5), jc)
    t, ch = (lm_params_from_jax(np_tree(a), "cpu") for a in (jt, jch))
    L = 1 if with_state else 12
    x = np.random.default_rng(6).standard_normal(
        (2, L, pc.d_model)).astype(np.float32)
    hs, nh = pc.rwkv_head_size, pc.d_model // pc.rwkv_head_size
    js, ps = (None, None)
    if with_state:
        shapes = {k: tuple(v.shape) for k, v in
                  RWKV.init_rwkv_state(pc, 2, nh).items()}
        assert shapes == {k: v.shape for k, v in
                          JRWKV.init_rwkv_state(jc, 2, nh).items()}
        assert shapes == {"S": (2, nh, hs, hs), "x_att": (2, pc.d_model),
                          "x_ffn": (2, pc.d_model)}
        js, ps = _state_pair(shapes, 7)
    jy, jS, jlast = jax.jit(lambda *a: JRWKV.rwkv_time_mix(
        jc, *a[:2], JUNSHARDED, a[2]))(jt, jnp.asarray(x), js)
    y, S, last = RWKV.rwkv_time_mix(pc, t, torch.from_numpy(x), state=ps)
    close_block(y, jy)
    close_block(S, jS)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    jy, jlast = jax.jit(lambda *a: JRWKV.rwkv_channel_mix(
        jc, *a[:2], JUNSHARDED, a[2]))(jch, jnp.asarray(x), js)
    y, last = RWKV.rwkv_channel_mix(pc, ch, torch.from_numpy(x), state=ps)
    close_block(y, jy)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_jax(with_state):
    jc, pc = family_cfgs("zamba2-2.7b")
    jp = JSSM.mamba_params(jax.random.PRNGKey(8), jc)
    p = lm_params_from_jax(np_tree(jp), "cpu")
    L = 1 if with_state else 12
    x = np.random.default_rng(9).standard_normal(
        (2, L, pc.d_model)).astype(np.float32)
    js, ps = (None, None)
    if with_state:
        shapes = {k: tuple(v.shape) for k, v in
                  SSM.init_ssm_state(pc, 2, pc.d_inner).items()}
        assert shapes == {k: v.shape for k, v in
                          JSSM.init_ssm_state(jc, 2, jc.d_inner).items()}
        js, ps = _state_pair(shapes, 10)
    jy, jst = jax.jit(lambda *a: JSSM.mamba_block(
        jc, *a[:2], JUNSHARDED, a[2]))(jp, jnp.asarray(x), js)
    y, st = SSM.mamba_block(pc, p, torch.from_numpy(x), state=ps)
    close_block(y, jy)
    if with_state:
        close_block(st["h"], jst["h"])
        close_block(st["conv"], jst["conv"])
    else:
        assert st is None and jst is None


def test_causal_conv_adds_its_taps_in_order():
    """The conv's taps add from tap 0 up, as the reference's ``sum``: bit
    for bit against the same sum in numpy, and against JAX."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for t in (None, tail):
        out, new_tail = SSM._causal_depthwise_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if t is None else torch.from_numpy(t))
        jo, jt = JSSM._causal_depthwise_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if t is None else jnp.asarray(t))
        xp = np.concatenate([np.zeros((2, 3, 6), np.float32) if t is None
                             else t, x], 1)
        want = xp[:, 0:9] * w[0]
        for i in range(1, 4):
            want = want + xp[:, i:i + 9] * w[i]
        np.testing.assert_array_equal(out.numpy(), want + b)
        np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_array_equal(new_tail.numpy(), np.asarray(jt))


# ---------------------------------------------------------------------------
# the loader, the training launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_loader_batches_equal_the_reference(n_hosts):
    for host in range(n_hosts):
        for seed in (0, 7):
            kw = dict(global_batch=8, seq_len=16, vocab_size=100,
                      n_hosts=n_hosts, host_id=host, seed=seed)
            a = LOADER.TokenStream(LOADER.LoaderConfig(**kw))
            b = JLOADER.TokenStream(JLOADER.LoaderConfig(**kw))
            for step in (0, 3, 11):
                for x, y in zip(a.batch_at(step), b.batch_at(step)):
                    assert x.shape == (8 // n_hosts, 16)
                    np.testing.assert_array_equal(x, y)
    cfg = LOADER.LoaderConfig(global_batch=8, seq_len=16, vocab_size=100,
                              n_hosts=2, host_id=0, seed=7)
    one = LOADER.TokenStream(cfg).batch_at(3)[0]
    other = LOADER.TokenStream(dataclasses.replace(cfg, host_id=1))
    assert not np.array_equal(one, other.batch_at(3)[0])
    with pytest.raises(ValueError):
        LOADER.TokenStream(dataclasses.replace(cfg, global_batch=7))


def test_prefetch_loader_yields_the_stream_in_order_and_closes():
    stream = LOADER.TokenStream(LOADER.LoaderConfig(
        global_batch=4, seq_len=8, vocab_size=50, seed=3))
    pl = LOADER.PrefetchLoader(stream, prefetch=2)
    got = [next(pl) for _ in range(5)]
    pl.close()
    for i, (toks, labels) in enumerate(got):
        want = stream.batch_at(i)
        np.testing.assert_array_equal(toks, want[0])
        np.testing.assert_array_equal(labels, want[1])
    finite = LOADER.PrefetchLoader(iter([1, 2, 3]), prefetch=2)
    assert list(finite) == [1, 2, 3]
    finite._thread.join(timeout=10)
    assert not finite._thread.is_alive()


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "rwkv6-1.6b",
                                  "zamba2-2.7b"])
def test_train_launcher_runs_every_family(arch, capsys):
    losses = LAUNCH.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                          "--batch", "2", "--seq", "8", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "step     1" in capsys.readouterr().out
