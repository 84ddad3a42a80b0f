"""LM decode serving in the port against the JAX package on the same
inputs: ``decode_step`` for every family (the 7 registered archs, reduced,
plus the vlm and encdec variants of ``test_torch_lm_families.py``) from
the reference's carried weights, the decode-equals-forward gate, the int8
KV cache (codes and bf16 scales), the sliding window and the ring buffer,
a slot past the cache dropped, the cache trees and their carry,
``launch/serve_lm.py``'s loop against a JAX replay of the reference's, the
launcher and ``examples/serve_decode_torch.py`` on the CPU.

Tolerances: decode tokens equal; fp32 caches and states within 1e-5 of
each leaf's largest magnitude (and relative: sums in another order); the
int8 cache's scales bit for bit and its codes within 1 (a new token's k
or v in fp32 differs from the reference's by the order of the
projection's sum, which moves a code only when k / scale sits at a .5
boundary; the share of such codes is asserted below 1e-3).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.common.pytree import leaf_paths, tree_leaves
from repro_torch.core.convert import lm_params_from_jax
from repro_torch.launch import serve_lm as SERVE
from repro_torch.models import layers as PL
from repro_torch.models import lm
from test_torch_lm_families import (ARCHS, both, family_cfgs,
                                    jax_params, np_tree, numpy_batch, setup)

ROOT = Path(__file__).resolve().parent.parent
DECODE_STEPS = 8
INT8_CODE_SHARE = 1e-3


def jax_paths(tree):
    return [tuple(str(getattr(k, "key", k)) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def close_trees(got, want, tol=1e-5):
    """Leaf by leaf: int8 codes within 1 (returns the share that differ),
    bf16 scales bit for bit, float leaves within ``tol`` of the leaf's
    largest magnitude."""
    assert leaf_paths(got) == jax_paths(want)
    differ, n = 0, 0
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        if b.dtype == torch.int8:
            d = np.abs(b.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1
            differ, n = differ + int((d > 0).sum()), n + d.size
        elif b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            scale = max(float(np.abs(a).max()), 1.0)
            np.testing.assert_allclose(b.numpy(), a, atol=tol * scale,
                                       rtol=tol)
    return differ / max(n, 1)


def decode_pair(arch, *, steps=DECODE_STEPS, slots=None, window=0,
                ring=False, dtype="float32", jit=True, B=2, seed=5):
    """``steps`` decode steps of the same tokens through JAX's and the
    port's ``decode_step`` from the same weights -> (JAX tokens, port
    tokens, JAX cache, port cache)."""
    jc, pc, jparams = jax_params(arch)
    params = lm_params_from_jax(np_tree(jparams), "cpu")
    nb = numpy_batch(pc, B, steps, seed)
    jb, tb = both(nb)
    slots = slots or steps + 1
    jcache = JLM.init_cache(jc, B, slots, enc_seq_local=jc.enc_seq or 0,
                            dtype=getattr(jnp, dtype))
    cache = lm.init_cache(pc, B, slots, enc_seq=pc.enc_seq,
                          dtype=getattr(torch, dtype))
    enc_len = None
    if pc.family == "encdec":
        jcache, _ = JLM.prefill_cross_cache(jc, jparams, jb["frames"], jcache)
        cache, _ = lm.prefill_cross_cache(pc, params, tb["frames"], cache)
        enc_len = pc.enc_seq
    kw = dict(window=window, ring=ring, enc_len=enc_len)
    step = (lambda p, c, t, pos: JLM.decode_step(jc, p, c, t, pos, **kw))
    step = jax.jit(step) if jit else step
    jt, pt = [], []
    for t in range(steps):
        n, jcache = step(jparams, jcache, jb["tokens"][:, t:t + 1],
                         jnp.int32(t))
        jt.append(np.asarray(n))
        n, cache = lm.decode_step(pc, params, cache, tb["tokens"][:, t:t + 1],
                                  t, **kw)
        assert n.dtype == torch.int32 and n.shape == (B, 1)
        pt.append(n.numpy())
    return np.concatenate(jt, 1), np.concatenate(pt, 1), jcache, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    jt, pt, jcache, cache = decode_pair(arch)
    np.testing.assert_array_equal(pt, jt)
    close_trees(cache, jcache)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "vlm"])
def test_decode_matches_forward(arch):
    """Greedy next token from the cache path == the teacher-forced
    forward's argmax (the reference's gate, >= 0.95). vlm is held against
    JAX's decode_step alone (its forward prepends vision tokens that its
    decode does not see), as the reference's test skips it."""
    _, pc, _, params, _, tb = setup(arch, S=DECODE_STEPS, seed=6)
    x, _ = lm.forward(pc, params, tb)
    want, _ = PL.lm_head_logits(pc, params["head"], x)
    cache = lm.init_cache(pc, 2, DECODE_STEPS + 1, enc_seq=pc.enc_seq,
                          dtype=torch.float32)
    enc_len = None
    if pc.family == "encdec":
        cache, _ = lm.prefill_cross_cache(pc, params, tb["frames"], cache)
        enc_len = pc.enc_seq
    got = []
    for t in range(DECODE_STEPS):
        n, cache = lm.decode_step(pc, params, cache,
                                  tb["tokens"][:, t:t + 1], t,
                                  enc_len=enc_len)
        got.append(n)
    match = float((torch.cat(got, 1) == want).float().mean())
    assert match >= 0.95, f"decode/forward agreement {match}"


def test_int8_quantizer_matches_jax_eager_and_jitted():
    """The int8 cache's quantizer: bit for bit the reference's eager
    ``_quantize_kv`` (max(|x|, 1e-6) / 127 in fp32, codes rounded half to
    even with it, the scale stored in bf16). Under ``jit`` XLA turns the
    division into a product with fl32(1/127), which moves 3056 of these
    65536 fp32 scales by an ulp: their bf16 scales stay equal, and 1 code
    of 4194304 moves by 1 (a .5 boundary)."""
    x = (np.random.default_rng(12).standard_normal((4096, 1, 16, 64))
         * 3).astype(np.float32)
    q, s = PL._quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    qe, se = (np.asarray(a) for a in JL._quantize_kv(jnp.asarray(x)))
    qj, sj = (np.asarray(a) for a in jax.jit(JL._quantize_kv)(jnp.asarray(x)))
    np.testing.assert_array_equal(q.numpy(), qe)
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  se.view(np.int16))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  sj.view(np.int16))
    d = np.abs(q.numpy().astype(np.int32) - qj)
    assert d.max() <= 1 and int((d > 0).sum()) == 1
    # the moved code sits at a .5 boundary of x / scale
    amax = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-6))
    r = x / (amax / np.float32(127.0))
    frac = np.abs(np.abs(r) - np.floor(np.abs(r)) - 0.5)
    assert float(frac[d > 0].max()) < 1e-4
    np.testing.assert_array_equal(PL._dequantize_kv(q, s).numpy(),
                                  np.asarray(JL._dequantize_kv(qe, se)))


@pytest.mark.parametrize("jit", [False, True])
def test_int8_cache_decode_matches_jax(jit):
    """Eight decode steps on the int8 cache against the reference's eager
    and jitted decode: tokens equal, scales bit for bit, codes within 1
    (the share that differs below 1e-3)."""
    jt, pt, jcache, cache = decode_pair("qwen1.5-0.5b", dtype="int8",
                                        jit=jit)
    np.testing.assert_array_equal(pt, jt)
    assert cache["trunk"]["k"].dtype == torch.int8
    assert close_trees(cache, jcache) < INT8_CODE_SHARE
    assert cache["trunk"]["k"][:, :, :DECODE_STEPS].abs().sum() > 0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b"])
@pytest.mark.parametrize("mode", ["window", "ring", "past_the_cache"])
def test_window_ring_and_dropped_slots_match_jax(arch, mode):
    """12 steps with window 4: a sliding window over a 13-slot cache, or a
    ring of 4 slots (slot pos % 4, every slot valid once it has wrapped);
    and 12 steps on a 6-slot cache without a ring, whose last 6 tokens'
    k and v fall outside it and are dropped."""
    kw = {"window": dict(slots=13, window=4),
          "ring": dict(slots=4, window=4, ring=True),
          "past_the_cache": dict(slots=6)}[mode]
    jt, pt, jcache, cache = decode_pair(arch, steps=12, **kw)
    np.testing.assert_array_equal(pt, jt)
    close_trees(cache, jcache)
    kv = cache["trunk" if arch == "qwen1.5-0.5b" else "attn"]["k"]
    assert kv.shape[2] == kw["slots"] and kv.abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_init_cache_matches_jax(arch, dtype):
    """The cache tree of every family: paths, shapes, dtypes (int8 codes
    with bf16 scales where the reference keeps them: dense, moe, vlm),
    all zeros."""
    jc, pc = family_cfgs(arch)
    cache = lm.init_cache(pc, 2, 5, enc_seq=pc.enc_seq,
                          dtype=getattr(torch, dtype))
    want = jax.eval_shape(lambda: JLM.init_cache(
        jc, 2, 5, enc_seq_local=jc.enc_seq or 0, dtype=getattr(jnp, dtype)))
    assert leaf_paths(cache) == jax_paths(want)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(cache)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.float().abs().sum()


def test_int8_decode_cache_carries_bit_for_bit():
    """A JAX int8 cache after one decode step crosses into the port's tree
    bit for bit (``lm_params_from_jax``: int8 codes, bf16 scales)."""
    jc, pc, jparams = jax_params("qwen3-1.7b")
    jcache = JLM.init_cache(jc, 2, 5, dtype=jnp.int8)
    _, jcache = jax.jit(lambda p, c: JLM.decode_step(
        jc, p, c, jnp.ones((2, 1), jnp.int32), jnp.int32(0)))(jparams, jcache)
    carried = lm_params_from_jax(np_tree(jcache), "cpu")
    assert leaf_paths(carried) == jax_paths(jcache)
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(carried)):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        if a.dtype.name == "bfloat16":
            a, b = a.view(np.int16), b.view(torch.int16)
        np.testing.assert_array_equal(b.numpy(), a)
    assert carried["trunk"]["k"][:, :, 0].abs().sum() > 0


# ---------------------------------------------------------------------------
# the launcher's loop, the launcher, the example
# ---------------------------------------------------------------------------


def jax_serve(jc, jparams, prompt, gen, window):
    """The reference launcher's loop (``repro/launch/serve_lm.py:main``)
    without its donation: the prompt fed token by token, then greedy."""
    P = prompt.shape[1]
    total = P + gen
    cache = JLM.init_cache(jc, prompt.shape[0], window or total,
                           enc_seq_local=jc.enc_seq or 0, dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, pos: JLM.decode_step(
        jc, p, c, t, pos, window=window, ring=bool(window),
        enc_len=jc.enc_seq or None))
    tok, out = jnp.asarray(prompt[:, :1], jnp.int32), []
    for pos in range(total - 1):
        if pos < P - 1:
            _, cache = step(jparams, cache, jnp.asarray(
                prompt[:, pos:pos + 1], jnp.int32), jnp.int32(pos))
        else:
            tok, cache = step(jparams, cache, tok, jnp.int32(pos))
            out.append(np.asarray(tok))
    return np.concatenate(out, 1)


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", 0),
                                         ("qwen1.5-0.5b", 16),
                                         ("rwkv6-1.6b", 0),
                                         ("zamba2-2.7b", 0)])
def test_serve_loop_matches_a_jax_replay(arch, window):
    """``serve_lm.serve`` (the launcher's loop) against the reference
    launcher's loop from the same weights and prompt: the generated tokens
    equal (the example's four runs: batch 2, prompt 8, 24 generated)."""
    jc, pc, jparams = jax_params(arch)
    params = lm_params_from_jax(np_tree(jparams), "cpu")
    prompt = np.random.default_rng(0).integers(0, pc.vocab_size, (2, 8))
    got, cache = SERVE.serve(pc, params, prompt, 24, window=window)
    assert got.shape == (2, 24) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_serve(jc, jparams, prompt, 24,
                                                 window))
    if window:
        assert cache["trunk"]["k"].shape[2] == window


def test_serve_lm_launcher_runs_on_the_cpu(capsys):
    gen = SERVE.main(["--device", "cpu", "--arch", "qwen3-moe-235b-a22b",
                      "--batch", "2", "--prompt-len", "4", "--gen", "6"])
    assert gen.shape == (2, 6)
    out = capsys.readouterr().out
    assert "arch=qwen3-moe-235b-a22b-reduced batch=2 generated=6" in out
    assert "tok/s (cpu, reduced config)" in out and "sample:" in out


def test_serve_lm_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        SERVE.main(["--gen", "1"])


def test_serve_decode_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_decode_torch", ROOT / "examples" / "serve_decode_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    runs = mod.main(["--device", "cpu"])
    assert [g.shape for g in runs] == [(2, 24)] * 4
    out = capsys.readouterr().out
    assert out.count("$ python -m repro_torch.launch.serve_lm") == 4
    assert "window=16" in out and "arch=zamba2-2.7b-reduced" in out
