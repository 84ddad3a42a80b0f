"""Weight carry between the JAX package and the port (repro_torch.core.convert)
and the port's adaptive head (repro_torch.core.edge_model) against
repro.core.edge_model on the same stacked weights and numpy inputs.

Tolerances: the carry is bit-exact; the frozen forward agrees to atol 1e-6
(the same fp32 ops; matmul sums in another order); masked-BN statistics,
features and logits to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_model as JEM
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import theta_from_jax, theta_numpy, theta_to_jax

CFG = JEM.EdgeModelConfig()


def _jax_heads(C, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    thetas = [JEM.init_adaptive_layers(k, CFG) for k in keys]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *thetas)


def _perturbed_heads(C, seed=0):
    """Stacked JAX heads with non-trivial biases and BN affine, so every
    leaf of the carry matters in the forward."""
    theta = _jax_heads(C, seed)
    rng = np.random.default_rng(seed)
    for group, leaf in (("l1", "b"), ("l2", "b"), ("bn", "scale"),
                        ("bn", "bias")):
        a = theta[group][leaf]
        theta[group][leaf] = (a + 0.1 * rng.standard_normal(a.shape)
                              ).astype(np.float32)
    return theta


def test_weight_carry_round_trip_bit_equal():
    theta_np = _perturbed_heads(3)
    theta = theta_from_jax(theta_np, "cpu")
    assert sorted(theta) == ["bn.bias", "bn.scale", "head.w", "l1.b", "l1.w",
                             "l2.b", "l2.w"]
    back = theta_to_jax(theta)
    flat_in, tree_in = jax.tree_util.tree_flatten(theta_np)
    flat_out, tree_out = jax.tree_util.tree_flatten(back)
    assert tree_in == tree_out
    for a, b in zip(flat_in, flat_out):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_frozen_forward_matches_jax():
    C, N = 3, 17
    theta_np = _perturbed_heads(C, seed=1)
    rng = np.random.default_rng(1)
    protos = rng.standard_normal((C, N, CFG.proto_dim)).astype(np.float32)
    mu = rng.standard_normal((C, CFG.feat_dim)).astype(np.float32)
    sd = (0.5 + rng.random((C, CFG.feat_dim))).astype(np.float32)
    want = jax.vmap(JEM.adaptive_forward_frozen)(theta_np, protos, mu, sd)
    got = EM.adaptive_forward_frozen(theta_from_jax(theta_np, "cpu"),
                                     *map(torch.from_numpy, (protos, mu, sd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_masked_forward_and_bn_stats_match_jax():
    C, N = 3, 21
    theta_np = _perturbed_heads(C, seed=2)
    rng = np.random.default_rng(2)
    protos = rng.standard_normal((C, N, CFG.proto_dim)).astype(np.float32)
    mask = np.ones((C, N), np.float32)
    mask[0, 15:] = 0.0
    mask[2, 3:] = 0.0
    theta = theta_from_jax(theta_np, "cpu")
    tp, tm = torch.from_numpy(protos), torch.from_numpy(mask)
    fn_j, logits_j = jax.vmap(JEM.adaptive_forward_masked)(theta_np, protos,
                                                            mask)
    fn_t, logits_t = EM.adaptive_forward_masked(theta, tp, tm)
    np.testing.assert_allclose(fn_t.numpy(), np.asarray(fn_j), atol=1e-5)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    f_j = jax.vmap(JEM.adaptive_pre_bn)(theta_np, protos)
    mu_j, sd_j = jax.vmap(JEM.adaptive_bn_stats)(f_j, jnp.asarray(mask))
    mu_t, sd_t = EM.adaptive_bn_stats(EM.adaptive_pre_bn(theta, tp), tm)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-5)
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), atol=1e-5)


def test_init_adaptive_layers_matches_reference_layout():
    """Same keys, shapes, dtypes and constant leaves as the JAX init; the
    random leaves have the reference's scale (different numbers)."""
    gen = torch.Generator().manual_seed(0)
    heads = [EM.init_adaptive_layers(CFG, gen) for _ in range(2)]
    theta = EM.stack_heads(heads, "cpu")
    ref = theta_numpy(theta_from_jax(_jax_heads(2), "cpu"))
    for k, v in theta_numpy(theta).items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
    assert not torch.equal(heads[0]["l1.w"], heads[1]["l1.w"])
    assert torch.all(theta["bn.scale"] == 1) and torch.all(theta["l1.b"] == 0)
    assert theta["l1.w"].std().item() == pytest.approx(
        1 / np.sqrt(CFG.proto_dim), rel=0.05)
