"""The port's LM scale-out for the other families against the JAX package:
moe (reduced qwen3-moe-235b-a22b), ssm (rwkv6-1.6b), hybrid (zamba2-2.7b),
vlm and encdec (the variants of ``test_torch_lm_families.py``), each on
(dp, tp) = (2, 2) through train (the split step), prefill and decode, and
moe again on (1, 4) (one expert a rank). The machinery, inputs and bars
are ``test_torch_tp.py``'s (``tp_harness.py``, ``tp_cases.py``).

The MoE's load-balance aux is each data rank's own on the reference's
sharded step, and the port's follows it (``tp_cases.vs_unsharded``: its
cross-entropy is the unsharded one). The hybrid's mamba projection w_zx
is [z | x]: the port deals each half by TP rank, and so do the JAX
package's sharded steps here (``tp_cases.dealt``), whose own spec splits
it by contiguous columns and so wires another model (pinned below,
ROADMAP Queue 3).
"""
import numpy as np
import pytest
import torch

import tp_cases as TC
import tp_harness as H
from repro_torch.sharding import specs as S
from test_torch_tp import check_train, unsharded_port_loss

CASES = TC.FAMILY_CASES
DECODE = [f"{n}-{kv}" for n, c in CASES.items() for kv in c["decode"]]
UNSHARDED_GRADS = [n for n, c in CASES.items()
                   if TC.vs_unsharded(c) == "all"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families")
    jax_out, port = H.run_all(list(CASES), out)
    return jax_out, port, out


@pytest.mark.parametrize("name", list(CASES))
def test_train_loss_matches_jax(results, name):
    rule = TC.vs_unsharded(CASES[name])
    check_train(results, name, vs_unsharded=rule == "all")
    if rule == "ce":
        _, ce = unsharded_port_loss(results[2], name)
        assert abs(float(results[1][name][0]["train/sgd/ce"]) - ce) \
            <= H.FWD_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_train_grads_match_jax_sharded_step(results, name):
    jax_out, port, _ = results
    H.close_leaves(H.under(port[name][0], "train/sgd/grad"),
                   H.under(jax_out[name], "train/sgd/grad"),
                   H.grad_tol(CASES[name]), name)


@pytest.mark.parametrize("name", UNSHARDED_GRADS)
def test_mesh_grads_match_jax_unsharded(results, name):
    jax_out, port, _ = results
    H.close_leaves(H.under(port[name][0], "train/mesh_grad"),
                   H.under(jax_out[name], "train/grad_unsharded"),
                   H.grad_tol(CASES[name]), name)


def test_hybrid_sharded_step_is_the_unsharded_model(results):
    """At TP 2 the port's sharded hybrid is the unsharded model (its loss
    here; its gradients, prefill and decode in the tests above), where the
    reference's own layout, w_zx split by contiguous columns (rank 0 all
    of z, rank 1 all of x), is another wiring of the same weights: the
    reference's fault, pinned."""
    jax_out, port, out = results
    loss, _ = unsharded_port_loss(out, "hybrid_2x2")
    assert abs(float(port["hybrid_2x2"][0]["train/sgd/loss"]) - loss) \
        <= H.FWD_TOL
    assert abs(float(jax_out["hybrid_2x2"]["train/contiguous/loss"])
               - loss) > 1e-3


class _Rank:
    """The coordinates of one rank of a (1, tp) mesh: what ``shard_tree``
    reads (no process group)."""
    device = torch.device("cpu")
    block = S.EngineMesh.block

    def __init__(self, r, tp):
        self.shape, self.coords = {"data": 1, "model": tp}, {"data": 0,
                                                             "model": r}


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_tree_deals_w_zx_by_parts(tp):
    """Rank r of TP receives [z_r | x_r] of mamba's w_zx (and of its
    optimizer moments, by path), which is the contiguous block r of the
    tests' ``tp_cases.dealt`` reordering; other leaves split as they
    are."""
    w = np.arange(3 * 2 * 4 * tp, dtype=np.float32).reshape(3, 8 * tp)
    tree = {"m": {"layers": {"mamba": {"w_zx": torch.from_numpy(w),
                                       "w_dt": torch.from_numpy(w)}}}}
    spec = {"m": {"layers": {"mamba": {"w_zx": (None, "model"),
                                       "w_dt": (None, "model")}}}}
    dealt = TC.dealt({"mamba": {"w_zx": w}}, tp)["mamba"]["w_zx"]
    di_loc = 4
    for r in range(tp):
        got = S.shard_tree(tree, spec, _Rank(r, tp))["m"]["layers"]["mamba"]
        z, x = w[:, :4 * tp], w[:, 4 * tp:]
        want = np.concatenate([z[:, r * di_loc:(r + 1) * di_loc],
                               x[:, r * di_loc:(r + 1) * di_loc]], 1)
        np.testing.assert_array_equal(got["w_zx"].numpy(), want)
        np.testing.assert_array_equal(
            got["w_zx"].numpy(), dealt[:, r * 2 * di_loc:(r + 1) * 2 * di_loc])
        np.testing.assert_array_equal(
            got["w_dt"].numpy(), w[:, r * 8:(r + 1) * 8])
    np.testing.assert_array_equal(
        TC.dealt({"mamba": {"w_zx": dealt}}, tp, inverse=True)["mamba"]
        ["w_zx"], w)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(results, name):
    jax_out, port, _ = results
    np.testing.assert_array_equal(port[name][0]["prefill/tokens"],
                                  jax_out[name]["prefill/tokens"])


@pytest.mark.parametrize("name_kv", DECODE)
def test_decode_matches_jax(results, name_kv):
    name, kv = name_kv.rsplit("-", 1)
    jax_out, port, _ = results
    j, p = jax_out[name], port[name][0]
    np.testing.assert_array_equal(p[f"decode/{kv}/tokens"],
                                  j[f"decode/{kv}/tokens"])
    H.close_cache(H.under(p, f"decode/{kv}/cache"),
                  H.under(j, f"decode/{kv}/cache"))


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_returns_the_same(results, name):
    ranks = [H.bits_of(r) for r in results[1][name]]
    assert len(ranks) == TC.world_size(CASES[name])
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
