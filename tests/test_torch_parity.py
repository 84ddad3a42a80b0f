"""Small entry points of the port against the JAX package, on numpy inputs
made from a seed: the tying penalty (``core/tying.py``, at the
reference's default ``lam_l2 = 0``: no caller sets its L2 term, and the
port keeps none), ``evalreid.evaluate_retrieval_batched`` against both of
the reference's backends with the package's re-exports, and ``launch/serve_lm.serve``'s
default device (the params').

Tolerances: the tying penalty and its gradient within 1e-6 relative (the
same sums, per client); the retrieval metrics within 1e-6 (the device
path's counts are exact integers, its AP sums fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.evalreid as JE
import repro_torch.evalreid as PE
from repro.core.tying import tying_loss as j_tying_loss
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.core.tying import tying_loss
from repro_torch.launch import serve_lm as SERVE
from repro_torch.models import lm

# ---------------------------------------------------------------------------
# the tying penalty
# ---------------------------------------------------------------------------


def _heads(rng, C):
    """Stacked heads (leaves (C, ...)) and their previous values, a third
    of the entries unchanged (the penalty's |d| at d = 0)."""
    shapes = {"l1.w": (6, 4), "l1.b": (4,), "l2.w": (4, 3)}
    prev = {k: rng.standard_normal((C,) + s).astype(np.float32)
            for k, s in shapes.items()}
    theta = {}
    for k, v in prev.items():
        d = rng.standard_normal(v.shape).astype(np.float32)
        d[rng.random(v.shape) < 1 / 3] = 0.0
        theta[k] = v + d
    return theta, prev


def _client(tree, c):
    return {k: jnp.asarray(v[c]) for k, v in tree.items()}


@pytest.mark.parametrize("lam_l1", (1e-4, 1e-2, 0.5))
def test_tying_loss_matches_jax(lam_l1):
    """Each client's penalty and its gradient in theta against the
    reference's ``tying_loss(theta_c, prev_c, lam_l1)`` (a tree of one
    client, its ``lam_l2`` at the default 0.0)."""
    rng = np.random.default_rng(int(lam_l1 * 1e4) + 3)
    C = 3
    theta, prev = _heads(rng, C)
    th = {k: torch.from_numpy(v).requires_grad_() for k, v in theta.items()}
    pv = {k: torch.from_numpy(v) for k, v in prev.items()}
    got = tying_loss(th, pv, lam_l1=lam_l1)
    assert got.shape == (C,)
    got.sum().backward()
    for c in range(C):
        want, grad = jax.value_and_grad(j_tying_loss)(
            _client(theta, c), _client(prev, c), lam_l1)
        np.testing.assert_allclose(float(got[c].detach()), float(want),
                                   rtol=1e-6)
        for k in theta:
            np.testing.assert_allclose(th[k].grad[c].numpy(),
                                       np.asarray(grad[k]), rtol=1e-6,
                                       atol=1e-9)


# ---------------------------------------------------------------------------
# evaluate_retrieval_batched
# ---------------------------------------------------------------------------


def _problem(rng, C=3, T=2, Q=6, G=40, F=8, n_ids=12):
    qf = rng.standard_normal((C, T, Q, F)).astype(np.float32)
    gf = rng.standard_normal((C, G, F)).astype(np.float32)
    qids = rng.integers(0, n_ids, (C, T, Q)).astype(np.int32)
    gids = rng.integers(0, n_ids, (C, G)).astype(np.int32)
    gf[:, 5] = gf[:, 3]                       # an exact distance tie
    gids[:, 5] = gids[:, 3]
    qmask = (rng.random((C, T, Q)) < 0.7).astype(np.float32)
    gmask = (rng.random((C, G)) < 0.8).astype(np.float32)
    qmask[1, 1] = 0.0                         # a fully padded query set
    gmask[2] = 0.0                            # a fully padded gallery
    return qf, qids, gf, gids, qmask, gmask


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("max_matches", (None, 64))
@pytest.mark.parametrize("backend", ("device", "host"))
def test_evaluate_retrieval_batched_matches_jax(backend, max_matches, masked):
    """The port's ``evaluate_retrieval_batched`` (on the CPU: the plain
    distances) against the reference's on ``backend`` (its device path or
    its numpy host oracle), within 1e-6; numpy in, numpy (C, T) fp32
    out."""
    rng = np.random.default_rng(11 + masked)
    qf, qids, gf, gids, qmask, gmask = _problem(rng)
    kw = dict(qmask=qmask, gmask=gmask) if masked else {}
    got = PE.evaluate_retrieval_batched(qf, qids, gf, gids, device="cpu",
                                        max_matches=max_matches, **kw)
    want = JE.evaluate_retrieval_batched(qf, qids, gf, gids, backend=backend,
                                         max_matches=max_matches, **kw)
    assert sorted(got) == sorted(want) == ["R1", "R3", "R5", "mAP"]
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (3, 2)
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6,
                                   err_msg=k)
    if masked:
        assert got["mAP"][1, 1] == 0.0 and not got["mAP"][2].any()


def test_evaluate_retrieval_batched_other_ranks():
    """Other ranks give their own keys, as on both of the reference's
    backends."""
    rng = np.random.default_rng(5)
    qf, qids, gf, gids, _, _ = _problem(rng)
    got = PE.evaluate_retrieval_batched(qf, qids, gf, gids, ranks=(2,),
                                        device="cpu")
    assert sorted(got) == ["R2", "mAP"]
    for backend in ("device", "host"):
        want = JE.evaluate_retrieval_batched(qf, qids, gf, gids, ranks=(2,),
                                             backend=backend)
        for k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=1e-6)


def test_evalreid_exports_the_references_names():
    names = {n for n in dir(JE) if not n.startswith("_")
             and callable(getattr(JE, n))}
    assert names == {"batched_retrieval_metrics", "distance_matrix",
                     "evaluate_retrieval", "evaluate_retrieval_batched",
                     "l2_normalize"}
    assert names <= set(dir(PE))
    assert all(getattr(PE, n).__module__.startswith("repro_torch.")
               for n in names)


# ---------------------------------------------------------------------------
# serve_lm.serve's device
# ---------------------------------------------------------------------------


def test_serve_puts_its_cache_on_the_params_device(monkeypatch):
    """``serve(..., device=None)`` builds its cache and prompt on the
    params' device (here the CPU, named explicitly to ``init_cache``), not
    on a default of its own; an explicit device is passed through."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    asked = []
    real = lm.init_cache

    def init_cache(*a, device=None, **kw):
        asked.append(device)
        return real(*a, device=device, **kw)

    monkeypatch.setattr(SERVE.lm, "init_cache", init_cache)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 3))
    got, cache = SERVE.serve(cfg, params, prompt, 4)
    assert got.shape == (2, 4)
    dev = tree_leaves(params)[0].device
    assert asked == [dev] and dev == torch.device("cpu")
    assert all(t.device == dev for t in tree_leaves(cache))
    got2, _ = SERVE.serve(cfg, params, prompt, 4, device=torch.device("cpu"))
    assert asked[-1] == torch.device("cpu")
    np.testing.assert_array_equal(got2, got)
