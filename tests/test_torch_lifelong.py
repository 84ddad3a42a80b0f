"""The port's local-only Table II baselines (repro_torch: ``EWC``, ``MAS``,
``ICaRL``) against the JAX package (repro) on the same numpy inputs and
initial weights, on the CPU; and the port's three examples run small.

Tolerances: the host engine within 1e-4 in every eval round (the bar of
``tests/test_torch_host_engine.py``), bytes and storage equal; EWC's and
MAS's importances within 1e-6 of their largest entry; EWC's (C,)
penalties within 1e-6 relative and their gradients within 1e-6 of the
largest.

iCaRL runs on the bench drawn from ``TIE_FREE_SEED``, in which no identity
has two training samples: it orders an identity's samples by their
distance to the identity's mean feature, and for a two-sample identity the
two distances are equal in exact arithmetic, so rounding would decide the
order of the exemplar memory, and with it which rows the rehearsal draws
(ROADMAP Queue 3, as for FedSTIL's rehearsal).
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import edge_model as JEM
from repro.data import FederatedReIDBenchmark as JBench
from repro.federated import run_simulation as j_run
from repro.lifelong import EWC as JEWC
from repro.lifelong import MAS as JMAS
from repro.lifelong import ICaRL as JICaRL
from repro_torch.checkpoint import load_checkpoint
from repro_torch.common import pytree as PT
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import (init_params_from_jax, theta_from_jax,
                                      theta_to_jax)
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import run_simulation
from repro_torch.lifelong import EWC, MAS, ICaRL

ROOT = Path(__file__).resolve().parent.parent
BENCH_KW = dict(n_clients=3, n_tasks=3, n_identities=60, ids_per_task=10,
                samples_per_id=8)
TIE_FREE_SEED = 0          # no identity has two training samples
METRICS = ("mAP", "R1", "R5", "forgetting_mAP")


@functools.lru_cache(maxsize=None)
def _setup(seed=TIE_FREE_SEED):
    kw = dict(BENCH_KW, seed=seed)
    jb, pb = JBench(**kw), FederatedReIDBenchmark(**kw)
    cfg = JEM.EdgeModelConfig(n_classes=jb.n_classes)
    g_key, *keys = jax.random.split(jax.random.PRNGKey(0), jb.n_clients + 1)
    init = init_params_from_jax(JEM.init_extraction(g_key, cfg),
                                [JEM.init_adaptive_layers(k, cfg)
                                 for k in keys])
    return jb, pb, cfg, init


def _flat_np(tree):
    if any(isinstance(v, dict) for v in tree.values()):
        tree = theta_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v) for k, v in tree.items()}


def _close_trees(got, want, rel):
    """Leaf by leaf within ``rel`` of the tree's largest |value|."""
    got, want = _flat_np(got), _flat_np(want)
    assert set(got) == set(want)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=rel * scale, rtol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the host engine against the JAX host engine
# ---------------------------------------------------------------------------

STRATEGIES = {
    "ewc": (JEWC, EWC, {}, {}),
    "mas": (JMAS, MAS, {}, {}),
    "icarl": (JICaRL, ICaRL, {"extractor": JEM.extract_prototypes},
              {"extractor": EM.extract_prototypes}),
}


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_host_engine_matches_jax_host_engine(name):
    """run_simulation(engine="host") of both packages, C=3, T=3, epochs 2,
    rounds 4 (EWC and MAS consolidate at every task's end, rounds 0, 1 and
    3), eval every 2, from the same initial weights: every eval round
    within 1e-4, no bytes moved, storage equal (iCaRL's raw memory
    included)."""
    jb, pb, cfg, init = _setup()
    J, P, jkw, pkw = STRATEGIES[name]
    jr = j_run(J(cfg, epochs=2, **jkw), jb, rounds=4, eval_every=2)
    ps = P(cfg, epochs=2, **pkw)
    pr = run_simulation(ps, pb, rounds=4, eval_every=2, engine="host",
                        device="cpu", init_params=init)
    assert [r["round"] for r in pr.rounds] == [r["round"] for r in jr.rounds]
    for k in METRICS:
        worst = max(abs(a[k] - b[k]) for a, b in zip(jr.rounds, pr.rounds))
        assert worst < 1e-4, (k, worst)
    assert pr.comm.total == jr.comm.total == 0
    assert pr.storage_bytes == jr.storage_bytes
    head = sum(v.nbytes for v in init["theta0"][0].values())
    if name == "icarl":
        assert pr.storage_bytes > head     # the exemplar images count
    else:
        assert pr.storage_bytes == 3 * head


def test_icarl_memory_matches_jax():
    """iCaRL's exemplar memory after a task: the same images and labels in
    the same order as the reference's (nearest mean per identity, up to
    ``per_identity``), then trimmed to ``memory_size`` by the same draw
    from the strategy's generator."""
    jb, pb, cfg, init = _setup()
    kw = dict(epochs=1, memory_size=40, per_identity=3)
    states = {}

    class Keep(ICaRL):
        def local_train(self, client, state, protos, labels, rnd,
                        raw_images=None, g_params=None, **k):
            state, up = super().local_train(
                client, state, protos, labels, rnd, raw_images=raw_images,
                g_params=g_params, **k)
            states[client] = state
            return state, up
    ps = Keep(cfg, extractor=EM.extract_prototypes, **kw)
    run_simulation(ps, pb, rounds=2, eval_every=2, engine="host",
                   device="cpu", init_params=init)
    jstates = {}

    class JKeep(JICaRL):
        def local_train(self, client, state, protos, labels, rnd,
                        raw_images=None, g_params=None, **k):
            state, up = super().local_train(
                client, state, protos, labels, rnd, raw_images=raw_images,
                g_params=g_params, **k)
            jstates[client] = state
            return state, up
    j_run(JKeep(cfg, extractor=JEM.extract_prototypes, **kw), jb, rounds=2,
          eval_every=2)
    for c in range(3):
        assert len(states[c].extras["mem_x"]) == 40     # 30 + 30, trimmed
        np.testing.assert_array_equal(states[c].extras["mem_x"],
                                      jstates[c].extras["mem_x"])
        np.testing.assert_array_equal(states[c].extras["mem_y"],
                                      jstates[c].extras["mem_y"])


# ---------------------------------------------------------------------------
# unit parity: the importances and EWC's penalty
# ---------------------------------------------------------------------------


def _protos(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((n, cfg.proto_dim))).astype(
        np.float32), rng.integers(0, cfg.n_classes, n).astype(np.int32))


@pytest.mark.parametrize("name,n", [("ewc", 64), ("ewc", 21), ("mas", 64),
                                    ("mas", 40)])
def test_importance_matches_jax(name, n):
    """EWC's Fisher and MAS's output-norm sensitivity, chunks of 8 of n
    prototypes (a ragged tail dropped), against the reference's
    ``_importance``: within 1e-6 of the largest entry."""
    _, _, cfg, init = _setup()
    head = init["theta0"][2]
    protos, labels = _protos(cfg, n)
    J, P = {"ewc": (JEWC, EWC), "mas": (JMAS, MAS)}[name]
    want = jax.jit(J(cfg)._importance)(
        theta_to_jax(head), jnp.asarray(protos), jnp.asarray(labels))
    got = P(cfg)._importance({k: torch.from_numpy(v) for k, v in head.items()},
                             protos, labels)
    _close_trees(got, want, 1e-6)


def test_ewc_penalties_and_gradients_match_jax():
    """The port's (C,) penalties 0.5 lam sum F (t - a)^2 of a stack of three
    clients against the reference's scalar of each client, and the
    gradients of their sum against ``jax.grad`` of each."""
    _, _, cfg, init = _setup()
    rng = np.random.default_rng(4)
    shapes = {k: v.shape for k, v in init["theta0"][0].items()}
    draw = lambda f=lambda x: x: [{k: f(rng.standard_normal(s)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(3)]
    th, anchor, fisher = draw(), draw(), draw(np.abs)
    stack = lambda ts: PT.tree_stack([PT.tree_map(torch.from_numpy, t)
                                      for t in ts])
    tr = PT.tree_map(lambda t: t.requires_grad_(True), stack(th))
    P, J = EWC(cfg, lam=0.7), JEWC(cfg, lam=0.7)
    pen = P.regularizer(tr, {"reg_fisher": stack(fisher),
                             "reg_anchor": stack(anchor)})
    assert pen.shape == (3,)
    pen.sum().backward()
    for c in range(3):
        ex = {"reg_fisher": theta_to_jax(fisher[c]),
              "reg_anchor": theta_to_jax(anchor[c])}
        want = float(J.regularizer(theta_to_jax(th[c]), ex))
        assert abs(float(pen[c].detach()) - want) <= 1e-6 * abs(want)
        _close_trees(PT.tree_map(lambda t: t.grad[c], tr),
                     jax.grad(J.regularizer)(theta_to_jax(th[c]), ex), 1e-6)


# ---------------------------------------------------------------------------
# the examples, small, on the CPU
# ---------------------------------------------------------------------------


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_runs_on_the_cpu(capsys):
    res, strategy = _example("quickstart_torch").main(
        ["--device", "cpu", "--rounds", "2"])
    assert res.rounds and all(np.isfinite(r["mAP"]) for r in res.rounds)
    assert strategy.last_W.shape == (5, 5)
    assert "knowledge relevance W" in capsys.readouterr().out


def test_method_comparison_example_runs_on_the_cpu(capsys):
    results = _example("federated_lifelong_reid_torch").main(
        ["--device", "cpu", "--rounds", "2"])
    assert set(results) == {"stl", "ewc", "fedavg", "fedstil"}
    for res in results.values():
        assert np.isfinite(res.final("mAP")) and res.storage_bytes > 0
    assert results["stl"].comm.total == results["ewc"].comm.total == 0
    assert results["fedavg"].comm.total > 0
    assert "fedstil" in capsys.readouterr().out


def test_train_e2e_example_runs_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "e2e.npz")
    losses, trainable = _example("train_e2e_torch").main(
        ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt", ckpt])
    assert len(losses) == 2 and all(np.isfinite(losses))
    tree, meta = load_checkpoint(ckpt)
    assert meta["steps"] == 2 and meta["final_loss"] == losses[-1]
    got = PT.tree_leaves(tree["trainable"])
    want = PT.tree_leaves(trainable)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.detach().numpy())
