"""The port's sharded engine (``run_simulation(engine="sharded")`` over
``torch.distributed``, gloo on the CPU) and its collectives against the
JAX package and the port's own stacked engine, on the same numpy inputs
and carried initial weights.

Worlds of 2 and 4 ranks (and 8 for the (4, 2) mesh) are spawned by
``repro_torch.launch.mesh.spawn`` (``file://`` rendezvous, every group
with a 120 s timeout, the whole world killed on a failure or after its
join timeout); their rank-side halves live in ``torch_sharded_workers.py``
and import no JAX. The spawns run in background threads while this
process computes the JAX references.

Tolerances: with C = 5 clients (Cp = 6 on 2 ranks, 8 on 4; on 4 ranks the
last rank holds only padding) every eval round within 1e-4 of the JAX
package (the float32 wire against its stacked engine, the default bf16
wire against its sharded engine on a 1-device mesh, FedAvg against its
host engine) with bytes and storage equal; ``topk+int8`` with bytes equal
and metrics within the ``CODED_TOL`` of ``test_torch_host_engine.py``
(B is a sum over ranks, so its last bits move, and the codec's top-k
amplifies them: ROADMAP Queue 3). Every rank's result is the same. A world
of one in this process with the float32 wire matches the port's stacked
engine within 1e-6. The collectives: the sharded aggregate Wn 1e-6 and B
1e-5 against ``ops.fused_relevance_aggregate(backend="ref")``; ``fed_round``
W 1e-5 and B 1e-4 against the numpy server built from JAX's
``decayed_relevance`` and ``ops.relevance_aggregate(backend="ref")`` (the
reference demo's bars); the sharded evaluation 1e-5 against
``stacked_eval_program(kernel_backend="ref")``.
"""
import concurrent.futures
import functools
import json
import os
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dryrun_workers as DW
import torch_sharded_workers as W
from repro.common import precision as JPREC
from repro.core import FedSTIL as JFedSTIL
from repro.core import edge_model as JEM
from repro.core.relevance import decayed_relevance as j_decayed_relevance
from repro.core.relevance import normalize_rows as j_normalize_rows
from repro.data import FederatedReIDBenchmark as JBench
from repro.federated import FedAvg as JFedAvg
from repro.federated import run_simulation as j_run
from repro.federated.base import stacked_eval_program
from repro.kernels import ops as JOPS
from repro.obs import trace as JOBS
from repro.sharding import specs as JSPECS
from repro_torch.common import precision as PREC
from repro_torch.configs import ARCH_IDS
from repro_torch.core.convert import (init_params_from_jax, theta_from_jax,
                                     theta_to_jax)
from repro_torch.core.fedstil import FedSTIL
from repro_torch.data import FederatedReIDBenchmark
from repro_torch.federated import FedAvg, run_simulation
from repro_torch.kernels import ops as POPS
from repro_torch.launch import eval_round as ER
from repro_torch.launch import fed_round as FR
from repro_torch.launch.mesh import spawn
from repro_torch.lifelong import EWC
from repro_torch.sharding import specs as S

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
METRICS = ("mAP", "R1", "R5", "forgetting_mAP")
# topk+int8 against the JAX package: the bars test_torch_host_engine.py
# measured for it
CODED_TOL = {"mAP": 5e-3, "forgetting_mAP": 1e-2, "R1": 2e-2, "R5": 2e-2}
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 300.0
AGG_SHAPE = (64, 4096)           # the reference's stacked demo
FR_SHAPE = dict(D=16, P=64, k=3)  # the reference's fed_round demo
# the reference's tests/test_sharded_engine.py fixture (a world of one)
ONE_KW = dict(n_clients=3, n_tasks=3, n_identities=60, ids_per_task=10,
              samples_per_id=8, seed=1)


# ---------------------------------------------------------------------------
# inputs, references and the spawned worlds
# ---------------------------------------------------------------------------


def _run(args, timeout=300.0, **kw):
    """``args`` in a subprocess of its own session with ``src`` on its
    path; on a timeout the whole session (the ranks a launcher started
    too) is killed. Returns its stdout; fails with its stderr's tail."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    return out


@functools.lru_cache(maxsize=None)
def _setup():
    jb, pb = JBench(**W.BENCH_KW), FederatedReIDBenchmark(**W.BENCH_KW)
    cfg = JEM.EdgeModelConfig(n_classes=jb.n_classes)
    C = jb.n_clients
    g_key, *keys = jax.random.split(jax.random.PRNGKey(0), C + 1)
    init = init_params_from_jax(JEM.init_extraction(g_key, cfg),
                                [JEM.init_adaptive_layers(k, cfg)
                                 for k in keys])
    return jb, pb, cfg, init


def _collective_inputs(n):
    rng = np.random.default_rng(n)
    C, P = AGG_SHAPE
    agg = (np.abs(rng.standard_normal((C, C))).astype(np.float32),
           rng.standard_normal((C, P)).astype(np.float32))
    fr = FR.demo_inputs(n // 2, seed=n, **FR_SHAPE)
    hier = tuple(np.stack(a) for a in zip(*(FR.demo_inputs(
        2, seed=n + 10 + p, **FR_SHAPE) for p in range(2))))
    return agg, ER.demo_inputs(C=8, seed=n), fr, hier


@pytest.fixture(scope="module")
def worlds():
    """Futures of the spawned worlds' results: 2 ranks then 8 on one
    thread, 4 on another, started when the first test asks."""
    init = _setup()[3]
    names = list(W.SCENARIOS)
    pool = concurrent.futures.ThreadPoolExecutor(2)

    def two_then_eight():
        two = spawn(W.world, 2, init, names, timeout=SPAWN_TIMEOUT_S)
        eight = spawn(W.collectives, 8, *_collective_inputs(8),
                      timeout=SPAWN_TIMEOUT_S)
        return two, eight

    a = pool.submit(two_then_eight)
    b = pool.submit(spawn, W.world, 4, init, names, _collective_inputs(4),
                    timeout=SPAWN_TIMEOUT_S)
    yield {"a": a, "b": b}
    pool.shutdown(wait=True)


def _world(worlds, n):
    """Every rank's result of the world of ``n`` ranks."""
    if n == 4:
        return worlds["b"].result()
    two, eight = worlds["a"].result()
    return {2: two, 8: [{"coll": r} for r in eight]}[n]


def _port_stacked(name):
    jb, pb, cfg, init = _setup()
    s = W.make_strategy(name, cfg, pb.n_clients)
    res = run_simulation(s, pb, engine="stacked", device="cpu",
                         init_params=init, **W.RUN_KW, **W.SCENARIOS[name][3])
    return W.summary(res, s)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """(the reference run's summary, its tolerance) for one scenario: the
    JAX package where a JAX counterpart exists, else the port's stacked
    engine (held against JAX by test_torch_round.py /
    test_torch_fed_strategies.py)."""
    jb, pb, cfg, init = _setup()
    C = jb.n_clients
    if name == "fedstil_f32":
        s = JFedSTIL(cfg, n_clients=C, epochs=1, wire_dtype="float32")
        out = _jsummary(j_run(s, jb, engine="stacked", **W.RUN_KW))
        return dict(out, last_W=s.last_W), 1e-4
    if name == "fedstil_bf16":
        tracer = JOBS.Tracer()
        res = j_run(JFedSTIL(cfg, n_clients=C, epochs=1), jb,
                    engine="sharded", trace=tracer, **W.RUN_KW)
        return _jsummary(res, tracer), 1e-4
    if name == "fedstil_int8":
        s = JFedSTIL(cfg, n_clients=C, epochs=1, wire_dtype="float32",
                     codec="topk+int8")
        return _jsummary(j_run(s, jb, engine="stacked", **W.RUN_KW)), \
            CODED_TOL
    if name == "fedavg":
        return _jsummary(j_run(JFedAvg(cfg, epochs=1), jb, engine="host",
                               **W.RUN_KW)), 1e-4
    return _port_stacked(name), (CODED_TOL if name == "fedstil_delta_topk"
                                 else 1e-4)


def _jsummary(res, tracer=None):
    out = {"rounds": res.rounds, "breakdown": res.comm_breakdown(),
           "c2s": res.comm.total_c2s, "s2c": res.comm.total_s2c,
           "measured": res.comm.measured, "storage": res.storage_bytes}
    if tracer is not None:
        out["events"] = [W.event_key(e) for e in tracer.events]
        out["metrics"] = [e["values"] for e in tracer.events
                          if e["kind"] == "metric"]
    return out


def _close(ref_rounds, rounds, tol):
    """Every eval round within ``tol`` (a number or a dict by metric)."""
    assert [r["round"] for r in rounds] == [r["round"] for r in ref_rounds]
    for k in METRICS:
        worst = max(abs(a[k] - b[k]) for a, b in zip(ref_rounds, rounds))
        bar = tol[k] if isinstance(tol, dict) else tol
        assert worst < bar, (k, worst, bar)


def _same_bytes(ref, got):
    for k in ("c2s", "s2c", "measured", "breakdown", "storage"):
        assert got[k] == ref[k], k


# ---------------------------------------------------------------------------
# worlds of 2 and 4 ranks, C = 5 (padding rows; a padding-only rank)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(W.SCENARIOS))
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_engine_matches_reference(worlds, n, name):
    ref, tol = _reference(name)
    got = _world(worlds, n)[0]["runs"][name]
    _close(ref["rounds"], got["rounds"], tol)
    _same_bytes(ref, got)


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_returns_the_same_result(worlds, n):
    ranks = _world(worlds, n)
    assert len(ranks) == n
    for name in W.SCENARIOS:
        first = ranks[0]["runs"][name]
        for other in ranks[1:]:
            got = other["runs"][name]
            for k in ("rounds", "breakdown", "c2s", "s2c", "measured",
                      "storage"):
                assert got[k] == first[k], (name, k)
            if first["last_W"] is not None:
                np.testing.assert_array_equal(got["last_W"], first["last_W"])


@pytest.mark.parametrize("n", WORLDS)
def test_padding_stays_out_of_the_relevance(worlds, n):
    """The (Cp, Cp) Wn of the last round: rows and columns of the padding
    clients are zero, and the real block equals the JAX stacked engine's
    C x C relevance of the same round within 1e-4."""
    got = _world(worlds, n)[0]["runs"]["fedstil_f32"]["last_W"]
    C = W.BENCH_KW["n_clients"]
    Cp = -(-C // n) * n
    assert got.shape == (Cp, Cp)
    assert (got[C:] == 0).all() and (got[:, C:] == 0).all()
    np.testing.assert_allclose(got[:C, :C],
                               _reference("fedstil_f32")[0]["last_W"],
                               atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_rank0_traces_the_jax_sharded_event_sequence(worlds, n):
    """Rank 0's traced run emits the JAX sharded engine's events in order
    (the flatten in its wire form under ``server.flatten``), each relevance
    metric with the reference's keys; the other ranks run the null
    tracer (their tracer holds only its own epoch)."""
    ref, _ = _reference("fedstil_bf16")
    ranks = _world(worlds, n)
    got = ranks[0]["runs"]["fedstil_bf16"]
    assert got["events"] == ref["events"]
    assert [set(m) for m in got["metrics"]] == [set(m)
                                                for m in ref["metrics"]]
    for other in ranks[1:]:
        assert other["runs"]["fedstil_bf16"]["events"] == [
            ("meta", None, None, None, None, None)]


# ---------------------------------------------------------------------------
# the collectives: aggregate, fed_round, hierarchical, evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (4, 8))
def test_sharded_fused_aggregate_matches_jax(worlds, n):
    """C = 64 over data x n/2, P = 4096 over model x 2 (the reference's
    stacked demo at n = 8)."""
    w, thetas = _collective_inputs(n)[0]
    Bref, Wnref = (np.asarray(a) for a in JOPS.fused_relevance_aggregate(
        jnp.asarray(w), jnp.asarray(thetas), backend="ref"))
    for rank in _world(worlds, n):
        got = rank["coll"]["aggregate"]
        (r0, r1), (c0, c1) = got["rows"], got["cols"]
        np.testing.assert_allclose(got["Wn"], Wnref, atol=1e-6)
        np.testing.assert_allclose(got["B"], Bref[r0:r1, c0:c1], atol=1e-5)


def _jax_server(thetas, feats, hists):
    k = hists.shape[1]
    decay = 0.5 ** jnp.arange(k - 1, -1, -1, dtype=jnp.float32)
    Wref = np.array(j_decayed_relevance(jnp.asarray(feats),
                                        jnp.asarray(hists), decay,
                                        metric="kl", backend="ref"))
    np.fill_diagonal(Wref, 0.0)
    Wref = j_normalize_rows(Wref)
    Bref = np.asarray(JOPS.relevance_aggregate(jnp.asarray(Wref),
                                               jnp.asarray(thetas),
                                               backend="ref"))
    return Wref, Bref


@pytest.mark.parametrize("n", (4, 8))
def test_fed_round_matches_the_jax_server(worlds, n):
    """One client a data rank, its head's columns over model x 2: a (2, 2)
    and the reference demo's (4, 2) mesh."""
    thetas, feats, hists = _collective_inputs(n)[2]
    Wref, Bref = _jax_server(thetas, feats, hists)
    for rank in _world(worlds, n):
        got = rank["coll"]["fed_round"]
        c0, c1 = got["cols"]
        np.testing.assert_allclose(got["w_row"], Wref[got["me"]], atol=1e-5)
        np.testing.assert_allclose(got["B"], Bref[got["me"], c0:c1],
                                   atol=1e-4)


def test_fed_round_hierarchical_matches_the_jax_server(worlds):
    """(pod 2, data 2): each pod's Eq. 4-6 over its own clients, then the
    mean over pods mixed in with beta = 0.25."""
    thetas, feats, hists = _collective_inputs(4)[3]
    per_pod = [_jax_server(thetas[p], feats[p], hists[p]) for p in range(2)]
    mean = np.mean([B for _, B in per_pod], 0)
    for rank in _world(worlds, 4):
        got = rank["coll"]["hierarchical"]
        p, i = got["pod"], got["me"]
        Wref, Bref = per_pod[p]
        np.testing.assert_allclose(got["w_row"], Wref[i], atol=1e-5)
        np.testing.assert_allclose(got["B"], 0.75 * Bref[i] + 0.25 * mean[i],
                                   atol=1e-4)


@pytest.mark.parametrize("n", (4, 8))
def test_sharded_eval_matches_jax(worlds, n):
    inputs = _collective_inputs(n)[1]
    ref = stacked_eval_program(
        jax.tree.map(jnp.asarray, theta_to_jax(inputs["theta"])),
        *(jnp.asarray(inputs[k]) for k in ("qf", "qids", "task_mask", "gf",
                                           "gids", "gmask")),
        kernel_backend="ref")
    for rank in _world(worlds, n):
        got = rank["coll"]["eval"]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _one_setup():
    pb = FederatedReIDBenchmark(**ONE_KW)
    return pb, JEM.EdgeModelConfig(n_classes=pb.n_classes)


def _one(engine, wire_dtype="bfloat16", codec=None):
    pb, cfg = _one_setup()
    kw = {"codec": codec} if codec else {}
    s = FedSTIL(cfg, n_clients=3, epochs=2, wire_dtype=wire_dtype, **kw)
    return run_simulation(s, pb, rounds=4, eval_every=2, engine=engine,
                          device="cpu")


def test_world_of_one_float32_wire_matches_stacked():
    """The reference's test (a): with the bf16 cast off, the sharded
    engine on one rank is the stacked engine within 1e-6, bytes and
    storage equal; the world it made is gone afterwards."""
    st, sh = _one("stacked", "float32"), _one("sharded", "float32")
    _close(st.rounds, sh.rounds, 1e-6)
    assert (sh.comm.total_c2s, sh.comm.total_s2c, sh.storage_bytes) == \
        (st.comm.total_c2s, st.comm.total_s2c, st.storage_bytes)
    assert not dist.is_initialized()


def test_world_of_one_bf16_wire_close_to_stacked():
    """The reference's test (b): the bf16 wire keeps every metric within
    5e-3 of the stacked engine (the reference measured 1.8e-3), bytes
    exact."""
    st, sh = _one("stacked"), _one("sharded")
    for key in ("mAP", "R1", "R5"):
        assert abs(st.final(key) - sh.final(key)) < 5e-3, key
    assert (sh.comm.total_c2s, sh.comm.total_s2c) == \
        (st.comm.total_c2s, st.comm.total_s2c)


def test_world_of_one_codec_bytes_match_stacked():
    """The reference's test (c): topk+int8 measures the stacked engine's
    bytes, and the metrics are its own within 1e-6."""
    st = _one("stacked", "float32", "topk+int8")
    sh = _one("sharded", "float32", "topk+int8")
    assert sh.comm_breakdown() == st.comm_breakdown()
    for key in ("mAP", "R1"):
        assert abs(st.final(key) - sh.final(key)) < 1e-6, key


def test_world_of_one_fedavg_matches_host():
    pb, cfg = _one_setup()
    kw = dict(rounds=3, eval_every=3, device="cpu")
    host = run_simulation(FedAvg(cfg, epochs=2), pb, **kw)
    sh = run_simulation(FedAvg(cfg, epochs=2), pb, engine="sharded", **kw)
    for key in ("mAP", "R1"):
        assert abs(host.final(key) - sh.final(key)) < 1e-4, key
    assert (sh.comm.total_c2s, sh.comm.total_s2c) == \
        (host.comm.total_c2s, host.comm.total_s2c)


def test_sharded_run_joins_an_initialized_group(monkeypatch):
    """Inside an initialized gloo group the run joins it (and leaves it
    up); its Eq. 5 -> 6 goes through the fused aggregate's column-block
    form (``ops.fused_relevance_aggregate(w, thetas, lo, hi)``) once a server
    round, never through the plain entry or the standalone normalize."""
    calls = []
    real = POPS.fused_relevance_aggregate
    monkeypatch.setattr(
        POPS, "fused_relevance_aggregate",
        lambda w, t, *cols: calls.append((w.shape, cols))
        or real(w, t, *cols))
    monkeypatch.setattr(POPS, "relevance_aggregate", None)
    monkeypatch.setattr(POPS, "normalize_relevance", None)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sh = _one("sharded", "float32")
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert calls == [((3, 3), (0, 3))] * 4
    monkeypatch.undo()
    _close(_one("stacked", "float32").rounds, sh.rounds, 1e-6)


def test_meshes_leave_no_process_groups_behind():
    """A long-lived world (a caller's group, or torchrun's) keeps no group
    of a mesh once it closes: ``EngineMesh.close`` (a ``with`` block) and
    every sharded run, which closes its mesh and unbinds its strategy
    when it ends."""
    from torch.distributed import distributed_c10d as c10d
    pb, cfg = _one_setup()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        before = len(c10d._world.pg_map)
        with S.engine_mesh(device="cpu") as mesh:
            assert len(c10d._world.pg_map) == before + 2   # data, model
            assert float(mesh.all_sum(torch.ones(1))) == 1.0
        assert len(c10d._world.pg_map) == before
        for _ in range(2):
            strat = FedAvg(cfg, epochs=1)
            run_simulation(strat, pb, rounds=1, engine="sharded",
                           device="cpu")
            assert strat.mesh is None
            assert len(c10d._world.pg_map) == before
    finally:
        dist.destroy_process_group()


def test_torchrun_world_is_joined(tmp_path):
    """Under ``torchrun`` (2 gloo ranks) ``run_simulation(engine="sharded")``
    joins torchrun's world rather than making a world of one a process:
    from the port's seeded weights, FedSTIL (float32 wire) and FedAvg
    match the port's stacked engine within 1e-4, bytes equal."""
    out = tmp_path / "runs.json"
    names = ["fedstil_f32", "fedavg"]
    _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
          "--nproc-per-node", "2",
          os.path.join(ROOT, "tests", "torch_sharded_workers.py"), str(out),
          *names])
    got = json.loads(out.read_text())
    _, pb, cfg, _ = _setup()
    for name in names:
        ref = run_simulation(W.make_strategy(name, cfg, pb.n_clients), pb,
                             engine="stacked", device="cpu", **W.RUN_KW)
        _close(ref.rounds, got[name]["rounds"], 1e-4)
        assert got[name]["c2s"] == ref.comm.total_c2s
        assert got[name]["s2c"] == ref.comm.total_s2c
        assert got[name]["storage"] == ref.storage_bytes


def test_sharded_engine_refuses():
    pb, cfg = _one_setup()
    with pytest.raises(ValueError, match="stacked engine API"):
        run_simulation(EWC(cfg), pb, engine="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        run_simulation(EWC(cfg), pb, engine="mesh", device="cpu")
    with pytest.raises(ValueError, match="wire_dtype"):
        FedSTIL(cfg, wire_dtype="float16")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                run_simulation(FedAvg(cfg), pb, engine="sharded")
    finally:
        dist.destroy_process_group()


def test_zero_validity_row_is_inert_as_in_jax():
    """The reference's test (d) on a world of one: a client row with
    validity 0 never enters the ring, so its W row and column and its nz
    stay zero over 3 rounds, and W, nz and B equal the JAX sharded server
    round's on its 1-device ``engine_mesh`` (W 1e-5, B 1e-4)."""
    cfg = JEM.EdgeModelConfig(n_classes=60)
    C = 4
    jtheta = jax.vmap(lambda k: JEM.init_adaptive_layers(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), C))
    js = JFedSTIL(cfg, n_clients=C, epochs=1, wire_dtype="float32")
    js.mesh = JSPECS.engine_mesh(jax.devices()[:1])
    ps = FedSTIL(cfg, n_clients=C, epochs=1, wire_dtype="float32")
    theta = theta_from_jax(jax.tree.map(np.asarray, jtheta), "cpu")
    valid = [1.0, 1.0, 1.0, 0.0]
    rng = np.random.default_rng(11)
    with S.engine_world("cpu"):
        ps.bind_mesh(S.engine_mesh(device="cpu"), C)
        for rnd in range(3):
            feats = rng.standard_normal((C, cfg.proto_dim)).astype(np.float32)
            jout = js.server_round_stacked(
                rnd, {"theta": jtheta, "task_feature": jnp.asarray(feats)},
                valid=jnp.asarray(valid))
            pout = ps.server_round_stacked(
                rnd, {"theta": theta, "task_feature": torch.from_numpy(feats)},
                valid=torch.tensor(valid))
            nz, Wn = pout["nz"].numpy(), ps.last_W
            assert not nz[3]
            assert (Wn[3] == 0).all() and (Wn[:, 3] == 0).all()
            assert nz[:3].all()
            np.testing.assert_array_equal(nz, np.asarray(jout["nz"]))
            np.testing.assert_allclose(Wn, js.last_W, atol=1e-5)
            jB = theta_from_jax(jax.tree.map(np.asarray, jout["B"]), "cpu")
            for k, v in jB.items():
                np.testing.assert_allclose(pout["B"][k].numpy(), v.numpy(),
                                           atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the wire cast and the layouts
# ---------------------------------------------------------------------------


def test_wire_casts_match_jax_bits():
    rng = np.random.default_rng(0)
    tree = {"f": (rng.standard_normal(257) * 1e3).astype(np.float32),
            "h": rng.standard_normal(9).astype(np.float16),
            "q": rng.integers(-127, 128, 33).astype(np.int8),
            "i": rng.integers(0, 1 << 30, 5).astype(np.int32),
            "b": rng.random(7) < 0.5}
    tree["f"][:4] = [np.inf, -np.inf, 0.0, -0.0]
    jb = JPREC.to_bf16(tree)
    pb = PREC.to_bf16({k: torch.from_numpy(v) for k, v in tree.items()})
    for k in ("f", "h"):
        assert pb[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pb[k].view(torch.int16).numpy().view(np.uint16),
            np.asarray(jb[k]).view(np.uint16))
        np.testing.assert_array_equal(PREC.to_f32(pb)[k].numpy(),
                                      np.asarray(JPREC.to_f32(jb)[k]))
    for k in ("q", "i", "b"):
        assert PREC.to_bf16(pb)[k] is pb[k]
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))


_BLOCKS_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec
from repro.sharding import specs
out = {}
for d in (1, 2, 3, 4, 8):
    mesh = specs.engine_mesh(jax.devices()[:d])
    for C in (5, 7, 64):
        Cp = specs.padded_clients(C, mesh)
        idx = NamedSharding(mesh, specs.client_row_spec(1)).devices_indices_map(
            (Cp,))
        rows = [idx[dev][0] for dev in mesh.devices[:, 0]]
        out[f"{d}/{C}"] = [Cp, [[s.start or 0, s.stop or Cp] for s in rows]]
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax_blocks():
    out = _run([sys.executable, "-c", _BLOCKS_SCRIPT])
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("d", (1, 2, 3, 4, 8))
def test_padded_clients_and_row_blocks_match_jax(d):
    stub = types.SimpleNamespace(shape={"data": d})
    for C in (5, 7, 64):
        Cp, rows = _jax_blocks()[f"{d}/{C}"]
        assert S.padded_clients(C, stub) == Cp == JSPECS.padded_clients(C,
                                                                        stub)
        assert [list(S.row_block(Cp, d, r)) for r in range(d)] == rows


@pytest.mark.parametrize("C", (1, 5, 33, 300))
def test_kernel_order_wn_matches_jax(C):
    """The sharded aggregate's Wn (``ops.normalize_relevance``, the fused
    kernel's first stage; its plain version on the CPU) against the JAX
    fused aggregate's within 1e-6, with an all-zero row and a NaN off the
    diagonal (both rows zero); a NaN on the diagonal is replaced, as the
    port's plain version and the Pallas kernel's ``where`` do (ROADMAP
    Queue 3: JAX's ``ref`` multiplies it in). On a world of one,
    ``sharded_fused_aggregate`` gives the fused entry's B and Wn bit for
    bit."""
    from repro_torch.core.fedstil import sharded_fused_aggregate
    rng = np.random.default_rng(C)
    w = np.abs(rng.standard_normal((C, C))).astype(np.float32)
    w[0] = 0.0
    if C > 2:
        w[2, 0] = np.nan
    _, Wref = JOPS.fused_relevance_aggregate(
        jnp.asarray(w), jnp.zeros((C, 4), jnp.float32), backend="ref")
    got = POPS.normalize_relevance(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(Wref), atol=1e-6)
    assert (got[0] == 0).all() and not np.isnan(got).any()
    if C > 2:
        w[1, 1] = np.nan
    wt = torch.from_numpy(w)
    th = torch.from_numpy(rng.standard_normal((C, 37)).astype(np.float32))
    B, Wn = POPS.fused_relevance_aggregate(wt, th)
    with S.engine_world("cpu"), S.engine_mesh(device="cpu") as mesh:
        Bs, Wns = sharded_fused_aggregate(wt, th, mesh)
    assert torch.equal(Wns, Wn) and torch.equal(Bs, B)
    assert not torch.isnan(Wns).any()


@pytest.mark.parametrize("C", (1, 5, 33, 300))
def test_block_aggregate_plain_matches_jax_per_rank_block(C):
    """The fused aggregate's column-block form (its plain version on the
    CPU), on each rank's column block of simulated worlds of 2 and 4 (C
    padded to a multiple of the world, as the engine pads its rows),
    against the JAX fused aggregate (``backend="ref"``) sliced to that
    block: Wn within 1e-6, the partial B within 1e-5 of the block's
    columns of JAX's Wn times its rows of Theta, and the partials' sum
    within 1e-5 of JAX's B; an all-zero row and a NaN off the diagonal,
    as in ``test_kernel_order_wn_matches_jax``."""
    rng = np.random.default_rng(C + 1)
    for d in (2, 4):
        Cp = -(-C // d) * d
        w = np.abs(rng.standard_normal((Cp, Cp))).astype(np.float32)
        w[0] = 0.0
        if C > 2:
            w[2, 0] = np.nan
        w[C:] = 0.0                       # padding rows: no relevance
        w[:, C:] = 0.0
        th = rng.standard_normal((Cp, 24)).astype(np.float32)
        th[C:] = 0.0
        Bref, Wnref = JOPS.fused_relevance_aggregate(
            jnp.asarray(w), jnp.asarray(th), backend="ref")
        total = np.zeros((Cp, 24), np.float32)
        for r in range(d):
            lo, hi = S.row_block(Cp, d, r)
            B, Wn = POPS.fused_relevance_aggregate(
                torch.from_numpy(w), torch.from_numpy(th[lo:hi]), lo, hi)
            np.testing.assert_allclose(Wn.numpy(), np.asarray(Wnref),
                                       atol=1e-6)
            part = np.asarray(Wnref[:, lo:hi] @ jnp.asarray(th[lo:hi]))
            np.testing.assert_allclose(B.numpy(), part, atol=1e-5)
            total += B.numpy()
        np.testing.assert_allclose(total, np.asarray(Bref), atol=1e-5)
        assert not np.isnan(total).any()


def test_normalize_wrapper_takes_cuda_tensors_only():
    """The normalize entry's wrapper launches its kernel or raises: a CPU
    tensor reaches the plain version only through ``ops``."""
    from repro_torch.kernels import relevance_aggregate as RA
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RA.normalize_relevance(torch.ones((3, 3)))
    with pytest.raises(ValueError, match=r"expected w \(C, C\)"):
        RA.normalize_relevance(torch.ones(3))
    assert RA.normalize_relevance.launches == 0


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _launch(module, *args):
    return _run([sys.executable, "-m", module, *args], cwd=ROOT)


def test_fed_round_launcher_runs_both_demos_traced(tmp_path):
    """8 gloo ranks on a (4, 2) mesh: each rank checks its rows against
    the port's batched server; rank 0 alone writes the trace."""
    path = tmp_path / "fed_round.jsonl"
    out = _launch("repro_torch.launch.fed_round", "--demo", "--stacked-demo",
                  "--device", "cpu", "--trace", str(path))
    assert "fed_round on-mesh == batched parameter server" in out
    assert "sharded fused aggregate (C=64 over data x 4, P=4096 over " \
           "model x 2) == kernel path" in out
    spans = [json.loads(line)["name"] for line in path.read_text().splitlines()
             if json.loads(line)["kind"] == "span"]
    assert spans == ["fed_round.stacked_demo", "fed_round.demo"]


@pytest.fixture(scope="module")
def arch_lowering(tmp_path_factory):
    """``fed_round --arch qwen1.5-0.5b`` on both production meshes, the
    round's counts at a fake (2, 2) and (2, 1, 2) (a subprocess) and in a
    gloo world of 4 (spawned), all started together."""
    out_dir = tmp_path_factory.mktemp("fed_round_arch")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    launchers = {mp: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fed_round", "--arch",
         DW.ROUND_ARCH] + (["--multi-pod"] if mp else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, start_new_session=True) for mp in (False, True)}
    meta = DW.start("meta_rounds", out_dir)
    try:
        gloo = spawn(DW.gloo_rank, 4, ["round/single", "round/pod"],
                     device="cpu", timeout=DW.JOB_TIMEOUT_S)[0]
        printed = {}
        for mp, proc in launchers.items():
            out, err = proc.communicate(timeout=DW.JOB_TIMEOUT_S)
            assert proc.returncode == 0, err[-4000:]
            printed[mp] = out
    finally:
        for proc in launchers.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return {"printed": printed, "meta": DW.collect(meta),
            "gloo": json.loads(json.dumps(gloo))}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_fed_round_launcher_lowers_arch(arch_lowering, multi_pod):
    """``--arch`` lowers the LM's round onto the production mesh (meta
    tensors in a fake world): the payload and collectives it prints."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import abstract_train_state
    out = arch_lowering["printed"][multi_pod]
    mesh = "2x16x16" if multi_pod else "16x16"
    assert f"fed_round lowered for {DW.ROUND_ARCH} on {mesh}" in out
    payload = FR.payload_bytes(abstract_train_state(
        get_config(DW.ROUND_ARCH), 16)[1])
    assert f"adaptive payload/client: {payload / 1e6:.1f} MB" in out
    counts = json.loads(out.split("collective bytes/device: ")[1]
                        .split(" MB ")[1].splitlines()[0].replace("'", '"'))
    # the history and W gathers, Eq. 6's reduce-scatter; across pods one
    # mean a leaf of the head
    assert counts["all-gather"] == 2 and counts["reduce-scatter"] == 1
    assert (counts["all-reduce"] > 0) == multi_pod
    assert "not ported" not in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fed_round_payload_equals_reference(arch):
    """The adaptive payload a client equals the bytes of the reference's
    ``abstract_train_state`` B (traced on one CPU device)."""
    from repro.configs import get_config as j_get_config
    from repro.launch.steps import abstract_train_state as j_state
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import abstract_train_state
    want = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in jax.tree.leaves(j_state(j_get_config(arch),
                                                   16)[1]))
    assert FR.payload_bytes(abstract_train_state(get_config(arch),
                                                 16)[1]) == want


@pytest.mark.parametrize("mesh", ["single", "pod"])
def test_fed_round_ledger_fake_equals_gloo(arch_lowering, mesh):
    """The round's FLOPs and collective ledger on meta tensors in a fake
    world of 4 equal those on CPU tensors in a gloo world of 4."""
    meta = arch_lowering["meta"][f"round/{mesh}"]
    assert meta["ledger"] and meta == arch_lowering["gloo"][f"round/{mesh}"]


def test_eval_round_launcher_runs_the_demo():
    out = _launch("repro_torch.launch.eval_round", "--demo", "--device",
                  "cpu")
    assert "sharded eval round (C=8 over data x 4) == one-process" in out
