"""The port's production lowering (``sharding/{analysis,analytic}.py``,
``launch/dryrun.py``, the flash stages' FLOPs on meta tensors, the time
loops' one-step cost) against the JAX package.

  * ``analytic_roofline`` / ``analytic_model_flops`` equal the reference's
    exactly on every arch x shape x pod count, with its options;
  * ``dtype_bytes`` / ``aval_bytes`` equal the reference's on its whole
    width table;
  * the collective counter's per-kind bytes and counts equal the
    reference's ``parse_collectives`` on HLO lines of the same ops (each
    kind at group sizes 2, 4 and 16, iota and list replica groups);
  * ``args_bytes_per_device`` equals the reference's ``_tree_device_bytes``
    for every arch's train and decode inputs at 16 x 16;
  * FLOPs and the collective ledger of a step counted on meta tensors in a
    fake world equal those counted on small random CPU tensors in a gloo
    world of the same mesh, exactly (dense at (2, 2), (1, 4) and (2, 1,
    2); moe, hybrid and ssm at (2, 2); train and decode);
  * the four flash stages count the kernels' visible pairs on the CPU and
    on meta alike, not the plain version's products;
  * the rwkv and mamba time loops cost one step x the trip count on meta,
    exactly what walking every step costs;
  * one ``run_combo`` a family at 16 x 16, and one at 2 x 16 x 16, ends
    ``ok`` with the reference's analytic block; where the counted FLOPs
    part from the analytic model, by the mechanism ROADMAP Queue 3
    records.

Every fake world runs in a subprocess (``torch_dryrun_workers.py``: a
process holds one default group); the gloo world is spawned, all of them
at once.
"""
import concurrent.futures
import json

import numpy as np
import pytest
import torch

import torch_dryrun_workers as W
from repro.configs import get_config as j_get_config
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.sharding import analysis as JAN
from repro.sharding import analytic as JAA
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.launch.dryrun import _tree_device_bytes
from repro_torch.launch import steps as STEPS
from repro_torch.launch.mesh import spawn
from repro_torch.models.rwkv import wkv_recurrence
from repro_torch.models.ssm import ssm_recurrence
from repro_torch.sharding import analysis as AN
from repro_torch.sharding import analytic as AA

STEP_NAMES = [f"{n}/{m}" for n in W.STEP_CASES for m in W.MODES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every job's result: the fake worlds' and the reference's
    subprocesses and the gloo world, started together."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    started = {job: W.start(job, out_dir)
               for job in ("meta_steps", "combos", "collectives", "ref_args")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gloo = pool.submit(spawn, W.gloo_rank, 4, STEP_NAMES, device="cpu",
                           timeout=W.JOB_TIMEOUT_S)
        out = {job: W.collect(s) for job, s in started.items()}
        # through JSON, as the subprocesses' results come
        out["gloo"] = json.loads(json.dumps(gloo.result()[0]))
    return out


# ---------------------------------------------------------------------------
# (a), (b): the analytic model and the width table, copied arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_roofline_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert AN.analytic_model_flops(cfg, shape) == \
            JAN.analytic_model_flops(jcfg, J_SHAPES[name])
        for pods in (1, 2):
            for ws_fused in (True, False):
                kw = dict(tp=16, dp=16, pods=pods, fused_dense_psum=False,
                          decode_ws=True, ws_fused=ws_fused)
                assert AA.analytic_roofline(cfg, shape, **kw) == \
                    JAA.analytic_roofline(jcfg, J_SHAPES[name], **kw), \
                    (name, kw)
            assert AA.analytic_roofline(cfg, shape, pods=pods) == \
                JAA.analytic_roofline(jcfg, J_SHAPES[name], pods=pods)


@pytest.mark.parametrize("name", sorted(JAN._NP_TO_HLO))
def test_dtype_widths_equal_reference(name):
    assert AN.dtype_bytes(name) == JAN.dtype_bytes(name)
    assert AN.aval_bytes((3, 5, 7), name) == JAN.aval_bytes((3, 5, 7), name)
    tdt = getattr(torch, name, None)
    if isinstance(tdt, torch.dtype):
        assert AN.dtype_bytes(tdt) == JAN.dtype_bytes(name)
    if name not in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        assert AN.dtype_bytes(np.dtype(name)) == \
            JAN.dtype_bytes(np.dtype(name))


# ---------------------------------------------------------------------------
# (c): the collective counter against parse_collectives
# ---------------------------------------------------------------------------

_HLO_DT = {"float32": "f32", "bfloat16": "bf16"}


def _hlo_line(kind, shape, dtype, g, form):
    t = f"{_HLO_DT[dtype]}[{','.join(map(str, shape))}]"
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    elif form == "iota":
        groups = f"replica_groups=[{16 // g},{g}]<=[16]"
    else:
        groups = "replica_groups={" + ",".join(
            "{" + ",".join(str(r) for r in range(i * g, (i + 1) * g)) + "}"
            for i in range(16 // g)) + "}"
    return f"  %op.1 = {t}{{1,0}} {kind}({t}{{1,0}} %p.0), {groups}"


@pytest.mark.parametrize("kind", JAN._COLLECTIVES)
def test_collective_counter_equals_parse_collectives(worlds, kind):
    rows = [r for r in worlds["collectives"] if r[0] == kind]
    assert {(r[1], r[2]) for r in rows} >= {
        ("c10d", g) for g in W.GROUP_SIZES}
    for _, api, g, shape, dtype, got_bytes, got_count in rows:
        for form in ("iota", "list"):
            want = JAN.parse_collectives(_hlo_line(kind, shape, dtype, g,
                                                   form))
            assert got_bytes == want.bytes_by_kind, (api, g, dtype, form)
            assert got_count == want.count_by_kind, (api, g, dtype, form)
            assert want.count_by_kind[kind] == 1


# ---------------------------------------------------------------------------
# (d): per-device argument bytes against the reference's
# ---------------------------------------------------------------------------


class _Mesh:
    """The production mesh's sizes: all a step builder reads of it."""
    shape = {"data": 16, "model": 16}

    def size(self, axis):
        return self.shape[axis]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_args_bytes_equal_reference(worlds, arch):
    for shape in ("train_4k", "decode_32k"):
        _, args, specs = STEPS.build_step(get_config(arch), _Mesh(), shape,
                                          multi_pod=False)
        assert _tree_device_bytes(args, specs, _Mesh.shape) == \
            worlds["ref_args"][f"{arch}/{shape}"], shape


# ---------------------------------------------------------------------------
# (e): meta in a fake world against real tensors in a gloo world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STEP_NAMES)
def test_meta_counts_equal_gloo_counts(worlds, name):
    meta, real = worlds["meta_steps"][name], worlds["gloo"][name]
    assert meta["flops"] > 0
    assert meta == real


# ---------------------------------------------------------------------------
# (f): the flash stages' FLOPs
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "causal": dict(shape=(1, 4, 2, 48, 64, 16), causal=True, window=0),
    "window": dict(shape=(2, 2, 1, 64, 64, 16), causal=True, window=16),
    "s256": dict(shape=(1, 2, 2, 256, 256, 64), causal=True, window=0),
}
FLASH_STAGES = {"fwd": (ops.flash_attention_fwd, REF.flash_attention_ref, 2),
                "fwd_lse": (ops.flash_attention_fwd_lse,
                            REF.flash_attention_fwd_lse_ref, 2),
                "dq": (ops.flash_attention_dq, REF.flash_attention_dq_ref, 3),
                "dkv": (ops.flash_attention_dkv, REF.flash_attention_dkv_ref,
                        4)}


def _flash_operands(B, hq, hkv, sq, sk, hd):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    return (r(B, hq, sq, hd), r(B, hkv, sk, hd), r(B, hkv, sk, hd),
            r(B, hq, sq, hd), r(B, hq, sq), r(B, hq, sq))


def _counted(fn, args, kw):
    with AN.OpCounter() as c:
        fn(*args, **kw)
    return c.flops


@pytest.mark.parametrize("stage", FLASH_STAGES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_stages_count_the_kernels_pairs(case, stage):
    spec = FLASH_CASES[case]
    B, hq, hkv, sq, sk, hd = spec["shape"]
    kw = dict(causal=spec["causal"], window=spec["window"])
    fn, plain, products = FLASH_STAGES[stage]
    args = _flash_operands(B, hq, hkv, sq, sk, hd)
    if stage.startswith("fwd"):
        args = args[:3]
    pairs = int(REF.flash_mask(sq, sk, device="cpu", **kw).sum())
    want = 2 * products * B * hq * hd * pairs
    meta = tuple(a.to("meta") for a in args)
    assert _counted(fn, args, kw) == want
    assert _counted(fn, meta, kw) == want
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        fn(*meta, **kw)
    assert fc.get_total_flops() == want
    # the plain version materializes every (query, key) product
    assert _counted(plain, args, kw) > want


# ---------------------------------------------------------------------------
# (g): a time loop's one-step cost on meta
# ---------------------------------------------------------------------------

B_, L_, NH, HD, DS = 2, 32, 3, 8, 5
LOOPS = {"rwkv": (wkv_recurrence, [(B_, L_, NH, HD)] * 4
                  + [(NH, HD), (B_, NH, HD, HD)]),
         "mamba": (ssm_recurrence, [(B_, L_, NH, HD), (B_, L_, DS),
                                    (B_, L_, DS), (B_, L_, NH), (B_, L_, NH),
                                    (B_, NH, HD, DS)])}


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("loop", LOOPS)
def test_time_loop_costs_one_step_times_its_trip_count(loop, grad):
    fn, shapes = LOOPS[loop]
    g = torch.Generator().manual_seed(0)
    real = [torch.randn(s, generator=g) for s in shapes]

    def count(device):
        # every operand but the initial state asks for a gradient
        ts = [t.to(device, copy=True).requires_grad_(
            grad and i < len(real) - 1) for i, t in enumerate(real)]
        with AN.OpCounter() as c:
            y, last = fn(*ts)
            if grad:
                y.sum().backward()
        return c.flops, y.shape, last.shape, y.device.type

    cpu, meta = count("cpu"), count("meta")
    assert meta[3] == "meta" and cpu[3] == "cpu"
    assert cpu[:3] == meta[:3]
    assert cpu[0] > 0


# ---------------------------------------------------------------------------
# (h): run_combo, one a family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(W.COMBOS)),
                         ids=[f"{a}-{s}-{'mp' if mp else 'sp'}"
                              for a, s, mp in W.COMBOS])
def test_run_combo_ends_ok_with_the_reference_analytic(worlds, i):
    arch, shape, mp = W.COMBOS[i]
    rec = worlds["combos"][i]
    assert rec["ok"] and rec["arch"] == arch and rec["shape"] == shape
    assert rec["mesh"] == ("2x16x16" if mp else "16x16")
    assert rec["n_devices"] == (512 if mp else 256)
    assert rec["cost"]["flops"] > 0
    assert rec["memory"]["args_bytes_per_device"] > 0
    assert rec["memory"]["peak_live_bytes_estimate"] > 0
    assert rec["analytic"] == JAA.analytic_roofline(
        j_get_config(arch), J_SHAPES[shape], tp=16, dp=16,
        pods=2 if mp else 1)
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes"].values())
    # every axis of the production meshes crosses nodes of 8
    assert coll["nvlink_bytes"] == 0
    assert coll["internode_bytes"] == coll["total_bytes"] > 0
    roof = rec["roofline"]
    assert roof["flops_per_device"] == rec["cost"]["flops"]
    assert roof["t_collective_s"] == pytest.approx(
        coll["total_bytes"] / AN.INTERNODE_BW)
    assert roof["bottleneck"] in ("compute", "memory", "collective")


def _combo(worlds, arch, shape, mp=False):
    return worlds["combos"][W.COMBOS.index((arch, shape, mp))]


def test_counted_flops_part_from_the_analytic_model_by_its_mechanisms(
        worlds):
    """Counted minus analytic FLOPs at 16 x 16, each gap within 1% of the
    count once its mechanism's FLOPs are added (ROADMAP Queue 3)."""
    def gap(arch, shape):
        rec = _combo(worlds, arch, shape)
        return (rec["cost"]["flops"] - rec["analytic"]["flops_per_device"],
                rec["cost"]["flops"])

    # KV = H = tp: nothing to add
    got, total = gap("qwen1.5-0.5b", "train_4k")
    assert abs(got) <= 0.01 * total
    # KV (8) < tp (16): every rank projects all kv heads (the analytic
    # model divides them by tp); the adaptive layer three times (forward,
    # two backward products)
    cfg = get_config("qwen3-1.7b")
    tok = 16 * 4096
    extra = (2 * tok * cfg.d_model * 2 * cfg.n_kv_heads * cfg.hd
             * (1 - 1 / 16)) * (cfg.n_layers + 2 * cfg.n_adaptive_layers)
    got, total = gap("qwen3-1.7b", "train_4k")
    assert abs(got - extra) <= 0.01 * total
    # MoE decode: each rank's 8 experts run the capacity's 128 rows (at
    # least 128) where the model counts top_k x 8 tokens
    from repro_torch.models.moe import expert_capacity
    cfg = get_config("qwen3-moe-235b-a22b")
    tok, e_loc = 128 // 16, cfg.n_experts // 16
    cap = expert_capacity(cfg, tok)
    assert cap == 128
    ffn = 2 * 3 * cfg.d_model * cfg.d_ff
    extra = cfg.n_layers * (e_loc * cap * ffn - tok * cfg.top_k * ffn / 16)
    got, total = gap("qwen3-moe-235b-a22b", "decode_32k")
    assert abs(got - extra) <= 0.01 * total
    # rwkv decode: the channel mix's gate wr (d x d) and the decay's LoRA
    # (d x 64 x 2) run replicated; the model's decode counts neither
    cfg = get_config("rwkv6-1.6b")
    tok, d = 128 // 16, cfg.d_model
    extra = cfg.n_layers * (2 * tok * d * d + 2 * 2 * tok * d * 64)
    got, total = gap("rwkv6-1.6b", "decode_32k")
    assert abs(got - extra) <= 0.01 * total
