"""The cases of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: which config, mesh, layout and modes
each runs, and its numpy inputs from a seed. Pure Python and numpy: the
JAX oracle subprocess (``tests/jax_tp_oracle.py``) and the port's ranks
(``tests/torch_tp_workers.py``) both read it.

A config is a registered arch ``reduced()`` (fp32), or a variant of one
built by the same ``dataclasses.replace`` on each side. A mesh is
{axis: size}: ("data", "model") or ("pod", "data", "model"). Train modes:

  * "sgd": one step of SGD at ``READ_LR`` (gradients read as (old - new)
    / READ_LR: a large power of 2 keeps the reading's rounding ~1e-7 of
    the gradient), tie_lambda 0, against the JAX package's sharded step;
    and the gradient on the mesh itself against JAX's unsharded
    ``jax.grad`` at tie_lambda 1e-4;
  * "pin": the same SGD step at tie_lambda 1e-4 (the reference's sharded
    gradient is x TP there);
  * "adam": ``ADAM_STEPS`` steps of the reference's Adam at tie_lambda 0;
  * "full": one full fine-tuning SGD step.

Decode runs ``DECODE_STEPS`` greedy steps from an empty cache of ``SLOTS``
slots (encdec: the cross cache filled by the unsharded encoder, 1536
slots as the reference's ``ENC_PAD``) in each kv dtype listed; "ring" is
long_500k's decode (an fp32 ring of the reference's 8192-slot window)
from position ``RING_START``, so that the steps wrap it.
"""
import dataclasses

import numpy as np

READ_LR = 2.0 ** 20
TIE = 1e-4
B, S = 4, 16
ADAM_STEPS = 3
DECODE_STEPS, SLOTS = 8, 16
RING_WINDOW = 8192                  # the reference's LONG_CONTEXT_WINDOW
RING_START = RING_WINDOW - DECODE_STEPS // 2
ENC_FRAMES = 16

VARIANTS = {
    "dense": ("qwen3-1.7b", {}),
    "gqa1": ("qwen1.5-0.5b", {"n_kv_heads": 1}),
    "heads3": ("qwen3-1.7b", {"n_heads": 3, "n_kv_heads": 1}),
    "moe": ("qwen3-moe-235b-a22b", {}),
    "ssm": ("rwkv6-1.6b", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "vlm": ("qwen3-1.7b", {"family": "vlm", "n_vision_tokens": 8}),
    "encdec": ("qwen1.5-0.5b", {"family": "encdec", "n_enc_layers": 2,
                                "enc_seq": ENC_FRAMES, "rope_theta": 0.0,
                                "norm": "layernorm", "act": "gelu"}),
}


def _case(variant, mesh, *, layout="tp", fsdp=False, train=(),
          prefill=False, decode=(), ws=False):
    return {"variant": variant, "mesh": mesh, "layout": layout,
            "fsdp": fsdp, "train": tuple(train), "prefill": prefill,
            "decode": tuple(decode), "ws": ws}


M12 = {"data": 1, "model": 2}
M22 = {"data": 2, "model": 2}
M14 = {"data": 1, "model": 4}
POD = {"pod": 2, "data": 1, "model": 2}

TP_CASES = {
    "dense_1x2": _case("dense", M12, train=("sgd", "pin"), prefill=True,
                       decode=("float32",)),
    "dense_2x2": _case("dense", M22, train=("sgd", "adam", "full"),
                       prefill=True, decode=("float32", "int8", "ring")),
    "dense_1x4": _case("dense", M14, train=("sgd",), prefill=True,
                       decode=("float32",)),
    "dense_pod": _case("dense", POD, train=("sgd",), prefill=True,
                       decode=("float32",)),
    "dense_dp": _case("dense", M22, layout="dp", train=("sgd", "adam")),
    "dense_fsdp": _case("dense", M22, fsdp=True, train=("sgd",),
                        prefill=True, decode=("float32",)),
    "dense_ws": _case("dense", M22, fsdp=True, ws=True,
                      decode=("float32", "int8")),
    "gqa1_1x2": _case("gqa1", M12, train=("sgd",), prefill=True,
                      decode=("float32",)),
    "heads3_1x2": _case("heads3", M12, train=("sgd",), prefill=True,
                        decode=("float32",)),
}

FAMILY_CASES = {
    f"{v}_2x2": _case(v, M22, train=("sgd",), prefill=True,
                      decode=("float32",) + (("int8",) if v in ("moe", "vlm")
                                             else ()))
    for v in ("moe", "ssm", "hybrid", "vlm", "encdec")}
FAMILY_CASES["moe_1x4"] = _case("moe", M14, train=("sgd",), prefill=True,
                                decode=("float32",))

CASES = {**TP_CASES, **FAMILY_CASES}


def vs_unsharded(case) -> str:
    """What of a case's sharded train step equals the unsharded step's:
    "all" (loss, cross-entropy, every gradient leaf); "ce" for a MoE over
    more than one data rank (its load-balance aux is each data rank's own,
    then averaged, as the reference's: the loss and the router's gradient
    move with it)."""
    data = case["mesh"]["data"] * case["mesh"].get("pod", 1)
    if case["variant"] == "moe" and data > 1:
        return "ce"
    return "all"


def dealt(tree, tp, inverse=False):
    """A nested dict tree with every mamba ``w_zx`` leaf's [z | x] columns
    reordered to [z_0 x_0 z_1 x_1 ...] (``inverse``: back), so that a
    split of the last dim into ``tp`` contiguous blocks hands rank r
    [z_r | x_r], as the port's ``shard_tree`` deals them. The JAX
    package's sharded steps take the reordered weights (its spec splits
    w_zx by contiguous columns). numpy or JAX arrays; other leaves as
    they are."""
    def go(node, parent):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = go(v, k)
            elif (parent, k) == ("mamba", "w_zx") and tp > 1:
                lead = v.shape[:-1]
                a, b = (tp, 2) if inverse else (2, tp)
                out[k] = v.reshape(*lead, a, b, -1).swapaxes(-3, -2) \
                    .reshape(*lead, -1)
            else:
                out[k] = v
        return out
    return go(tree, "")


def decode_mode(name):
    """A decode entry -> (kv dtype name, shape name, first position)."""
    if name == "ring":
        return "float32", "long_500k", RING_START
    return name, "decode", 0


def world_size(case) -> int:
    n = 1
    for v in case["mesh"].values():
        n *= v
    return n


def tp_of(case) -> int:
    """The TP degree the weights are built for (the dp layout: 1)."""
    return 1 if case["layout"] == "dp" else case["mesh"]["model"]


def params_key(case) -> str:
    return f"{case['variant']}_tp{tp_of(case)}"


def same_model_key(cfg, case) -> str:
    """Cases whose unsharded model is the same (one variant, the same
    padded q heads) share this key."""
    return f"{case['variant']}_h{cfg.padded_heads(tp_of(case))}"


def config(configs, case):
    """The case's config from a config package (``repro.configs`` or
    ``repro_torch.configs``)."""
    arch, kw = VARIANTS[case["variant"]]
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **kw)
    return dataclasses.replace(cfg, fsdp=True) if case["fsdp"] else cfg


def numpy_batch(cfg, seed, B=B, S=S):
    """Tokens and labels (S of them past vlm's vision tokens), plus vision
    embeds (vlm) or frames (encdec), from ``seed``."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    return b


def flat(tree, prefix=""):
    """Nested dicts of arrays -> {"a/b/c": array} (the npz keys)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def nested(flat_tree, prefix=""):
    """The entries of ``flat_tree`` (under ``prefix/``) as nested dicts."""
    out = {}
    for key, v in flat_tree.items():
        if prefix and not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1 if prefix else 0:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
