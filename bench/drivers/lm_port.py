"""How the benchmark hands a config file and its seeded weights to the
system under test, the port's dense LM (``repro_torch``): its
``ModelConfig`` from the config file's published keys, and its parameter
tree, whose leaves are views of the benchmark's stacked weights (no
copy). The trained slice's leaf paths map back to the reference's leaf
names."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig

# reference leaf name -> (the port's sub-tree, key) inside a layer
LAYER_LEAVES = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale"),
                "wq": ("attn", "wq"), "wk": ("attn", "wk"),
                "wv": ("attn", "wv"), "wo": ("attn", "wo"),
                "bq": ("attn", "bq"), "bk": ("attn", "bk"),
                "bv": ("attn", "bv"), "qnorm": ("attn", "qnorm"),
                "knorm": ("attn", "knorm"), "wi": ("mlp", "wi"),
                "wg": ("mlp", "wg"), "w2": ("mlp", "wo")}
_BY_PORT = {v: k for k, v in LAYER_LEAVES.items()}


def port_config(conf: Dict, arch) -> ModelConfig:
    """The port's config of a dense model file, in the dtype it states."""
    dtype = conf["torch_dtype"]
    return ModelConfig(
        name=conf["name"], family="dense", n_layers=arch.layers,
        d_model=arch.d, n_heads=arch.heads, n_kv_heads=arch.kv_heads,
        head_dim=arch.hd, d_ff=arch.ff, vocab_size=arch.vocab,
        qkv_bias=arch.qkv_bias, qk_norm=arch.qk_norm,
        rope_theta=arch.theta, norm="rmsnorm", act="swiglu",
        n_adaptive_layers=arch.adaptive,
        tied_embeddings=not arch.untied_head, param_dtype=dtype,
        compute_dtype=dtype, source=conf["source"])


def port_params(arch, w) -> Dict:
    """The port's parameter tree over the stacked weights ``w``: the
    trunk's layers and the adaptive ones as slices of the same tensors."""
    lo = arch.layers - arch.adaptive

    def stack(sl):
        t: Dict = {}
        for name, (sub, key) in LAYER_LEAVES.items():
            if name in w:
                t.setdefault(sub, {})[key] = w[name][sl]
        return t

    return {"embed": {"table": w["embed"]},
            "final_norm": {"scale": w["final_norm"]},
            "head": {"w": w["head"]},
            "layers": stack(slice(0, lo)),
            "adaptive_layers": stack(slice(lo, arch.layers))}


def reference_leaf(path: Tuple[str, ...]) -> str:
    """A trained leaf's path in the port's (alpha, A) tree -> the
    reference's name: ("alpha", "adaptive_layers", "mlp", "wo") ->
    "alpha.layer.w2"; ("A", "head", "w") -> "A.head"."""
    part, top = path[0], path[1]
    if top == "adaptive_layers":
        return f"{part}.layer.{_BY_PORT[(path[2], path[3])]}"
    return f"{part}.{top}"
