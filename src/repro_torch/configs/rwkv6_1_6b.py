"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                # d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    norm="layernorm",
    act="gelu",                # rwkv uses squared relu in channel mix (custom)
    rwkv_head_size=64,
    n_adaptive_layers=1,
    source="arXiv:2404.05892",
)
