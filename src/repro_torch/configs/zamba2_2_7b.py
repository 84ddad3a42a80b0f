"""zamba2-2.7b [hybrid] — Mamba2 trunk + shared attention blocks.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,               # mamba2 layers
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    norm="rmsnorm",
    act="gelu",
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,              # shared (weight-tied) attention block period
    n_adaptive_layers=1,
    source="arXiv:2411.15242",
)
