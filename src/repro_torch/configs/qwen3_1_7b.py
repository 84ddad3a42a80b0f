"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1e6,
    n_adaptive_layers=1,
    source="hf:Qwen/Qwen3-8B",
)
