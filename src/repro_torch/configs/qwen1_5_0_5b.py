"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1e6,
    n_adaptive_layers=1,
    source="hf:Qwen/Qwen1.5-0.5B",
)
