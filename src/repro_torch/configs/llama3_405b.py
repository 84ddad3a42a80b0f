"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=5e5,
    n_adaptive_layers=1,
    fsdp=True,
    source="arXiv:2407.21783",
)
