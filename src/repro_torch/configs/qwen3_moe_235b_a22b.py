"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B family scaled per assignment]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                  # per-expert hidden
    vocab_size=151936,
    qk_norm=True,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    n_adaptive_layers=1,
    fsdp=True,
    source="hf:Qwen/Qwen3-30B-A3B",
)
