"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,                # padded to 64 under TP=16 (see DESIGN.md)
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,                 # per-expert hidden
    vocab_size=32000,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10000.0,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    dense_ff=4864,
    n_adaptive_layers=1,
    fsdp=True,
    source="hf:Snowflake/snowflake-arctic-base",
)
