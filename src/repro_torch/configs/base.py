"""Architecture + input-shape config system: the port's own copy of the
JAX package's ``configs/base.py`` (pure Python, field for field; the tests
hold the two equal for every arch id).

Every assigned architecture gets a ``configs/<id>.py`` exporting
``CONFIG`` built from :class:`ModelConfig`. ``reduced()`` produces the
CPU-smoke variant (<=2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    source: str = ""               # citation (paper / model card)

    # attention variants
    qkv_bias: bool = False         # qwen1.5
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10000.0
    causal: bool = True
    sliding_window: int = 0        # 0 = full attention; >0 used for long_500k

    # norm / activation
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu

    # MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    dense_ff: int = 0              # hidden of the dense residual MLP

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    attn_every: int = 0            # zamba2: shared attention block period

    # RWKV6
    rwkv_head_size: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0               # stub frontend frames (1500 for whisper)

    # VLM
    n_vision_tokens: int = 0       # stub projector output tokens

    # FedSTIL split: how many *last* decoder layers are adaptive (trainable)
    n_adaptive_layers: int = 1

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # distribution
    fsdp: bool = False             # shard params over data axis, gather on use

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def padded_heads(self, tp: int) -> int:
        """Q heads padded so TP divides them (arctic: 56 -> 64 at TP=16)."""
        return _round_up(self.n_heads, tp)

    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size if self.rwkv_head_size else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if long_500k decode runs with O(1)/O(W) per-token state."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, hd, V = self.d_model, self.hd, self.padded_vocab()
        emb = V * d * (2 if not self.tied_embeddings else 1)
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":   # rwkv6
            blk = 6 * d * d + 3 * d * self.d_ff
            return emb + self.n_layers * blk
        if self.act == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.n_experts:
            moe = self.n_experts * (3 * d * self.d_ff)
            if self.dense_residual:
                moe += 3 * d * (self.dense_ff or self.d_ff)
            blk = attn + moe
        elif self.family == "hybrid":
            di = self.d_inner
            mamba = d * (2 * di + di // self.ssm_head_dim * 0) + 2 * d * di + di * d
            blk = mamba + mlp
        else:
            blk = attn + mlp
        n = emb + self.n_layers * blk
        if self.n_enc_layers:
            n += self.n_enc_layers * (attn + mlp) + self.n_layers * (attn)  # cross-attn
        return int(n)

    def active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        return int(dense + self.n_layers * self.top_k * 3 * d * self.d_ff)

    def adaptive_active_params(self) -> int:
        """Active params of the trainable (adaptive) slice: last
        n_adaptive_layers + head (FedSTIL split)."""
        per_layer = (self.active_params()
                     - 2 * self.padded_vocab() * self.d_model) / max(self.n_layers, 1)
        head = self.padded_vocab() * self.d_model
        return int(self.n_adaptive_layers * per_layer + head)

    tied_embeddings: bool = False

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: 2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=d,
            n_heads=heads,
            n_kv_heads=max(1, kv if kv <= heads else heads),
            head_dim=64 if self.head_dim else 0,
            d_ff=min(self.d_ff, 512),
            dense_ff=min(self.dense_ff, 512) if self.dense_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            rwkv_head_size=min(self.rwkv_head_size, 32) if self.rwkv_head_size else 0,
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            n_vision_tokens=min(self.n_vision_tokens, 8) if self.n_vision_tokens else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            param_dtype="float32",
            compute_dtype="float32",
            fsdp=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Sliding-window size used for long_500k decode on full-attention families.
LONG_CONTEXT_WINDOW = 8192
