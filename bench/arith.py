"""Operations and bytes the cells' work needs, from the shapes alone,
whatever implements it.

``train_step_flops`` and ``decode_step_flops`` copy the dense-model
branches of the port's first-principles model (the unsharded case of
``repro_torch.sharding.analytic.analytic_roofline``, which the port's
meta-tensor count matches on the card for the split step); a test holds
the copies equal to it at the cells' shapes. The split step counts the
frozen trunk's forward, the adaptive layers' forward and backward (x3)
and the head's forward, dW and dX (x3); not the trunk's backward (it
needs none) nor any recomputation. Causal attention counts the half of
the score matrix a query sees.
"""
from __future__ import annotations

from bench.inputs import padded_vocab


def _layer_fwd_flops(a, tokens: int, seq: int) -> float:
    """One dense layer's forward over ``tokens`` = batch x ``seq``."""
    d, hd, H, KV = a.d, a.hd, a.heads, a.kv_heads
    proj = 2 * tokens * d * (H * hd + 2 * KV * hd + H * hd)
    attn = 4 * (tokens // seq) * seq * seq * H * hd * 0.5
    mlp = 2 * tokens * d * (3 * a.ff)
    return proj + attn + mlp


def train_step_flops(a, batch: int, seq: int) -> float:
    """Model FLOPs of one FedSTIL split step (frozen trunk, ``a.adaptive``
    trained layers and the head)."""
    tokens = batch * seq
    per = _layer_fwd_flops(a, tokens, seq)
    trunk = per * (a.layers - a.adaptive)
    adaptive = 3.0 * per * a.adaptive
    head = 3 * 2 * tokens * a.d * padded_vocab(a.vocab)
    return trunk + adaptive + head


def matrix_params(a) -> int:
    """Weights a decode step multiplies by: every layer's projections and
    MLP, and the head (padded as the program keeps it)."""
    d, hd, H, KV = a.d, a.hd, a.heads, a.kv_heads
    per = d * (2 * H * hd + 2 * KV * hd) + 3 * d * a.ff
    return a.layers * per + d * padded_vocab(a.vocab)


def decode_step_flops(a, batch: int, valid: int) -> float:
    """One greedy decode step of ``batch`` rows, each attending ``valid``
    cache positions (the new token's included): 2 x the matrix weights x
    rows, plus attention's two products over the valid positions."""
    attn = 4 * batch * valid * a.heads * a.hd * a.layers
    return 2.0 * batch * matrix_params(a) + attn


def decode_step_bytes(a, batch: int, valid: int, weight_bytes: int) -> float:
    """Bytes a decode step must move: the weights it reads once (every
    leaf but the embedding table), the ``batch`` embedding rows, the valid
    positions' keys and values once each (bf16), and the new token's key
    and value written once."""
    kv_row = 2 * a.kv_heads * a.hd * 2          # k and v of one position
    cache = a.layers * batch * (valid + 1) * kv_row
    return weight_bytes + batch * a.d * 2 + cache


def flash_stage_flops(stage: str, batch: int, heads: int, seq: int,
                      hd: int) -> float:
    """Operations of one causal flash launch over (batch, heads, seq, hd)
    bf16: 4 hd per visible (query, key) pair for the forward (QK^T, PV), 6
    for dQ (S, dP, dQ), 8 for dK/dV (S, dP, dV, dK)."""
    pairs = seq * (seq + 1) / 2
    per_pair = {"fwd": 4, "fwd_lse": 4, "dq": 6, "dkv": 8}[stage]
    return per_pair * hd * pairs * batch * heads


def flash_stage_bytes(stage: str, batch: int, heads: int, kv_heads: int,
                      seq: int, hd: int) -> float:
    """Bytes of one flash launch: each bf16 operand read once, each output
    written once (fp32 lse and delta)."""
    q = batch * heads * seq * hd * 2
    kv = batch * kv_heads * seq * hd * 2
    rows = batch * heads * seq * 4
    return {"fwd": 2 * q + 2 * kv,
            "fwd_lse": 2 * q + 2 * kv + rows,
            "dq": 3 * q + 2 * kv + 2 * rows,
            "dkv": 2 * q + 4 * kv + 2 * rows}[stage]
