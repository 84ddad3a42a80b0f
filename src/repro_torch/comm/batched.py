"""Device-resident batched wire codec for the stacked engine.

The port of ``repro/comm/batched.py``. ``BatchedCodec`` runs the host
``PipelineCodec``'s stage stack (delta -> grouped topk -> {int8|bf16}) over
ALL C clients' flattened (C, P) payload rows at once, on the device that
holds them: a sparse payload's sparsify and index stages are one
``kernels.ops.batched_topk_encode`` (grouped top-k pack and index
bit-pack) and one ``batched_topk_decode`` (bit-unpack and unpack), the
quantize stage ``batched_quantize`` per chunk; an int8 sparse payload
decodes in one ``batched_topk_decode_int8`` (dequantize, bit-unpack and
unpack), a dense one in ``batched_dequantize`` (CUDA kernels for CUDA
tensors, one launch each, the plain versions for CPU tensors); bf16 is a
cast to ``torch.bfloat16`` and back. Encoded
buffers stay on the device; the measured per-client wire bytes follow from
the buffer shapes, so a simulated round reads nothing back. The encode's
per-row telemetry (residual norm, kept energy, keep rate) is computed only
while an ``obs`` tracer is active, as the reference reads it back only then.

Stage semantics are the host codec's (same top-k tie rule, same bit-plane
layout, bf16 rounded to nearest even), with one difference the reference
has too: the int8 scale is ``absmax * fl32(1/127)`` here, as the compiled
kernel computes it, and a true division in the host codec. The reference's
``jax.jit`` programs become plain eager methods.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm.codec import PipelineCodec
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs

Buffers = Dict[str, torch.Tensor]


class BatchedCodec:
    """One direction's (C, P) encode / decode program, built from the host
    codec's stage parameters. Stateful only when delta is on (the encoder
    and decoder references live on the device)."""

    def __init__(self, like: PipelineCodec, p: int):
        if like.topk and like.group is None:
            raise ValueError(
                "BatchedCodec needs the grouped top-k stage (group=N); "
                "explicit-k global top-k is a host-codec-only mode")
        self.delta = like.delta
        self.topk = like.topk
        self.quant = like.quant
        self.chunk = like.chunk
        self.group = like.group
        self.kg = like.kg
        self.p = int(p)
        self.k = like.k_for(self.p) if like.topk else None
        self._enc_ref: Optional[torch.Tensor] = None
        self._dec_ref: Optional[torch.Tensor] = None
        # the last encode's per-row telemetry, on the device (never read
        # back here); computed only while a tracer is active, else None
        self.last_metrics: Optional[Dict[str, torch.Tensor]] = None

    # ---- stages --------------------------------------------------------------
    def _quant(self, vals, buffers: Buffers) -> Buffers:
        if self.quant == "int8":
            q, scales = ops.batched_quantize(vals, chunk=self.chunk)
            buffers["values"] = q
            buffers["scales"] = scales
        elif self.quant == "bf16":
            buffers["values"] = vals.to(torch.bfloat16)
        else:
            buffers["values"] = vals
        return buffers

    def _dequant(self, buffers: Buffers) -> torch.Tensor:
        v = buffers["values"]
        if self.quant == "int8":
            return ops.batched_dequantize(v, buffers["scales"],
                                          chunk=self.chunk)
        return v.float()

    def _enc_metrics(self, x, vals) -> Dict[str, torch.Tensor]:
        """Per-row residual norm (decoder-reference staleness), the share of
        residual energy the wire kept, and the effective keep rate."""
        r2 = torch.sum(torch.square(x), dim=1)
        k2 = torch.sum(torch.square(vals), dim=1)
        return {"residual_norm": torch.sqrt(r2),
                "kept_energy": k2 / torch.clamp(r2, min=1e-12),
                "keep_rate": torch.sum(vals != 0, dim=1) / self.p}

    def _enc_sparse(self, x) -> Tuple[Buffers, torch.Tensor]:
        """(buffers, the kept values) of a sparse payload."""
        vals, packed = ops.batched_topk_encode(x, group=self.group,
                                               kg=self.kg)
        return self._quant(vals, {"idx_bits": packed}), vals

    def _enc_dense(self, x) -> Tuple[Buffers, torch.Tensor]:
        x = x.float()
        return self._quant(x, {}), x

    def _dec(self, buffers: Buffers) -> torch.Tensor:
        if "idx_bits" not in buffers:
            return self._dequant(buffers)
        kw = dict(k=self.k, p=self.p, group=self.group, kg=self.kg)
        if self.quant == "int8":
            return ops.batched_topk_decode_int8(
                buffers["values"], buffers["scales"], buffers["idx_bits"],
                chunk=self.chunk, **kw)
        return ops.batched_topk_decode(self._dequant(buffers),
                                       buffers["idx_bits"], **kw)

    # ---- wire ----------------------------------------------------------------
    def _encode_residual(self, x):
        """Apply the keyframe rule and encode; advances NO state. Returns
        (buffers, delta reference or None). Under a tracer the encode's
        telemetry goes to ``last_metrics``; untraced it is None and no
        metric is launched."""
        ref = None
        if self.delta:
            keyframe = self._enc_ref is None
            ref = torch.zeros_like(x) if keyframe else self._enc_ref
            x = x - ref
            sparse = self.topk and not keyframe
        else:
            sparse = self.topk
        buffers, kept = self._enc_sparse(x) if sparse else self._enc_dense(x)
        self.last_metrics = (self._enc_metrics(x, kept) if obs.is_active()
                             else None)
        return buffers, ref

    def encode(self, mat) -> Buffers:
        """(C, P) stacked payload rows -> dict of device wire buffers. A
        delta stream's first payload ships dense (quantized only) to
        establish the reference; every later payload is a sparse
        residual."""
        buffers, ref = self._encode_residual(mat.float())
        if self.delta:
            self._enc_ref = ref + self._dec(buffers)
        return buffers

    def decode(self, buffers: Buffers) -> torch.Tensor:
        """Wire buffers -> reconstructed (C, P) fp32 rows."""
        x = self._dec(buffers)
        if self.delta:
            x = x if self._dec_ref is None else self._dec_ref + x
            self._dec_ref = x
        return x

    def roundtrip(self, mat):
        """encode + decode in one pass: (reconstruction, buffers). The
        encoder's error-feedback reference IS the decoder's reconstruction,
        so the unpack runs once a round; both references advance exactly as
        separate encode() / decode() calls would."""
        buffers, ref = self._encode_residual(mat.float())
        recon = self._dec(buffers)
        if self.delta:
            recon = ref + recon
            self._enc_ref = recon
            self._dec_ref = recon
        return recon, buffers

    # ---- accounting ----------------------------------------------------------
    @staticmethod
    def per_client_bytes(buffers: Buffers) -> int:
        """Measured wire bytes per client (row), from the buffer shapes."""
        return sum(math.prod(b.shape[1:]) * b.element_size()
                   for b in buffers.values())
