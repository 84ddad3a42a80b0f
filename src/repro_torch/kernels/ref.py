"""Plain PyTorch versions of the port's kernels.

Same arithmetic, in the same expression order, as ``repro.kernels.ref``:
``x / scale`` is a division (not a multiply by the reciprocal), rounding is
``torch.round`` (half to even). The CPU tests run these against the JAX
package; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def batched_pairwise_dist_ref(q, g):
    """Per-client squared euclidean: (C,Q,D) x (C,G,D) -> (C,Q,G), fp32."""
    q = q.float()
    g = g.float()
    qq = torch.sum(q * q, -1)[:, :, None]
    gg = torch.sum(g * g, -1)[:, None, :]
    return qq + gg - 2.0 * torch.bmm(q, g.transpose(1, 2))


def batched_int8_pairwise_dist_ref(q, gq, gscale, gn2):
    """fp32 queries vs the int8 resident gallery: (C, B, F) x ((C, G, F)
    int8 codes, (C, G) per-row scales, (C, G) dequantized squared norms)
    -> (C, B, G) squared distances to the dequantized rows."""
    q = q.float()
    qq = torch.sum(q * q, -1)[:, :, None]
    dot = torch.bmm(q, gq.float().transpose(1, 2))
    return qq + gn2[:, None, :] - 2.0 * (dot * gscale[:, None, :])


def batched_quantize_ref(x, *, chunk: int = 256):
    """Per-chunk symmetric int8 quantization of stacked rows: (C, P) fp32
    -> ((C, P) int8, (C, ceil(P/chunk)) fp32 scales). Each chunk of
    ``chunk`` contiguous elements shares scale = absmax * fl32(1/127) (1.0
    for an all-zero chunk); round half to even, clip to [-127, 127]."""
    C, P = x.shape
    nc = (P + chunk - 1) // chunk
    xp = F.pad(x.float(), (0, nc * chunk - P))
    xc = xp.reshape(C, nc, chunk)
    absmax = torch.amax(torch.abs(xc), dim=2, keepdim=True)
    # the reference's `absmax / 127.0` is a multiply by the fp32 reciprocal
    # once compiled (XLA rewrites division by a constant; PyTorch's CUDA div
    # does the same for a scalar divisor), 1 ulp off IEEE division for a few
    # percent of chunks: write that product, so every version agrees bit
    # for bit
    scale = absmax * (1.0 / 127.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xc / scale), -127.0, 127.0).to(torch.int8)
    return q.reshape(C, nc * chunk)[:, :P].contiguous(), scale[..., 0]
