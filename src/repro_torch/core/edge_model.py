"""Edge-scale ReID model: the adaptive head, batched over clients.

The port of ``repro/core/edge_model.py``'s adaptive layers. A stacked head
is a dict of ``(C, ...)`` tensors under the keys of the JAX ``theta``
pytree, flattened with dots: ``l1.w`` (C, proto_dim, hidden), ``l1.b``
(C, hidden), ``l2.w`` (C, hidden, feat_dim), ``l2.b`` (C, feat_dim),
``bn.scale`` / ``bn.bias`` (C, feat_dim) and ``head.w`` (C, feat_dim,
n_classes). The client axis is written out: every product is a
``torch.bmm`` over ``(C, N, .)`` batches where the reference vmaps.

BN is the paper's masked BN, not ``torch.nn.BatchNorm``: statistics over
``mask``-valid rows only, ``sd = sqrt(masked var) + 1e-5``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import torch

Theta = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EdgeModelConfig:
    img_dim: int = 256         # stub "image" dimensionality (synthetic data)
    proto_dim: int = 128       # prototype size (extraction-layer output)
    hidden: int = 128          # adaptive-layer hidden
    feat_dim: int = 64         # retrieval feature size
    n_classes: int = 512       # global identity space


def init_adaptive_layers(cfg: EdgeModelConfig,
                         generator: torch.Generator) -> Theta:
    """One client's head, drawn from ``generator`` on its device with the
    reference's scales (the numbers differ from ``jax.random``'s)."""
    dev = generator.device

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    zeros = lambda n: torch.zeros(n, device=dev)
    return {
        "l1.w": normal(cfg.proto_dim, cfg.hidden,
                       scale=1.0 / math.sqrt(cfg.proto_dim)),
        "l1.b": zeros(cfg.hidden),
        "l2.w": normal(cfg.hidden, cfg.feat_dim,
                       scale=1.0 / math.sqrt(cfg.hidden)),
        "l2.b": zeros(cfg.feat_dim),
        "bn.scale": torch.ones(cfg.feat_dim, device=dev),
        "bn.bias": zeros(cfg.feat_dim),
        # bias-free classifier (paper: "bias of the classifier is removed")
        "head.w": normal(cfg.feat_dim, cfg.n_classes,
                         scale=1.0 / math.sqrt(cfg.feat_dim)),
    }


def stack_heads(heads: Sequence[Theta], device) -> Theta:
    """Per-client heads -> one stacked head on ``device``."""
    return {k: torch.stack([h[k] for h in heads]).to(device)
            for k in heads[0]}


def adaptive_pre_bn(theta: Theta, protos: torch.Tensor) -> torch.Tensor:
    """The head up to (not including) BN: (C, N, D) -> (C, N, feat_dim)."""
    h = torch.relu(torch.bmm(protos, theta["l1.w"]) + theta["l1.b"][:, None])
    return torch.bmm(h, theta["l2.w"]) + theta["l2.b"][:, None]


def adaptive_bn_stats(f: torch.Tensor, mask: torch.Tensor):
    """Masked BN statistics: f (C, N, F), mask (C, N) 1.0 = valid ->
    (mu, sd), each (C, F). Padded rows contribute nothing."""
    m = mask.to(f.dtype)[:, :, None]
    n = torch.clamp(torch.sum(m, 1), min=1.0)                   # (C, 1)
    mu = torch.sum(f * m, 1) / n
    sd = torch.sqrt(torch.sum(torch.square(f - mu[:, None]) * m, 1) / n) + 1e-5
    return mu, sd


def adaptive_bn_apply(theta: Theta, f, mu, sd) -> torch.Tensor:
    """BN affine with the given statistics: (C, N, F) -> features."""
    return ((f - mu[:, None]) / sd[:, None] * theta["bn.scale"][:, None]
            + theta["bn.bias"][:, None])


def adaptive_forward_masked(theta: Theta, protos, mask):
    """(C, N, D) prototypes over a padded batch -> (features, logits), BN
    statistics over ``mask``-valid rows only."""
    f = adaptive_pre_bn(theta, protos)
    mu, sd = adaptive_bn_stats(f, mask)
    fn = adaptive_bn_apply(theta, f, mu, sd)
    return fn, torch.bmm(fn, theta["head.w"])


def adaptive_forward_frozen(theta: Theta, protos, mu, sd) -> torch.Tensor:
    """The serving forward: BN with FROZEN (C, F) statistics taken over each
    client's gallery at index refresh, so a query's feature does not depend
    on the batch it rides in. Features only."""
    return adaptive_bn_apply(theta, adaptive_pre_bn(theta, protos), mu, sd)
