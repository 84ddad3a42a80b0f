"""Edge-scale ReID model: frozen extraction layers + the adaptive head,
batched over clients.

The port of ``repro/core/edge_model.py``. The extraction layers ``G``
(Eq. 1) are a frozen two-layer tanh trunk shared by every client. A
stacked head is a dict of ``(C, ...)`` tensors under the keys of the JAX
``theta`` pytree, flattened with dots: ``l1.w`` (C, proto_dim, hidden),
``l1.b`` (C, hidden), ``l2.w`` (C, hidden, feat_dim), ``l2.b`` (C,
feat_dim), ``bn.scale`` / ``bn.bias`` (C, feat_dim) and ``head.w`` (C,
feat_dim, n_classes). The client axis is written out: every product is a
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


def init_extraction(cfg: EdgeModelConfig,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The frozen trunk ``{"w1": (img_dim, proto_dim), "w2": (proto_dim,
    proto_dim)}``, drawn from ``generator`` with the reference's scales."""
    dev = generator.device
    return {
        "w1": torch.randn((cfg.img_dim, cfg.proto_dim), generator=generator,
                          device=dev) / math.sqrt(cfg.img_dim),
        "w2": torch.randn((cfg.proto_dim, cfg.proto_dim), generator=generator,
                          device=dev) / math.sqrt(cfg.proto_dim),
    }


def extract_prototypes(g_params, images: torch.Tensor) -> torch.Tensor:
    """Eq. (1): P = G(X). images (..., img_dim) -> (..., proto_dim)."""
    h = torch.tanh(images @ g_params["w1"])
    return torch.tanh(h @ g_params["w2"])


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


def adaptive_layers_meta(cfg: EdgeModelConfig, n: int) -> Theta:
    """``n`` stacked heads' shapes and dtypes on the meta device, no data
    (the analysis registry's abstract inputs)."""
    one = init_adaptive_layers(cfg, torch.Generator().manual_seed(0))
    return {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                           device="meta") for k, v in one.items()}


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


def adaptive_forward(theta: Theta, protos):
    """(C, N, D) prototypes -> (features, logits), BN statistics over each
    client's whole batch."""
    return adaptive_forward_masked(theta, protos, protos.new_ones(
        protos.shape[:2]))


def adaptive_features_sets(theta: Theta, protos) -> torch.Tensor:
    """Features of T separate batches per client: (C, T, Q, D) -> (C, T, Q,
    feat_dim), each (c, t) set its own BN batch (the reference vmaps
    ``adaptive_forward`` over the sets)."""
    C, T, Q, D = protos.shape
    f = adaptive_pre_bn(theta, protos.reshape(C, T * Q, D)).reshape(
        C * T, Q, -1)
    mu, sd = adaptive_bn_stats(f, f.new_ones((C * T, Q)))
    fn = ((f - mu[:, None]) / sd[:, None]).reshape(C, T, Q, -1)
    return (fn * theta["bn.scale"][:, None, None]
            + theta["bn.bias"][:, None, None])


def ce_loss(theta: Theta, protos, labels) -> torch.Tensor:
    """Per-client cross-entropy: protos (C, B, D), labels (C, B) int64 ->
    (C,) mean negative log-likelihood of each client's batch."""
    _, logits = adaptive_forward(theta, protos)
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, 2, labels[:, :, None])[..., 0], 1)
