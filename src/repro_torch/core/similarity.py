"""Task-similarity functions Π(·,·) over task features (paper Eq. 4).

The port of ``repro/core/similarity.py``. Task features are mean
prototypes (Eq. 3); each function maps a pair of features to a relevance
weight (higher = more relevant). ``pairwise_similarity`` is the all-pairs
(N, D) x (M, D) -> (N, M) form. KL goes through ``kernels.ops.kl_similarity``
(the CUDA kernel for CUDA tensors, its log-softmax plain version on the
CPU); cosine and euclidean are plain PyTorch. ``SIMILARITY_FNS`` holds the
per-pair forms the relevance tracker's loop oracle calls, KL with the
reference's 1e-12 inside its logs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def kl_similarity(a, b):
    """exp(-KL(a||b)) with softmax-normalised features, (..., D) each."""
    p, q = torch.softmax(a.float(), -1), torch.softmax(b.float(), -1)
    kl = torch.sum(p * (torch.log(p + 1e-12) - torch.log(q + 1e-12)), -1)
    return torch.exp(-kl)


def cosine_similarity(a, b):
    a, b = a.float(), b.float()
    num = torch.sum(a * b, -1)
    den = (torch.linalg.vector_norm(a, dim=-1)
           * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
    return 0.5 * (1.0 + num / den)


def euclidean_similarity(a, b):
    d = torch.linalg.vector_norm(a.float() - b.float(), dim=-1)
    return torch.exp(-d)


SIMILARITY_FNS = {
    "kl": kl_similarity,
    "cosine": cosine_similarity,
    "euclidean": euclidean_similarity,
}


def pairwise_similarity(feats_a, feats_b, metric: str = "kl"):
    """All-pairs similarity: (N, D) x (M, D) -> (N, M)."""
    if metric == "kl":
        return ops.kl_similarity(feats_a.float().contiguous(),
                                 feats_b.float().contiguous())
    return SIMILARITY_FNS[metric](feats_a[:, None, :], feats_b[None, :, :])
