"""CUDA kernel wrappers of the IVF shortlist serving path
(``csrc/cluster_dist.cu`` and ``csrc/ivf_shortlist.cu``; replace
``repro/kernels/ivf.py:batched_cluster_dist`` and
``repro/kernels/ivf.py:batched_ivf_shortlist_scores``).

    cluster:    dist[c, b, l] = |q[c, b]|^2 + cn2[c, l] - 2 q[c, b] . cent[c, l]
    shortlist:  d[c, b, j, k] = n2 - 2 ((q[c, b] . code) s) over the slots k
                of bucket probe[c, b, j], plus the slots' row ids

Take CUDA tensors only; ``ops.batched_cluster_assign`` and
``ops.batched_ivf_shortlist`` send CPU tensors to the plain versions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pairwise_dist import VARIANTS, Plan, _aligned
from repro_torch.kernels.pairwise_dist import _plan as _dist_plan

_CDIST_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_SHORT_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def _cluster(qf, cent, cn2, plan: Plan):
    """Launch the cluster-distance kernel under ``plan``: (C, B, L)."""
    C, B, F = qf.shape
    L = cent.shape[1]
    dev = qf.device
    out = torch.empty((C, B, L), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = _build.kernel("cluster_dist", "repro_batched_cluster_dist",
                       _CDIST_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qf.data_ptr(), cent.data_ptr(), cn2.data_ptr(),
                out.data_ptr(), C, B, L, F, VARIANTS.index(plan.variant),
                stream)
    _build.raise_on_error("batched_cluster_dist", rc)
    return out


def batched_cluster_dist(qf, cent, cn2):
    """(C, B, F) fp32 queries x ((C, L, F) centroids, (C, L) their squared
    norms) -> (C, B, L) fp32 squared distances; the variant from
    ``pairwise_dist._plan`` in mode ``norms``."""
    if qf.dim() != 3 or cent.dim() != 3:
        raise ValueError(f"expected qf (C, B, F) and cent (C, L, F), got "
                         f"{tuple(qf.shape)} and {tuple(cent.shape)}")
    C, B, F = qf.shape
    L = cent.shape[1]
    dev = qf.device
    _build.check_operand("qf", qf, torch.float32, (C, B, F), dev)
    _build.check_operand("cent", cent, torch.float32, (C, L, F), dev)
    _build.check_operand("cn2", cn2, torch.float32, (C, L), dev)
    out = _cluster(qf, cent, cn2,
                   _dist_plan(C, B, L, F, "norms", _aligned(qf, cent)))
    if out.numel():
        batched_cluster_dist.launches += 1
    return out


batched_cluster_dist.launches = 0


def batched_ivf_shortlist_scores(qf, probe, bq, pack):
    """(C, B, F) fp32 queries + (C, B, P) int32 probe bucket ids against the
    bucket-major image ((C, L, K, F) int8 rows, (C, L, 3, K) fp32 sidecar)
    -> ((C, B, P, K) fp32 partial squared distances |g|^2 - 2 (q.code) s,
    (C, B, P, K) int32 row ids, -1 on empty slots)."""
    if qf.dim() != 3 or probe.dim() != 3 or bq.dim() != 4:
        raise ValueError(f"expected qf (C, B, F), probe (C, B, P) and bq "
                         f"(C, L, K, F), got {tuple(qf.shape)}, "
                         f"{tuple(probe.shape)} and {tuple(bq.shape)}")
    C, B, F = qf.shape
    P = probe.shape[2]
    L, K = bq.shape[1], bq.shape[2]
    dev = qf.device
    _build.check_operand("qf", qf, torch.float32, (C, B, F), dev)
    _build.check_operand("probe", probe, torch.int32, (C, B, P), dev)
    _build.check_operand("bq", bq, torch.int8, (C, L, K, F), dev)
    _build.check_operand("pack", pack, torch.float32, (C, L, 3, K), dev)
    if bq.data_ptr() % 16:
        raise ValueError("bq: the kernel reads 16-byte vectors and needs a "
                         "16-byte aligned base")
    d = torch.empty((C, B, P, K), dtype=torch.float32, device=dev)
    ids = torch.empty((C, B, P, K), dtype=torch.int32, device=dev)
    if d.numel() == 0:
        return d, ids
    fn = _build.kernel("ivf_shortlist", "repro_batched_ivf_shortlist_scores",
                       _SHORT_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qf.data_ptr(), probe.data_ptr(), bq.data_ptr(),
                pack.data_ptr(), d.data_ptr(), ids.data_ptr(), C, B, P, L, K,
                F, stream)
    _build.raise_on_error("batched_ivf_shortlist_scores", rc)
    batched_ivf_shortlist_scores.launches += 1
    return d, ids


batched_ivf_shortlist_scores.launches = 0
