"""Device-resident per-client gallery index for online ReID retrieval
(the port of ``repro/serving/index.py``, flat int8 / fp32 image).

Layout (leading axis C = clients, fixed capacity G rows per client):

  host side (the cloud's copy, never re-extracted):
    gp         (C, G, proto_dim) fp32   gallery prototypes (Eq. 1 outputs)
    gids_host  (C, G) int32             person ids, -1 = empty slot
  device side (rebuilt by ``refresh`` when a federated round lands a new
  adaptive head; prototypes are reused, only the head math reruns):
    gq         (C, G, feat_dim) int8    quantized L2-normalized features
    gscale     (C, G) fp32              per-row symmetric scale (absmax/127)
    gn2        (C, G) fp32              |dequant(row)|^2
    gids       (C, G) int32             device copy of gids_host
    bn_mu/sd   (C, feat_dim) fp32       BN statistics frozen over each
                                        client's valid gallery rows
    gf         (C, G, feat_dim) fp32    exact rows, kept only with
                                        ``keep_fp32=True``

The prototypes also stay on the device (``extend`` writes new rows to both
copies), so a head swap moves no prototype bytes across PCIe.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.core import edge_model as EM
from repro_torch.core.convert import theta_numpy
from repro_torch.kernels import ops

_EPS = 1e-12


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(torch.sum(torch.square(x), -1,
                                                keepdim=True), min=_EPS))


def index_features(theta, gp, gmask):
    """The head over the cached prototypes: (C, G, proto_dim) + (C, G)
    validity -> (L2-normalized features with empty rows zeroed, BN mu, sd)."""
    f = EM.adaptive_pre_bn(theta, gp)
    mu, sd = EM.adaptive_bn_stats(f, gmask)
    fn = EM.adaptive_bn_apply(theta, f, mu, sd)
    return l2n(fn) * gmask[..., None], mu, sd


def index_refresh(theta, gp, gmask):
    """Rebuild the resident image under a stacked head -> (int8 codes,
    per-row scales, dequantized squared norms, BN mu, BN sd, fp32 rows).

    Features are L2-normalized before quantization so every row shares the
    same dynamic range; empty slots are zeroed (scale 1, norm 0)."""
    fn, mu, sd = index_features(theta, gp, gmask)
    C, G, F = fn.shape
    q8, scales = ops.batched_quantize(fn.reshape(C, G * F), chunk=F)
    gq = q8.reshape(C, G, F)
    gn2 = torch.sum(torch.square(gq.float()), -1) * torch.square(scales)
    return gq, scales, gn2, mu, sd, fn


def refresh_host(theta, gp, gmask):
    """Numpy oracle for ``index_refresh``: identical head math, masked BN
    statistics, L2 normalization, and per-row symmetric int8 quantization
    (round half to even, clip to ±127, scale 1.0 for empty rows)."""
    t = theta_numpy(theta)
    gp = np.asarray(gp, np.float32)
    gmask = np.asarray(gmask, np.float32)
    C = gp.shape[0]
    out_q, out_s, out_n2, out_mu, out_sd, out_f = [], [], [], [], [], []
    for c in range(C):
        h = np.maximum(gp[c] @ t["l1.w"][c] + t["l1.b"][c], 0.0)
        f = h @ t["l2.w"][c] + t["l2.b"][c]
        m = gmask[c][:, None]
        n = max(float(gmask[c].sum()), 1.0)
        mu = (f * m).sum(0) / n
        sd = np.sqrt((np.square(f - mu[None, :]) * m).sum(0) / n) + 1e-5
        fn = (f - mu) / sd * t["bn.scale"][c] + t["bn.bias"][c]
        fn = fn / np.sqrt(np.maximum(np.sum(np.square(fn), -1,
                                            keepdims=True), _EPS))
        fn = (fn * m).astype(np.float32)
        scale = np.abs(fn).max(-1) / 127.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.round(fn / scale[:, None]), -127, 127).astype(np.int8)
        n2 = (np.square(q.astype(np.float32)).sum(-1)
              * np.square(scale)).astype(np.float32)
        out_q.append(q)
        out_s.append(scale)
        out_n2.append(n2)
        out_mu.append(mu.astype(np.float32))
        out_sd.append(sd.astype(np.float32))
        out_f.append(fn)
    return (np.stack(out_q), np.stack(out_s), np.stack(out_n2),
            np.stack(out_mu), np.stack(out_sd), np.stack(out_f))


class GalleryIndex:
    """Fixed-capacity per-client gallery with a device-resident int8 image.

    Host arrays are the source of truth (``extend`` appends rows there and
    to the device copy of the prototypes); the queryable image is rebuilt
    by ``refresh(theta_stacked)`` — one pass per head swap, no prototype
    re-extraction. ``device`` defaults to the card and raises without one.
    """

    def __init__(self, protos: Sequence[np.ndarray], ids: Sequence[np.ndarray],
                 *, capacity: Optional[int] = None, keep_fp32: bool = True,
                 nlist=0, device="cuda"):
        if nlist:
            raise NotImplementedError(
                "IVF (nlist > 0) is not ported yet: it comes with the IVF "
                "serving slice (batched_cluster_dist, "
                "batched_ivf_shortlist_scores, balanced-Lloyd refresh)")
        C = len(protos)
        if C == 0:
            raise ValueError("need at least one client")
        self.device = resolve_device(device)
        counts = [len(p) for p in protos]
        G = capacity if capacity is not None else max(max(counts), 1)
        if max(counts) > G:
            raise ValueError(f"capacity {G} < largest client gallery "
                             f"{max(counts)}")
        Dp = int(np.asarray(protos[0]).shape[-1])
        self.keep_fp32 = keep_fp32
        self.gp = np.zeros((C, G, Dp), np.float32)
        self.gids_host = np.full((C, G), -1, np.int32)
        self._fill = np.zeros((C,), np.int64)
        for c, (p, y) in enumerate(zip(protos, ids)):
            n = len(p)
            self.gp[c, :n] = np.asarray(p, np.float32)
            self.gids_host[c, :n] = np.asarray(y, np.int32)
            self._fill[c] = n
        self.gp_dev = torch.tensor(self.gp, device=self.device)   # a copy
        # device image — populated by refresh()
        self.gq = self.gscale = self.gn2 = None
        self.bn_mu = self.bn_sd = self.gids = self.gf = None

    @property
    def n_clients(self) -> int:
        return self.gp.shape[0]

    @property
    def capacity(self) -> int:
        return self.gp.shape[1]

    @property
    def fill(self) -> List[int]:
        return [int(n) for n in self._fill]

    def resident_bytes(self, mode: str = "int8") -> int:
        """Device bytes of the queryable image (all C clients): int8 =
        codes + scale + norm + ids; fp32 = rows + ids."""
        C, G = self.gids_host.shape
        F = EM.EdgeModelConfig().feat_dim
        if mode == "int8":
            return C * G * (F + 4 + 4 + 4)
        if mode == "fp32":
            return C * G * (4 * F + 4)
        raise ValueError(f"unknown image mode {mode!r}")

    def extend(self, client: int, protos: np.ndarray, ids: np.ndarray):
        """Append gallery rows for one client (the next ``refresh`` lands
        them in the image). Raises when capacity is hit — capacity is a
        fixed-shape contract, not a ring buffer."""
        n0 = int(self._fill[client])
        n = len(protos)
        if n0 + n > self.capacity:
            raise ValueError(f"client {client}: {n0}+{n} rows exceed "
                             f"capacity {self.capacity}")
        self.gp[client, n0:n0 + n] = np.asarray(protos, np.float32)
        self.gids_host[client, n0:n0 + n] = np.asarray(ids, np.int32)
        self.gp_dev[client, n0:n0 + n] = torch.from_numpy(
            self.gp[client, n0:n0 + n]).to(self.device)
        self._fill[client] = n0 + n

    def refresh(self, theta_stacked):
        """Swap in a new stacked head: rerun the head math over the cached
        prototypes and replace the resident image."""
        self.gids = torch.tensor(self.gids_host, device=self.device)
        gmask = (self.gids >= 0).float()
        gq, gscale, gn2, mu, sd, gf = index_refresh(theta_stacked,
                                                    self.gp_dev, gmask)
        self.gq, self.gscale, self.gn2 = gq, gscale, gn2
        self.bn_mu, self.bn_sd = mu, sd
        self.gf = gf if self.keep_fp32 else None
        return self
