"""Lifelong-learning baselines (paper Table II, local-only methods).

The port of ``repro/lifelong/strategies.py``:

  * STL: plain local training; both engines.
  * EWC   [Kirkpatrick+ 17]: a diagonal-Fisher penalty on the movement away
    from the last task's head.
  * MAS   [Aljundi+ 18]: the same penalty, with the importance |d ||f(x)||^2
    / d theta| in place of the Fisher.
  * iCaRL [Rebuffi+ 17]: rehearsal of raw-image exemplars chosen by
    nearest mean, re-encoded by the extraction layers every round.

Nothing is exchanged (comm 0). EWC, MAS and iCaRL run on the host engine
only, as in the reference. Importances are taken per client, in chunks of
8 prototypes (``federated.base.chunk_grads``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import (device_of, tree_bytes, tree_leaves,
                                       tree_map)
from repro_torch.core import edge_model as EM
from repro_torch.federated.base import (Strategy, chunk_grads, client_sum,
                                        fisher_diag, forward_one, tree_copy)


class STL(Strategy):
    name = "stl"
    # pure local minibatch training: batches cleanly over clients
    supports_stacked = True


class EWC(Strategy):
    name = "ewc"

    def __init__(self, cfg, *, lam=0.1, **kw):
        super().__init__(cfg, **kw)
        self.lam = lam

    def init_client(self, theta0):
        st = super().init_client(theta0)
        st.extras["reg_fisher"] = tree_map(torch.zeros_like, st.theta)
        st.extras["reg_anchor"] = tree_copy(st.theta)
        return st

    def regularizer(self, trainable, extras):
        pen = sum(
            client_sum(f * torch.square(t - a))
            for f, t, a in zip(tree_leaves(extras["reg_fisher"]),
                               tree_leaves(trainable),
                               tree_leaves(extras["reg_anchor"])))
        return 0.5 * self.lam * pen

    def _importance(self, theta, protos, labels):
        """The diagonal Fisher, E[grad log p(y|x)^2] over chunks of 8."""
        return fisher_diag(theta, protos, labels)

    def local_train(self, client, state, protos, labels, rnd, *,
                    consolidate=False, **_):
        state, _ = self._run_epochs(state, protos, labels)
        if consolidate:
            # at a task's end only; the decayed sum keeps the penalty
            # bounded over many tasks
            n = min(len(protos), 64)
            f_new = self._importance(state.theta, protos[:n], labels[:n])
            state.extras["reg_fisher"] = tree_map(
                lambda old, new: 0.5 * old + new,
                state.extras["reg_fisher"], f_new)
            state.extras["reg_anchor"] = state.theta
        return state, None

    def storage_bytes(self, state):
        return (tree_bytes(state.theta)
                + tree_bytes(state.extras["reg_fisher"])
                + tree_bytes(state.extras["reg_anchor"]))


def _out_norm(theta, x):
    """(C,) mean over each chunk of the squared logit norm."""
    _, logits = EM.adaptive_forward(theta, x)
    return torch.mean(torch.sum(torch.square(logits), -1), -1)


class MAS(EWC):
    name = "mas"

    def _importance(self, theta, protos, labels):
        """The chunk-mean sensitivity |d mean ||logits||^2 / d theta|."""
        g = chunk_grads(theta, _out_norm, protos)
        return tree_map(lambda gg: torch.mean(torch.abs(gg), 0), g)


class ICaRL(Strategy):
    """Raw-image exemplar rehearsal: the extraction layers re-encode the
    stored images every round (FedSTIL keeps prototypes instead)."""

    name = "icarl"

    def __init__(self, cfg, *, memory_size=2000, per_identity=8,
                 extractor=None, **kw):
        super().__init__(cfg, **kw)
        self.memory_size = memory_size
        self.per_identity = per_identity
        # (g_params, raw image tensor) -> prototypes: EM.extract_prototypes
        self.extractor = extractor

    def init_client(self, theta0):
        st = super().init_client(theta0)
        st.extras["mem_x"] = None      # raw images, numpy on the host
        st.extras["mem_y"] = None
        return st

    def _encode_memory(self, g_params, mem_x) -> np.ndarray:
        with torch.no_grad():
            x = torch.from_numpy(mem_x).to(device_of(g_params))
            return self.extractor(g_params, x).cpu().numpy()

    def local_train(self, client, state, protos, labels, rnd,
                    raw_images=None, g_params=None, **_):
        rehearsal = None
        if state.extras["mem_x"] is not None and self.extractor is not None:
            rehearsal = (self._encode_memory(g_params, state.extras["mem_x"]),
                         state.extras["mem_y"])
        state, _ = self._run_epochs(state, protos, labels, rehearsal)

        # nearest-mean exemplar selection on raw images; then the trim, in
        # the reference's order of draws from self.rng
        if raw_images is not None:
            feats = forward_one(state.theta, protos)
            keep = []
            for ident in np.unique(labels):
                idx = np.nonzero(labels == ident)[0]
                center = feats[idx].mean(0)
                d = np.linalg.norm(feats[idx] - center, axis=1)
                keep.extend(idx[np.argsort(d)[: self.per_identity]].tolist())
            keep = np.asarray(keep, np.int64)
            nx, ny = raw_images[keep], labels[keep]
            if state.extras["mem_x"] is None:
                state.extras["mem_x"], state.extras["mem_y"] = nx, ny
            else:
                state.extras["mem_x"] = np.concatenate(
                    [state.extras["mem_x"], nx])
                state.extras["mem_y"] = np.concatenate(
                    [state.extras["mem_y"], ny])
            if len(state.extras["mem_x"]) > self.memory_size:
                sel = self.rng.choice(len(state.extras["mem_x"]),
                                      self.memory_size, replace=False)
                state.extras["mem_x"] = state.extras["mem_x"][sel]
                state.extras["mem_y"] = state.extras["mem_y"][sel]
        return state, None

    def storage_bytes(self, state):
        extra = 0
        if state.extras["mem_x"] is not None:
            extra = state.extras["mem_x"].nbytes + state.extras["mem_y"].nbytes
        return tree_bytes(state.theta) + extra
