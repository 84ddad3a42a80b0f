"""Synthetic token streams for the assigned LM architectures (smoke tests,
examples, and the end-to-end ~100M-param training example).

A Zipf-ish unigram mixed with a deterministic n-gram structure so that a
model can actually reduce loss on it (the end-to-end example checks that
loss decreases).
The port's numpy copy of ``repro/data/tokens.py``: the same draws from the
same ``np.random.Generator``, so both packages train on identical batches.
"""
from __future__ import annotations

import numpy as np


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, structure: float = 0.8):
    """Returns (tokens, labels) = (B, S) next-token pairs."""
    # zipf-like marginal
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
    # inject structure: tok[t+1] = f(tok[t]) with probability `structure`
    f = (np.arange(vocab) * 31 + 7) % vocab
    for t in range(seq):
        use = rng.random(batch) < structure
        toks[use, t + 1] = f[toks[use, t]]
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
