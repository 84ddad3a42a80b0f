"""Deterministic, host-sharded streaming loader with background prefetch.

Production substrate for the training drivers: every host in a multi-host
launch pulls only its shard of the global batch (deterministic from
(seed, step, host_id) — no coordination traffic), with a double-buffered
prefetch thread so host-side generation overlaps device compute.
The port's numpy copy of ``repro/data/loader.py`` over its own
``data/tokens.py``: the same batches for every (seed, step, host).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.data.tokens import synthetic_lm_batch


@dataclasses.dataclass
class LoaderConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    host_id: int = 0
    n_hosts: int = 1
    seed: int = 0
    prefetch: int = 2


class TokenStream:
    """Deterministic per-host shard of the synthetic LM stream.

    Batch for step s on host h is a pure function of (seed, s, h): restarts
    and elastic re-sharding reproduce the exact same data order.
    """

    def __init__(self, cfg: LoaderConfig,
                 batch_fn: Optional[Callable] = None):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._batch_fn = batch_fn or synthetic_lm_batch

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 64 + self.cfg.host_id)
        return self._batch_fn(rng, self.local_batch, self.cfg.seq_len,
                              self.cfg.vocab_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchLoader:
    """Double-buffered background prefetch around any batch iterator."""

    def __init__(self, stream, prefetch: int = 2):
        self._it = iter(stream)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
