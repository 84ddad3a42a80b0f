"""Traffic kind ``decode``: greedy decoding through the port's
``repro_torch.models.lm.decode_step`` as ``launch/serve_lm.serve`` loops
it (each step's token fed back on the device), every step's tokens read
back to the host as a streaming server sends them.

The KV cache is filled from the seed up to position ``prompt`` (the
prompt every request continues: input data, the same for both sides).
A request is a row's first token, drawn from the seed, decoded from
position ``prompt`` until the cache's last slot; the next request starts
again at ``prompt``, so every step attends between ``prompt`` + 1 and
``slots`` positions, however fast the steps are.

``correct`` judges the served tokens: the requests checked are the first
of the window (the longest, whether or not it finished) and one more
finished request drawn from the seed, every row and every token of them;
for each served token the reference, fed the same first token and served
tokens after the cached prompt, gives its logits, and the number is the
widest gap by which a served token's logit lies below the reference's
best.
"""
from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from bench import arith, inputs
from bench.drivers.lm_port import port_config, port_params
from bench.reference import dense_lm as REF
from repro_torch.models import lm


def _cache_tensors(arch, batch: int, slots: int, device):
    """The stacked (layers, batch, slots, kv heads, hd) keys and values in
    the config's dtype (as ``serve_lm`` keeps its cache), filled by
    ``inputs.fill_cache`` keys first."""
    shape = (arch.layers, batch, slots, arch.kv_heads, arch.hd)
    return [torch.empty(shape, dtype=arch.dtype, device=device)
            for _ in range(2)]


class Driver:
    def __init__(self, run):
        self.run = run
        self.arch = REF.Arch(run.conf)
        t, a, dev = run.traffic, self.arch, run.device
        self.batch, self.slots, self.prompt = t["batch"], t["slots"], \
            t["prompt"]
        self.cfg = port_config(run.conf, a)
        w = inputs.make_weights(a, run.seed, dev)
        self.weight_bytes = sum(v.numel() * v.element_size()
                                for k, v in w.items() if k != "embed")
        self.params = port_params(a, w)
        K, V = _cache_tensors(a, self.batch, self.slots, dev)
        inputs.fill_cache([K, V], run.seed)
        lo = a.layers - a.adaptive
        self.cache = {"trunk": {"k": K[:lo], "v": V[:lo]},
                      "adaptive": {"k": K[lo:], "v": V[lo:]}}
        self.first = inputs.make_request_tokens(run.seed, t["requests"],
                                                self.batch, a.vocab, dev)
        self._start(0)
        for _ in range(t["warmup_steps"]):
            self._one()
        self._start(0)
        self.served: List[List[np.ndarray]] = [[]]
        self.positions: List[int] = []

    def _start(self, r: int) -> None:
        self.request, self.pos = r, self.prompt
        self.tok = self.first[r % len(self.first)]

    def _one(self) -> np.ndarray:
        with self.run.spans("bench.decode_step"):
            nxt, self.cache = lm.decode_step(self.cfg, self.params,
                                             self.cache, self.tok, self.pos)
        with self.run.spans("bench.readback"):
            host = nxt.cpu().numpy()[:, 0]
        self.tok = nxt
        return host

    # -- the window ----------------------------------------------------------

    def step(self):
        """One decode step -> (tokens served, tokens out of the vocab)."""
        self.positions.append(self.pos)
        host = self._one()
        self.served[-1].append(host)
        self.pos += 1
        if self.pos == self.slots:
            self._start(self.request + 1)
            self.served.append([])
        bad = int(np.sum((host < 0) | (host >= self.arch.vocab)))
        return len(host), bad

    def counters(self) -> Dict[str, int]:
        return {}

    def end_to_end(self, t0: float, stamps) -> Dict[str, float]:
        gaps = np.diff(np.asarray([t0] + list(stamps)))
        return {"decode_tokens_per_s":
                self.batch * len(stamps) / (stamps[-1] - t0),
                "decode_gap_p95_ms": float(np.percentile(gaps, 95)) * 1e3}

    def work(self) -> Dict:
        a = self.arch
        valid = [p + 1 for p in self.positions]
        return {"flops": [arith.decode_step_flops(a, self.batch, v)
                          for v in valid],
                "bytes": [arith.decode_step_bytes(a, self.batch, v,
                                                  self.weight_bytes)
                          for v in valid]}

    # -- the check -------------------------------------------------------------

    def free(self) -> None:
        del self.params, self.cache, self.tok, self.first

    def _checked(self) -> List[int]:
        finished = [r for r in range(1, len(self.served))
                    if len(self.served[r]) == self.slots - self.prompt]
        picked = [0]
        if finished:
            picked.append(random.Random(self.run.seed).choice(finished))
        return [r for r in picked if self.served[r]]

    def _gaps(self, controls: bool):
        """Per checked row: (the widest gap of a served token, and with
        ``controls`` the widest gap of the token the fp8 reference puts
        first)."""
        run, a = self.run, self.arch
        w = inputs.make_weights(a, run.seed, run.device)
        K, V = _cache_tensors(a, self.batch, self.slots, run.device)
        inputs.fill_cache([K, V], run.seed)
        first = inputs.make_request_tokens(run.seed, run.traffic["requests"],
                                           self.batch, a.vocab, run.device)
        served_gap, control_gap, n = 0.0, 0.0, 0
        for r in self._checked():
            out = torch.as_tensor(np.stack(self.served[r], 1),
                                  device=run.device).long()     # (B, T)
            for b in range(self.batch):
                fed = torch.cat([first[r % len(first), b].long(),
                                 out[b, :-1]])
                ref = REF.logits_after_cache(a, w, K[:, b], V[:, b],
                                             self.prompt, fed)
                best = ref.amax(-1)
                ok = (out[b] >= 0) & (out[b] < a.vocab)
                got = ref.gather(1, out[b].clamp(0, a.vocab - 1)[:, None])
                gap = torch.where(ok, best - got[:, 0], float("inf"))
                served_gap = max(served_gap, float(gap.max()))
                n += out.shape[1]
                if controls:
                    low = REF.logits_after_cache(a, w, K[:, b], V[:, b],
                                                 self.prompt, fed, "fp8")
                    pick = low.argmax(-1, keepdim=True)
                    control_gap = max(control_gap, float(
                        (best - ref.gather(1, pick)[:, 0]).max()))
                    del low
                del ref
        return served_gap, control_gap, n

    def check(self):
        gap, _, n = self._gaps(False)
        return {"token_gap": gap}, {"tokens_compared": n}

    def controls(self):
        _, control, _ = self._gaps(True)
        return {"fp8": {"token_gap": control}}
