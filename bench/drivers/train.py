"""Traffic kind ``train``: the port's FedSTIL split step
(``repro_torch.train.trainer.make_train_step`` with ``launch/train.py``'s
Adam, cosine schedule and tying weight) in a closed loop, each step's
loss read back to the host as the launcher reads it.

Set-up builds one train state from the seeded weights and drives it
through the traffic's first steps (batches 0, 1, 2 of the pool), through
the same call the window makes; the window then continues that same
state, cycling the pool. The first steps are what ``correct`` judges:
each step's loss, the first clipped gradient as Adam's state holds it
after one step (m / (1 - b1)): each leaf's norm and its values at
seeded elements; and each trained leaf's change after the last of them,
against the plain reference's.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from bench import arith, inputs
from bench.drivers.lm_port import port_config, port_params, reference_leaf
from bench.reference import dense_lm as REF
from repro_torch.common.pytree import leaf_paths, tree_leaves
from repro_torch.kernels import flash_attention as FLASH
from repro_torch.train import trainer
from repro_torch.train.optimizer import adam, cosine_schedule

FLASH_STAGES = ("fwd", "fwd_lse", "dq", "dkv")
_EXCLUDE = 1e-3       # of the median leaf's reference gradient norm
SAMPLE = 65536        # first-gradient values compared a leaf


def _flash_launches() -> Dict[str, int]:
    return {s: getattr(FLASH, f"flash_attention_{s}").launches
            for s in FLASH_STAGES}


def _gap(got: Dict[str, float], want: Dict[str, float], keys):
    """The worst leaf's |got - want| over max(want, the median want)."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _diff(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
          keys):
    """The worst leaf's relative L2 distance ||got - want|| / ||want||."""
    d = {k: float(torch.linalg.vector_norm(got[k] - want[k])
                  / torch.clamp(torch.linalg.vector_norm(want[k]), min=1e-30))
         for k in keys}
    worst = max(d, key=d.get)
    return d[worst], worst


def compare(prog: Dict, ref: Dict):
    """The numbers ``correct`` holds against their limits, and the leaf
    each was worst on: each step's loss; the first clipped gradient's norm
    and its sampled values; the change's norm. Leaves whose reference
    gradient is under a thousandth of the median leaf's move by round-off
    alone and are left out of the change and of the values."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                    ref["loss"]))
    if not all(math.isfinite(x) for x in prog["loss"]):
        loss = math.inf
    grad, grad_leaf = _gap(prog["grad"], ref["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    kept = [k for k, g in ref["grad"].items() if g >= _EXCLUDE * med]
    values, values_leaf = _diff(prog["grad_sample"], ref["grad_sample"], kept)
    change, change_leaf = _gap(prog["change"], ref["change"], kept)
    return ({"loss_gap": loss, "grad_gap": grad, "grad_diff": values,
             "change_gap": change},
            {"grad_gap": grad_leaf, "grad_diff": values_leaf,
             "change_gap": change_leaf,
             "excluded": sorted(set(ref["grad"]) - set(kept))})


class Driver:
    def __init__(self, run):
        self.run = run
        self.arch = REF.Arch(run.conf)
        t, a, dev = run.traffic, self.arch, run.device
        self.batch, self.seq = t["batch"], t["seq"]
        o = t["optimizer"]
        self.opt_conf = o
        opt = adam(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                   weight_decay=o["weight_decay"],
                   schedule=cosine_schedule(warmup=o["warmup"],
                                            total=o["total"]))
        cfg = port_config(run.conf, a)
        w = inputs.make_weights(a, run.seed, dev)
        st = trainer.train_state_from_params(cfg, port_params(a, w), opt)
        self.frozen, self.base = st.frozen, st.B
        self.trainable, self.opt_state = st.trainable, st.opt_state
        self.step_fn = trainer.make_train_step(cfg, optimizer=opt,
                                               tie_lambda=t["tie_lambda"])
        self.pool = [{"tokens": x, "labels": y} for x, y in
                     inputs.make_batches(run.seed, t["pool"], self.batch,
                                         self.seq, a.vocab, dev)]
        self.i = 0
        self.readings = self._first_steps(t["first_steps"])

    def _one(self) -> float:
        with self.run.spans("bench.next_batch"):
            b = self.pool[self.i % len(self.pool)]
            self.i += 1
        with self.run.spans("bench.train_step"):
            self.trainable, self.opt_state, m = self.step_fn(
                self.frozen, self.base, self.trainable, self.opt_state, b)
        with self.run.spans("bench.readback"):
            return float(m["loss"])

    def _norms(self, tree, fn) -> Dict[str, float]:
        return {reference_leaf(p): float(torch.linalg.vector_norm(fn(t)))
                for p, t in zip(leaf_paths(tree), tree_leaves(tree))}

    def _first_steps(self, n: int) -> Dict:
        losses = []
        for j in range(n):
            losses.append(self._one())
            if j == 0:
                grad, values = self._first_gradient()
        tr = self.trainable
        change = self._norms({"alpha": tr["alpha"]},
                             lambda t: t.float() - 1.0)
        change.update(self._norms({"A": tr["A"]}, lambda t: t.float()))
        return {"loss": losses, "grad": grad, "grad_sample": values,
                "change": change}

    def _first_gradient(self):
        """The first clipped gradient as Adam's state holds it after one
        step, m / (1 - b1): each leaf's norm and its sampled values, one
        leaf at a time (no copy of the state outlives the call)."""
        scale = 1.0 / (1.0 - self.opt_conf["b1"])
        m = self.opt_state["m"]
        leaves = {reference_leaf(p): t[0]
                  for p, t in zip(leaf_paths(m), tree_leaves(m))}
        self.sample = inputs.sample_indices(
            self.run.seed, {k: g.numel() for k, g in leaves.items()},
            SAMPLE, self.run.device)
        grad = {k: float(torch.linalg.vector_norm(g, dtype=torch.float32))
                * scale for k, g in leaves.items()}
        values = {k: g.reshape(-1)[self.sample[k]].float().cpu() * scale
                  for k, g in leaves.items()}
        return grad, values

    # -- the window ----------------------------------------------------------

    def step(self):
        """One window step -> (steps attempted, steps failed)."""
        return 1, int(not math.isfinite(self._one()))

    def counters(self) -> Dict[str, int]:
        return _flash_launches()

    def end_to_end(self, t0: float, stamps) -> Dict[str, float]:
        return {"train_tokens_per_s":
                self.batch * self.seq * len(stamps) / (stamps[-1] - t0)}

    def work(self) -> Dict:
        a = self.arch
        return {"flops_per_step": arith.train_step_flops(a, self.batch,
                                                         self.seq),
                "flash_shape": {"batch": self.batch, "heads": a.heads,
                                "kv_heads": a.kv_heads, "seq": self.seq,
                                "hd": a.hd}}

    # -- the check -------------------------------------------------------------

    def free(self) -> None:
        del self.frozen, self.base, self.trainable, self.opt_state
        del self.step_fn, self.pool

    def reference(self, prec: str = "fp32", half_batch: bool = False):
        run, t = self.run, self.run.traffic
        w = inputs.make_weights(self.arch, run.seed, run.device)
        batches = inputs.make_batches(run.seed, t["pool"], self.batch,
                                      self.seq, self.arch.vocab,
                                      run.device)[:t["first_steps"]]
        return REF.train_readings(self.arch, w, batches, self.opt_conf,
                                  t["tie_lambda"], self.sample, prec=prec,
                                  half_batch=half_batch)

    def check(self):
        """-> (numbers, details), the program's first steps against the
        fp32 reference's."""
        self.ref = self.reference()
        return compare(self.readings, self.ref)

    def controls(self) -> Dict[str, Dict[str, float]]:
        """The numbers the control (the reference in fp8 in the program's
        place) and the half-batch fault (the reference over half the
        rows) read against the fp32 reference; after ``check``."""
        out = {}
        for name, kw in (("fp8", {"prec": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            out[name] = compare(self.reference(**kw), self.ref)[0]
        return out
