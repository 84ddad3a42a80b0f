"""Plain reference of a dense decoder LM of the Qwen2 / Qwen3 kind, and of
the FedSTIL split step trained on it, in plain PyTorch.

Written from the published architecture (the Hugging Face ``Qwen2`` and
``Qwen3`` modelling code and the configs under ``bench/configs``):
token embedding; per layer an RMSNorm, q / k / v projections (with bias
in Qwen2, with an RMSNorm over each head's q and k in Qwen3), rotary
position embeddings (the rotate-half form, angles in fp32), grouped-query
attention with the 1 / sqrt(head_dim) scale, the output projection, a
second RMSNorm and a SwiGLU MLP; a final RMSNorm and the output head over
the true vocabulary. It imports nothing of the system under test and
takes only the inputs the benchmark makes from the seed: weights, token
batches, a filled KV cache.

FedSTIL's split step (the paper's Eq. 2, its tying term and the local
optimizer): the last ``adaptive`` layers, the final norm and the head are
theta = B * alpha + A with B the given weights, alpha = 1 and A = 0 at
the start; only (alpha, A) train. The loss is the mean next-token
cross-entropy plus ``tie * sum |A|``, whose slope at A = 0 is taken as +1
(the original implementation's convention; the reported loss leaves the
term out), taken one batch row at a time with the rows' gradients
summed, so that one row's fp32 logits are alive at a time. The gradient
is clipped to global norm 1 and Adam updates (alpha, A) with a
warm-up-cosine learning rate and weight decay added to the update. Each trained leaf is stored in the dtype the configuration
states for it (bf16 weights, fp32 norm scales): an update smaller than
half a bf16 step leaves a bf16 leaf as it was, as it would on any bf16
run. The moments are kept in fp32.

Precision: ``prec="fp32"`` computes every product in IEEE fp32 (TF32
off, restored afterwards). ``prec="fp8"`` is the control: every matrix
product (projections, attention's two products, the head) takes its
operands rounded to float8 e4m3 with a per-tensor scale, and its
backward the incoming gradient rounded to e5m2, the usual fp8 training
recipe; everything else stays fp32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def _qdq(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value, back in fp32."""
    amax = torch.clamp(x.detach().abs().amax().float(), min=1e-30)
    s = torch.finfo(dtype).max / amax
    return (x * s).to(dtype).float() / s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _qdq(a, E4M3), _qdq(b, E4M3)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _qdq(g, E5M2)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (qg @ qb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        if ctx.needs_input_grad[1]:
            gb = (qa.transpose(-1, -2) @ qg).sum_to_size(ctx.shapes[1])
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    if prec != "fp32":
        raise ValueError(f"precision {prec!r}: fp32 or fp8")
    return a @ b


@contextlib.contextmanager
def ieee_fp32():
    """Matrix products in IEEE fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# the architecture
# ---------------------------------------------------------------------------


class Arch:
    """The sizes and mechanisms a config file states."""

    def __init__(self, conf: Dict):
        self.layers = conf["num_hidden_layers"]
        self.d = conf["hidden_size"]
        self.heads = conf["num_attention_heads"]
        self.kv_heads = conf["num_key_value_heads"]
        self.hd = conf.get("head_dim") or self.d // self.heads
        self.ff = conf["intermediate_size"]
        self.vocab = conf["vocab_size"]
        self.eps = conf["rms_norm_eps"]
        self.theta = float(conf["rope_theta"])
        mech = conf["architecture"]
        self.qkv_bias = bool(mech["qkv_bias"])
        self.qk_norm = bool(mech["qk_norm"])
        self.adaptive = conf["deployment"]["adaptive_layers"]
        # the deployment's output head: a leaf of its own, whatever the
        # published model ties (the split step trains it with alpha, A)
        self.untied_head = bool(conf["deployment"]["untied_head"])
        if not self.untied_head:
            raise ValueError("the split step trains an untied head; a "
                             "deployment with a tied one has no reference")
        self.dtype = {"bfloat16": torch.bfloat16,
                      "float32": torch.float32}[conf["torch_dtype"]]


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (B, S, H, hd) rotated by the angles of positions ``pos`` (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.int64).float() / hd))
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _f(t):
    return t.float()


def _qkv(a: Arch, lw, h, pos, prec):
    """h (B, S, d) -> q (B, S, H, hd), k and v (B, S, KV, hd), q and k
    normed (Qwen3) and rotated."""
    B, S, _ = h.shape
    q, k, v = (mm(h, _f(lw[n]), prec) for n in ("wq", "wk", "wv"))
    if a.qkv_bias:
        q, k, v = q + _f(lw["bq"]), k + _f(lw["bk"]), v + _f(lw["bv"])
    q = q.reshape(B, S, a.heads, a.hd)
    k = k.reshape(B, S, a.kv_heads, a.hd)
    v = v.reshape(B, S, a.kv_heads, a.hd)
    if a.qk_norm:
        q = rms_norm(q, _f(lw["qnorm"]), a.eps)
        k = rms_norm(k, _f(lw["knorm"]), a.eps)
    return rope(q, pos, a.theta), rope(k, pos, a.theta), v


def _attend(a: Arch, q, k, v, q_pos, k_pos, prec):
    """q (B, Sq, H, hd) at positions q_pos against k, v (B, Sk, KV, hd) at
    k_pos: each query sees the keys at positions <= its own."""
    r = a.heads // a.kv_heads
    qh = q.transpose(1, 2)                                  # B H Sq hd
    kh = k.transpose(1, 2).repeat_interleave(r, 1)          # B H Sk hd
    vh = v.transpose(1, 2).repeat_interleave(r, 1)
    s = mm(qh, kh.transpose(-1, -2), prec) / math.sqrt(a.hd)
    s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
    o = mm(torch.softmax(s, -1), vh, prec)
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)


def _mlp(a: Arch, lw, h, prec):
    g = F.silu(mm(h, _f(lw["wg"]), prec)) * mm(h, _f(lw["wi"]), prec)
    return mm(g, _f(lw["w2"]), prec)


def layer(a: Arch, lw, x, pos, prec):
    """One decoder layer over a whole causal sequence x (B, S, d)."""
    h = rms_norm(x, _f(lw["ln1"]), a.eps)
    q, k, v = _qkv(a, lw, h, pos, prec)
    x = x + mm(_attend(a, q, k, v, pos, pos, prec), _f(lw["wo"]), prec)
    return x + _mlp(a, lw, rms_norm(x, _f(lw["ln2"]), a.eps), prec)


def layer_weights(w, i: int):
    """Layer i's weights from the stacked inputs."""
    return {k: t[i] for k, t in w.items() if t.dim() >= 2 and k not in
            ("embed", "head")}


def logits(a: Arch, head_w, x, prec):
    """Logits over the true vocabulary (the padded columns left out)."""
    return mm(x, _f(head_w[:, :a.vocab]), prec)


# ---------------------------------------------------------------------------
# the FedSTIL split step
# ---------------------------------------------------------------------------


ADAPTIVE_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "bq", "bk", "bv", "qnorm",
                       "knorm", "wo", "ln2", "wi", "wg", "w2")


def adaptive_base(a: Arch, w) -> Dict[str, torch.Tensor]:
    """B: the trained slice of the given weights, by leaf name (the last
    layers' weights as ``layer.<key>``, the final norm and the head)."""
    lo = a.layers - a.adaptive
    base = {f"layer.{k}": w[k][lo:] for k in ADAPTIVE_LAYER_KEYS if k in w}
    base["final_norm"] = w["final_norm"]
    base["head"] = w["head"]
    return base


def _cosine(count: int, warmup: int, total: int, floor: float = 0.1):
    c = torch.tensor(float(count))
    if c < warmup:
        return c / max(warmup, 1)
    prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0, 1)
    return floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))


class SplitStep:
    """The reference's split step on one model: state (alpha, A) in the
    leaves' dtypes, Adam's moments in fp32."""

    def __init__(self, a: Arch, w, opt: Dict, tie: float, prec: str):
        self.a, self.w, self.opt, self.tie, self.prec = a, w, opt, tie, prec
        self.base = adaptive_base(a, w)
        self.alpha = {k: torch.ones_like(t) for k, t in self.base.items()}
        self.A = {k: torch.zeros_like(t) for k, t in self.base.items()}
        self.m = {f"{p}.{k}": torch.zeros(t.shape, device=t.device)
                  for p in ("alpha", "A") for k, t in self.base.items()}
        self.v = {k: torch.zeros_like(t) for k, t in self.m.items()}
        self.count = 0

    def _trunk(self, tokens):
        a, w = self.a, self.w
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = _f(w["embed"][tokens.long()])
        with torch.no_grad():
            for i in range(a.layers - a.adaptive):
                x = layer(a, layer_weights(w, i), x, pos, self.prec)
        return x, pos

    def _block(self, tokens, labels, n: int, tie: float):
        """One block of rows: (its cross-entropy summed over its tokens,
        the gradients of that sum / ``n`` plus ``tie * sum |A|``)."""
        a = self.a
        x, pos = self._trunk(tokens)
        al = {k: _f(t).requires_grad_(True) for k, t in self.alpha.items()}
        A = {k: _f(t).requires_grad_(True) for k, t in self.A.items()}
        th = {k: _f(self.base[k]) * al[k] + A[k] for k in self.base}
        for j in range(a.adaptive):
            lw = {k[len("layer."):]: t[j] for k, t in th.items()
                  if k.startswith("layer.")}
            x = layer(a, lw, x, pos, self.prec)
        x = rms_norm(x, th["final_norm"], a.eps)
        lg = logits(a, th["head"], x, self.prec)
        ce = F.cross_entropy(lg.reshape(-1, a.vocab),
                             labels.reshape(-1).long(), reduction="sum")
        del lg
        l1 = sum(torch.sum(torch.where(t >= 0, t, -t)) for t in A.values())
        grads = torch.autograd.grad(ce / n + tie * l1,
                                    list(al.values()) + list(A.values()))
        return float(ce.detach()), grads

    def loss_and_grads(self, tokens, labels, rows=None):
        """(reported loss, {"alpha.<leaf>" / "A.<leaf>": gradient}) of one
        batch; ``rows``: the batch rows the loss averages over (all by
        default). The rows are taken one at a time, their gradients
        summed, so that the fp32 logits of one row are alive at a time."""
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        n = labels.numel()
        names = [f"{p}.{k}" for p in ("alpha", "A") for k in self.base]
        ce_sum, total = 0.0, None
        for r in range(tokens.shape[0]):
            ce, grads = self._block(tokens[r:r + 1], labels[r:r + 1], n,
                                    self.tie if r == 0 else 0.0)
            ce_sum += ce
            total = list(grads) if total is None else [
                t + g for t, g in zip(total, grads)]
            del grads
        return ce_sum / n, dict(zip(names, total))

    def update(self, grads):
        """Clip to global norm 1, one Adam step, store in each leaf's
        dtype -> the clipped gradients the moments took."""
        o = self.opt
        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(1.0 / (gn + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        self.count += 1
        c = self.count
        lr = o["lr"] * _cosine(c, o["warmup"], o["total"]).item()
        bc1, bc2 = 1 - o["b1"] ** c, 1 - o["b2"] ** c
        for name, g in grads.items():
            part, leaf = name.split(".", 1)
            store = self.alpha if part == "alpha" else self.A
            self.m[name] = o["b1"] * self.m[name] + (1 - o["b1"]) * g
            self.v[name] = o["b2"] * self.v[name] + (1 - o["b2"]) * g * g
            p = _f(store[leaf])
            u = -lr * (self.m[name] / bc1) / (
                torch.sqrt(self.v[name] / bc2) + o["eps"])
            u = u - lr * o["weight_decay"] * p
            store[leaf] = (p + u).to(store[leaf].dtype)
        return grads

    def params_change(self) -> Dict[str, torch.Tensor]:
        """Each trained leaf's change from its start (alpha = 1, A = 0)."""
        out = {f"alpha.{k}": _f(t) - 1.0 for k, t in self.alpha.items()}
        out.update({f"A.{k}": _f(t) for k, t in self.A.items()})
        return out


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(_f(t.detach())))
            for k, t in tree.items()}


def train_readings(a: Arch, w, batches: List, opt: Dict, tie: float,
                   sample: Dict[str, torch.Tensor], prec: str = "fp32",
                   half_batch: bool = False):
    """The split step's first ``len(batches)`` steps: each step's loss,
    each leaf's first clipped gradient norm and its values at the flat
    indices ``sample[leaf]``, each leaf's change norm after the last
    step. ``half_batch``: every loss over the first half of the batch
    rows alone (a fault)."""
    with ieee_fp32():
        st = SplitStep(a, w, opt, tie, prec)
        losses, first = [], None
        for tokens, labels in batches:
            rows = None
            if half_batch:
                rows = slice(0, max(tokens.shape[0] // 2, 1))
            loss, grads = st.loss_and_grads(tokens, labels, rows)
            clipped = st.update(grads)
            if first is None:
                first = norms(clipped)
                values = {k: g.detach().reshape(-1)[sample[k]].cpu()
                          for k, g in clipped.items()}
            losses.append(loss)
            del grads, clipped
        return {"loss": losses, "grad": first, "grad_sample": values,
                "change": norms(st.params_change())}


# ---------------------------------------------------------------------------
# decode: logits of fed tokens against a filled cache
# ---------------------------------------------------------------------------


def logits_after_cache(a: Arch, w, k_cache, v_cache, start: int, fed,
                       prec: str = "fp32"):
    """One sequence's logits (T, vocab) at each of the T tokens ``fed``
    (T,) placed at positions start .. start + T - 1, after a cache whose
    slots 0 .. start - 1 hold the keys and values of earlier positions:
    ``k_cache[i]``, ``v_cache[i]`` of layer i are (>= start, KV, hd), the
    keys rotated as stored."""
    T = fed.shape[0]
    dev = fed.device
    with ieee_fp32(), torch.no_grad():
        pos = torch.arange(start, start + T, device=dev)
        k_pos = torch.arange(start + T, device=dev)
        x = _f(w["embed"][fed.long()])[None]                 # 1 T d
        for i in range(a.layers):
            lw = layer_weights(w, i)
            h = rms_norm(x, _f(lw["ln1"]), a.eps)
            q, k, v = _qkv(a, lw, h, pos, prec)
            kk = torch.cat([_f(k_cache[i][:start])[None], k], 1)
            vv = torch.cat([_f(v_cache[i][:start])[None], v], 1)
            o = _attend(a, q, kk, vv, pos, k_pos, prec)
            x = x + mm(o, _f(lw["wo"]), prec)
            x = x + _mlp(a, lw, rms_norm(x, _f(lw["ln2"]), a.eps), prec)
        x = rms_norm(x, _f(w["final_norm"]), a.eps)
        return logits(a, w["head"], x[0], prec)
