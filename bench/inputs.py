"""Everything a run feeds the system, made on the device from ``--seed``:
weights, token batches, a filled KV cache, the first tokens of decode
requests.

Each kind of input draws from a ``torch.Generator`` of its own, seeded
from the run's seed and the kind, in a fixed order of a few large calls,
so a second call with the same seed makes the same tensors: the program
takes them before the measured window, the reference makes them again
after it. Sizes depend on the cell alone, never on the seed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

WEIGHTS, BATCHES, CACHE, REQUESTS, SAMPLES = 1, 2, 3, 4, 5
_MIX = 0x9E3779B97F4A7C15


def generator(seed: int, kind: int, device) -> torch.Generator:
    """A generator on ``device`` for one kind of input; any whole seed
    (negative or past 64 bits too) maps to a 63-bit state."""
    state = ((int(seed) * _MIX) ^ (kind * 0xBF58476D1CE4E5B9)) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(state)


def padded_vocab(vocab: int) -> int:
    """The vocabulary rounded up to 256 rows: the layout the program keeps
    (the padded rows are drawn like the others and never used)."""
    return -(-vocab // 256) * 256


def weight_specs(arch) -> List[Tuple[str, Tuple[int, ...], torch.dtype, str,
                                     float]]:
    """(name, shape, dtype, law, scale) of every weight, layers stacked on
    a leading dim, in the config's dtype: matrices N(0, 1 / fan_in), the
    embedding N(0, 0.02^2), biases N(0, 0.1^2); norm scales N(1, 0.1^2)
    in fp32."""
    L, d, hd, ff = arch.layers, arch.d, arch.hd, arch.ff
    hq, hkv, vp = arch.heads * hd, arch.kv_heads * hd, padded_vocab(
        arch.vocab)
    bf, f32 = arch.dtype, torch.float32
    mat = lambda name, rows, cols: (name, (L, rows, cols), bf, "normal",
                                    1.0 / math.sqrt(rows))
    specs = [("embed", (vp, d), bf, "normal", 0.02),
             ("head", (d, vp), bf, "normal", 1.0 / math.sqrt(d)),
             ("final_norm", (d,), f32, "scale", 0.1),
             ("ln1", (L, d), f32, "scale", 0.1),
             ("ln2", (L, d), f32, "scale", 0.1),
             mat("wq", d, hq), mat("wk", d, hkv), mat("wv", d, hkv),
             mat("wo", hq, d), mat("wi", d, ff), mat("wg", d, ff),
             mat("w2", ff, d)]
    if arch.qkv_bias:
        specs += [(f"b{n}", (L, c), bf, "normal", 0.1)
                  for n, c in (("q", hq), ("k", hkv), ("v", hkv))]
    if arch.qk_norm:
        specs += [(n, (L, hd), f32, "scale", 0.1) for n in ("qnorm", "knorm")]
    return specs


def make_weights(arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights, one generator call a stacked leaf."""
    gen = generator(seed, WEIGHTS, device)
    out = {}
    for name, shape, dtype, law, scale in weight_specs(arch):
        t = torch.empty(shape, dtype=dtype, device=device)
        if law == "scale":
            t.normal_(1.0, scale, generator=gen)
        else:
            t.normal_(0.0, scale, generator=gen)
        out[name] = t
    return out


def make_batches(seed: int, n: int, batch: int, seq: int, vocab: int,
                 device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``n`` batches of (tokens, labels), each (batch, seq) int32, ids
    uniform over the vocabulary, labels the next tokens."""
    gen = generator(seed, BATCHES, device)
    ids = torch.randint(0, vocab, (n, batch, seq + 1), generator=gen,
                        device=device, dtype=torch.int32)
    return [(ids[i, :, :-1], ids[i, :, 1:]) for i in range(n)]


def fill_cache(tensors: List[torch.Tensor], seed: int) -> None:
    """Fill KV cache tensors in place with N(0, 1) values, in the order
    given: the keys and values of the prompt every request continues."""
    if not tensors:
        return
    gen = generator(seed, CACHE, tensors[0].device)
    for t in tensors:
        t.normal_(0.0, 1.0, generator=gen)


def make_request_tokens(seed: int, n: int, batch: int, vocab: int, device):
    """(n, batch, 1) int32: each request's first token for every row."""
    gen = generator(seed, REQUESTS, device)
    return torch.randint(0, vocab, (n, batch, 1), generator=gen,
                         device=device, dtype=torch.int32)


def sample_indices(seed: int, sizes: Dict[str, int], n: int, device
                   ) -> Dict[str, torch.Tensor]:
    """For each named tensor of ``sizes[name]`` elements, the flat indices
    of a sample of ``n`` of them drawn from the seed (all of them when it
    has no more than ``n``), in the names' sorted order."""
    gen = generator(seed, SAMPLES, device)
    out = {}
    for name in sorted(sizes):
        numel = sizes[name]
        out[name] = (torch.arange(numel, device=device) if numel <= n else
                     torch.randint(0, numel, (n,), generator=gen,
                                   device=device))
    return out
