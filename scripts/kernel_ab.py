#!/usr/bin/env python3
"""The redesigned kernels of one checkout, timed and fingerprinted, for an
A/B between two checkouts on one card.

    python3 scripts/kernel_ab.py TREE LABEL [SET ...]    # from the repo root

SET is any of ``aggregate``, ``kl``, ``quantize``, ``dist``, ``combine``,
``codec`` and ``codec_int8`` (all seven when none is named). Runs this checkout's ``chip_smoke.py`` against TREE's ``src/``
(TREE ``.`` for this checkout; for another one the script is copied into
TREE as ``chip_smoke_ab.py`` and imported from there), builds TREE's
kernels, and for each set prints a ``TIMES`` line (CUDA events, median of
30, each shape with its bound and its variant) and a ``DIGESTS`` line
(sha256 of the outputs on seeded inputs at shapes of every variant, so two
trees compare bit for bit):

  aggregate  both entries at ``AGG_FUSED_TIMED`` / ``AGG_PLAIN_TIMED``
             beside ``torch.mm``; B and Wn at skinny, tiled and ragged shapes
  kl         S at ``KL_VARIANT_SHAPES`` (the round's, C = 100 and the
             fleet's); S at those and at ragged D, N, M, b misaligned
  quantize   the refresh's shape and ``QUANT_TIMED``; codes and scales at
             ``QUANT_EDGES``, aligned and not
  dist       the four distance entry points: the serving int8 and fp32
             shapes and the round's evaluation (``DIST_PATHS``), the 2-D
             entry at 64 x 32768 x 64 and the cluster distances at (4, 64,
             512, 64) (rows 5 and 6); their outputs there and at
             ``DIST_FP32_EDGES`` / ``DIST_INT8_EDGES`` (the 2-D entry on
             client 0's rows), aligned and not
  combine    ``core.adaptive.combine`` (the tree's own: one launch per
             dtype group, or a launch a leaf before the multi-leaf kernel)
             on the round's head stacked at C = 5 and as a stack of one
             (device ms, host microseconds a call, launches a call), on
             row 11's single leaves, (1000, 57664) fp32 and the LM's
             (2048, 152064) bf16 head; outputs there, on the head through
             ``offset_copy`` and on a mixed fp32 / bf16 tree, and the
             head's alpha and B gradients
  codec      the wire codec's sparse encode and decode (one launch each,
             or, before them, pack + bit-pack and bit-unpack + unpack) at
             the round's (5, 37696) and the fleet's (1000, 57664) rows
             beside their bounds, launches a call; ``BatchedCodec``'s
             roundtrip of a residual at the fleet's rows under both codecs
             (device ms, codec launches with quantize and dequantize, peak
             memory above what is held before it); outputs there, at
             ragged P with kg 1, 3 and 8, on a misaligned copy, on rows
             holding NaN and infinities, and the decode of malformed
             planes
  codec_int8 the int8 codec's residual decode (one launch, or, before it,
             dequantize then decode) at the round's (5, 37696) and the
             fleet's (1000, 57664) payloads beside its bound, launches a
             call; outputs there, at ragged P with kg 1, 3 and 8 and
             chunks 256 and 100, with NaN and infinite scales, on codes
             at a misaligned base, and on malformed planes

A tree whose kernel has no ``_plan`` reports its variant as "one"; a tree
before the multi-leaf combine gets a stand-in ``adaptive_combine_tree``
(its one-leaf kernel leaf by leaf), and one before the codec's encode and
decode gets stand-ins that call its two one-stage kernels each, and one
before the int8 decode a stand-in that calls dequantize then decode, so
this checkout's script imports. Run
parent, change, change, parent in one call on one card (the parent
unpacked with ``git archive`` into a gitignored directory). Needs a CUDA
card.
"""
import hashlib
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SETS = ("aggregate", "kl", "quantize", "dist", "combine", "codec",
        "codec_int8")


def digest(*xs):
    import torch
    h = hashlib.sha256()
    for x in xs:
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:          # numpy has no bf16: its bits
            x = x.view(torch.int16)
        h.update(x.numpy().tobytes())
    return h.hexdigest()[:16]


def aggregate(CS, dev, peak):
    import torch
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    times = {"fused": CS.aggregate_timings(gen, dev, peak, True),
             "plain": CS.aggregate_timings(gen, dev, peak, False)}
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    for c, p in ((5, 37696), (5, 57664), (33, 1000), (100, 57664),
                 (1000, 57664), (7, 1001), (129, 333)):
        w = torch.rand((c, c), generator=gen, device=dev)
        w.fill_diagonal_(7.5)
        w[1] = 0.0
        th = 10.0 * torch.randn((c, p), generator=gen, device=dev)
        b, wn = CS.fused_relevance_aggregate(w, th)
        out[f"fused {c}x{p}"] = [digest(b), digest(wn)]
        rows = wn[:max(1, c // 2)].contiguous()
        out[f"plain {rows.shape[0]}x{c}x{p}"] = digest(
            CS.relevance_aggregate(rows, th))
    return times, out


def kl(CS, dev, peak):
    import torch
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    D = CS.CFG.proto_dim
    times = []
    for n, m in CS.KL_VARIANT_SHAPES:
        a, b = CS.task_features(gen, dev, n), CS.task_features(gen, dev, m)
        ms = CS.time_ms(lambda: CS.kl_similarity(a, b))
        bd = CS.bound(*CS.kl_work(n, m, D), peak)
        times.append({"shape": [n, m, D], "ms": ms, "bound_ms": bd[0],
                      "bound_share": bd[0] / ms,
                      "variant": CS.plan_of(CS.KLM, n, m, D, True)})
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    shapes = [(n, m, D) for n, m in CS.KL_VARIANT_SHAPES] + list(CS.KL_EDGES)
    for n, m, d in shapes:
        a = torch.randn((n, d), generator=gen, device=dev)
        b = torch.randn((m, d), generator=gen, device=dev)
        out[f"{n}x{m}x{d}"] = [digest(CS.kl_similarity(a, b)),
                               digest(CS.kl_similarity(torch.tanh(a),
                                                       torch.tanh(b))),
                               digest(CS.kl_similarity(a, CS.offset_copy(b)))]
    return times, out


def quantize(CS, dev, peak):
    import torch
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    times = []
    shapes = ((CS.C, CS.G_INT8 * CS.F, CS.F),) + CS.QUANT_TIMED
    for c, p, chunk in shapes:
        x = torch.randn((c, p), generator=gen, device=dev)
        ms = CS.time_ms(lambda: CS.batched_quantize(x, chunk=chunk))
        bd = CS.bound(*CS.quantize_work(c, p, chunk), peak)
        times.append({"shape": [c, p, chunk], "ms": ms, "bound_ms": bd[0],
                      "bound_share": bd[0] / ms,
                      "variant": CS.plan_of(CS.QZ, c, p, chunk, True)})
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    for c, p, chunk in CS.QUANT_EDGES:
        x = 3.0 * torch.randn((c, p), generator=gen, device=dev)
        x[0, :chunk] = 0.0
        out[f"{c}x{p}/{chunk}"] = [
            digest(*CS.batched_quantize(x, chunk=chunk)),
            digest(*CS.batched_quantize(CS.offset_copy(x), chunk=chunk))]
    return times, out


def dist(CS, dev, peak):
    import torch
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    shapes = [("batched_int8_pairwise_dist", CS.DIST_PATHS["serve_int8"]),
              ("batched_pairwise_dist", CS.DIST_PATHS["serve_fp32"]),
              ("batched_pairwise_dist", CS.DIST_PATHS["round_eval"]),
              ("pairwise_dist", (1, CS.BATCH, CS.G_FP32, CS.F)),
              ("batched_cluster_dist", (CS.C, CS.BATCH, 512, CS.F))]
    times = []
    for name, (c, b, g, f) in shapes:
        args = CS.dist_operands(name, gen, dev, c, b, g, f)
        fn = CS.KERNELS[name]["fn"]
        ms = CS.time_ms(lambda: fn(*args))
        bd = CS.bound(*CS.dist_work(name, c, b, g, f), peak)
        times.append({"name": name, "shape": [c, b, g, f], "ms": ms,
                      "bound_ms": bd[0], "bound_share": bd[0] / ms,
                      "variant": CS.plan_of(CS.PD, c, b, g, f,
                                            CS.DIST_MODE[name], True)})
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    for name, (c, b, g, f) in shapes + [
            (n, e) for n in ("batched_pairwise_dist", "pairwise_dist",
                             "batched_cluster_dist")
            for e in CS.DIST_FP32_EDGES] + [
            ("batched_int8_pairwise_dist", e) for e in CS.DIST_INT8_EDGES]:
        args = CS.dist_operands(name, gen, dev, c, b, g, f)
        fn = CS.KERNELS[name]["fn"]
        off = (CS.offset_copy(args[0]), CS.offset_copy(args[1]), *args[2:])
        out[f"{name} {c}x{b}x{g}x{f}"] = [digest(fn(*args)), digest(fn(*off))]
    return times, out


def combine(CS, dev, peak):
    import torch
    from repro_torch.core.adaptive import combine as tree_combine
    from repro_torch.kernels import adaptive_combine as ACM

    def launches():
        return ACM.adaptive_combine.launches + getattr(
            ACM.adaptive_combine_tree, "launches", 0)

    def leaf(shape, dt, gen):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    times, out = [], {}
    for clients in (CS.N_CLIENTS, 1):
        B = CS.round_head(gen, clients)
        al, A = ({k: leaf(t.shape, t.dtype, gen) for k, t in B.items()}
                 for _ in range(2))
        trainable = [{k: t.clone().requires_grad_(True) for k, t in d.items()}
                     for d in (al, A)]
        before = launches()
        theta = tree_combine(B, al, A)
        n_launch = launches() - before
        out[f"head C={clients}"] = digest(*CS.tree_leaves(theta))
        off = {k: CS.offset_copy(t) for k, t in B.items()}
        out[f"head C={clients} misaligned"] = digest(
            *CS.tree_leaves(tree_combine(off, al, A)))
        bd = CS.bound(*CS.combine_work(CS.tree_leaves(B)), peak)
        times.append({
            "shape": f"head C={clients}", "leaves": len(B),
            "launches": n_launch,
            "ms": CS.time_ms(lambda: tree_combine(B, al, A)),
            "host_us": CS.host_us(lambda: tree_combine(B, *trainable)),
            "bound_ms": bd[0]})
        if clients == CS.N_CLIENTS:
            Bg = {k: t.clone().requires_grad_(True) for k, t in B.items()}
            th = tree_combine(Bg, *trainable)
            gs = [leaf(t.shape, t.dtype, gen) for t in CS.tree_leaves(th)]
            torch.autograd.backward(CS.tree_leaves(th), gs)
            out["head C=5 grads"] = digest(
                *(t.grad for t in CS.tree_leaves(trainable[0])),
                *(t.grad for t in CS.tree_leaves(Bg)))
    for name, shape, dt in (("fleet leaf", (1000, 57664), torch.float32),
                            ("lm head leaf", CS.LM_HEAD_LEAF,
                             torch.bfloat16)):
        b, al, a = ({"w": leaf(shape, dt, gen)} for _ in range(3))
        out[name] = digest(tree_combine(b, al, a)["w"])
        bd = CS.bound(*CS.combine_work([b["w"]]), peak)
        times.append({"shape": f"{name} {list(shape)}", "leaves": 1,
                      "ms": CS.time_ms(lambda: tree_combine(b, al, a)),
                      "bound_ms": bd[0]})
        del b, al, a
    mixed = [leaf((n,), torch.float32 if k % 2 else torch.bfloat16, gen)
             for k, n in enumerate((1, 4097, 8193, 1001, 37 * 129, 5))]
    trees = [dict(zip("abcdef", mixed))] + [
        {k: leaf(t.shape, t.dtype, gen) for k, t in zip("abcdef", mixed)}
        for _ in range(2)]
    out["mixed"] = digest(*CS.tree_leaves(tree_combine(*trees)))
    return times, out


def codec(CS, dev, peak):
    import torch

    def launches():
        return sum(CS.KERNELS[n]["fn"].launches
                   for n in CS.CODEC_KERNELS + CS.ONE_STAGE_CODEC
                   + (CS.INT8_DECODE, "batched_quantize",
                      "batched_dequantize"))

    def enc(x, kg=CS.KG):
        return CS.batched_topk_encode(x, group=CS.GROUP, kg=kg)

    def dec(vals, planes, p, kg=CS.KG):
        return CS.batched_topk_decode(vals, planes, k=vals.shape[1], p=p,
                                      group=CS.GROUP, kg=kg)

    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    times = []
    for c, p in ((CS.N_CLIENTS, CS.P_ROUND), (CS.SCALE_CLIENTS[-1],
                                              CS.P_EDGE)):
        x = CS.codec_rows(gen, dev, c, p)
        vals, planes = enc(x)
        for name, fn in (("encode", lambda: enc(x)),
                         ("decode", lambda: dec(vals, planes, p))):
            before = launches()
            fn()
            n_launch = launches() - before
            bd = CS.bound(*CS.codec_work(f"batched_topk_{name}", c, p,
                                         CS.GROUP, CS.KG), peak)
            ms = CS.time_ms(fn)
            times.append({"name": name, "shape": [c, p], "ms": ms,
                          "bound_ms": bd[0], "bound_share": bd[0] / ms,
                          "launches": n_launch})
        del x, vals, planes
    for spec in (CS.CODEC, CS.CODEC_INT8):      # the path's roundtrip
        c, p = CS.SCALE_CLIENTS[-1], CS.P_EDGE
        prog = CS.BatchedCodec(CS.make_codec(spec), p)
        base = torch.randn((c, p), generator=gen, device=dev)
        prog.roundtrip(base)                               # the keyframe
        mat = base + 0.01 * torch.randn((c, p), generator=gen, device=dev)
        ms = CS.time_ms(lambda: prog.roundtrip(mat))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        prog.roundtrip(mat)
        torch.cuda.synchronize()
        times.append({"name": f"roundtrip {spec}", "shape": [c, p],
                      "ms": ms, "launches": launches() - before,
                      "peak_bytes_above_held":
                      torch.cuda.max_memory_allocated() - held})
        del prog, base, mat
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    cases = [(CS.N_CLIENTS, CS.P_ROUND, CS.KG, False),
             (CS.SCALE_CLIENTS[-1], CS.P_EDGE, CS.KG, False),
             (CS.N_CLIENTS, CS.P_ROUND, CS.KG, True)] + [
        (3, p, kg, nf) for p in (999, 8 * 2048 + 5) for kg in (1, 3, 8)
        for nf in (False, True)]
    for c, p, kg, nonfinite in cases:
        x = (CS.nonfinite_rows if nonfinite else CS.codec_rows)(gen, dev, c,
                                                                  p)
        vals, planes = enc(x, kg)
        bad = torch.randint(0, 256, planes.shape, generator=gen, device=dev,
                            dtype=torch.uint8)
        key = f"{c}x{p} kg {kg}{' non-finite' if nonfinite else ''}"
        out[key] = [digest(vals, planes), digest(dec(vals, planes, p, kg)),
                    digest(*enc(CS.offset_copy(x), kg)),
                    digest(dec(vals, bad, p, kg))]
    return times, out


def codec_int8(CS, dev, peak):
    import torch

    def launches():
        return sum(CS.KERNELS[n]["fn"].launches
                   for n in (CS.INT8_DECODE, "batched_dequantize",
                             "batched_topk_decode"))

    def dec(q, sc, planes, p, kg=CS.KG, chunk=256):
        return CS.batched_topk_decode_int8(q, sc, planes, k=q.shape[1], p=p,
                                           group=CS.GROUP, kg=kg, chunk=chunk)

    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    times = []
    for c, p in ((CS.N_CLIENTS, CS.P_ROUND), (CS.SCALE_CLIENTS[-1],
                                              CS.P_EDGE)):
        q, sc, planes = CS.int8_payload(gen, dev, c, p, CS.KG, 256)
        before = launches()
        dec(q, sc, planes, p)
        n_launch = launches() - before
        bd = CS.bound(*CS.codec_work(CS.INT8_DECODE, c, p, CS.GROUP, CS.KG),
                      peak)
        ms = CS.time_ms(lambda: dec(q, sc, planes, p))
        times.append({"name": "decode_int8", "shape": [c, p], "ms": ms,
                      "bound_ms": bd[0], "bound_share": bd[0] / ms,
                      "launches": n_launch})
        del q, sc, planes
    gen = torch.Generator(device=dev).manual_seed(123)
    out = {}
    cases = [(CS.N_CLIENTS, CS.P_ROUND, CS.KG, 256),
             (CS.SCALE_CLIENTS[-1], CS.P_EDGE, CS.KG, 256)] + [
        (3, p, kg, chunk) for p in (999, 8 * 2048 + 5) for kg in (1, 3, 8)
        for chunk in (256, 100)]
    for c, p, kg, chunk in cases:
        for nonfinite in (False, True):
            q, sc, planes = CS.int8_payload(gen, dev, c, p, kg, chunk,
                                            nonfinite=nonfinite)
            bad = torch.randint(0, 256, planes.shape, generator=gen,
                                device=dev, dtype=torch.uint8)
            key = (f"{c}x{p} kg {kg} chunk {chunk}"
                   f"{' non-finite' if nonfinite else ''}")
            out[key] = [digest(dec(q, sc, planes, p, kg, chunk)),
                        digest(dec(CS.offset_copy(q), sc, planes, p, kg,
                                   chunk)),
                        digest(dec(q, sc, bad, p, kg, chunk))]
    return times, out


def main():
    tree, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sets = sys.argv[3:] or SETS
    bad = [s for s in sets if s not in SETS]
    if bad:
        sys.exit(f"unknown kernel sets {bad}: choose from {SETS}")
    if tree != HERE:
        shutil.copy(HERE / "chip_smoke.py", tree / "chip_smoke_ab.py")
        sys.path[:0] = [str(tree / "src"), str(tree)]
        from repro_torch.kernels import adaptive_combine as ACM
        if not hasattr(ACM, "adaptive_combine_tree"):
            def stand_in(bases, alphas, as_):
                return [ACM.adaptive_combine(*x)
                        for x in zip(bases, alphas, as_)]
            stand_in.launches = 0
            ACM.adaptive_combine_tree = stand_in
        from repro_torch.kernels import topk_pack as TPM
        if not hasattr(TPM, "batched_topk_encode"):
            def encode(x, *, group=8, kg):
                v, i = TPM.batched_topk_pack(x, group=group, kg=kg)
                return v, TPM.batched_idx_bitpack(i, group=group, kg=kg)

            def decode(vals, packed, *, k, p, group=8, kg):
                return TPM.batched_topk_unpack(
                    vals, TPM.batched_idx_bitunpack(packed, k=k, group=group,
                                                    kg=kg),
                    p=p, group=group, kg=kg)
            encode.launches = decode.launches = 0
            TPM.batched_topk_encode, TPM.batched_topk_decode = encode, decode
        if not hasattr(TPM, "batched_topk_decode_int8"):
            from repro_torch.kernels import quantize as QZM

            def decode_int8(codes, scales, packed, *, k, p, group=8, kg,
                            chunk=256):
                return TPM.batched_topk_decode(
                    QZM.batched_dequantize(codes, scales, chunk=chunk),
                    packed, k=k, p=p, group=group, kg=kg)
            decode_int8.launches = 0
            TPM.batched_topk_decode_int8 = decode_int8
        import chip_smoke_ab as CS
    else:
        sys.path.insert(0, str(tree))
        import chip_smoke as CS
    import torch
    if not hasattr(CS.RA, "_plan"):          # a tree before the variants
        CS.RA._plan = lambda *a, **k: type("P", (), {"variant": "one"})()
    dev = torch.device("cuda", 0)
    CS._build.build_all()
    peak = CS.peaks(torch.cuda.get_device_name(0))
    run = {"aggregate": aggregate, "kl": kl, "quantize": quantize,
           "dist": dist, "combine": combine, "codec": codec,
           "codec_int8": codec_int8}
    for name in sets:
        times, digests = run[name](CS, dev, peak)
        print("TIMES", name, label, json.dumps(times), flush=True)
        print("DIGESTS", name, label, json.dumps(digests), flush=True)


if __name__ == "__main__":
    main()
