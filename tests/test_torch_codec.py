"""The port's wire codec (repro_torch.comm, the grouped top-k kernels'
plain versions) against the JAX package's (repro.comm, repro.kernels) on
the same numpy inputs, on the CPU.

Everything here is exact: the top-k ranks are integer counts, the values
one-hot sums with a single nonzero term (a finite value comes out
unchanged), the indices and bit-planes int32 shifts and masks, the int8
codes and scales and the bf16 bits the reference's arithmetic, and the
delta references advance by fp32 elementwise sums of equal operands. The
kernels are compared with ``assert_array_equal`` (values as numbers, so
+0.0 and -0.0 are equal; indices, codes and packed bytes bit for bit). A
bf16 buffer is compared by its bits (``view(np.uint16)``) and ``nbytes``:
the reference keeps an ml_dtypes array, the port's host codec the uint16
bit patterns and its batched codec a ``torch.bfloat16`` tensor. One
comparison is not exact, in either package: the host codec's int8 scale
divides by 127 and the batched codec's multiplies by fl32(1/127), so a row
of the batched stream and the host codec's payload of the same row may
differ by an ulp in a scale (and then by one code at a rounding boundary);
there the port's host codec is held to the JAX host codec bit for bit,
and its difference from the port's batched stream to the reference's own
(the same elements differ, by the same amounts). The CUDA kernels run only on the card, where chip_smoke.py holds them against
these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import batched as JBATCHED
from repro.comm import codec as JCODEC
from repro.common.pytree import tree_flatten_stacked as j_tree_flatten_stacked
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.comm import codec as CODEC
from repro_torch.comm.batched import BatchedCodec
from repro_torch.common.pytree import (tree_flatten_stacked,
                                       tree_unflatten_stacked)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import topk_pack as TP
from repro_torch.kernels.topk_pack import (batched_idx_bitpack,
                                           batched_idx_bitunpack,
                                           batched_topk_decode,
                                           batched_topk_decode_int8,
                                           batched_topk_encode,
                                           batched_topk_pack,
                                           batched_topk_unpack)
from repro_torch.obs import trace as POBS

BACKENDS = ["ref", "interpret"]
GROUP = 8


def _codec_input(rng, C, P, group=GROUP):
    """Rows with ties (repeated magnitudes of both signs), zeros, an
    all-zero row, and a tail group whose real elements are all zero."""
    x = rng.standard_normal((C, P)).astype(np.float32)
    x[0] = np.round(x[0] * 2.0) / 2.0               # many exact ties
    x[0, 3:6] = [0.5, -0.5, 0.5]
    x[1, :2 * group] = 0.0                           # two all-zero groups
    x[2] = 0.0                                       # an all-zero row
    x[3, P - P % group if P % group else P - group:] = 0.0
    return x


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jops(name, backend, *args, **kw):
    return getattr(JOPS, name)(*args, backend=backend, **kw)


def _bits(a):
    """A wire buffer as comparable numpy: bf16 (ml_dtypes or torch) as its
    uint16 bits, anything else as it is."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the four kernels' plain versions
# ---------------------------------------------------------------------------

KERNEL_CASES = [(P, GROUP, kg) for P in (8, 999, 2 * 2048 + 5)
                for kg in (1, 3, 8)] + [(640, 16, 5), (37, 4, 2)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P,group,kg", KERNEL_CASES)
def test_topk_kernels_match_jax(P, group, kg, backend):
    """Pack, unpack, bit-pack and bit-unpack against the JAX package's
    ``ref`` path and its Pallas kernels in interpret mode; with kg = 8 the
    ragged tail groups (999 and 4101 hold 7 and 5 real elements) select
    pad positions, whose indices (>= P) ship on the wire."""
    rng = np.random.default_rng(P * 31 + kg)
    x = _codec_input(rng, 4, P, group)
    vals, idx = ops.batched_topk_pack(torch.from_numpy(x), group=group, kg=kg)
    jv, ji = _jops("batched_topk_pack", backend, x, group=group, kg=kg)
    np.testing.assert_array_equal(_np(vals), np.asarray(jv))
    np.testing.assert_array_equal(_np(idx), np.asarray(ji))
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert vals.shape == (4, -(-P // group) * kg)
    if P % group and kg > P % group:
        assert int(idx.max()) >= P                   # a pad slot selected

    dense = ops.batched_topk_unpack(vals, idx, p=P, group=group, kg=kg)
    jd = _jops("batched_topk_unpack", backend, jv, ji, p=P, group=group,
               kg=kg)
    np.testing.assert_array_equal(_np(dense), np.asarray(jd))
    kept = _np(dense) != 0
    np.testing.assert_array_equal(_np(dense)[kept], x[kept])

    packed = ops.batched_idx_bitpack(idx, group=group, kg=kg)
    jp = _jops("batched_idx_bitpack", backend, ji, group=group, kg=kg)
    np.testing.assert_array_equal(_np(packed), np.asarray(jp))
    bits = (group - 1).bit_length()
    K = idx.shape[1]
    assert packed.dtype == torch.uint8
    assert packed.shape == (4, bits * ((K + 7) // 8))
    back = ops.batched_idx_bitunpack(packed, k=K, group=group, kg=kg)
    jb = _jops("batched_idx_bitunpack", backend, jp, k=K, group=group, kg=kg)
    np.testing.assert_array_equal(_np(back), np.asarray(jb))
    np.testing.assert_array_equal(_np(back), _np(idx))


def test_topk_rank_is_a_permutation_with_ties_to_lowest_index():
    x = torch.tensor([[1.0, -1.0, 0.0, 2.0, -2.0, 0.0, 1.0, 0.5]])
    rank = ref.grouped_topk_rank_ref(x, group=8)
    assert rank.tolist() == [[[2, 3, 6, 0, 1, 7, 4, 5]]]
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(JREF.grouped_topk_rank_ref(x.numpy(),
                                                            group=8)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_unpack_and_bitpack_of_malformed_indices_match_jax(backend):
    """Local indices outside 0..7 add nothing on unpack and pack their
    low bits; two slots on one local index sum."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 999)).astype(np.float32)
    vals, idx = ops.batched_topk_pack(torch.from_numpy(x), kg=3)
    bad = idx.clone()
    bad[0, 0] = -1                          # before group 0
    bad[0, 4] = 3 * GROUP + 9               # past group 1
    bad[1, 7] = bad[1, 6]                   # a duplicate in group 2
    bad[2, 10] = 1 << 20
    dense = ops.batched_topk_unpack(vals, bad, p=999, kg=3)
    jd = _jops("batched_topk_unpack", backend, vals.numpy(), bad.numpy(),
               p=999, group=GROUP, kg=3)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))
    wild = torch.from_numpy(rng.integers(-40, 1 << 12, (3, 30))
                            .astype(np.int32))
    packed = ops.batched_idx_bitpack(wild, kg=3)
    jp = _jops("batched_idx_bitpack", backend, wild.numpy(), group=GROUP,
               kg=3)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))


def test_pack_of_non_finite_rows_follows_the_reference():
    """NaN and infinity: the one-hot sums spread x * 0 = NaN across the
    group and a NaN never wins a comparison, exactly as in the reference
    (the CUDA kernel mirrors the same arithmetic)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24)).astype(np.float32)
    x[0, 2], x[0, 9] = np.nan, np.inf
    x[1, 3], x[1, 5], x[1, 17] = np.nan, np.nan, -np.inf
    vals, idx = ops.batched_topk_pack(torch.from_numpy(x), kg=3)
    jv, ji = JREF.batched_topk_pack_ref(x, group=GROUP, kg=3)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert np.isnan(vals.numpy()[0, :3]).all()


# ---------------------------------------------------------------------------
# the codec's path: encode (pack + bit-pack) and decode (bit-unpack +
# unpack), one launch each on the card
# ---------------------------------------------------------------------------

CODEC_CASES = [(group * 40 + tail, group, kg)
               for group in (2, 6, 8, 16) for tail in (0, 3)
               for kg in sorted({1, min(3, group), group})]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P,group,kg", CODEC_CASES)
def test_topk_encode_decode_match_jax(P, group, kg, backend):
    """Encode equals the JAX package's pack then bit-pack, decode its
    bit-unpack then unpack, bit for bit (P a multiple of the group and
    ragged by 3; G = 6 leaves local indices 6 and 7 unused in 3 bits)."""
    rng = np.random.default_rng(P * 7 + group + kg)
    x = _codec_input(rng, 4, P, group)
    vals, packed = ops.batched_topk_encode(torch.from_numpy(x), group=group,
                                           kg=kg)
    jv, ji = _jops("batched_topk_pack", backend, x, group=group, kg=kg)
    jp = _jops("batched_idx_bitpack", backend, ji, group=group, kg=kg)
    np.testing.assert_array_equal(_np(vals), np.asarray(jv))
    np.testing.assert_array_equal(_np(packed), np.asarray(jp))
    K = vals.shape[1]
    assert K == -(-P // group) * kg and packed.dtype == torch.uint8
    assert packed.shape == (4, (group - 1).bit_length() * -(-K // 8))

    dense = ops.batched_topk_decode(vals, packed, k=K, p=P, group=group,
                                    kg=kg)
    jb = _jops("batched_idx_bitunpack", backend, jp, k=K, group=group,
               kg=kg)
    jd = _jops("batched_topk_unpack", backend, jv, jb, p=P, group=group,
               kg=kg)
    np.testing.assert_array_equal(_np(dense), np.asarray(jd))
    assert dense.shape == (4, P) and dense.dtype == torch.float32
    kept = _np(dense) != 0
    np.testing.assert_array_equal(_np(dense)[kept], x[kept])


@pytest.mark.parametrize("group", [6, 8])
def test_topk_encode_of_non_finite_rows_follows_the_reference(group):
    """NaN and infinity through the one-step encode: the values spread
    x * 0 = NaN across a group as the reference's pack does, and the
    planes carry the low bits of its (then unclamped) indices."""
    rng = np.random.default_rng(13 + group)
    x = rng.standard_normal((3, 5 * group + 2)).astype(np.float32)
    x[0, 2], x[0, group + 1] = np.nan, np.inf
    x[1, 3], x[1, 5], x[1, 2 * group + 1] = np.nan, np.nan, -np.inf
    x[2, -1] = np.inf                              # in the ragged tail
    vals, packed = ops.batched_topk_encode(torch.from_numpy(x), group=group,
                                           kg=3)
    jv, ji = JREF.batched_topk_pack_ref(x, group=group, kg=3)
    jp = JREF.batched_idx_bitpack_ref(ji, group=group, kg=3)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    assert np.isnan(vals.numpy()[0, :3]).all()
    dense = ops.batched_topk_decode(vals, packed, k=vals.shape[1],
                                    p=x.shape[1], group=group, kg=3)
    jd = JREF.batched_topk_unpack_ref(
        jv, JREF.batched_idx_bitunpack_ref(jp, k=vals.shape[1], group=group,
                                           kg=3),
        p=x.shape[1], group=group, kg=3)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("group", [6, 8])
def test_topk_decode_of_malformed_planes_matches_jax(group, backend):
    """Planes of random bytes: local indices that repeat in a group sum,
    and at G = 6 the indices 6 and 7 add nothing."""
    rng = np.random.default_rng(21 + group)
    C, P, kg = 3, 40 * group + 5, 3
    K = -(-P // group) * kg
    bits = (group - 1).bit_length()
    vals = rng.standard_normal((C, K)).astype(np.float32)
    bad = rng.integers(0, 256, (C, bits * -(-K // 8)), dtype=np.uint8)
    dense = ops.batched_topk_decode(torch.from_numpy(vals),
                                    torch.from_numpy(bad), k=K, p=P,
                                    group=group, kg=kg)
    jb = _jops("batched_idx_bitunpack", backend, bad, k=K, group=group,
               kg=kg)
    jd = _jops("batched_topk_unpack", backend, vals, jb, p=P, group=group,
               kg=kg)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))


@pytest.mark.parametrize("rows,p,group,kg", [
    (5, 37696, 8, 3), (1000, 57664, 8, 3), (3, 999, 8, 8), (2, 5, 6, 3),
    (4, 256 * 8 * 3, 8, 1), (7, 256 * 16 + 1, 16, 16), (1, 2, 2, 1)])
def test_codec_plan_tiles_every_slot_once_on_byte_boundaries(rows, p, group,
                                                             kg):
    nb = -(-p // group)
    K, kb = nb * kg, -(-nb * kg // 8)
    for per in TP.PER_THREAD:
        plan = TP._plan(rows, p, group, kg, aligned=True, per=per)
        assert plan.groups == TP.THREADS * per
        assert plan.grid == (-(-nb // plan.groups), rows)
        slots = [plan.slots(x) for x in range(plan.grid[0])]
        assert all(s.start % 8 == 0 and len(s) > 0 for s in slots)
        assert [i for s in slots for i in s] == list(range(K))
        planes = [plan.plane_bytes(x) for x in range(plan.grid[0])]
        assert [b for r in planes for b in r] == list(range(kb))
        assert plan.vec == (group % 4 == 0 and p % 4 == 0)
        assert not TP._plan(rows, p, group, kg, aligned=False, per=per).vec


@pytest.mark.parametrize("rows,p,per", [(5, 37696, 1), (9, 57664, 1),
                                        (10, 57664, 2), (100, 57664, 2),
                                        (1000, 57664, 2), (1, 10 ** 6, 2)])
def test_codec_plan_takes_two_groups_a_thread_past_a_small_grid(rows, p,
                                                                per):
    """One group a thread while the one-group grid has at most SMALL_GRID
    blocks (the round's C = 5: 95), two past it (the fleet's)."""
    assert TP._plan(rows, p, 8, 3, aligned=True).per == per


# the int8 codec's decode: dequantize, bit-unpack and unpack in one launch
# on the card

DECODE_INT8_CASES = [(group * 150 + 3, group, kg, chunk)
                     for group in (2, 8, 16)
                     for kg in sorted({1, min(3, group), group})
                     for chunk in (256, 100)]


def _int8_payload(rng, C, P, group, kg, chunk):
    """A sparse payload as the int8 codec ships it: the encode's values
    quantized per chunk, with the int8 extremes, -128 among them, written
    in."""
    x = _codec_input(rng, C, P, group)
    vals, packed = ops.batched_topk_encode(torch.from_numpy(x), group=group,
                                           kg=kg)
    q, scales = ops.batched_quantize(vals, chunk=chunk)
    q[3, :3] = torch.tensor([-128, 127, -127], dtype=torch.int8)
    return q, scales, packed


def _with_nonfinite_scales(scales):
    """A NaN, a +inf and a -inf scale, as the quantizer gives a chunk that
    holds NaN or an infinity."""
    bad = scales.clone()
    nc = bad.shape[1]
    bad[0, min(1, nc - 1)] = float("nan")
    bad[1, 0] = float("inf")
    bad[2, nc - 1] = float("-inf")
    return bad


def _jax_decode_int8(decode_ops, q, scales, packed, *, p, group, kg, chunk):
    """The JAX package's dequantize, bit-unpack and unpack, through
    ``decode_ops(name, *args, **kw)``."""
    K = q.shape[1]
    jv = decode_ops("batched_dequantize", q.numpy(), scales.numpy(),
                    chunk=chunk)
    jb = decode_ops("batched_idx_bitunpack", packed.numpy(), k=K,
                    group=group, kg=kg)
    return np.asarray(decode_ops("batched_topk_unpack", jv, jb, p=p,
                                 group=group, kg=kg))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P,group,kg,chunk", DECODE_INT8_CASES)
def test_topk_decode_int8_matches_jax(P, group, kg, chunk, backend):
    """The int8 decode equals the JAX package's dequantize, then
    bit-unpack, then unpack, bit for bit, and the port's two-step
    ``batched_topk_decode(batched_dequantize(...))``: ragged P (3 past a
    group multiple), a chunk that divides no tile (100), the code -128.

    With a NaN, a +inf and a -inf scale it equals the reference's written
    arithmetic (``repro.kernels.ref``, eager), where value * 0 spreads NaN
    across every group holding a non-finite value. The JAX package's
    jitted ``ops`` (both backends) differ there: XLA rewrites the one-hot
    product into a select, which keeps a non-finite value at its own slot
    alone; every group holding none is equal bit for bit."""
    rng = np.random.default_rng(P * 11 + group + kg + chunk)
    q, scales, packed = _int8_payload(rng, 4, P, group, kg, chunk)
    K = q.shape[1]
    kw = dict(p=P, group=group, kg=kg, chunk=chunk)
    jitted = lambda name, *a, **k: _jops(name, backend, *a, **k)
    eager = lambda name, *a, **k: getattr(JREF, f"{name}_ref")(*a, **k)
    for sc in (scales, _with_nonfinite_scales(scales)):
        dense = ops.batched_topk_decode_int8(q, sc, packed, k=K, **kw)
        assert dense.shape == (4, P) and dense.dtype == torch.float32
        bits = dense.view(torch.int32).numpy()
        two = ops.batched_topk_decode(
            ops.batched_dequantize(q, sc, chunk=chunk), packed, k=K, p=P,
            group=group, kg=kg)
        np.testing.assert_array_equal(bits, two.view(torch.int32).numpy())
        np.testing.assert_array_equal(
            bits, ref.batched_topk_decode_int8_ref(q, sc, packed, k=K, **kw)
            .view(torch.int32).numpy())
        jd = _jax_decode_int8(jitted, q, sc, packed, **kw)
        finite = bool(torch.isfinite(sc).all())
        if finite:
            np.testing.assert_array_equal(_np(dense), jd)
            continue
        np.testing.assert_array_equal(
            _np(dense), _jax_decode_int8(eager, q, sc, packed, **kw))
        nb = -(-P // group)
        pad = np.pad(_np(dense), ((0, 0), (0, nb * group - P)))
        clean = np.isfinite(pad.reshape(4, nb, group)).all(-1)
        keep = np.repeat(clean, group, axis=1)[:, :P]
        assert not keep.all() and np.isnan(_np(dense)).any()
        np.testing.assert_array_equal(_np(dense)[keep], jd[keep])


SPARSE_PAYLOAD_CALLS = {
    # spec: (the dense keyframe's calls, a residual payload's calls)
    "delta+topk": ({}, {"batched_topk_encode": 1, "batched_topk_decode": 1}),
    "topk+int8": ({"batched_dequantize": 1},
                  {"batched_topk_encode": 1, "batched_topk_decode_int8": 1}),
}


@pytest.mark.parametrize("spec", sorted(SPARSE_PAYLOAD_CALLS))
def test_batched_codec_sparse_payload_takes_one_encode_and_one_decode(
        spec, monkeypatch):
    """A roundtrip of a sparse payload calls ``ops.batched_topk_encode``
    once and one decode once: ``batched_topk_decode`` for fp32 values,
    ``batched_topk_decode_int8`` (dequantize folded in) for int8 codes,
    with no ``batched_dequantize`` on a residual; none of the four
    one-stage ops (counted on ``ops``). The dense keyframe calls no codec
    op (int8: one ``batched_dequantize``)."""
    calls = {}
    for name in ("batched_topk_encode", "batched_topk_decode",
                 "batched_topk_decode_int8", "batched_dequantize",
                 "batched_topk_pack", "batched_topk_unpack",
                 "batched_idx_bitpack", "batched_idx_bitunpack"):
        def counted(*a, _name=name, _fn=getattr(ops, name), **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    keyframe, residual = SPARSE_PAYLOAD_CALLS[spec]
    rng = np.random.default_rng(8)
    prog = BatchedCodec(CODEC.make_codec(spec), 999)
    prog.roundtrip(torch.from_numpy(_codec_input(rng, 4, 999)))
    assert calls == keyframe
    for r in range(2):
        recon, buffers = prog.roundtrip(
            torch.from_numpy(_codec_input(rng, 4, 999)))
        assert "idx_bits" in buffers
        assert calls == {n: keyframe.get(n, 0) + (r + 1) * residual.get(n, 0)
                         for n in set(keyframe) | set(residual)}


CUDA_WRAPPERS = [
    (batched_topk_encode, lambda: (torch.zeros(2, 16),), {"kg": 3}),
    (batched_topk_decode,
     lambda: (torch.zeros(2, 6), torch.zeros(2, 3, dtype=torch.uint8)),
     {"k": 6, "p": 16, "kg": 3}),
    (batched_topk_decode_int8,
     lambda: (torch.zeros(2, 6, dtype=torch.int8), torch.ones(2, 1),
              torch.zeros(2, 3, dtype=torch.uint8)),
     {"k": 6, "p": 16, "kg": 3}),
    (batched_topk_pack, lambda: (torch.zeros(2, 16),), {"kg": 3}),
    (batched_topk_unpack,
     lambda: (torch.zeros(2, 6), torch.zeros(2, 6, dtype=torch.int32)),
     {"p": 16, "kg": 3}),
    (batched_idx_bitpack, lambda: (torch.zeros(2, 6, dtype=torch.int32),),
     {"kg": 3}),
    (batched_idx_bitunpack, lambda: (torch.zeros(2, 3, dtype=torch.uint8),),
     {"k": 6, "kg": 3}),
]


@pytest.mark.parametrize("wrapper,args,kw", CUDA_WRAPPERS,
                         ids=[w.__name__ for w, _, _ in CUDA_WRAPPERS])
def test_topk_wrappers_refuse_cpu_tensors(wrapper, args, kw):
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wrapper(*args(), **kw)
    assert wrapper.launches == before


def test_topk_wrappers_refuse_budgets_the_kernel_does_not_take():
    for kw in ({"group": 17, "kg": 3}, {"group": 8, "kg": 9},
               {"group": 8, "kg": 0}):
        with pytest.raises(ValueError, match="group|kg"):
            batched_topk_pack(torch.zeros(2, 16), **kw)
    with pytest.raises(ValueError, match="slots"):
        batched_topk_unpack(torch.zeros(2, 5), torch.zeros(2, 5,
                                                           dtype=torch.int32),
                            p=16, kg=3)
    with pytest.raises(ValueError, match="planes"):
        batched_idx_bitunpack(torch.zeros(2, 4, dtype=torch.uint8), k=6,
                              kg=3)


@pytest.mark.parametrize("kw", [{"group": 17, "kg": 3}, {"group": 1, "kg": 1},
                                {"group": 8, "kg": 9}, {"group": 8, "kg": 0}],
                         ids=["group17", "group1", "kg9", "kg0"])
def test_codec_wrappers_refuse_budgets_the_kernel_does_not_take(kw):
    """Encode and both decodes take 2 <= group <= 16 (a plane needs a bit)
    and 1 <= kg <= group, and none launches on a refusal."""
    wrappers = (batched_topk_encode, batched_topk_decode,
                batched_topk_decode_int8)
    before = [w.launches for w in wrappers]
    with pytest.raises(ValueError, match="group|kg"):
        batched_topk_encode(torch.zeros(2, 16), **kw)
    with pytest.raises(ValueError, match="group|kg"):
        batched_topk_decode(torch.zeros(2, 6),
                            torch.zeros(2, 3, dtype=torch.uint8), k=6, p=16,
                            **kw)
    with pytest.raises(ValueError, match="group|kg"):
        batched_topk_decode_int8(torch.zeros(2, 6, dtype=torch.int8),
                                 torch.ones(2, 1),
                                 torch.zeros(2, 3, dtype=torch.uint8), k=6,
                                 p=16, **kw)
    assert [w.launches for w in wrappers] == before


def test_codec_wrappers_refuse_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="slots"):
        batched_topk_decode(torch.zeros(2, 5),
                            torch.zeros(2, 3, dtype=torch.uint8), k=5, p=16,
                            kg=3)
    with pytest.raises(ValueError, match="planes"):
        batched_topk_decode(torch.zeros(2, 6),
                            torch.zeros(2, 4, dtype=torch.uint8), k=6, p=16,
                            kg=3)
    with pytest.raises(ValueError, match="rows"):
        batched_topk_encode(torch.zeros(TP.MAX_ROWS + 1, 8), kg=3)
    planes = torch.zeros(2, 3, dtype=torch.uint8)
    codes = torch.zeros(2, 6, dtype=torch.int8)
    with pytest.raises(ValueError, match="slots"):
        batched_topk_decode_int8(codes[:, :5], torch.ones(2, 1), planes, k=5,
                                 p=16, kg=3)
    with pytest.raises(ValueError, match="planes"):
        batched_topk_decode_int8(codes, torch.ones(2, 1),
                                 torch.zeros(2, 4, dtype=torch.uint8), k=6,
                                 p=16, kg=3)
    with pytest.raises(ValueError, match="chunk"):
        batched_topk_decode_int8(codes, torch.ones(2, 1), planes, k=6, p=16,
                                 kg=3, chunk=0)
    for cols, chunk in ((2, 256), (1, 4)):    # a column too many / too few
        with pytest.raises(ValueError, match="scales"):
            batched_topk_decode_int8(codes, torch.ones(2, cols), planes, k=6,
                                     p=16, kg=3, chunk=chunk)


# ---------------------------------------------------------------------------
# the numpy host codec copy
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((13, 7)).astype(np.float32) * scale,
                  "b": rng.standard_normal((7,)).astype(np.float32)},
            "c": rng.standard_normal((41,)).astype(np.float32)}


@pytest.mark.parametrize("P,group,kg", [(999, 8, 3), (64, 8, 8), (37, 4, 1)])
def test_host_selection_and_index_packing_equal_jax(P, group, kg):
    rng = np.random.default_rng(P)
    x = _codec_input(rng, 4, P, group)[0]
    v, i = CODEC.grouped_topk_select_host(x, group, kg)
    jv, ji = JCODEC.grouped_topk_select_host(x, group, kg)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(
        i, ref.batched_topk_pack_ref(torch.from_numpy(x[None]), group=group,
                                     kg=kg)[1][0].numpy())
    packed = CODEC.pack_group_indices_host(i, group, kg)
    np.testing.assert_array_equal(packed,
                                  JCODEC.pack_group_indices_host(i, group, kg))
    np.testing.assert_array_equal(
        CODEC.unpack_group_indices_host(packed, i.size, group, kg), i)
    for k in (1, 17, P):
        gv, gi = CODEC.topk_select_host(x, k)
        jgv, jgi = JCODEC.topk_select_host(x, k)
        np.testing.assert_array_equal(gv, jgv)
        np.testing.assert_array_equal(gi, jgi)


def test_host_quantize_copy_equals_jax():
    rng = np.random.default_rng(4)
    v = (rng.standard_normal(1000) * 3.0).astype(np.float32)
    v[:256] = 0.0                                    # an all-zero chunk
    q, s = CODEC.quantize_host(v, 256)
    jq, js = JCODEC.quantize_host(v, 256)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(CODEC.dequantize_host(q, s, 256),
                                  JCODEC.dequantize_host(jq, js, 256))


def test_bf16_bits_equal_ml_dtypes():
    """The host codec's bf16 stage without ml_dtypes: the same bits as the
    reference's ``np.asarray(v, dtype=jnp.bfloat16)`` for normal, subnormal,
    halfway, infinite and NaN inputs (arbitrary fp32 bit patterns), and an
    exact way back."""
    rng = np.random.default_rng(12)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        rng.integers(0, 2 ** 32, 8192, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0, 1.00390625,
                  1.01171875, 3.4028235e38, 1e-45], np.float32)])
    with np.errstate(invalid="ignore"):
        ref_bits = np.asarray(x, dtype=jnp.bfloat16).view(np.uint16)
    bits = CODEC.bf16_bits_host(x)
    assert bits.dtype == np.uint16 and bits.nbytes == ref_bits.nbytes
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_array_equal(
        CODEC.bf16_bits_to_f32(bits).view(np.uint32),
        np.asarray(ref_bits.view(jnp.bfloat16), np.float32).view(np.uint32))


HOST_SPECS = [("raw", {}), ("delta", {}), ("topk", {}), ("delta+topk", {}),
              ("topk", {"delta": False}), ("topk", {"k": 60, "delta": False}),
              ("delta+topk", {"keep_frac": 0.25}), ("int8", {}), ("bf16", {}),
              ("topk+int8", {}), ("delta+topk+bf16", {}),
              ("topk+int8", {"delta": False})]


@pytest.mark.parametrize("spec,opts", HOST_SPECS,
                         ids=[f"{s}-{o}" for s, o in HOST_SPECS])
def test_host_codec_stream_equals_jax(spec, opts):
    """Three payloads per peer through both packages' PipelineCodec
    (encode + decode, and roundtrip): equal buffers, bytes and
    reconstructions, delta state included."""
    rng = np.random.default_rng(9)
    port, jax_ = (CODEC.make_codec(spec, **opts),
                  JCODEC.make_codec(spec, **opts))
    port_rt, jax_rt = (CODEC.make_codec(spec, **opts),
                       JCODEC.make_codec(spec, **opts))
    for r in range(3):
        for peer in (0, 1):
            tree = _tree(rng, scale=1.0 + r)
            p, j = port.encode(tree, peer=peer), jax_.encode(tree, peer=peer)
            assert sorted(p.buffers) == sorted(j.buffers)
            for name in p.buffers:
                np.testing.assert_array_equal(p.buffers[name],
                                              _bits(j.buffers[name]))
                assert p.buffers[name].dtype == _bits(j.buffers[name]).dtype
                assert p.buffers[name].nbytes == j.buffers[name].nbytes
            assert p.nbytes == j.nbytes
            assert p.schema["sparse"] == j.schema["sparse"]
            dp, dj = port.decode(p, peer=peer), jax_.decode(j, peer=peer)
            for a, b in zip(jax.tree.leaves(dj), (dp["a"]["b"], dp["a"]["w"],
                                                  dp["c"])):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype and a.shape == b.shape
            (rp, pp), (rj, pj) = (port_rt.roundtrip(tree, peer=peer),
                                  jax_rt.roundtrip(tree, peer=peer))
            assert pp.nbytes == pj.nbytes == p.nbytes
            np.testing.assert_array_equal(rp["c"], rj["c"])
            np.testing.assert_array_equal(rp["a"]["w"], rj["a"]["w"])


def test_make_codec_parses_as_the_reference():
    for spec in ("raw", "delta", "topk", "delta+topk", " topk + delta ",
                 "int8", "bf16", "topk+int8", "delta+topk+bf16"):
        p, j = CODEC.make_codec(spec), JCODEC.make_codec(spec)
        assert (p.delta, p.topk, p.group, p.kg, p.quant, p.chunk) == (
            j.delta, j.topk, j.group, j.kg, j.quant, j.chunk)
    assert CODEC.make_codec(None) is None
    stateless = CODEC.make_codec("topk", delta=False)
    assert stateless.topk and not stateless.delta
    assert CODEC.make_codec("topk", keep_frac=0.25).kg == 2
    assert CODEC.make_codec("topk", k=10).group is None
    assert CODEC.make_codec("topk").k_for(999) == JCODEC.make_codec(
        "topk").k_for(999) == 125 * 3
    with pytest.raises(ValueError, match="unknown codec stage"):
        CODEC.make_codec("topk+gzip")
    with pytest.raises(ValueError, match="at most one quantization"):
        CODEC.make_codec("int8+bf16")
    assert CODEC.make_codec("int8", chunk=64).chunk == 64
    with pytest.raises(ValueError, match="unknown quant stage"):
        CODEC.PipelineCodec("x", quant="fp8")
    with pytest.raises(ValueError, match="global top-k"):
        BatchedCodec(CODEC.make_codec("topk", k=10), 100)


# ---------------------------------------------------------------------------
# the batched device codec
# ---------------------------------------------------------------------------


BATCHED_SPECS = [("delta+topk", {}), ("topk", {}), ("topk", {"delta": False}),
                 ("delta", {}), ("raw", {}), ("int8", {}), ("bf16", {}),
                 ("topk+int8", {}), ("delta+topk+bf16", {}),
                 ("topk+int8", {"delta": False})]


@pytest.mark.parametrize("spec,opts", BATCHED_SPECS,
                         ids=[f"{s}-{o}" for s, o in BATCHED_SPECS])
def test_batched_codec_stream_matches_jax_and_host(spec, opts):
    """A keyframe and two residual payloads of (C, P) rows: equal buffers,
    bit-equal reconstructions and equal per-client bytes against the JAX
    BatchedCodec; each row equal to the port's host codec, whose per-peer
    delta stream it mirrors (``tests/test_comm_codec.py``'s parity, made
    exact; for int8 the host rows differ from the batched ones exactly
    where the reference's do, module docstring)."""
    rng = np.random.default_rng(6)
    C, P = 4, 999
    port = BatchedCodec(CODEC.make_codec(spec, **opts), P)
    jref = JBATCHED.BatchedCodec(JCODEC.make_codec(spec, **opts), P)
    host = CODEC.make_codec(spec, **opts)
    jhost = JCODEC.make_codec(spec, **opts)
    enc_only = BatchedCodec(CODEC.make_codec(spec, **opts), P)
    for r in range(3):
        mat = _codec_input(rng, C, P) * np.float32(1 + r)
        with POBS.active(POBS.Tracer()):     # the encode's metrics too
            recon, buffers = port.roundtrip(torch.from_numpy(mat))
        jrecon, jbuf = jref.roundtrip(jnp.asarray(mat))
        sparse = port.topk and (r > 0 or not port.delta)
        assert ("idx_bits" in buffers) == sparse
        assert sorted(buffers) == sorted(jbuf)
        for name in buffers:
            np.testing.assert_array_equal(_bits(buffers[name]),
                                          _bits(jbuf[name]))
        np.testing.assert_array_equal(recon.numpy(), np.asarray(jrecon))
        per_client = port.per_client_bytes(buffers)
        assert per_client == jref.per_client_bytes(jbuf)
        # encode() and decode() on their own advance the same references
        np.testing.assert_array_equal(
            enc_only.decode(enc_only.encode(torch.from_numpy(mat))).numpy(),
            recon.numpy())
        for c in range(C):
            payload = host.encode({"w": mat[c]}, peer=c)
            assert payload.nbytes == per_client
            decoded = host.decode(payload, peer=c)["w"]
            if port.quant == "int8":
                jdecoded = jhost.decode(jhost.encode({"w": mat[c]}, peer=c),
                                        peer=c)["w"]
                np.testing.assert_array_equal(decoded, jdecoded)
                np.testing.assert_array_equal(
                    decoded - recon[c].numpy(),
                    jdecoded - np.asarray(jrecon[c]))
                continue
            for name in buffers:
                np.testing.assert_array_equal(payload.buffers[name],
                                              _bits(buffers[name][c]))
            np.testing.assert_array_equal(decoded, recon[c].numpy())
    assert enc_only.last_metrics is None          # untraced: none computed
    assert set(port.last_metrics) == {"residual_norm", "kept_energy",
                                      "keep_rate"}
    for name, v in port.last_metrics.items():
        np.testing.assert_allclose(v.numpy(),
                                   np.asarray(jref.last_metrics[name]),
                                   rtol=1e-6, atol=0, err_msg=name)


def test_nested_stacked_flatten_matches_jax():
    """The codec's (C, P) rows of a nested payload: the JAX package's
    column order, and back to the same tree and dtypes."""
    rng = np.random.default_rng(2)
    tree = {"theta": {"l1.w": rng.standard_normal((3, 4, 5)),
                      "bn.bias": rng.standard_normal((3, 5)),
                      "head.w": rng.standard_normal((3, 5, 2))},
            "task_feature": rng.standard_normal((3, 6))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    port = jax.tree.map(torch.from_numpy, tree)
    port["theta"]["bn.bias"] = port["theta"]["bn.bias"].double()
    mat, meta = tree_flatten_stacked(port)
    jmat, _ = j_tree_flatten_stacked(tree)
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jmat))
    back = tree_unflatten_stacked(mat, meta)
    assert back["theta"]["bn.bias"].dtype == torch.float64
    assert list(back) == ["task_feature", "theta"]
    np.testing.assert_array_equal(back["theta"]["head.w"].numpy(),
                                  tree["theta"]["head.w"])
