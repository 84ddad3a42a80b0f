"""The multi-leaf adaptive combine (``kernels/adaptive_combine.py``:
``adaptive_combine_tree`` and its ``_plan``; ``ops.adaptive_combine_tree``,
which ``core.adaptive.combine`` goes through) on the CPU.

The tree equals the one-leaf ``ops.adaptive_combine`` applied leaf by leaf
and autograd of the plain ``b * al + a`` leaf by leaf, bit for bit, in
values and in gradients (its backward forms each kind of product in one
``_foreach_mul``), on the round's ReID head stacked
at C = 5 and as a stack of one, a reduced dense LM's nested adaptive tree
in bf16, a mixed fp32 / bf16 tree and a tree with an empty leaf. Against
the JAX package: bit for bit its eager ``core.adaptive.combine`` (two
roundings, fp32 and bf16), and within the product's rounding its Pallas
``adaptive_combine_tree`` in interpret mode (which may fuse the product
and the sum into one rounding: half an ulp of B*alpha plus an ulp of the
result, in the leaf's dtype). ``_plan``: one launch per dtype group, split
past ``MAX_LEAVES``, blocks that cover every element once, vector flags,
empty leaves, the 2^31 refusal. The CUDA kernel runs only on the card:
chip_smoke.py holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as JAD
from repro.kernels.adaptive_combine import \
    adaptive_combine_tree as j_combine_tree
from repro_torch import configs as CFG
from repro_torch.common.pytree import (leaf_paths, tree_leaves, tree_map,
                                       tree_stack)
from repro_torch.core import edge_model as EM
from repro_torch.core.adaptive import combine, split_params
from repro_torch.kernels import ops
from repro_torch.kernels import ref as REF
from repro_torch.kernels.adaptive_combine import (MAX_LEAVES, SPAN, Launch,
                                                  _plan,
                                                  adaptive_combine_tree)
from repro_torch.models import lm

ROUND_CLASSES = 200                      # the synthetic benchmark's ids


def _like(tree, rng, dtype=None):
    """A tree of ``tree``'s structure, standard-normal leaves from numpy."""
    return tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(
            dtype or t.dtype), tree)


def _head(clients):
    cfg = EM.EdgeModelConfig(n_classes=ROUND_CLASSES)
    gen = torch.Generator().manual_seed(clients)
    return tree_stack([EM.init_adaptive_layers(cfg, gen)
                       for _ in range(clients)])


def _lm_tree():
    cfg = CFG.get_config("qwen3-1.7b").reduced()
    _, adaptive = split_params(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(0)))
    return tree_map(lambda t: t.to(torch.bfloat16), adaptive)


def _mixed():
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"a": f(33, 7), "b": {"c": f(1000).bfloat16(), "d": f(4097)},
            "e": f(17, 9).bfloat16(), "f": f(5)}


def _with_empty():
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"w": f(6, 4), "empty": f(0, 3), "b": f(6)}


TREES = {"head_c5": lambda: _head(5), "head_c1": lambda: _head(1),
         "lm_bf16": _lm_tree, "mixed": _mixed, "empty_leaf": _with_empty}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_trees_bitwise(got, want):
    assert leaf_paths(got) == leaf_paths(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("b_grad", [False, True])
@pytest.mark.parametrize("name", list(TREES))
def test_tree_equals_per_leaf_combine_with_gradients(name, b_grad):
    """Values and the gradients of B (where it needs one), alpha and A equal
    the one-leaf entry's and autograd's of the plain ``b * al + a``, leaf by
    leaf, bit for bit; the structure and key order are B's."""
    B0 = TREES[name]()
    rng = np.random.default_rng(11)
    al0, A0, W = _like(B0, rng), _like(B0, rng), _like(B0, rng)

    def leaves(flag):
        return (tree_map(lambda t: t.clone().requires_grad_(flag), B0),
                tree_map(lambda t: t.clone().requires_grad_(True), al0),
                tree_map(lambda t: t.clone().requires_grad_(True), A0))

    tree_in, leaf_in, plain_in = leaves(b_grad), leaves(b_grad), \
        leaves(b_grad)
    got = ops.adaptive_combine_tree(*tree_in)
    runs = ((tree_map(ops.adaptive_combine, *leaf_in), leaf_in),
            (tree_map(REF.adaptive_combine_ref, *plain_in), plain_in))
    for want, _ in runs:
        _assert_trees_bitwise(got, want)
    assert list(got) == list(B0)
    for out, ins in ((got, tree_in),) + runs:
        sum(torch.sum(o.float() * w.float()) for o, w in
            zip(tree_leaves(out), tree_leaves(W))).backward()
    for _, ref_in in runs:
        for t_tree, l_tree in zip(tree_in, ref_in):
            for t, l in zip(tree_leaves(t_tree), tree_leaves(l_tree)):
                assert (t.grad is None) == (l.grad is None)
                if t.grad is not None:
                    assert torch.equal(_bits(t.grad), _bits(l.grad))
    assert (tree_leaves(tree_in[0])[0].grad is not None) == b_grad


def test_combine_goes_through_the_tree_entry(monkeypatch):
    """``core.adaptive.combine`` makes one tree call, no one-leaf call."""
    calls = []
    monkeypatch.setattr(ops, "adaptive_combine", lambda *a: calls.append(a))
    B = _head(2)
    rng = np.random.default_rng(0)
    out = combine(B, _like(B, rng), _like(B, rng))
    assert not calls and leaf_paths(out) == leaf_paths(B)


@pytest.mark.parametrize("name", ["head_c5", "head_c1", "lm_bf16",
                                  "mixed"])
def test_tree_matches_jax_eager_combine_and_interpret_kernel(name):
    """Bit for bit the reference's eager ``combine`` (product and sum each
    rounded in the leaf's dtype); within the product's rounding its Pallas
    ``adaptive_combine_tree`` in interpret mode."""
    B = TREES[name]()
    rng = np.random.default_rng(5)
    al, A = _like(B, rng), _like(B, rng)
    got = tree_leaves(ops.adaptive_combine_tree(B, al, A))
    to_j = lambda tree: tree_map(
        lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        tree)
    jB, jal, jA = to_j(B), to_j(al), to_j(A)
    eager = jax.tree.leaves(JAD.combine(jB, jal, jA))
    kernel = jax.tree.leaves(j_combine_tree(jB, jal, jA, interpret=True))
    assert len(got) == len(eager) == len(kernel)
    for g, e, k, b, a in zip(got, eager, kernel, tree_leaves(B),
                             tree_leaves(al)):
        e = np.asarray(e.astype(jnp.float32))
        k = np.asarray(k.astype(jnp.float32))
        gf = g.float().numpy()
        np.testing.assert_array_equal(gf, e)
        prod = (b.float() * a.float()).numpy()
        mant = 7 if g.dtype == torch.bfloat16 else 23
        ulp = lambda x: np.ldexp(1.0, np.frexp(np.abs(x))[1] - 1 - mant)
        bound = 0.5 * ulp(prod) + ulp(k)
        assert (np.abs(gf - k) <= bound).all()


def _addrs(off=(0, 0, 0, 0)):
    """Four 16-byte-aligned addresses (base, alpha, a, out), each moved by
    its offset."""
    return tuple(4096 * (k + 1) * 1024 + o for k, o in enumerate(off))


def test_plan_groups_by_dtype_in_first_appearance_order():
    f32, bf = torch.float32, torch.bfloat16
    plan = _plan([(bf, 10, _addrs()), (f32, 5000, _addrs()),
                  (bf, 9000, _addrs()), (f32, 1, _addrs())])
    assert [p.dtype for p in plan] == [bf, f32]
    assert [[i for i, _, _ in p.leaves] for p in plan] == [[0, 2], [1, 3]]
    assert plan[0] == Launch(bf, ((0, 0, True), (2, 1, True)), 3)
    assert plan[1] == Launch(f32, ((1, 0, True), (3, 2, True)), 3)


def test_plan_splits_past_max_leaves():
    leaves = [(torch.float32, 100, _addrs())] * (2 * MAX_LEAVES + 22)
    plan = _plan(leaves)
    assert [len(p.leaves) for p in plan] == [MAX_LEAVES, MAX_LEAVES, 22]
    assert [p.leaves[0][0] for p in plan] == [0, MAX_LEAVES, 2 * MAX_LEAVES]
    assert all(p.blocks == len(p.leaves) for p in plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_blocks_cover_every_element_once(dtype):
    """The kernel's own walk (each block finds the last leaf whose first
    block is at or below it, and covers SPAN values from there) visits each
    element of each leaf once, and no block falls outside its leaf."""
    rng = np.random.default_rng(9)
    span = SPAN[dtype]
    sizes = [1, span - 1, span, span + 1, 3 * span + 7, 0, 2,
             *rng.integers(1, 5 * span, 20).tolist()]
    plan = _plan([(dtype, n, _addrs()) for n in sizes])
    assert len(plan) == 1
    (launch,) = plan
    firsts = [first for _, first, _ in launch.leaves]
    seen = {i: np.zeros(sizes[i], np.int64) for i, _, _ in launch.leaves}
    for blk in range(launch.blocks):
        row = int(np.searchsorted(firsts, blk, side="right")) - 1
        i, first, _ = launch.leaves[row]
        start = (blk - first) * span
        assert start < sizes[i]
        seen[i][start:start + span] += 1
    assert all((v == 1).all() for v in seen.values())
    assert sorted(seen) == [i for i, n in enumerate(sizes) if n]


def test_plan_vector_flags_follow_every_base():
    f32 = torch.float32
    offs = [(0, 0, 0, 0), (4, 0, 0, 0), (0, 8, 0, 0), (0, 0, 12, 0),
            (0, 0, 0, 4), (16, 32, 48, 64)]
    plan = _plan([(f32, 999, _addrs(o)) for o in offs])
    assert [vec for _, _, vec in plan[0].leaves] == [True, False, False,
                                                     False, False, True]


def test_plan_skips_empty_leaves_and_refuses_what_the_kernel_cannot_take():
    f32 = torch.float32
    assert _plan([(f32, 0, _addrs())]) == []
    assert _plan([(f32, (1 << 31) - 1, _addrs())])[0].blocks == \
        -(-((1 << 31) - 1) // SPAN[f32])
    with pytest.raises(ValueError, match="2\\^31"):
        _plan([(f32, 5, _addrs()), (f32, 1 << 31, _addrs())])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _plan([(torch.float16, 5, _addrs())])


def test_tree_wrapper_refuses_what_it_cannot_launch():
    """The CUDA wrapper takes CUDA tensors only and refuses unequal lists
    and a dtype the kernel lacks before any launch; the count does not
    move."""
    before = adaptive_combine_tree.launches
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        adaptive_combine_tree([x], [x], [x])
    with pytest.raises(ValueError, match="bases"):
        adaptive_combine_tree([x], [x], [])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        adaptive_combine_tree([x.double()], [x.double()], [x.double()])
    assert adaptive_combine_tree([], [], []) == []
    assert adaptive_combine_tree.launches == before
