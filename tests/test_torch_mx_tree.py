"""Parity of the port's grouped MX tree path (``core/mx.py``:
``quantize_tree_mx`` / ``dequantize_tree_mx`` / ``quantize_tree`` through
``ops.mx_quantize_many`` / ``mx_dequantize_many``) with the JAX package's
``repro.core.mx``, run live on the CPU, and of the pure-Python planner that
lays out a tree's launches and arenas on the card
(``kernels/mx_quantize.py::plan_many``).

Tolerance: none. MX quantization is integer bit manipulation plus
power-of-two scales, so the port's trees equal the reference's bit for bit
(mantissas, exponents, micro-exponent bits and the dequantized values) at
mx4 and mx6, where the reference's ``jnp.exp2`` is exact on these weights
(``tests/test_torch_mx.py`` pins mx9's divergence).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dacapo_pairs as jpairs
from repro.core import mx as jmx
from repro.models.registry import make_vision_model as j_make_vision_model
from repro_torch.convert import params_from_numpy
from repro_torch.core import mx as tmx
from repro_torch.kernels import mx_quantize as tmq
from repro_torch.kernels import ops as tops

PRECISIONS = ("mx4", "mx6")
F32_DENORMAL = np.float32(1e-40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread per test worker process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_mx(p) -> bool:
    return isinstance(p, (tmx.MXLeaf, jmx.MXLeaf))


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_mx)
    return {jax.tree_util.keystr(p): v for p, v in flat}


def _bits(a) -> np.ndarray:
    """A tensor or array as its raw bytes, with its dtype's name."""
    if isinstance(a, torch.Tensor):
        name = str(a.dtype).split(".")[-1]
        a = a.contiguous().view(torch.uint8).numpy()
    else:
        a = np.asarray(a)
        name = a.dtype.name
        a = a.view(np.uint8)
    return name, a.tobytes(), a.shape[:-1]


def _assert_same(got, want) -> None:
    g, w = _bits(got), _bits(want)
    assert g[0] == w[0] and g[2] == w[2], (g[0], w[0], g[2], w[2])
    assert g[1] == w[1]


def _assert_trees_match(tp, jp, precision, min_size=1024):
    """The port's three tree functions against the reference's on the same
    weights: every MXLeaf's fields, the dequantized tree and the fake-quant
    tree bitwise; the same leaves skipped, and skipped leaves returned as
    the very source objects."""
    qt, qj = (tmx.quantize_tree_mx(tp, precision, min_size),
              jmx.quantize_tree_mx(jp, precision, min_size))
    got, want, src = _paths(qt), _paths(qj), _paths(tp)
    assert got.keys() == want.keys() == src.keys()
    for key, leaf in got.items():
        assert isinstance(leaf, tmx.MXLeaf) == isinstance(want[key],
                                                          jmx.MXLeaf), key
        if isinstance(leaf, tmx.MXLeaf):
            for f in ("mantissa", "exponent", "mx_bits"):
                _assert_same(getattr(leaf.q, f), getattr(want[key].q, f))
            assert (leaf.shape, leaf.k) == (want[key].shape, want[key].k)
        else:
            assert leaf is src[key], key
    for got_tree, want_tree in (
            (tmx.dequantize_tree_mx(qt), jmx.dequantize_tree_mx(qj)),
            (tmx.quantize_tree(tp, precision, min_size),
             jmx.quantize_tree(jp, precision, min_size))):
        got, want = _paths(got_tree), _paths(want_tree)
        assert got.keys() == want.keys()
        for key, leaf in got.items():
            if isinstance(src[key], torch.Tensor) and tmx._quantizable(
                    src[key], min_size):
                _assert_same(leaf, want[key])
            else:
                assert leaf is src[key], key
    return qt


@pytest.fixture(scope="module", params=["RESNET18", "WIDERESNET50",
                                        "VIT_B32"])
def reduced_tree(request):
    """A reduced model's tree initialized by the JAX package and carried
    across to the port as numpy."""
    cfg = getattr(jpairs, request.param).reduced()
    jp = j_make_vision_model(cfg).init(jax.random.PRNGKey(1))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_reduced_model_trees_match_jax(reduced_tree, precision):
    jp, tp = reduced_tree
    tops.reset_kernel_stats()
    qt = _assert_trees_match(tp, jp, precision)
    n = sum(isinstance(v, tmx.MXLeaf) for v in _paths(qt).values())
    assert n > 5
    # One call per tree and direction (quantize_tree_mx, dequantize_tree_mx
    # and quantize_tree's round trip), all on the plain path.
    assert tops.kernel_stats() == {"mx_quantize": {"plain": 2},
                                   "mx_dequantize": {"plain": 2}}


def _hard_tree(rng):
    """Every hard case of a serving tree, as numpy: a ragged-K leaf (the
    classifier heads' K = 1000), a K that is not a multiple of 4, a bf16
    leaf, zero and denormal blocks beside normal ones, a 3-D leaf and
    leaves the predicate skips (1-D, too small, integer)."""
    ragged = rng.normal(size=(40, 1000)).astype(np.float32)
    ragged[3, 992:] = 0.0  # the padded last block holds zeros only
    blocks = rng.normal(size=(64, 48)).astype(np.float32)
    blocks[0, :16] = 0.0
    blocks[1, 16:32] = F32_DENORMAL * np.arange(1, 17, dtype=np.float32)
    blocks[2, 32:48] = np.tile(np.float32([1e-40, 0.0, 1.0, -1.0]), 4)
    blocks[3, :16] = -0.0
    blocks[4, :16] = np.tile(np.float32([1.5, 2.5, -0.5, 3.5, 0.75, -1.25,
                                         6.5, 7.5]), 2)
    return {
        "head": {"w": ragged, "b": rng.normal(size=(1000,)).astype(
            np.float32)},
        "odd": rng.normal(size=(60, 30)).astype(np.float32),
        "half": rng.normal(size=(24, 96)).astype(np.float32),
        "blocks": [blocks, rng.normal(size=(4, 16, 24)).astype(np.float32)],
        "small": rng.normal(size=(8, 16)).astype(np.float32),
        "steps": np.arange(2048, dtype=np.int32).reshape(32, 64),
    }


def _carry(tree):
    """The hard tree on both sides; the "half" leaf as bf16 (both packages
    round the same fp32 values to nearest even)."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp["half"] = jp["half"].astype(jnp.bfloat16)
    tp = jax.tree_util.tree_map(torch.from_numpy, tree)
    tp["half"] = tp["half"].to(torch.bfloat16)
    return jp, tp


@pytest.mark.parametrize("precision", PRECISIONS)
def test_hard_cases_tree_matches_jax(precision):
    jp, tp = _carry(_hard_tree(np.random.default_rng(2)))
    qt = _assert_trees_match(tp, jp, precision)
    half = tmx.dequantize_tree_mx(qt)["half"]
    assert half.dtype == torch.bfloat16 and half.shape == (24, 96)
    assert qt["head"]["w"].q.mantissa.shape == (40, 1008)
    # Zero, denormal and negative-zero blocks: exponent -126, no bits,
    # zero mantissas; denormals beside 1.0 count as zero there too.
    q = qt["blocks"][0].q
    for row, blk in ((0, 0), (1, 1), (3, 0)):
        assert int(q.exponent[row, blk]) == -126
        assert int(q.mx_bits[row, blk]) == 0
        assert not q.mantissa[row, 16 * blk: 16 * blk + 16].any()
    assert int(q.exponent[2, 2]) == 0


def test_tree_without_a_quantizable_leaf():
    """Nothing to quantize: every leaf comes back as itself, no call is
    counted, and both packages agree."""
    rng = np.random.default_rng(3)
    tree = {"b": rng.normal(size=(64,)).astype(np.float32),
            "w": rng.normal(size=(8, 16)).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = jax.tree_util.tree_map(torch.from_numpy, tree)
    tops.reset_kernel_stats()
    _assert_trees_match(tp, jp, "mx6")
    assert tops.kernel_stats() == {}
    assert tops.mx_quantize_many([], "mx6") == []
    assert tops.mx_dequantize_many([], [], []) == []


@pytest.mark.parametrize("precision", ["mx4", "mx6", "mx9"])
def test_many_entries_equal_the_single_entries(precision):
    """``ops.mx_quantize_many`` / ``mx_dequantize_many`` equal
    ``ops.mx_quantize`` / ``mx_dequantize`` leaf by leaf (the padded width
    kept by the single entry, dropped by the grouped one)."""
    rng = np.random.default_rng(4)
    leaves = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((3, 3, 8, 64), (5, 1000), (7, 30), (33, 48))]
    qs = tops.mx_quantize_many(leaves, precision)
    ys = tops.mx_dequantize_many(qs, [x.shape for x in leaves],
                                 [x.dtype for x in leaves])
    for x, q, y in zip(leaves, qs, ys):
        single = tops.mx_quantize(x, precision)
        for f in ("mantissa", "exponent", "mx_bits"):
            assert torch.equal(getattr(q, f), getattr(single, f))
        back = tops.mx_dequantize(single)[:, : x.shape[-1]].reshape(x.shape)
        assert y.shape == x.shape
        assert torch.equal(y.view(torch.int32), back.view(torch.int32))


def test_many_entries_count_one_call_per_launch_and_route_by_device():
    """A tree above the cap takes two launches: ``kernel_stats`` counts two
    calls of each on the plain path too. Leaves on two devices raise."""
    n = tmq.MAX_LEAVES + 3
    leaves = [torch.full((2, 16 * (1 + i % 3)), 2.0 ** (i % 9 - 4))
              for i in range(n)]
    tops.reset_kernel_stats()
    qs = tops.mx_quantize_many(leaves, "mx6")
    ys = tops.mx_dequantize_many(qs, [x.shape for x in leaves],
                                 [x.dtype for x in leaves])
    assert tops.kernel_stats() == {"mx_quantize": {"plain": 2},
                                   "mx_dequantize": {"plain": 2}}
    assert all(torch.equal(x, y) for x, y in zip(leaves, ys))  # powers of 2
    with pytest.raises(ValueError, match="different devices"):
        tops.mx_quantize_many([leaves[0], leaves[1].to("meta")], "mx6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmq.mx_quantize_many_cuda(leaves, "mx6")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmq.mx_dequantize_many_cuda(qs, [x.shape for x in leaves])


SHAPES = [(3, 3, 64, 64), (512, 1000), (0, 16), (7, 30), (1, 16),
          (2048, 1000), (16, 8), (4, 8, 768)]


def test_plan_places_leaves_in_whole_chunks():
    """Prefix counts of 16-blocks, each leaf's range rounded up to whole
    chunks (so every mantissa starts 16-byte aligned and no chunk spans two
    leaves), 128-byte aligned fp32 outputs, and one launch for a tree under
    the cap."""
    plan = tmq.plan_many(SHAPES)
    assert plan.rows == (576, 512, 0, 7, 1, 2048, 16, 32)
    assert plan.kps == (64, 1008, 16, 32, 16, 1008, 16, 768)
    assert plan.blocks == tuple(m * kp // 16 for m, kp in zip(plan.rows,
                                                                plan.kps))
    chunk = tmq.CHUNK_BLOCKS
    ends = plan.begin[1:] + (plan.arena_blocks,)
    assert plan.begin[0] == 0
    for b, e, n in zip(plan.begin, ends, plan.blocks):
        assert b % chunk == 0 and (16 * b) % 16 == 0
        assert e - b == -(-n // chunk) * chunk  # the prefix count
    out_ends = plan.out_begin[1:] + (plan.arena_out,)
    for o, e, m, k in zip(plan.out_begin, out_ends, plan.rows, plan.ks):
        assert o % tmq.OUT_ALIGN == 0 and e - o >= m * k
        assert e - o - m * k < tmq.OUT_ALIGN
    assert plan.groups == ((0, len(SHAPES)),)
    assert plan.chunks(plan.groups[0]) == plan.arena_blocks // chunk
    assert plan.launches == 1
    # An empty leaf takes no room: it shares its successor's begin.
    assert plan.begin[2] == plan.begin[3]
    assert tmq.plan_many([(0, 16)]).launches == 0


def test_plan_splits_a_tree_above_the_cap():
    cap = tmq.MAX_LEAVES
    shapes = [SHAPES[i % len(SHAPES)] for i in range(2 * cap + 5)]
    plan = tmq.plan_many(shapes)
    assert plan.groups == ((0, cap), (cap, 2 * cap), (2 * cap, 2 * cap + 5))
    assert plan.launches == 3
    assert sum(plan.chunks(g) for g in plan.groups) * tmq.CHUNK_BLOCKS == (
        plan.arena_blocks)
    assert tmq.plan_many(shapes[:cap]).groups == ((0, cap),)
    with pytest.raises(ValueError, match="32-bit"):
        tmq.plan_many([(2 ** 31, 16)])


def test_plan_matches_the_kernels_table():
    """The mirror of the kernels' leaf record: 56 bytes, ``MAX_LEAVES`` of
    them and a 16-byte head within CUDA's 32,764 bytes of kernel parameters
    (``load()`` checks that the built library agrees); each plan's tables
    hold the leaves' prefix counts, block counts and widths, read-only."""
    assert tmq.LEAF_DTYPE.itemsize == 56
    assert 16 + 56 * tmq.MAX_LEAVES <= 32764
    plan = tmq.plan_many(SHAPES)
    (table,) = plan.tables
    assert table["begin"].tolist() == list(plan.begin)
    assert table["blocks"].tolist() == list(plan.blocks)
    assert table["k"].tolist() == list(plan.ks)
    assert table["kb"].tolist() == [kp // 16 for kp in plan.kps]
    assert not table.flags.writeable
    assert tmq.plan_many([list(s) for s in SHAPES]) is plan  # kept


class _TableLibrary:
    """Stands in for the kernel library on the CPU: each grouped "launch"
    copies its leaf records from the address the wrapper passes, as the
    kernel gets them, and fills the leaves' memory through their pointers
    with the plain versions. So the wrappers' tables, arenas and views are
    held to the plain path without a card."""

    def __init__(self):
        self.tables = []

    @staticmethod
    def _array(ptr, ctype, n, dtype):
        import ctypes

        if n == 0:
            return torch.empty(0, dtype=dtype)
        return torch.frombuffer((ctype * n).from_address(ptr), dtype=dtype)

    def _leaves(self, addr, n, mb, chunks):
        import ctypes

        size = n * tmq.LEAF_DTYPE.itemsize
        leaves = np.frombuffer((ctypes.c_char * size).from_address(addr),
                               tmq.LEAF_DTYPE).copy()  # as a launch copies
        self.tables.append((leaves, chunks))
        precision = {2: "mx4", 4: "mx6", 7: "mx9"}[mb]
        return precision, [types.SimpleNamespace(
            **{f: int(leaf[f]) for f in tmq.LEAF_DTYPE.names})
            for leaf in leaves]

    def mx_quantize_many(self, addr, n, mb, chunks, stream):
        import ctypes

        from repro_torch.kernels import ref as tref

        precision, leaves = self._leaves(addr, n, mb, chunks)
        for leaf in leaves:
            m, kp = leaf.blocks // leaf.kb if leaf.blocks else 0, 16 * leaf.kb
            x = self._array(leaf.src, ctypes.c_float, m * leaf.k,
                            torch.float32).view(m, leaf.k)
            q = tref.mx_quantize_ref(torch.nn.functional.pad(
                x, (0, kp - leaf.k)), precision)
            for ptr, ctype, n, dtype, val in (
                    (leaf.dst, ctypes.c_int8, m * kp, torch.int8, q.mantissa),
                    (leaf.expo, ctypes.c_int8, leaf.blocks, torch.int8,
                     q.exponent),
                    (leaf.bits, ctypes.c_uint8, leaf.blocks, torch.uint8,
                     q.mx_bits)):
                self._array(ptr, ctype, n, dtype).copy_(val.reshape(-1))
        return 0

    def mx_dequantize_many(self, addr, n, mb, chunks, stream):
        import ctypes

        from repro_torch.kernels import ref as tref

        precision, leaves = self._leaves(addr, n, mb, chunks)
        for leaf in leaves:
            m, kp = leaf.blocks // leaf.kb if leaf.blocks else 0, 16 * leaf.kb
            q = tref.MXTensor(
                self._array(leaf.src, ctypes.c_int8, m * kp,
                            torch.int8).view(m, kp),
                self._array(leaf.expo, ctypes.c_int8, leaf.blocks,
                            torch.int8).view(m, leaf.kb),
                self._array(leaf.bits, ctypes.c_uint8, leaf.blocks,
                            torch.uint8).view(m, leaf.kb), precision)
            y = tref.mx_dequantize_ref(q)[:, : leaf.k]
            self._array(leaf.dst, ctypes.c_float, m * leaf.k,
                        torch.float32).copy_(y.reshape(-1))
        return 0


@pytest.mark.parametrize("precision", ["mx4", "mx9"])
def test_cuda_wrappers_build_tables_and_views_the_kernels_can_use(
        monkeypatch, precision):
    """``mx_quantize_many_cuda`` / ``mx_dequantize_many_cuda`` rehearsed on
    the CPU against a stand-in library that fills memory as the table says:
    the results equal the plain path leaf by leaf, the tables hold
    chunk-aligned prefix counts within the cap and the 16-byte aligned
    float4 flag, each result is a view of the arenas, and a tree above the
    cap takes two launches of each."""
    import contextlib

    lib = _TableLibrary()
    monkeypatch.setattr(tmq, "load", lambda: lib)
    monkeypatch.setattr(tmq, "_check_card", lambda device, what: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    rng = np.random.default_rng(5)
    _, tp = _carry(_hard_tree(rng))
    leaves = [p for p in jax.tree_util.tree_leaves(tp)
              if tmx._quantizable(p, 1024)]
    leaves += [torch.from_numpy(rng.normal(size=(3, 16 * (1 + i % 4))).astype(
        np.float32)) for i in range(tmq.MAX_LEAVES)]
    leaves.append(torch.from_numpy(rng.normal(size=(64 * 48 + 1,)).astype(
        np.float32))[1:].view(64, 48))  # fp32 rows not 16-byte aligned
    shapes = [tuple(x.shape) for x in leaves]
    tmq.reset_launch_counts()
    qs = tmq.mx_quantize_many_cuda(leaves, precision)
    assert not any("mantissa" in vars(q) for q in qs)  # no view made yet
    ys = tmq.mx_dequantize_many_cuda(qs, shapes)  # read from the arenas
    assert tmq.launch_counts()["mx_quantize"] == 2
    assert tmq.launch_counts()["mx_dequantize"] == 2
    plain_q = [tops.mx_quantize(x, precision) for x in leaves]
    # The same dequantize from MXTensors that are not arenas' (the plain
    # path's), and from the arenas' once their planes have been read.
    others = tmq.mx_dequantize_many_cuda(plain_q, shapes)
    for x, q, y, p in zip(leaves, qs, ys, plain_q):
        for f in ("mantissa", "exponent", "mx_bits"):
            assert torch.equal(getattr(q, f), getattr(p, f))
        assert q.mantissa.data_ptr() % 16 == 0
        want = tops.mx_dequantize(p)[:, : x.shape[-1]].reshape(x.shape)
        assert y.shape == x.shape and y.is_contiguous()
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    arena = qs[0].mantissa.untyped_storage().data_ptr()
    assert all(q.mantissa.untyped_storage().data_ptr() == arena for q in qs)
    for y, y_other, y_read in zip(ys, others,
                                  tmq.mx_dequantize_many_cuda(qs, shapes)):
        assert torch.equal(y.view(torch.int32), y_other.view(torch.int32))
        assert torch.equal(y.view(torch.int32), y_read.view(torch.int32))
    quantize_tables = lib.tables[:2]
    assert [len(t) for t, _ in quantize_tables] == [
        tmq.MAX_LEAVES, len(leaves) - tmq.MAX_LEAVES]
    for table, chunks in quantize_tables:
        begins = table["begin"].tolist()
        assert begins[0] == 0 and begins == sorted(begins)
        assert all(b % tmq.CHUNK_BLOCKS == 0 for b in begins)
        assert chunks * tmq.CHUNK_BLOCKS >= begins[-1] + table["blocks"][-1]
    last = quantize_tables[1][0][-1]
    assert (last["k"], last["vec"]) == (48, 0)  # the misaligned view
    assert quantize_tables[0][0][0]["vec"] == 1
