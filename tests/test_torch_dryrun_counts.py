"""The dry run's counts (``launch/counting.py``, ``steps.trace_bundle``) on
reduced archs at small shapes: a multiplied trace equals a full one
exactly (FLOPs, collective bytes and counts, peak bytes) for a dense, an
MoE, a Mamba-hybrid and an xLSTM train step, each with its repeated units
(layer groups, loss chunks, Mamba and mLSTM chunks, sLSTM steps,
microbatches) run more than four times; on a real 2-rank gloo world each
rank's own FLOPs and collectives, counted while the real step runs, equal
the fake trace's per-device numbers; and ``ops.flash_attention``'s fake
path returns the plain version's shapes and dtypes while a real CPU call
keeps its "plain" path. Imports no JAX."""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.sharding import make_rules
from repro_torch.launch.steps import build_bundle, trace_bundle
from repro_torch.models import ssm, transformer, xlstm

from _torch_count_worlds import cell_bundle, run_world, summary
from _torch_lm import RTOL, close, one_torch_thread  # noqa: F401

SEQ = 20  # with 4-token chunks: 5 loss, Mamba and mLSTM chunks, 20 steps
# (arch, layers, batch, microbatches): every loop above four iterations.
CELLS = {"dense": ("yi-6b", 5, 2, 1),  # 5 layer groups, 5 loss chunks
         "moe": ("mixtral-8x7b", 2, 10, 5),  # 5 microbatches
         "hybrid": ("jamba-v0.1-52b", 8, 2, 1),  # 5 Mamba chunks
         "xlstm": ("xlstm-125m", 6, 2, 1)}  # 20 sLSTM steps, 5 mLSTM chunks


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(transformer, "CE_CHUNK", 4)
    monkeypatch.setattr(ssm, "MAMBA_CHUNK", 4)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 4)


@contextlib.contextmanager
def fake_mesh(shape):
    with dryrun.fake_world(shape[0] * shape[1]):
        from torch.distributed.device_mesh import init_device_mesh

        yield init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))


def _key(c):
    return (c.flops, c.collective_bytes, c.ring_bytes, dict(c.op_bytes),
            dict(c.op_counts), c.peak_bytes, c.arg_bytes, c.hbm_bytes,
            c.hbm_bytes_unfused)


@pytest.mark.parametrize("cell", list(CELLS))
def test_multiplied_trace_equals_full_trace(cell, small_chunks):
    name, layers, batch, nmb = CELLS[cell]
    arch = dataclasses.replace(configs.get_arch(name).reduced(),
                               num_layers=layers)
    shape = ShapeConfig("count", SEQ, batch, "train")
    with fake_mesh((1, 2)) as mesh:
        rules = make_rules(arch, shape, mesh)
        got = {}
        for multiply in (True, False):
            bundle = build_bundle(arch, shape, mesh, rules, device="cpu",
                                  num_microbatches=nmb)
            got[multiply] = trace_bundle(bundle, mesh, rules,
                                         multiply=multiply)
    assert got[True].flops > 0 and got[True].collective_bytes > 0
    assert _key(got[True]) == _key(got[False])


WORLD_CELLS = [("gemma2-2b", "train", 16, 4, 2, [1, 2]),
               ("yi-6b", "decode", 16, 4, 2, [1, 2])]


def test_fake_counts_equal_a_real_gloo_world(tmp_path):
    """Each rank of a real 2-rank world counts its own FLOPs and
    collectives while the step runs; the fake trace of the same cell on a
    fake 2-rank mesh gives the same per-device numbers."""
    real = run_world(2, tmp_path, WORLD_CELLS)
    for i, (name, kind, seq, batch, layers, shape) in enumerate(WORLD_CELLS):
        with fake_mesh(tuple(shape)) as mesh:
            bundle, rules = cell_bundle(mesh, name, kind, seq, batch, layers)
            fake = summary(trace_bundle(bundle, mesh, rules, t=seq - 1))
        assert fake["flops"] > 0 and sum(fake["op_counts"].values()) > 0
        assert fake["kernel_flops"]["flash_attention"] > 0
        for rank in range(2):
            assert real[rank][i] == fake, (name, kind, rank)


def test_fused_traffic_counts_at_boundaries():
    """The fused HBM count (the roofline's memory term): a product reads
    its operands and writes its result; an elementwise chain reads what is
    in HBM once and leaves its result for the next boundary to write and
    read; an in-place update of a whole tensor (an optimizer's) reads and
    writes it once however many operations it takes; a write into a slice
    of a larger tensor (a cache) moves the update alone. The unfused count
    takes every operation's operands and results."""
    from repro_torch.launch.counting import Counter

    x, w, w2 = torch.ones(8, 16), torch.ones(16, 32), torch.ones(32, 4)
    p, g = torch.ones(64), torch.ones(64)
    cache, new = torch.zeros(4, 10, 16), torch.ones(4, 1, 16)
    xb, wb, yb, w2b, ob = 8 * 16 * 4, 16 * 32 * 4, 8 * 32 * 4, 32 * 16, 128
    counter = Counter()
    with counter:
        y = x @ w  # reads x, w; writes y
        z = torch.nn.functional.gelu(y) * 2  # reads y; z stays in a fusion
        out = z @ w2  # z written and read; w2 read; out written
        p.mul_(0.9).add_(g)  # p read and written once, g read once
        cache[:, 3:4].copy_(new)  # the update read and written
    counts = counter.finish(out)
    assert counts.hbm_bytes == ((xb + wb + yb) + yb + (2 * yb + w2b + ob)
                                + 3 * 256 + 2 * 256)
    assert counts.hbm_bytes_unfused == (
        (xb + wb + yb) + 2 * yb + 2 * yb + (yb + w2b + ob)
        + 2 * 256 + 3 * 256 + 3 * 256)


def _qkv(dtype, sq=8, skv=8):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, sq, 4, 16, generator=gen).to(dtype)
    k = torch.randn(2, skv, 2, 16, generator=gen).to(dtype)
    v = torch.randn(2, skv, 2, 16, generator=gen).to(dtype)
    return q, k, v


@pytest.mark.parametrize("lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_fake_path(lse, dtype):
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    q, k, v = _qkv(dtype)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=4,
                                   return_lse=lse)
    ops.reset_kernel_stats()
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        got = ops.flash_attention(fq, fk, fv, causal=True, window=4,
                                  return_lse=lse)
    assert ops.kernel_stats() == {}  # the fake path launches nothing
    want = want if lse else (want,)
    got = got if lse else (got,)
    for g, w in zip(got, want):
        assert isinstance(g, FakeTensor)
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    real = ops.flash_attention(q, k, v, causal=True, window=4,
                               return_lse=lse)
    assert ops.kernel_stats() == {"flash_attention": {"plain": 1}}
    for r, w in zip(real if lse else (real,), want):
        assert torch.equal(r, w)


def test_kernel_counts_as_the_kernel():
    """Under a counter a real CPU call counts the kernel's FLOPs (4·D per
    unmasked pair and head), not its plain version's operations."""
    from repro_torch.launch.counting import Counter

    q, k, v = _qkv(torch.float32, sq=8, skv=8)
    counter = Counter()
    ops.reset_kernel_stats()
    with counter:
        ops.flash_attention(q, k, v, causal=True, window=4)
    pairs = sum(min(i, 3) + 1 for i in range(8))  # rows see <= 4 keys
    assert counter.counts.flops == 4 * 2 * 4 * 16 * pairs
    assert counter.counts.kernel_flops == {"flash_attention":
                                           4 * 2 * 4 * 16 * pairs}
    assert ops.kernel_stats() == {"flash_attention": {"plain": 1}}


def test_heads_that_do_not_divide_the_model_axis():
    """gemma2-2b's 8 heads over a model axis of 16 failed every cell
    (DTensor cannot unflatten a split that cuts a head):
    ``attention.split_heads`` gathers the fused dim first. The reduced
    arch's 4 heads over 8 ranks trace the same way."""
    from repro_torch.models.attention import split_heads

    with fake_mesh((1, 8)) as mesh:
        bundle, rules = cell_bundle(mesh, "gemma2-2b", "prefill", 16, 2, 2)
        counts = trace_bundle(bundle, mesh, rules)
        assert counts.kernel_flops["flash_attention"] > 0
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Shard

        from repro_torch.distributed import use_rules

        with FakeTensorMode(), use_rules(rules, mesh):
            fused = DTensor.from_local(torch.empty(2, 16, 8), mesh,
                                       [Shard(0), Shard(2)], run_check=False)
            heads = split_heads(fused, 4, 16, "heads")
        assert tuple(heads.shape) == (2, 16, 4, 16)


def test_prefill_caches_made_per_rank():
    """A prefill's caches come to each rank as its own part: on a fake
    (1, 2) mesh the count's peak while they are made is the local caches'
    bytes, not the whole caches' (a whole 32k cache is many cards)."""
    from repro_torch.distributed import use_rules
    from repro_torch.launch.counting import Counter, tensor_bytes
    from repro_torch.models.transformer import LMModel
    from repro_torch.tree import tree_leaves

    arch = configs.get_arch("yi-6b").reduced()
    shape = ShapeConfig("count", 64, 2, "prefill")
    with fake_mesh((1, 2)) as mesh:
        from torch._subclasses.fake_tensor import FakeTensorMode

        rules = make_rules(arch, shape, mesh)
        with FakeTensorMode(), use_rules(rules, mesh):
            counter = Counter()
            with counter:
                caches = LMModel(arch, "cpu").init_caches(2, 64)
            local = sum(tensor_bytes(x) for x in tree_leaves(caches))
            whole = sum(x.numel() * x.element_size()
                        for x in tree_leaves(caches))
    assert local < whole
    assert counter.counts.temp_bytes == local


POD_ARCHS = ("jamba-v0.1-52b", "xlstm-125m")


def _pod_argv(name: str) -> list:
    return ["--arch", name, "--reduced", "--device", "cpu", "--batch", "4",
            "--prompt-len", "8", "--gen", "4"]


def test_mixer_caches_on_two_pods_match_one_rank(tmp_path):
    """Reduced jamba and xlstm served (prefill and three decodes) on a real
    2-rank world over ("pod", "data", "model") = (2, 1, 1), where each
    Mamba / xLSTM layer runs on the tokens gathered over "pod": every
    rank's tokens equal the one-rank run's and its logits are within
    ``RTOL`` of them."""
    from repro_torch.launch import serve

    got = run_world(2, tmp_path, [_pod_argv(n) for n in POD_ARCHS],
                    fn="pod_serve")
    for i, name in enumerate(POD_ARCHS):
        want = serve.serve(_pod_argv(name), on_mesh=False)
        for rank in range(2):
            np.testing.assert_array_equal(got[rank][i]["tokens"],
                                          want["tokens"])
            close(np.array(got[rank][i]["logits"]), want["logits"].numpy(),
                  RTOL, f"{name} rank {rank} logits")


@pytest.mark.parametrize("name,kind", [("jamba-v0.1-52b", "prefill"),
                                       ("xlstm-125m", "decode")])
def test_mixer_caches_on_two_pods(name, kind, small_chunks):
    """Serving on the two-pod mesh splits the tokens over ("pod", "data")
    and the caches over "data" alone: the Mamba and xLSTM layers raised
    there; they now run on the tokens gathered over "pod"."""
    from torch.distributed.device_mesh import init_device_mesh

    with dryrun.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        bundle, rules = cell_bundle(mesh, name, kind, 8, 4,
                                    configs.get_arch(name).reduced()
                                    .num_layers)
        counts = trace_bundle(bundle, mesh, rules, t=7)
    assert counts.flops > 0 and counts.collective_bytes > 0
