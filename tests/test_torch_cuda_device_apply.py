"""The device close's four kernels on the card (csrc/device_apply.cu
through ops/device_apply.py) against their plain PyTorch versions on the
same inputs, bytes equal (the fold and the scale at every row length
and alignment their sweep treats apart, NaN payloads kept by a set, and
the library's row plan itself); the sharded optimizer and the core's
device close (per tensor and flat) on the card against the host numpy
optimizers, bytes equal.  Marked ``cuda``; skips without a card.  On
one, run ``python -m pytest --noconftest
tests/test_torch_cuda_device_apply.py -m cuda``.  Imports neither
``jax`` nor the JAX package.  Inputs are seeded with numpy; odd sizes
and unaligned offsets reach the kernels' scalar tails."""

import os

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import ShardedDeviceOptimizer
from parameter_server_distributed_tpu_torch.core import device_apply
from parameter_server_distributed_tpu_torch.core.optimizer import \
    make_optimizer
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import to_host
from parameter_server_distributed_tpu_torch.ops import device_apply as da
from parameter_server_distributed_tpu_torch.rpc import codec

SHAPES = {"emb/w": (129, 33), "l0/w": (64, 65), "l0/b": (65,),
          "head/w": (33, 17), "odd": (513,)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    native.set_enabled(False)
    try:
        yield torch.device("cuda")
    finally:
        native.set_enabled(os.environ.get("PSDT_NATIVE", "1").lower()
                           not in ("0", "false"))


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape
            and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())


def _stores_equal(a, b) -> bool:
    a, b = to_host(a), to_host(b)
    return set(a) == set(b) and all(
        np.asarray(a[k], np.float32).tobytes()
        == np.asarray(b[k], np.float32).tobytes() for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("add", [False, True])
def test_fold_segments_matches_plain(card, src, add):
    rng = np.random.default_rng(1)
    dst = torch.from_numpy(rng.standard_normal(70001).astype(np.float32))
    raw = rng.standard_normal(50001).astype(np.float32)
    source = {"f32": torch.from_numpy(raw),
              "bf16": torch.from_numpy(raw).bfloat16(),
              "int8": torch.from_numpy(rng.integers(-127, 128, 50001,
                                                    dtype=np.int8))}[src]
    rows = [(3, 5, 40000), (40007, 0, 1), (50000, 1001, 20001)]
    got, want = dst.to(card), dst.clone()
    s_card = source.to(card)
    da.fold_segments([da.Segment(got, d, s_card, o, n, 0.0123)
                      for d, o, n in rows], add)
    da.fold_segments_reference([da.Segment(want, d, source, o, n, 0.0123)
                                for d, o, n in rows], add)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_fold_segments_many_small_rows(card, src):
    """300 rows of 0 to 9000 elements: chunks that span many rows, rows
    that span chunks, and empty rows, in one launch."""
    rng = np.random.default_rng(6)
    sizes = rng.integers(0, 9000, 300)
    sizes[::37] = 0
    total = int(sizes.sum())
    dst = torch.from_numpy(rng.standard_normal(total + 3).astype(
        np.float32))
    source = torch.from_numpy(rng.standard_normal(total).astype(np.float32))
    if src == "bf16":
        source = source.bfloat16()
    rows, off = [], 0
    for n in sizes.tolist():
        rows.append((off + 3, off, n))    # disjoint, 12 bytes off alignment
        off += n
    got, want, s_card = dst.to(card), dst.clone(), source.to(card)
    before = da.launches["fold_segments"]
    da.fold_segments([da.Segment(got, d, s_card, o, n) for d, o, n in rows],
                     True)
    assert da.launches["fold_segments"] == before + 1
    da.fold_segments_reference([da.Segment(want, d, source, o, n)
                                for d, o, n in rows], True)
    assert _same(got, want)


SPAN = da.SPAN
# every row length the sweep treats apart: short rows (head and tail
# only, or a few vectors), a block step's edge (4096 elements), an odd
# large row, and a span's edges
LENGTHS = (list(range(1, 38)) + [4095, 4096, 4097, 65537]
           + [SPAN - 1, SPAN, SPAN + 1, 2 * SPAN + 3])
# source residues (in elements) that reach every alignment of the lane's
# vector load (16 bytes of f32, 8 of bf16, 4 of int8) and more
SRC_RESIDUES = {"f32": 4, "bf16": 4, "int8": 16}


def _layout(lengths, src_mod: int):
    """Disjoint rows (dst_off, src_off, n): every length at every dst
    offset mod 4 elements (16 bytes) and every source offset mod
    ``src_mod`` elements, so dst and src residues also differ."""
    rows, d, s = [], 0, 0
    for n in lengths:
        for a in range(4):
            for b in range(src_mod):
                d, s = -(-d // 16) * 16 + a, -(-s // 16) * 16 + b
                rows.append((d, s, n))
                d, s = d + n, s + n
    return rows, d, s


def _source(kind: str, rng, size: int) -> torch.Tensor:
    raw = torch.from_numpy(rng.standard_normal(size).astype(np.float32))
    if kind == "bf16":
        return raw.bfloat16()
    if kind == "int8":
        return torch.from_numpy(rng.integers(-128, 128, size,
                                             dtype=np.int8))
    return raw


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("add", [False, True])
def test_fold_every_length_and_residue(card, src, add):
    """Each of LENGTHS at every dst and source residue, bytes equal to
    the plain version: the scalar rows, the heads and tails of vector
    rows, and rows across span edges."""
    rng = np.random.default_rng(7)
    rows, d_len, s_len = _layout(LENGTHS, SRC_RESIDUES[src])
    dst = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32))
    source = _source(src, rng, s_len)
    got, want, s_card = dst.to(card), dst.clone(), source.to(card)
    da.fold_segments([da.Segment(got, d, s_card, o, n, 0.0123)
                      for d, o, n in rows], add)
    da.fold_segments_reference([da.Segment(want, d, source, o, n, 0.0123)
                                for d, o, n in rows], add)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
def test_fold_plan_heads_vectors_and_spans(card, src):
    """The library's plan: each row's head brings dst to 16 bytes (or is
    the whole row), the vector flag is set exactly when the source past
    the head is aligned for the lane's load, and the rows' spans tile
    them (ceil(n / SPAN) each, numbered in order)."""
    rng = np.random.default_rng(8)
    rows, d_len, s_len = _layout(LENGTHS[::3], SRC_RESIDUES[src])
    dst = torch.zeros(d_len, device=card)
    source = _source(src, rng, s_len).to(card)
    segs = [da.Segment(dst, d, source, o, n) for d, o, n in rows]
    first, plan = da.fold_plan(segs)
    esize = source.element_size()
    assert first[0] == 0
    for i, (d, o, n) in enumerate(rows):
        head, vec = int(plan[i]) & 3, bool(plan[i] & da.PLAN_VECTOR)
        d_addr = dst.data_ptr() + 4 * d
        assert head == min((-d_addr) % 16 // 4, n)
        s_addr = source.data_ptr() + esize * (o + head)
        assert vec == (s_addr % (4 * esize) == 0)
        assert first[i + 1] - first[i] == -(-n // SPAN)


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_fold_set_is_a_bit_copy(card, src, offset):
    """The set lane keeps NaN payloads (quiet and signalling), -0.0,
    subnormals and infinities bit for bit (bf16: the exact upcast)."""
    rng = np.random.default_rng(9)
    n = 4099
    if src == "f32":
        bits = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32)
        bits[:8] = [0x7fc00001, 0xffa00003, 0x80000000, 0x00000001,
                    0x7f800000, 0xff800000, 0x7fbfffff, 0x807fffff]
        source = torch.from_numpy(bits.view(np.float32))
    else:
        bits = rng.integers(0, 1 << 16, n, dtype=np.uint32).astype(
            np.uint16)
        bits[:6] = [0x7fc1, 0xffa3, 0x8000, 0x0001, 0x7f80, 0x807f]
        source = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    dst = torch.full((n + offset,), 7.0)
    got, want = dst.to(card), dst.clone()
    da.fold_segments([da.Segment(got, offset, source.to(card), 0, n)], False)
    da.fold_segments_reference([da.Segment(want, offset, source, 0, n)],
                               False)
    assert _same(got, want)
    expect = (bits.astype(np.uint32) << 16 if src == "bf16"
              else bits).view(np.float32)
    assert got[offset:].cpu().numpy().tobytes() == expect.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("src", ["f32", "bf16", "int8"])
def test_fold_1024_rows_is_one_launch(card, src):
    """1,024 rows of random lengths and residues in one launch (and the
    1,025th row in a second), bytes equal to the plain version."""
    rng = np.random.default_rng(10)
    sizes = rng.integers(1, 3000, 1025)
    rows, d, s = [], 0, 0
    for n in sizes.tolist():
        d += int(rng.integers(0, 5))
        s += int(rng.integers(0, 17))
        rows.append((d, s, n))
        d, s = d + n, s + n
    dst = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    source = _source(src, rng, s)
    got, want, s_card = dst.to(card), dst.clone(), source.to(card)
    for part, launches in ((rows[:1024], 1), (rows, 2)):
        before = da.launches["fold_segments"]
        da.fold_segments([da.Segment(got, d, s_card, o, n, 0.5)
                          for d, o, n in part], True)
        assert da.launches["fold_segments"] == before + launches
        da.fold_segments_reference([da.Segment(want, d, source, o, n, 0.5)
                                    for d, o, n in part], True)
    assert _same(got, want)


@pytest.mark.cuda
def test_scale_mean_lengths_and_residues(card):
    """scale_mean over rows of every length of LENGTHS at every residue,
    one launch (and 1,024 rows in one launch), bytes equal."""
    rng = np.random.default_rng(11)
    rows, d_len, _ = _layout(LENGTHS, 1)
    x = torch.from_numpy(rng.standard_normal(d_len).astype(np.float32))
    got, want = x.to(card), x.clone()
    inv = device_apply.inverse_count(3)
    before = da.launches["scale_mean"]
    da.scale_mean([(got[d:d + n], inv) for d, _, n in rows])
    assert da.launches["scale_mean"] == before + 1
    da.scale_mean_reference([(want[d:d + n], inv) for d, _, n in rows])
    assert _same(got, want)
    small = [(got[i * 7:i * 7 + 5], inv) for i in range(1024)]
    before = da.launches["scale_mean"]
    da.scale_mean(small)
    assert da.launches["scale_mean"] == before + 1
    da.scale_mean_reference([(want[i * 7:i * 7 + 5], inv)
                             for i in range(1024)])
    assert _same(got, want)


@pytest.mark.cuda
def test_topk_scatter_at_chunk_edges(card):
    total = 3 * 4096 + 5
    idx = np.array([0, 1, 4095, 4096, 8191, 8192, total - 1], np.uint32)
    vals = np.arange(1, 8, dtype=np.float32)
    buf = bytearray(4 + 6 * idx.size)
    buf[:4] = np.uint32(idx.size).tobytes()
    buf[4:4 + 4 * idx.size] = idx.tobytes()
    buf[4 + 4 * idx.size:] = codec.bf16_bits(vals).tobytes()
    want = codec.PythonCodec().unpack(codec.WIRE_TOPK, bytes(buf), total)
    got = device_apply.device_unpack(codec.WIRE_TOPK, bytes(buf), total, card)
    assert got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.cuda
def test_scale_mean_matches_plain(card):
    rng = np.random.default_rng(2)
    xs = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
          for n in (1, 1000, 65537)]
    got = [x.to(card) for x in xs]
    inv = device_apply.inverse_count(3)
    da.scale_mean([(x, inv) for x in got])
    da.scale_mean_reference([(x, inv) for x in xs])
    assert all(_same(g, w) for g, w in zip(got, xs))


@pytest.mark.cuda
@pytest.mark.parametrize("rule", da.RULES)
def test_sharded_update_matches_plain(card, rule):
    rng = np.random.default_rng(3)
    opt = ShardedDeviceOptimizer(rule, 0.01, device="cpu")
    opt.step = 3
    scalars = opt._scalars()
    slots = da.RULE_SLOTS[rule]
    sizes = (131075, 4096, 7)
    host_rows, card_rows = [], []
    for i, n in enumerate(sizes):
        tensors = [torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)) for _ in range(2 + slots)]
        if rule in ("adam", "adamw"):
            tensors[3] = tensors[3].abs()      # v >= 0
        pad = [None] * (2 - slots)
        out_h = torch.empty(n)
        host_rows.append(da.UpdateRow(tensors[0], tensors[1], out_h,
                                      *tensors[2:], *pad,
                                      decay=n // 2 if i else 0,
                                      seed=i == 1))
        on_card = [t.to(card) for t in tensors]
        # an unaligned view of the second row (the scalar lane)
        if i == 1:
            on_card = [torch.cat([t.new_zeros(1), t])[1:] for t in on_card]
        card_rows.append(da.UpdateRow(on_card[0], on_card[1],
                                      torch.empty(n, device=card),
                                      *on_card[2:], *pad,
                                      decay=n // 2 if i else 0,
                                      seed=i == 1))
    before = da.launches["sharded_update"]
    da.sharded_update(rule, card_rows, scalars)
    assert da.launches["sharded_update"] == before + 1
    for r in host_rows:
        da.sharded_update_reference(rule, r, scalars)
    for h, c in zip(host_rows, card_rows):
        assert _same(c.out, h.out)
        for hs, cs in ((h.s0, c.s0), (h.s1, c.s1)):
            assert hs is None or _same(cs, hs)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["raw", "bf16", "int8", "topk"])
def test_device_unpack_matches_codec(card, wire):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(10007).astype(np.float32)
    dtype = codec.WIRE_DTYPE_NAMES[wire]
    k = codec.topk_k(x.size, 0.05) if wire == "topk" else 0
    buf = bytearray(codec.payload_nbytes(dtype, x.size, k))
    codec.PythonCodec().pack_into(dtype, x, buf, k)
    want = codec.PythonCodec().unpack(dtype, bytes(buf), x.size)
    got = device_apply.device_unpack(dtype, bytes(buf), x.size, card)
    assert got.is_cuda and got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ShardedDeviceOptimizer.RULES)
@pytest.mark.parametrize("arena", ["0", "1"])
def test_core_device_close_on_card_equals_host_numpy(card, monkeypatch,
                                                     rule, arena):
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", arena)
    rng = np.random.default_rng(5)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    host = ParameterServerCore(total_workers=2, stripes=2,
                               optimizer=make_optimizer(rule, 0.01))
    dev = ParameterServerCore(total_workers=2, stripes=2,
                              optimizer=make_optimizer(f"sharded_{rule}",
                                                       0.01))
    assert dev.device_fold() is not None
    for core in (host, dev):
        core.initialize_parameters(init)
    for it in range(1, 4):
        for wid in range(2):
            g = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in SHAPES.items()}
            host.receive_gradients(wid, it, g)
            dev.receive_gradients(wid, it, {
                k: device_apply.upload(v, card) for k, v in g.items()})
        assert _stores_equal(host.get_parameters(), dev.get_parameters())
    h_state, d_state = host.optimizer_state(), dev.optimizer_state()
    for kind in h_state:
        if kind == "step":
            assert h_state[kind] == d_state[kind]
        else:
            assert _stores_equal(h_state[kind], d_state[kind])


def _dtoh_copies(fn) -> int:
    """Run ``fn`` and count the ops it runs that read a card tensor and
    give a host tensor that is not empty, or a Python number."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    scalar_ops = {torch.ops.aten._local_scalar_dense.default,
                  torch.ops.aten.equal.default}
    copies = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in tree_leaves((args, kwargs))):
                if func in scalar_ops or any(
                        isinstance(x, torch.Tensor) and not x.is_cuda
                        and x.numel() > 0 for x in tree_leaves(out)):
                    copies.append(func)
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return len(copies)


@pytest.mark.cuda
def test_flat_eviction_stays_on_the_card(card, monkeypatch):
    """A broadcast push evicts a slab-resident sum into the overflow: the
    folds that evict it and add to it copy nothing to the host, and the
    close equals the host numpy close byte for byte."""
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", "1")
    rng = np.random.default_rng(6)
    shapes = {"w": (4, 31), "b": (17,)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    pushes = [{k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()},
              {"w": rng.standard_normal(31).astype(np.float32),
               "b": rng.standard_normal(17).astype(np.float32)},
              {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}]
    host = ParameterServerCore(total_workers=3, stripes=1,
                               optimizer=make_optimizer("sgd", 0.1))
    dev = ParameterServerCore(total_workers=3, stripes=1,
                              optimizer=make_optimizer("sharded_sgd", 0.1))
    for core in (host, dev):
        core.initialize_parameters(init)
    on_card = [{k: device_apply.upload(v, card) for k, v in g.items()}
               for g in pushes]
    torch.cuda.synchronize()

    def folds():
        for wid in range(2):
            dev.receive_gradients(wid, 1, on_card[wid])

    assert _dtoh_copies(folds) == 0
    overflow = dev._iteration_states[1].accum.overflow
    assert set(overflow) == {"w"} and overflow["w"].is_cuda
    dev.receive_gradients(2, 1, on_card[2])
    for wid, g in enumerate(pushes):
        host.receive_gradients(wid, 1, g)
    assert _stores_equal(host.get_parameters(), dev.get_parameters())
