"""The int8 serving kernels on the card (csrc/int8_serve.cu through
ops/int8_serve.py) against their plain PyTorch versions on the same
inputs: K5 ``int8_wdot`` and K6 ``decode_attention_int8`` in f32 within
rtol 2e-5, atol 2e-5 (tests/test_quant.py's tolerance for wdot) and in
bf16 within 2^-7 of the output's largest magnitude (bf16 rows above 16
with aligned 16-byte chunks take K5's wgmma kernel); K6 bit for bit
against itself (a row alone against the same row in a batch, a call
against another); K7 ``kv_quantize`` byte for byte.  Marked ``cuda``;
skips without a card.  On one, run ``python -m pytest --noconftest
tests/test_torch_cuda_int8.py -m cuda``.
Imports neither ``jax`` nor the JAX package.  Inputs are seeded with
numpy; odd sizes reach the kernels' ragged edges."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(
            device=dev, dtype=dtype)


def _weights(rng, k, n, dev):
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    scale = torch.from_numpy(
        (rng.random(n) * 1e-3 + 1e-4).astype(np.float32))
    return q.to(dev), scale.to(dev)


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item(), err


def _same(a, b):
    """The same shape, dtype and bytes (bf16 compared through its bytes:
    numpy has no bf16)."""
    def raw(x):
        return x.detach().cpu().contiguous().view(torch.uint8).numpy()

    return (a.shape == b.shape and a.dtype == b.dtype
            and raw(a).tobytes() == raw(b).tobytes())


# the skinny kernel's edges (1 and 16 rows, N off its 4-column words and
# its 128-column tiles, run counts off the 8 run groups: K 200 has 4 runs,
# 2816 has 44, 5000 has 79, more than a block's 8 warps take at once),
# the SIMT and tensor-core tiles' ragged edges, then the bf16 prefill
# products at llama_350m's K and N (17, 64 and 2048 rows)
WDOT_CASES = ([(1, 48, 33), (3, 1024, 256), (8, 2816, 1024), (16, 200, 130),
               (17, 1024, 256), (200, 300, 97), (130, 104, 144),
               (2048, 1024, 2816), (1, 1024, 32000), (16, 2816, 1000),
               (5, 200, 33), (8, 5000, 130), (4, 8192, 1000)]
              + [(m, k, n) for m in (17, 64, 2048) for k in (1024, 2816)
                 for n in (256, 32000) if (m, k, n) != (17, 1024, 256)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,offset",
                         [(m, k, n, 0) for m, k, n in WDOT_CASES]
                         + [(8, 1024, 256, 1), (64, 1024, 256, 1)])
def test_int8_wdot_matches_plain(card, dtype, m, k, n, offset):
    """``offset`` > 0: x is a view that starts that many elements into its
    storage, so its data pointer is not 16-byte aligned (the skinny
    kernel stages it by scalar loads, and bf16 rows above 16 take the
    SIMT tile instead of the tensor cores)."""
    rng = np.random.default_rng(m * 7 + n)
    x = _randn(rng, (m * k + offset,), dtype, card)[offset:].view(m, k)
    q, scale = _weights(rng, k, n, card)
    if offset and m > i8.SKINNY_M:
        assert i8.int8_wdot_shape(x, q) == "tiled"
    before = i8.launches["int8_wdot"]
    got = i8.int8_wdot(x, q, scale)
    torch.cuda.synchronize()
    assert i8.launches["int8_wdot"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _close(got, i8.int8_wdot_reference(x, q, scale), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [96, 200, 1024, 2816, 5000])
def test_int8_wdot_rows_do_not_depend_on_the_batch(card, dtype, k):
    """A row's product is the same bits whichever shape computes it, so a
    prefill, an extension and a decode round agree on a shared row: f32
    rows in the skinny shape (up to 16 rows) and the tiled one above,
    held against a 70-row call; bf16 rows up to 16 (the skinny shape's
    fixed order; above 16 they take the tensor cores' order) against a
    16-row call."""
    rng = np.random.default_rng(k)
    x = _randn(rng, (70, k), dtype, card)
    q, scale = _weights(rng, k, 300, card)
    if dtype == torch.float32:
        full = i8.int8_wdot(x, q, scale)
        for rows in (1, 5, 16):
            assert _same(i8.int8_wdot(x[:rows], q, scale), full[:rows])
        assert _same(i8.int8_wdot(x[40:57], q, scale), full[40:57])
    else:
        full = i8.int8_wdot(x[:16], q, scale)
        for rows in (1, 5, 8):
            assert _same(i8.int8_wdot(x[:rows], q, scale), full[:rows])
        assert _same(i8.int8_wdot(x[3:10], q, scale), full[3:10])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 256), (1024, 2816),
                                 (2816, 1024), (1024, 32000)])
def test_int8_wdot_shapes_of_llama_350m(card, k, n):
    """The kernel each llama_350m product takes: a decode round's rows
    (1-16) the skinny kernel in either dtype, a bf16 prefill's (17-2048)
    the tensor cores, an f32 prefill's the tiled SIMT kernel."""
    q = torch.zeros((k, n), dtype=torch.int8, device=card)
    for m in (1, 8, 16):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.zeros((m, k), dtype=dtype, device=card)
            assert i8.int8_wdot_shape(x, q) == "skinny"
    for m in (17, 129, 2048):
        x = torch.zeros((m, k), dtype=torch.bfloat16, device=card)
        assert i8.int8_wdot_shape(x, q) == "tensor_cores"
        assert i8.int8_wdot_shape(x.float(), q) == "tiled"


def _cache(rng, b, max_len, kv, d, dev):
    k8 = torch.from_numpy(rng.integers(-127, 128, (b, max_len, kv, d))
                          .astype(np.int8)).to(dev)
    v8 = torch.from_numpy(rng.integers(-127, 128, (b, max_len, kv, d))
                          .astype(np.int8)).to(dev)
    ks = torch.from_numpy((rng.random((b, max_len, kv)) * 0.02 + 1e-3)
                          .astype(np.float32)).to(dev)
    vs = torch.from_numpy((rng.random((b, max_len, kv)) * 0.02 + 1e-3)
                          .astype(np.float32)).to(dev)
    return k8, v8, ks, vs


def _limits(rng, b, max_len):
    """Row limits: K6's chunk edges (0, P - 2 .. P + 1, 2P), or in a cache
    of many rounds (a round: a chunk for each block of a cluster) the
    round's edges, the cache's last position and past it (a retired lane
    keeps going) where the cache holds them, random ones for the other
    rows."""
    p = i8.ATTN_CHUNK
    edges = [0, p - 2, p - 1, p, p + 1, 2 * p, max_len - 1, max_len + 3]
    rnd = p * i8.ATTN_CLUSTER
    if max_len > 4 * rnd:
        edges = [0, p + 1, rnd - 1, rnd, rnd + 1, 3 * rnd + 7, max_len - 1,
                 max_len + 3]
    lens = rng.integers(0, max_len, b)
    if max_len > 2 * p:
        lens[:min(b, len(edges))] = edges[:b]
    else:
        lens[0] = max_len + 3
    return lens


# (B, T, H, KV, D, max_len): the serving round (G 4, D 64), the extension
# (one row, 256 queries after a 1024-token prefix), G 1 (MHA), G 4 and 8,
# D 12 (4-byte copies), 64, 128 and 256, T > 1 across chunk edges, caches
# of one chunk and of several; long caches: 10 rounds held in shared
# memory, 28 rounds streamed through one slot (57,344 positions), the
# head_dim-128 model's 16,384 and an extension of 64 queries there
ATTN_CASES = [(8, 1, 16, 4, 64, 2048), (1, 256, 16, 4, 64, 1280),
              (2, 5, 4, 2, 12, 40), (3, 16, 8, 8, 128, 96),
              (8, 1, 8, 1, 256, 600), (8, 4, 16, 16, 64, 1100),
              (8, 6, 8, 2, 12, 700), (8, 2, 16, 2, 128, 520),
              (8, 1, 16, 4, 64, 20000), (8, 1, 16, 4, 64, 57344),
              (2, 5, 8, 8, 128, 16384), (1, 64, 16, 4, 64, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,d,max_len", ATTN_CASES)
@pytest.mark.parametrize("ragged", [True, False])
def test_decode_attention_int8_matches_plain(card, dtype, b, t, h, kv, d,
                                             max_len, ragged):
    rng = np.random.default_rng(b * 100 + d)
    q = _randn(rng, (b, t, h, d), dtype, card)
    cache = _cache(rng, b, max_len, kv, d, card)
    if ragged:
        lengths = torch.from_numpy(_limits(rng, b, max_len).astype(
            np.int64)).to(card)
        if b == 1:
            lengths[0] = max_len - t
        base = 0
    else:
        lengths, base = None, max_len // 3
    before = i8.launches["decode_attention_int8"]
    got = i8.decode_attention_int8(q, *cache, lengths=lengths, base=base)
    torch.cuda.synchronize()
    assert i8.launches["decode_attention_int8"] == before + 1
    want = i8.decode_attention_int8_reference(q, *cache, lengths, base)
    assert got.dtype == dtype
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,h,kv,d,max_len", [(1, 16, 4, 64, 2048),
                                              (5, 8, 8, 128, 2048),
                                              (1, 16, 4, 64, 40000)])
def test_decode_attention_int8_rows_do_not_depend_on_the_batch(card, dtype,
                                                               t, h, kv, d,
                                                               max_len):
    """Each row of an 8-row serving batch (max_len 2048, or 40,000, whose
    call streams its rounds) is the same bits computed alone (B 1) against
    a cache of another max_len (whose call holds its rounds where they
    fit): the chunks' sums run in chunk order whatever the cluster, the
    rounds, the batch or the cache."""
    rng = np.random.default_rng(t * 10 + d)
    b = 8
    q = _randn(rng, (b, t, h, d), dtype, card)
    cache = _cache(rng, b, max_len, kv, d, card)
    lens = _limits(rng, b, max_len)
    lens = np.minimum(lens, max_len - t)
    full = i8.decode_attention_int8(
        q, *cache, lengths=torch.from_numpy(lens).to(card))
    for row, length in enumerate(lens):
        width = int(length) + t + 37 * (row + 1)
        alone = i8.decode_attention_int8(
            q[row:row + 1].contiguous(),
            *(x[row:row + 1, :width].contiguous() for x in cache),
            lengths=torch.tensor([int(length)], device=card))
        assert _same(alone, full[row:row + 1]), row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,kv,d,max_len", ATTN_CASES[:2])
def test_decode_attention_int8_calls_give_the_same_bytes(card, dtype, b, t,
                                                         h, kv, d, max_len):
    rng = np.random.default_rng(7)
    q = _randn(rng, (b, t, h, d), dtype, card)
    cache = _cache(rng, b, max_len, kv, d, card)
    lengths = torch.from_numpy(
        np.minimum(_limits(rng, b, max_len), max_len - t)).to(card)
    first = i8.decode_attention_int8(q, *cache, lengths=lengths)
    assert _same(i8.decode_attention_int8(q, *cache, lengths=lengths), first)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,kv,d,max_len,lens",
                         [(2, 3, 4, 2, 16, 32, [5, 20]),
                          (8, 1, 16, 4, 64, 2048,
                           [300, 1000, 255, 256, 700, 1500, 2000, 129]),
                          (2, 4, 16, 4, 64, 2048, [510, 1290]),
                          (2, 1, 16, 4, 64, 40000, [30001, 2100])])
def test_decode_attention_int8_reads_nothing_past_the_limit(card, b, t, h,
                                                            kv, d, max_len,
                                                            lens):
    """Garbage (NaN scales) past each row's last query's limit leaves the
    result as it was; the serving-size limits end inside a chunk."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (b, t, h, d), torch.float32, card)
    k8, v8, ks, vs = _cache(rng, b, max_len, kv, d, card)
    lengths = torch.tensor(lens, dtype=torch.int64, device=card)
    clean = i8.decode_attention_int8(q, k8, v8, ks, vs, lengths=lengths)
    ks2, vs2 = ks.clone(), vs.clone()
    for row, length in enumerate(lens):
        past = length + t
        (ks2 if row % 2 else vs2)[row, past:] = float("nan")
        (vs2 if row % 2 else ks2)[row, past + 3:] = float("nan")
    dirty = i8.decode_attention_int8(q, k8, v8, ks2, vs2, lengths=lengths)
    assert _same(clean, dirty)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("d", [12, 64, 256])
def test_kv_quantize_bytes_equal_plain(card, dtype, ragged, d):
    """D 12 runs element by element, 64 and 256 in 16-byte loads; a zero
    row, ties of the division (scale 1) and writes past max_len."""
    rng = np.random.default_rng(int(ragged) + d)
    b, t, kv, max_len = 4, 3, 2, 10
    k = _randn(rng, (b, t, kv, d), dtype, card)
    v = _randn(rng, (b, t, kv, d), dtype, card, scale=3.0)
    k[1, 0, 1] = 0.0                              # a zero row: scale 1
    v[2, 2, 0, :3] = torch.tensor([127.0, 2.5, -3.5])  # scale 1: ties
    if ragged:
        lengths = torch.tensor([0, 7, 8, 12], dtype=torch.int64, device=card)
        base = 0
    else:
        lengths, base = None, 8                   # the last lands past
    outs = [[torch.full((b, max_len, kv, d), 9, dtype=torch.int8,
                        device=card) for _ in range(2)]
            + [torch.full((b, max_len, kv), 7.0, device=card)
               for _ in range(2)] for _ in range(2)]
    before = i8.launches["kv_quantize"]
    i8.kv_quantize(k, v, *outs[0], lengths=lengths, base=base)
    torch.cuda.synchronize()
    assert i8.launches["kv_quantize"] == before + 1
    i8.kv_quantize_reference(k, v, *outs[1], lengths, base)
    for got, want in zip(*outs):
        assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(12, 0), (64, 0), (256, 0), (64, 1)])
def test_kv_quantize_rows_bytes_equal_plain(card, dtype, d, offset):
    """``offset`` > 0: K is a view that starts that many elements into its
    storage, so its rows are not 16-byte aligned (element by element)."""
    rng = np.random.default_rng(3)
    shape = (3, 2048, 4, d)
    k = _randn(rng, (int(np.prod(shape)) + offset,), dtype, card)[
        offset:].view(shape)
    v = _randn(rng, shape, dtype, card, scale=0.01)
    v[0, 5] = 0.0
    v[1, 7, 2, :3] = torch.tensor([0.5, 127.0, -1.5])   # ties
    got = i8.kv_quantize_rows(k, v)
    want = (*i8.kv_rows_reference(k)[:1], *i8.kv_rows_reference(v)[:1],
            i8.kv_rows_reference(k)[1], i8.kv_rows_reference(v)[1])
    for g, w in zip(got, want):
        assert _same(g, w)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q, scale = _weights(np.random.default_rng(0), 8, 4, card)
    with pytest.raises(ValueError, match="int8_wdot"):
        i8.int8_wdot(torch.ones(2, 8, dtype=torch.float16, device=card), q,
                     scale)
    with pytest.raises(ValueError, match="one cuda device"):
        i8.int8_wdot(torch.ones(2, 8), q, scale)
    k8 = torch.zeros(1, 4, 1, 6, dtype=torch.int8, device=card)
    s = torch.ones(1, 4, 1, device=card)
    with pytest.raises(ValueError, match="decode_attention_int8"):
        i8.decode_attention_int8(torch.ones(1, 1, 1, 6, device=card), k8,
                                 k8, s, s)
