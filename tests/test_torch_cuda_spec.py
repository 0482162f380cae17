"""The int8 serving kernels on the card at the shapes speculative decoding
gives them (csrc/int8_serve.cu through ops/int8_serve.py), against their
plain PyTorch versions: K5 ``int8_wdot`` at a verify block's M = 8 * (k +
1) = 40 rows (bf16 on the tensor cores, f32 on the tiled kernel) and the
draft's catch-up block's M = 16 (the skinny limit); K6
``decode_attention_int8`` at ragged blocks of T = 2..5 queries, row b's
query j seeing positions up to ``lengths[b] + j`` (finished rows past
max_len included); K7 ``kv_quantize`` at ragged T = 5 with the writes
past max_len dropped.  K5 and K6 in f32 within rtol 2e-5, atol 2e-5, in
bf16 within 2^-7 of the output's largest magnitude; K7 byte for byte.

The f32 serving contract rests on two properties held here bit for bit:
a row's K5 product is the same at M 40 as at M 1, and a T-query K6 call
is what T single-query calls give.  Last, the speculative decoders on the
card: f32 greedy streams token-exact against ``generate`` with int8
weights in both cache dtypes.

Marked ``cuda``; skips without a card.  On one, run ``python -m pytest
--noconftest tests/test_torch_cuda_spec.py -m cuda``.  Imports neither
``jax`` nor the JAX package.  Inputs are seeded with numpy."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

TOL = dict(rtol=2e-5, atol=2e-5)
# llama_350m's (K, N) products, and a 2-layer model's (d_model 256)
SHAPES = [(1024, 1024), (1024, 256), (1024, 2816), (2816, 1024),
          (1024, 32000), (256, 128), (512, 1024)]


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


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * want.float().abs().max().item(), err


def _same(a, b):
    def raw(x):
        return x.detach().cpu().contiguous().view(torch.uint8).numpy()

    return (a.shape == b.shape and a.dtype == b.dtype
            and raw(a).tobytes() == raw(b).tobytes())


def _cache(rng, b, max_len, kv, d, dev):
    k8, v8 = (torch.from_numpy(rng.integers(-127, 128, (b, max_len, kv, d))
                               .astype(np.int8)).to(dev) for _ in range(2))
    ks, vs = (torch.from_numpy((rng.random((b, max_len, kv)) * 0.02 + 1e-3)
                               .astype(np.float32)).to(dev)
              for _ in range(2))
    return k8, v8, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [16, 40])
@pytest.mark.parametrize("k,n", SHAPES)
def test_int8_wdot_at_verify_rows(card, dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(
        np.int8)).to(card)
    scale = torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(
        np.float32)).to(card)
    x = _randn(rng, (m, k), dtype, card)
    want_shape = ("skinny" if m <= i8.SKINNY_M else
                  "tensor_cores" if dtype == torch.bfloat16 else "tiled")
    assert i8.int8_wdot_shape(x, q) == want_shape
    before = i8.launches["int8_wdot"]
    got = i8.int8_wdot(x, q, scale)
    torch.cuda.synchronize()
    assert i8.launches["int8_wdot"] == before + 1
    _close(got, i8.int8_wdot_reference(x, q, scale), dtype)
    if dtype == torch.float32:
        # one summation order at any M: each verify row is the bits the
        # single-row decode step gives
        for row in (0, m // 2, m - 1):
            alone = i8.int8_wdot(x[row:row + 1].contiguous(), q, scale)
            assert _same(alone, got[row:row + 1]), row


# (B, H, KV, D, max_len): llama_350m's serving round, a 2-layer model's
# (4 heads of 64 over 2 KV heads), G 1
ATTN = [(8, 16, 4, 64, 2048), (8, 4, 2, 64, 512), (4, 8, 8, 64, 300)]


def _ragged(rng, b, t, max_len):
    """Row limits of a verify block: one row at 0, rows across K6's chunk
    edges, one block ending on the cache's last position, one straddling
    it and one finished row wholly past it (a retired lane keeps going)."""
    p = i8.ATTN_CHUNK
    lens = rng.integers(0, max_len - t, b)
    edges = [0, p - 2, p - t + 1, max_len - t, max_len - 2, max_len + 3]
    lens[:len(edges)] = edges[:b]
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2, 3, 4, 5])
@pytest.mark.parametrize("b,h,kv,d,max_len", ATTN)
def test_decode_attention_int8_ragged_block(card, dtype, t, b, h, kv, d,
                                            max_len):
    rng = np.random.default_rng(t * 7 + h)
    q = _randn(rng, (b, t, h, d), dtype, card)
    cache = _cache(rng, b, max_len, kv, d, card)
    lens = torch.from_numpy(_ragged(rng, b, t, max_len).astype(
        np.int64)).to(card)
    before = i8.launches["decode_attention_int8"]
    got = i8.decode_attention_int8(q, *cache, lengths=lens)
    torch.cuda.synchronize()
    assert i8.launches["decode_attention_int8"] == before + 1
    _close(got, i8.decode_attention_int8_reference(q, *cache, lens, 0),
           dtype)
    if dtype == torch.float32:
        # query j is what a single-query call at lengths + j gives
        for j in range(t):
            one = i8.decode_attention_int8(q[:, j:j + 1].contiguous(),
                                           *cache, lengths=lens + j)
            assert _same(one, got[:, j:j + 1].contiguous()), j


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [2, 5])
def test_kv_quantize_ragged_block_drops_past_max_len(card, dtype, t):
    rng = np.random.default_rng(t)
    b, kv, d, max_len = 8, 4, 64, 64
    k = _randn(rng, (b, t, kv, d), dtype, card)
    v = _randn(rng, (b, t, kv, d), dtype, card, scale=3.0)
    lens = torch.tensor([0, 5, 30, max_len - t, max_len - 3, max_len - 1,
                         max_len, max_len + 9], dtype=torch.int64,
                        device=card)
    outs = [[torch.full((b, max_len, kv, d), 9, dtype=torch.int8,
                        device=card) for _ in range(2)]
            + [torch.full((b, max_len, kv), 7.0, device=card)
               for _ in range(2)] for _ in range(3)]
    before = i8.launches["kv_quantize"]
    i8.kv_quantize(k, v, *outs[0], lengths=lens)
    torch.cuda.synchronize()
    assert i8.launches["kv_quantize"] == before + 1
    i8.kv_quantize_reference(k, v, *outs[1], lens, 0)
    # the block equals its positions written one at a time
    for j in range(t):
        i8.kv_quantize(k[:, j:j + 1].contiguous(), v[:, j:j + 1].contiguous(),
                       *outs[2], lengths=lens + j)
    for got, want, single in zip(*outs):
        assert _same(got, want) and _same(got, single)
    assert int(outs[0][0][7].ne(9).sum()) == 0      # all dropped


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["native", "int8"])
def test_speculative_f32_token_exact_on_the_card(card, cache_dtype):
    """A 2-layer f32 target with int8 weights (head_dim 64) and a draft
    that agrees in part (the target's weights, perturbed): the batched
    decoder (k = 4: verify blocks of 40 rows), the batch-1 host loop and
    beam width 1 give generate's greedy tokens."""
    from parameter_server_distributed_tpu_torch.models import generation
    from parameter_server_distributed_tpu_torch.models.quant import \
        quantize_params
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig)

    model = Transformer(TransformerConfig(
        vocab=1024, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=torch.float32))
    dense = model.init_params(1, device=card)
    gen = torch.Generator(device=card).manual_seed(2)
    noisy = {name: w + 0.03 * w.std() * torch.randn(
        w.shape, generator=gen, device=card) if w.ndim == 2 else w
        for name, w in dense.items()}
    params, dparams = quantize_params(dense), quantize_params(noisy)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, 1024, (8, 40)).astype(
        np.int32))
    want = generation.generate(model, params, prompt, 16,
                               cache_dtype=cache_dtype, device=card)
    got, stats = generation.speculative_generate_batched(
        model, params, model, dparams, prompt, 16, draft_len=4,
        cache_dtype=cache_dtype, device=card)
    assert torch.equal(got, want), stats
    assert stats["verify_calls"] >= 1
    if cache_dtype == "native":
        one, _ = generation.speculative_generate(
            model, params, model, dparams, prompt[:1], 16, draft_len=4,
            device=card)
        assert torch.equal(one, want[:1])
        beam, _ = generation.beam_search(model, params, prompt[:2], 16,
                                         beam_width=1, device=card)
        assert torch.equal(beam, want[:2])
