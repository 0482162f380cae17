"""KV-cached generation of the PyTorch port (models/generation.py) against
the JAX package on one converted store, in float32 on the CPU.  Logits
within rtol/atol 1e-4 (tests/test_hf.py:49); greedy ``generate``
token-exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import generation as tg
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy


@pytest.fixture(autouse=True)
def hygiene():
    """torch on at most two intra-op threads: these tests' products are
    small, and more threads only cost time where workers share cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=["gqa_swiglu", "gpt2_knobs"])
def pair(request):
    kw = (dict(n_kv_heads=2, mlp_act="swiglu")
          if request.param == "gqa_swiglu" else
          dict(pos_emb="learned", norm="layernorm", bias=True,
               norm_eps=1e-5))
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=96, d_model=48, n_heads=4, n_layers=2, d_ff=96, max_seq=64,
        dtype=jnp.float32, **kw))
    jparams = jm.init_params(0)
    store = {k: np.asarray(v) for k, v in jparams.items()}
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    pm = tt.Transformer(cfg)
    return jm, jparams, pm, params_from_numpy(store, cfg, device="cpu")


def _prompt(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 96, (batch, n),
                                                dtype=np.int32)


def test_prefill_and_decode_block_match(pair):
    jm, jparams, pm, params = pair
    prompt = _prompt(0, 2, 7)
    ref_last, ref_cache = jg.prefill(jm, jparams, jnp.asarray(prompt), 24)
    with torch.inference_mode():
        last, cache = tg.prefill(pm, params, torch.from_numpy(prompt), 24)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    assert cache.length == 7 and cache.max_len == 24
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k),
                               **TOL)
    block = _prompt(1, 2, 3)
    ref_logits, ref_cache = jg.decode_block(jm, jparams, jnp.asarray(block),
                                            ref_cache)
    with torch.inference_mode():
        logits, cache = tg.decode_block(pm, params, torch.from_numpy(block),
                                        cache)
    assert cache.length == int(ref_cache.length) == 10
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref_cache.v),
                               **TOL)


@pytest.mark.parametrize("lengths", [[7, 4], [7, 23]])
def test_ragged_decode_block_matches(pair, lengths):
    """Rows at their own positions; [7, 23] runs row 1's block past the
    cache end, whose writes both sides drop."""
    jm, jparams, pm, params = pair
    prompt = _prompt(2, 2, 7)
    block = _prompt(3, 2, 2)
    _, ref_cache = jg.prefill(jm, jparams, jnp.asarray(prompt), 24)
    ref_logits, ref_cache = jg.decode_block(
        jm, jparams, jnp.asarray(block), ref_cache,
        lengths=jnp.asarray(lengths, jnp.int32))
    with torch.inference_mode():
        _, cache = tg.prefill(pm, params, torch.from_numpy(prompt), 24)
        logits, cache = tg.decode_block(pm, params, torch.from_numpy(block),
                                        cache,
                                        lengths=torch.tensor(lengths))
    assert cache.length == 7
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref_cache.k),
                               **TOL)


def test_greedy_generate_token_exact(pair):
    jm, jparams, pm, params = pair
    prompt = _prompt(4, 2, 9)
    ref = np.asarray(jg.generate(jm, jparams, jnp.asarray(prompt), 12))
    out = tg.generate(pm, params, prompt, 12, device="cpu")
    assert out.dtype == torch.int32 and out.shape == (2, 12)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generate_rejects_out_of_vocab(pair):
    _, _, pm, params = pair
    with pytest.raises(ValueError, match="token ids"):
        tg.generate(pm, params, [[1, 96]], 2, device="cpu")


def test_sampling_is_seeded_and_in_support(pair):
    _, _, pm, params = pair
    prompt = _prompt(5, 2, 5)
    a = tg.generate(pm, params, prompt, 6, temperature=0.9, top_k=5,
                    rng=3, device="cpu")
    b = tg.generate(pm, params, prompt, 6, temperature=0.9, top_k=5,
                    rng=3, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(a.min()) >= 0 and int(a.max()) < 96


def test_truncation_matches_jax(rng):
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    for top_k, top_p in [(5, 0.0), (0, 0.7), (8, 0.5), (100, 0.0)]:
        ref = np.asarray(jg._truncate_logits(jnp.asarray(logits), top_k,
                                             top_p))
        out = tg._truncate_logits(torch.from_numpy(logits), top_k,
                                  top_p).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
        np.testing.assert_allclose(out[~np.isinf(out)],
                                   ref[~np.isinf(ref)])


def test_rowwise_sampling_greedy_rows_and_distribution():
    gen = torch.Generator().manual_seed(0)
    logits = torch.log(torch.tensor([[0.7, 0.2, 0.1]] * 2))
    temps = torch.tensor([0.0, 1.0])
    draws = torch.stack([tg.sample_token_rowwise(logits, gen, temps)
                         for _ in range(4000)])
    assert (draws[:, 0] == 0).all()
    freq = torch.bincount(draws[:, 1].long(), minlength=3).float() / 4000
    np.testing.assert_allclose(freq.numpy(), [0.7, 0.2, 0.1], atol=0.03)


def test_int8_cache_raises(pair):
    """The int8 cache is ported (tests/test_torch_int8_cache.py holds it
    against the JAX package's): init_cache builds it, int8 codes with
    unit scales; a cache dtype neither native nor int8 raises."""
    _, _, pm, _ = pair
    cache = tg.init_cache(pm, 1, 8, "int8", device="cpu")
    assert isinstance(cache, tg.QuantKVCache) and cache.max_len == 8
    assert cache.k.dtype == torch.int8 and bool((cache.v_scale == 1).all())
    with pytest.raises(ValueError, match="cache_dtype"):
        tg.init_cache(pm, 1, 8, "fp8", device="cpu")
