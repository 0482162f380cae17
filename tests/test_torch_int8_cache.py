"""The int8 KV cache of the PyTorch port (models/generation.py
QuantKVCache) against the JAX package's on one converted store, in
float32 on the CPU, where the plain versions of ``kv_quantize`` and
``decode_attention_int8`` run: ``_kv_quantize`` byte for byte on the same
inputs; prefill and ``decode_block`` (contiguous, ragged, and ragged
writes past max_len dropped) with logits within rtol/atol 1e-4
(tests/test_hf.py:49) and cache codes within one step of the JAX
package's (the two frameworks' K/V differ in the last bits, so a code on
a rounding boundary may land one apart); ``generate(cache_dtype="int8")``
token-exact, with dense and with int8 weights."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu.models import quant as jq
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


@pytest.fixture(scope="module")
def pair():
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=64, dtype=jnp.float32, mlp_act="swiglu"))
    jparams = jm.init_params(0)
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               cfg, device="cpu")
    return jm, jparams, tt.Transformer(cfg), params


def _prompt(seed, batch, n):
    return np.random.default_rng(seed).integers(0, 96, (batch, n),
                                                dtype=np.int32)


def _cache_close(got, ref):
    """Codes within one step of the reference's (nearly all equal),
    scales within rtol 1e-5, the length equal."""
    for a, b in ((got.k, ref.k), (got.v, ref.v)):
        diff = np.abs(a.numpy().astype(np.int32)
                      - np.asarray(b).astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 0.01, diff.mean()
    for a, b in ((got.k_scale, ref.k_scale), (got.v_scale, ref.v_scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bytes_equal_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, 4, 64)) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0                          # a zero row: scale 1
    x[1, 2, 0, :3] = [127.0, 2.5, -3.5]       # scale 1, rint's ties
    xj = jnp.asarray(x, dtype)
    ref_q, ref_s = jg._kv_quantize(xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    k8, v8, ks, vs = tg._kv_quantize(xt, -xt)
    assert k8.numpy().tobytes() == np.asarray(ref_q).tobytes()
    assert ks.numpy().tobytes() == np.asarray(ref_s).tobytes()
    assert v8.numpy().tobytes() == (-np.asarray(ref_q)).tobytes()
    assert vs.numpy().tobytes() == np.asarray(ref_s).tobytes()


def test_prefill_and_contiguous_decode_match(pair):
    jm, jparams, pm, params = pair
    prompt = _prompt(0, 2, 7)
    ref_last, ref_cache = jg.prefill(jm, jparams, jnp.asarray(prompt), 24,
                                     cache_dtype="int8")
    with torch.inference_mode():
        last, cache = tg.prefill(pm, params, torch.from_numpy(prompt), 24,
                                 cache_dtype="int8")
    assert isinstance(cache, tg.QuantKVCache) and cache.length == 7
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    _cache_close(cache, ref_cache)
    block = _prompt(1, 2, 3)
    ref_logits, ref_cache = jg.decode_block(jm, jparams, jnp.asarray(block),
                                            ref_cache)
    with torch.inference_mode():
        logits, cache = tg.decode_block(pm, params, torch.from_numpy(block),
                                        cache)
    assert cache.length == 10
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _cache_close(cache, ref_cache)


def test_ragged_decode_drops_writes_past_max_len(pair):
    jm, jparams, pm, params = pair
    prompt = _prompt(2, 2, 7)
    _, ref_cache = jg.prefill(jm, jparams, jnp.asarray(prompt), 24,
                              cache_dtype="int8")
    with torch.inference_mode():
        _, cache = tg.prefill(pm, params, torch.from_numpy(prompt), 24,
                              cache_dtype="int8")
    block = _prompt(3, 2, 3)
    lengths = np.array([5, 23], np.int32)     # row 1 writes 23, 24, 25
    ref_logits, ref_cache = jg.decode_block(
        jm, jparams, jnp.asarray(block), ref_cache,
        lengths=jnp.asarray(lengths))
    with torch.inference_mode():
        logits, cache = tg.decode_block(
            pm, params, torch.from_numpy(block), cache,
            lengths=torch.from_numpy(lengths.astype(np.int64)))
    assert cache.length == 7                  # ragged: left alone
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    _cache_close(cache, ref_cache)
    assert int(cache.k[:, 1, 23].abs().sum()) > 0   # the one kept write


@pytest.mark.parametrize("weights", ["dense", "int8"])
def test_generate_int8_cache_token_exact(pair, weights):
    jm, jparams, pm, params = pair
    if weights == "int8":
        jparams = jq.quantize_params(jparams)
        params = params_from_numpy(
            {k: (np.asarray(v.q), np.asarray(v.scale))
             if isinstance(v, jq.QTensor) else np.asarray(v)
             for k, v in jparams.items()}, pm.config, device="cpu")
    prompt = _prompt(4, 2, 9)
    ref = jg.generate(jm, jparams, jnp.asarray(prompt), 8,
                      cache_dtype="int8")
    got = tg.generate(pm, params, prompt, 8, cache_dtype="int8",
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
