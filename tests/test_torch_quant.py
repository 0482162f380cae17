"""Weight-only int8 quantization of the PyTorch port (models/quant.py)
against the JAX package's models/quant.py on the CPU: ``quantize`` byte
for byte on the same numpy matrices; ``wdot`` within rtol 2e-5, atol
2e-5 (tests/test_quant.py); ``quantize_params`` quantizing the same
leaves in both layouts; ``store_bytes`` equal; a quantized store's
logits within rtol/atol 1e-4 of the JAX quantized model's and its greedy
cached decode token-exact, through a store converted from the JAX one
(``(q, scale)`` numpy pairs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import generation as jg
from parameter_server_distributed_tpu.models import quant as jq
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import generation as tg
from parameter_server_distributed_tpu_torch.models import quant as tq
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


TOL = dict(rtol=2e-5, atol=2e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)


def to_numpy(store):
    """A JAX store as numpy, a QTensor as its (q, scale) pair."""
    return {k: (np.asarray(v.q), np.asarray(v.scale))
            if isinstance(v, jq.QTensor) else np.asarray(v)
            for k, v in store.items()}


def _pair(scan_layers):
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=128, max_seq=64, dtype=jnp.float32, mlp_act="swiglu",
        scan_layers=scan_layers))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    cfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    return jm, jm.init_params(0), tt.Transformer(cfg), cfg


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "stacked"])
def pair(request):
    jm, jparams, pm, cfg = _pair(request.param)
    jq_params = jq.quantize_params(jparams)
    return jm, jq_params, pm, params_from_numpy(to_numpy(jq_params), cfg,
                                                device="cpu")


@pytest.mark.parametrize("shape", [(64, 128), (2, 96, 48), (1024, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bytes_equal_jax(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[..., 3] = 0.0                           # an all-zero channel
    w[..., 0, 5] = 1.0                        # a channel of one outlier
    wj = jnp.asarray(w, dtype)
    ref = jq.quantize(wj)
    got = tq.quantize(torch.from_numpy(np.array(wj.astype(jnp.float32)))
                      .to(getattr(torch, dtype)))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.q.numpy().tobytes() == np.asarray(ref.q).tobytes()
    assert got.scale.numpy().tobytes() == np.asarray(ref.scale).tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wdot_plain_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    ref = jq.wdot(xj, jq.quantize(jnp.asarray(w)))
    got = tq.wdot(torch.from_numpy(np.array(xj.astype(jnp.float32)))
                  .to(dtype), tq.quantize(torch.from_numpy(w)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # a dense weight passes through as the f32 product
    dense = tq.wdot(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(dense.numpy(), x @ w, **TOL)


def test_qtensor_slices_stacks_and_dequantizes():
    qt = tq.quantize(torch.ones(3, 16, 8))
    assert qt.shape == (3, 16, 8) and qt.ndim == 3
    sliced = qt[1]
    assert sliced.q.shape == (16, 8) and sliced.scale.shape == (8,)
    assert bool((sliced.dequant() == 1.0).all())
    unrolled = {f"layer{i}/attn/wq": qt[i] for i in range(3)}
    stacked = tt.stack_layers(unrolled, 3)["blocks/attn/wq"]
    assert isinstance(stacked, tq.QTensor)
    assert torch.equal(stacked.q, qt.q) and torch.equal(stacked.scale,
                                                        qt.scale)
    assert repr(qt) == "QTensor(int8 (3, 16, 8))"


def test_quantize_params_eligibility_and_store_bytes(pair):
    jm, jq_params, pm, params = pair
    want = {k for k, v in jq_params.items() if isinstance(v, jq.QTensor)}
    got = {k for k, v in params.items() if isinstance(v, tq.QTensor)}
    assert got == want and "lm_head/w" in got
    assert not isinstance(params["embed/tok"], tq.QTensor)
    # quantizing the converted dense store in the port picks the same
    dense = params_from_numpy(to_numpy(jm.init_params(0)), pm.config,
                              device="cpu")
    again = tq.quantize_params(dense)
    assert {k for k, v in again.items() if isinstance(v, tq.QTensor)} == want
    assert tq.store_bytes(params) == jq.store_bytes(jq_params)
    assert tq.store_bytes(dense) == jq.store_bytes(jm.init_params(0))


def test_quantized_logits_match_jax(pair):
    jm, jq_params, pm, params = pair
    toks = np.random.default_rng(2).integers(0, 96, (2, 16)).astype(np.int32)
    ref = jm.apply(jq_params, jnp.asarray(toks))
    with torch.inference_mode():
        got = pm.apply(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGITS_TOL)


def test_quantized_cached_decode_token_exact(pair):
    jm, jq_params, pm, params = pair
    prompt = np.random.default_rng(3).integers(0, 96, (2, 8)).astype(
        np.int32)
    ref = jg.generate(jm, jq_params, jnp.asarray(prompt), 6)
    got = tg.generate(pm, params, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantized_store_crosses_layouts_and_refuses_training():
    jm, jparams, pm, cfg = _pair(False)
    stacked_cfg = dataclasses.replace(cfg, scan_layers=True)
    params = params_from_numpy(to_numpy(jq.quantize_params(jparams)),
                               stacked_cfg, device="cpu")
    assert isinstance(params["blocks/mlp/w2"], tq.QTensor)
    assert params["blocks/mlp/w2"].shape == (2, 128, 64)
    with pytest.raises(ValueError, match="post-training"):
        tt.Transformer(stacked_cfg).loss(
            params, torch.zeros((1, 8), dtype=torch.int32))
