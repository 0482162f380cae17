"""Transformer forward of the PyTorch port (models/transformer.py) against
the JAX package on one parameter store, converted with
models/convert.params_from_numpy.  Both run on the CPU in float32; the
flash case runs the Pallas kernel in interpret mode on the JAX side and the
port's plain version on the other.  Tolerance: rtol/atol 1e-4, the
tests/test_hf.py:49 tolerance for a converted model."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)

BASE = dict(vocab=96, d_model=64, n_heads=4, n_layers=2, d_ff=96,
            max_seq=128)
CONFIGS = {
    "gqa_swiglu": dict(n_kv_heads=2, mlp_act="swiglu"),
    "mha_gelu": dict(),
    "gpt2_knobs": dict(pos_emb="learned", norm="layernorm", bias=True,
                       norm_eps=1e-5),
}


def jax_model(scan_layers=False, attention_fn=None, **kw):
    cfg = jt.TransformerConfig(**{**BASE, **kw}, dtype=jnp.float32,
                               scan_layers=scan_layers)
    return jt.Transformer(cfg, attention_fn=attention_fn)


def port_config(jax_cfg, **override):
    fields = {f.name: getattr(jax_cfg, f.name)
              for f in dataclasses.fields(jax_cfg)}
    fields.update({"dtype": torch.float32, **override})
    return tt.TransformerConfig(**fields)


def numpy_store(model, seed=0):
    """Reference init as numpy, with norm scales and biases perturbed so
    the bias and LayerNorm paths carry real values."""
    rng = np.random.default_rng(seed)
    store = {}
    for name, value in model.init_params(seed).items():
        arr = np.asarray(value, np.float32)
        if name.endswith(("/scale", "/bias")) or "/b" in name.split("/")[-1]:
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(
                np.float32)
        store[name] = arr
    return store


def _tokens(seed, batch=2, seq=16, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, (batch, seq),
                                                dtype=np.int32)


def _check_forward(jm, pm, store, params, tokens):
    ref_logits, ref_kvs = jm.apply_collect_kv(
        {k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(tokens))
    logits, kvs = pm.apply_collect_kv(params, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert len(kvs) == len(ref_kvs)
    for (k, v), (rk, rv) in zip(kvs, ref_kvs):
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), **TOL)
    np.testing.assert_allclose(
        pm.apply(params, torch.from_numpy(tokens)).numpy(),
        np.asarray(ref_logits), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jm = jax_model(**CONFIGS[name])
    store = numpy_store(jm)
    cfg = port_config(jm.config)
    params = params_from_numpy(store, cfg, device="cpu")
    pm = tt.Transformer(cfg, attention_fn=tt.causal_attention)
    assert pm.param_shapes() == jm.param_shapes()
    _check_forward(jm, pm, store, params, _tokens(1))


def test_flash_forward_matches_jax_at_seq_128():
    jm = jax_model(attention_fn=jt.flash_attention_auto,
                   **CONFIGS["gqa_swiglu"])
    store = numpy_store(jm, seed=2)
    cfg = port_config(jm.config)
    params = params_from_numpy(store, cfg, device="cpu")
    pm = tt.Transformer(cfg, attention_fn=tt.flash_attention_auto)
    _check_forward(jm, pm, store, params, _tokens(3, batch=1, seq=128))


@pytest.mark.parametrize("port_scan", [True, False])
def test_stacked_layout_converts(port_scan):
    jm = jax_model(scan_layers=True, **CONFIGS["gqa_swiglu"])
    store = numpy_store(jm, seed=4)
    assert any(name.startswith("blocks/") for name in store)
    cfg = port_config(jm.config, scan_layers=port_scan)
    params = params_from_numpy(store, cfg, device="cpu")
    assert any(n.startswith("blocks/") for n in params) == port_scan
    pm = tt.Transformer(cfg, attention_fn=tt.causal_attention)
    _check_forward(jm, pm, store, params, _tokens(5))


@pytest.mark.parametrize("name", ["gqa_swiglu", "gpt2_knobs"])
def test_bf16_forward_within_rounding(name):
    """bf16 end to end: the first layer's K/V agree within one bf16 step
    (2^-7 relative: the same products, each rounded once), and the logits
    within 5e-2 after two layers of bf16 re-rounding at places the two
    frameworks choose differently."""
    jm = jax_model(**CONFIGS[name])
    jm = jt.Transformer(dataclasses.replace(jm.config, dtype=jnp.bfloat16),
                        attention_fn=jt.causal_attention)
    store = {k: np.asarray(v).astype(ml_dtypes.bfloat16)
             for k, v in numpy_store(jm).items()}
    cfg = port_config(jm.config, dtype=torch.bfloat16)
    params = params_from_numpy(store, cfg, device="cpu")
    pm = tt.Transformer(cfg, attention_fn=tt.causal_attention)
    tokens = _tokens(6)
    ref_logits, ref_kvs = jm.apply_collect_kv(
        {k: jnp.asarray(v) for k, v in store.items()}, jnp.asarray(tokens))
    logits, kvs = pm.apply_collect_kv(params, torch.from_numpy(tokens))
    for got, ref in zip(kvs[0], ref_kvs[0]):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref).astype(np.float32),
                                   rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=0, atol=5e-2)


def test_bf16_store_converts_bit_exact():
    jm = jax_model(**CONFIGS["mha_gelu"])
    store = {name: np.asarray(value).astype(ml_dtypes.bfloat16)
             for name, value in numpy_store(jm).items()}
    cfg = port_config(jm.config, dtype=torch.bfloat16)
    params = params_from_numpy(store, cfg, device="cpu")
    for name, arr in store.items():
        assert params[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            params[name].view(torch.int16).numpy().view(np.uint16),
            arr.view(np.uint16))


def test_converter_rejects_drift():
    jm = jax_model(**CONFIGS["mha_gelu"])
    store = numpy_store(jm)
    store.pop("lm_head/w")
    with pytest.raises(ValueError, match="drift"):
        params_from_numpy(store, port_config(jm.config), device="cpu")


def test_layer_helpers_match_jax(rng):
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    np.testing.assert_allclose(
        tt.rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jt.rope(jnp.asarray(x), jnp.asarray(pos))), **TOL)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        tt.rms_norm(*map(torch.from_numpy, (h, scale))).numpy(),
        np.asarray(jt.rms_norm(*map(jnp.asarray, (h, scale)))), **TOL)
    np.testing.assert_allclose(
        tt.layer_norm(*map(torch.from_numpy, (h, scale, bias))).numpy(),
        np.asarray(jt.layer_norm(*map(jnp.asarray, (h, scale, bias)))),
        **TOL)
    kv = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tt.repeat_kv(torch.from_numpy(kv), 2).numpy(),
        np.asarray(jt.repeat_kv(jnp.asarray(kv), 2)))
    np.testing.assert_allclose(
        tt.causal_attention(*map(torch.from_numpy, (x, kv, kv))).numpy(),
        np.asarray(jt.causal_attention(*map(jnp.asarray, (x, kv, kv)))),
        **TOL)


def test_factories_match_reference_shapes():
    for name in ("small_lm", "tiny_lm", "lm_350m", "llama_350m"):
        ours = getattr(tt, name)()
        ref = getattr(jt, name)()
        assert ours.param_shapes() == ref.param_shapes(), name
        assert ours.config.loss_chunk == ref.config.loss_chunk
    assert tt.llama_350m().num_params() == jt.llama_350m().num_params()


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.Transformer(tt.TransformerConfig(moe_every=2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.select_attention("ring")
    with pytest.raises(ValueError, match="unknown attention"):
        tt.select_attention("nope")
    assert tt.select_attention("dense") is None
    assert tt.select_attention("flash") is tt.flash_attention_auto
