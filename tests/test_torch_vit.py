"""The port's ViT (models/vit.py, the ViT rows of models/registry.py)
against the JAX package's.

- Loss and gradients of a small ViT (8 px, patch 4, d_model 32, 2
  layers) through the port's ``Trainer`` and the JAX model's
  ``value_and_grad`` (compiled with ``xla_allow_excess_precision`` off,
  so that XLA rounds at every cast as the model does) on one numpy store
  and batch, with ``pool="cls"`` and ``pool="mean"``: f32
  within the reference's gradient tolerance, rtol 5e-4, atol 1e-5; bf16
  within 2^-5 of each gradient's largest entry, the loss within 1e-2.
- The patch order (row, column, channel within a patch), the
  bidirectional attention, the tanh GELU and the config's checks.
- ``param_shapes`` of ``vit_tiny()`` and ``vit_s16()``, the registry
  rows, their dtype plumbing and a JAX store carried across.

torch runs on at most two intra-op threads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.models import vit as ref_vit
from parameter_server_distributed_tpu_torch.models import registry, vit
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

SMALL = dict(image_size=8, patch_size=4, num_classes=10, d_model=32,
             n_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(autouse=True)
def hygiene():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def models(pool: str, dtype: str):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    return (ref_vit.ViT(ref_vit.ViTConfig(**SMALL, pool=pool, dtype=jdt)),
            vit.ViT(vit.ViTConfig(**SMALL, pool=pool, dtype=tdt)))


def numpy_store(model, seed: int) -> dict:
    """A numpy f32 store of ``model``'s shapes from ``seed``: matrices
    N(0, 1/fan_in), the embeddings N(0, 0.02²), norm scales near 1 and
    the patch bias near 0."""
    rng = np.random.default_rng(seed)
    store = {}
    for name, shape in model.param_shapes().items():
        noise = rng.standard_normal(shape)
        if name.endswith("/scale"):
            value = 1.0 + 0.1 * noise
        elif name.endswith("/bias"):
            value = 0.1 * noise
        elif name.startswith("embed/"):
            value = 0.02 * noise
        else:
            value = noise / np.sqrt(shape[0])
        store[name] = value.astype(np.float32)
    return store


def batch(seed: int, n: int = 4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_loss_and_gradients_match_jax(pool, dtype):
    ref_model, model = models(pool, dtype)
    store = numpy_store(ref_model, 2)
    xy = batch(3)
    params = {k: jnp.asarray(v, ref_model.config.dtype)
              for k, v in store.items()}
    ref_loss, ref_g = jax.jit(jax.value_and_grad(ref_model.loss)).lower(
        params, xy).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, xy)
    ref_loss = float(ref_loss)
    grads, loss = Trainer(model, device="cpu").compute_gradients(store, xy)
    assert sorted(grads) == sorted(ref_g)
    for k, ref in ref_g.items():
        ref = np.asarray(ref, np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(grads[k], ref, rtol=5e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(grads[k], ref, rtol=0,
                                       atol=2.0 ** -5 * np.abs(ref).max(),
                                       err_msg=k)
    assert abs(loss - ref_loss) <= (5e-4 if dtype == "f32" else 1e-2) \
        * abs(ref_loss)


def test_patches_attention_and_gelu_match_jax():
    ref_model, model = models("cls", "f32")
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    np.testing.assert_array_equal(
        model._patchify(torch.from_numpy(x)).numpy(),
        np.asarray(ref_model._patchify(jnp.asarray(x))))
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
               for _ in range(3))
    np.testing.assert_allclose(
        vit.bidirectional_attention(*map(torch.from_numpy, (q, k, v))),
        np.asarray(ref_vit.bidirectional_attention(q, k, v)), rtol=1e-5,
        atol=1e-6)
    # jax.nn.gelu's default is the tanh approximation, F.gelu's is erf
    z = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(z), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(z)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pool"):
        vit.ViTConfig(pool="max")
    with pytest.raises(ValueError, match="divide"):
        vit.ViTConfig(image_size=30, patch_size=4)


def test_param_shapes_rows_and_store_conversion():
    for port_fn, ref_fn, tensors, params in (
            (vit.vit_tiny, ref_vit.vit_tiny, 54, 2_680_704),
            (vit.vit_s16, ref_vit.vit_s16, 102, 21_998_592)):
        model, ref = port_fn(), ref_fn()
        assert model.param_shapes() == ref.param_shapes()
        assert len(model.param_shapes()) == tensors
        assert model.num_params() == ref.num_params() == params
    assert vit.vit_s16().config.dtype == torch.bfloat16
    for name in ("vit_tiny_cifar", "vit_s16_imagenet"):
        ref_model, _ = ref_registry.get_model_and_batches(name, 4)
        assert registry.get_model(name).param_shapes() == \
            ref_model.param_shapes()
    model, batches = registry.get_model_and_batches("vit_tiny_cifar", 4,
                                                    seed=1, device="cpu")
    _, ref_batches = ref_registry.get_model_and_batches("vit_tiny_cifar", 4,
                                                        seed=1)
    (x, y), (rx, ry) = next(batches), next(ref_batches)
    np.testing.assert_array_equal(x.numpy(), rx)
    np.testing.assert_array_equal(y.numpy(), ry)
    assert registry.get_model("vit_tiny_cifar", dtype="bf16").config.dtype \
        == torch.bfloat16
    with pytest.raises(ValueError, match="scan_layers"):
        registry.get_model("vit_tiny_cifar", scan=True)
    # a JAX store carried across gives the JAX model's logits
    ref_model, model = models("mean", "f32")
    store = numpy_store(ref_model, 5)
    params = params_from_numpy(store, model.config, device="cpu")
    x, _ = batch(6)
    np.testing.assert_allclose(
        model.apply(params, torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(ref_model.apply)(store, x)), rtol=1e-4,
        atol=1e-5)
