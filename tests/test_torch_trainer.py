"""The PyTorch port's training step (worker/trainer.py over
models/transformer.py's loss, with flash attention's autograd Function)
against the JAX package's ``Trainer`` on one numpy store and batch, and
the port's Trainer -> PallasOptimizer loop against the JAX one.  Both run
on the CPU: the JAX side runs the Pallas kernels in interpret mode, the
port its plain versions.

Tolerances: f32 loss within 1e-5 relative and gradients rtol 1e-4 (atol
1e-6 for entries near zero), the reference's optimizer-level tolerance
(tests/test_pallas_ops.py:152); chunked loss and remat against the plain
step rtol 1e-5, atol 1e-7 (the same arithmetic, summed in another order);
bf16 loss within 1e-2 relative and gradients within 2^-5 of each tensor's
largest entry (both frameworks round every bf16 activation, at places
they choose differently, and scatter-add the embedding gradient in bf16
in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
    PallasOptimizer as JaxPallasOptimizer
from parameter_server_distributed_tpu.models import registry as jax_registry
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as JaxTrainer
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import PallasOptimizer
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SAME_TOL = dict(rtol=1e-5, atol=1e-7)

# 2 layers, narrow, GQA + SwiGLU; seq 128 so flash_attention_auto takes
# the flash path (blocks of 128) on both sides
CFG = dict(vocab=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=96, max_seq=128, mlp_act="swiglu")


def jax_model(dtype=jnp.float32, **kw):
    return jt.Transformer(jt.TransformerConfig(**CFG, dtype=dtype, **kw),
                          attention_fn=jt.flash_attention_auto)


def port_model(dtype=torch.float32, **kw):
    return tt.Transformer(tt.TransformerConfig(**CFG, dtype=dtype, **kw),
                          attention_fn=tt.flash_attention_auto)


def numpy_store(seed=0):
    return {k: np.array(v, np.float32)
            for k, v in jax_model().init_params(seed).items()}


def tokens(seed=1, batch=2):
    return np.random.default_rng(seed).integers(0, CFG["vocab"],
                                                (batch, CFG["max_seq"]),
                                                dtype=np.int32)


def jax_trainer(model):
    return JaxTrainer(model, local_devices=jax.devices()[:1])


def assert_grads(got, ref, **tol):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), **tol,
                                   err_msg=k)


def test_compute_gradients_matches_jax():
    store, batch = numpy_store(), tokens()
    ref_g, ref_loss = jax_trainer(jax_model()).compute_gradients(store, batch)
    grads, loss = Trainer(port_model(), device="cpu").compute_gradients(
        store, batch)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert_grads(grads, ref_g, **GRAD_TOL)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32)
    toks = rng.integers(0, 17, (2, 9), dtype=np.int32)
    np.testing.assert_allclose(
        float(tt.next_token_nll(torch.from_numpy(logits),
                                torch.from_numpy(toks))),
        float(jt.next_token_nll(jnp.asarray(logits), jnp.asarray(toks))),
        rtol=1e-6)
    q = rng.standard_normal((1, 4, 6, 8)).astype(np.float32)
    kv = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    for n_tp in (1, 2, 4):   # 4 does not divide 2 kv heads: expanded
        got = tt.prepare_gqa_kv(*map(torch.from_numpy, (q, kv, kv)), n_tp)
        ref = jt.prepare_gqa_kv(*map(jnp.asarray, (q, kv, kv)), n_tp)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="divide"):
        tt.prepare_gqa_kv(torch.zeros(1, 4, 5, 8), torch.zeros(1, 4, 2, 8),
                          torch.zeros(1, 4, 2, 8), 1)


def test_card_tensor_params_pack_like_numpy():
    """Params given as tensors on the trainer's device (what
    PallasOptimizer returns) are packed there; the step is the same."""
    store, batch = numpy_store(2), tokens(3)
    trainer = Trainer(port_model(), device="cpu")
    g_np, l_np = trainer.compute_gradients(store, batch)
    g_t, l_t = trainer.compute_gradients(
        {k: torch.from_numpy(v) for k, v in store.items()},
        torch.from_numpy(batch))
    assert l_t == l_np
    assert_grads(g_t, g_np, rtol=0, atol=0)


@pytest.mark.parametrize("variant", [
    dict(loss_chunk=32), dict(remat=True),
    dict(remat=True, remat_policy="dots"),
    dict(remat=True, loss_chunk=64, scan_layers=True)])
def test_chunked_loss_and_remat_equal_plain(variant):
    store, batch = numpy_store(4), tokens(5)
    ref_g, ref_loss = Trainer(port_model(), device="cpu").compute_gradients(
        store, batch)
    model = port_model(**variant)
    if variant.get("scan_layers"):
        store = {k: v.numpy() for k, v in tt.stack_layers(
            {k: torch.from_numpy(v) for k, v in store.items()},
            CFG["n_layers"]).items()}
    grads, loss = Trainer(model, device="cpu").compute_gradients(store, batch)
    if variant.get("scan_layers"):
        grads = {k: v.numpy() for k, v in tt.unstack_layers(
            {k: torch.from_numpy(v) for k, v in grads.items()}).items()}
    np.testing.assert_allclose(loss, ref_loss, **SAME_TOL)
    assert_grads(grads, ref_g, **SAME_TOL)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_projection_products():
    """remat "full" reruns every projection product in the backward pass;
    "dots" saves them, so its backward runs no more aten.mm than a step
    without remat."""
    params = {k: torch.from_numpy(v) for k, v in numpy_store().items()}
    batch = torch.from_numpy(tokens())
    counts = {}
    for name, kw in (("none", {}), ("full", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = port_model(**kw).loss(leaves, batch)
        with _CountMM() as count:
            loss.backward()
        counts[name] = count.mm
    assert counts["dots"] == counts["none"] < counts["full"]


def test_bf16_gradients_within_rounding():
    store, batch = numpy_store(6), tokens(7)
    ref_g, ref_loss = jax_trainer(
        jax_model(jnp.bfloat16)).compute_gradients(store, batch)
    grads, loss = Trainer(port_model(torch.bfloat16),
                          device="cpu").compute_gradients(store, batch)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for k, ref in ref_g.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=2.0 ** -5 * np.abs(ref).max(),
                                   err_msg=k)


def adam_loop(**opt_kw):
    """Three rounds of worker step -> PS apply through each package; the
    port's optimizer hands back tensors, which its Trainer packs on the
    device.  Returns (port params, JAX params)."""
    store = numpy_store(8)
    batches = [tokens(9 + i) for i in range(3)]
    ref_t = jax_trainer(jax_model())
    ref_opt = JaxPallasOptimizer("adam", 1e-3, **opt_kw)
    trainer = Trainer(port_model(), device="cpu")
    opt = PallasOptimizer("adam", 1e-3, device="cpu", **opt_kw)
    p_ref, p = dict(store), dict(store)
    for batch in batches:
        g_ref, l_ref = ref_t.compute_gradients(
            {k: np.asarray(v) for k, v in p_ref.items()}, batch)
        p_ref = ref_opt.apply(p_ref, g_ref)
        g, loss = trainer.compute_gradients(p, batch)
        p = opt.apply(p, g)
        assert abs(loss - l_ref) <= 1e-5 * abs(l_ref)
    assert all(isinstance(v, torch.Tensor) for v in p.values())
    assert sorted(p) == sorted(store)
    return p, p_ref


def test_adam_loop_matches_jax():
    """The loop at eps 1e-6.  Adam divides by sqrt(v) + eps, so a gradient
    entry near eps in size hands its rounding differences to the update
    almost undamped: eps 1e-6 bounds that gain, and the check stays on the
    two packages' steps at the reference's tolerance."""
    p, p_ref = adam_loop(eps=1e-6)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(p_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_adam_loop_default_eps_matches_jax():
    """The loop at the optimizers' default eps (1e-8), as the card's
    training run uses it.  A gradient entry of a size near eps, whose
    rounding differs between the packages by a share of itself, moves
    the Adam step by up to that share of lr.  So every tensor holds the
    reference's tolerance in all but 0.1% of its entries, and those few
    within 0.1 lr (1e-4).  With these seeds one entry of 4,096 in
    layer1/attn/wq is off by 4.4e-5; every other entry holds."""
    p, p_ref = adam_loop()
    for k in p:
        got, ref = p[k].numpy(), np.asarray(p_ref[k])
        off = ~np.isclose(got, ref, rtol=1e-4, atol=1e-6)
        assert off.sum() <= 1e-3 * off.size, k
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_registry_batches_match_jax():
    model, batches = registry.get_model_and_batches("small_lm", 4, seed=3,
                                                    device="cpu")
    ref_model, ref_batches = jax_registry.get_model_and_batches(
        "small_lm", 4, seed=3)
    assert model.param_shapes() == ref_model.param_shapes()
    for _ in range(2):
        batch = next(batches)
        assert batch.dtype == torch.int32 and batch.shape == (4, 256)
        np.testing.assert_array_equal(batch.numpy(), next(ref_batches))
    flagship = registry.get_model("llama_350m")
    assert flagship.param_shapes() == jt.llama_350m().param_shapes()
    assert flagship.config.remat and flagship.config.loss_chunk == 128
    assert flagship.config.remat_policy == "full"
    assert flagship.config.dtype == torch.bfloat16


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        Trainer(port_model(), device="cpu", mesh_config=object())
    with pytest.raises(NotImplementedError, match="item 4"):
        Trainer(port_model(), device="cpu").compute_gradient_buckets(
            {}, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_model_and_batches("small_lm", 2, data_path="x.bin",
                                       device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("resnet18")
    with pytest.raises(ValueError, match="unknown dtype"):
        registry.get_model("small_lm", dtype="fp8")
