"""Flash-attention backward of the PyTorch port (ops/flash_attention.py)
against the JAX package: ``_flash_bwd`` against the JAX ``_flash_bwd``
(Pallas in interpret mode, as tests/test_pallas_ops.py runs it), and the
autograd Function's gradients against the JAX ``custom_vjp`` and dense
attention.  On the CPU the port takes its plain version,
flash_bwd_reference (tests/test_torch_cuda.py holds the Hopper kernels
against it on the card).

Tolerances are the reference's own (tests/test_pallas_ops.py): f32
gradients rtol 5e-4, atol 1e-5 (:195, :268); bf16 gradients against f32
dense rtol 0.1, atol 0.05 (:219)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.models.transformer import \
    causal_attention as jax_dense
from parameter_server_distributed_tpu.ops.pallas import \
    flash_attention as jax_flash
from parameter_server_distributed_tpu_torch.models.transformer import \
    causal_attention
from parameter_server_distributed_tpu_torch.ops import flash_attention as fa


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


GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 32), (64, 64)])
def test_flash_bwd_matches_pallas(block_q, block_k, groups):
    """The folded layout: q/o/dO [BH, G*S, D] against k/v [BH, S, D], the
    G segments summed into dk/dv."""
    rng = np.random.default_rng(block_q + 3 * block_k + groups)
    bh, s, d = 2, 64, 16
    q = _normal(rng, bh, groups * s, d)
    k, v = _normal(rng, bh, s, d), _normal(rng, bh, s, d)
    g = _normal(rng, bh, groups * s, d)
    bps = s // block_q
    o, lse = jax_flash._flash_fwd(*map(jnp.asarray, (q, k, v)), block_q,
                                  block_k, True, bps)
    o, lse = np.array(o), np.array(lse)
    ref = jax_flash._flash_bwd(*map(jnp.asarray, (q, k, v, o, lse, g)),
                               block_q, block_k, True, bps)
    got = fa._flash_bwd(*map(torch.from_numpy, (q, k, v, o, lse, g)),
                        block_q, block_k, bps)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


def test_flash_backward_bf16_within_rounding():
    """bf16 inputs: gradients through the Function track the f32 dense
    gradients within bf16 resolution, and come back bf16."""
    rng = np.random.default_rng(7)
    b, s, h, d = 1, 64, 2, 16
    q, k, v = (_normal(rng, b, s, h, d) for _ in range(3))

    def jax_loss(q, k, v):
        return jnp.sum(jax_dense(q, k, v).astype(jnp.float32) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
          for x in (q, k, v)]
    out = fa.flash_attention(*xs, block_q=32, block_k=32)
    (out.float() ** 2).sum().backward()
    for x, r in zip(xs, ref):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(r),
                                   rtol=0.1, atol=0.05)


def test_flash_gqa_gradients_match_pallas_and_stay_kv_sized():
    rng = np.random.default_rng(11)
    b, s, kv, groups, d = 1, 128, 2, 3, 8
    q = _normal(rng, b, s, kv * groups, d)
    k, v = _normal(rng, b, s, kv, d), _normal(rng, b, s, kv, d)

    def jax_loss(q, k, v):
        return jnp.sum(jax_flash.flash_attention_gqa(
            q, k, v, block_q=32, block_k=32) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_attention_gqa(*xs, block_q=32, block_k=32) ** 2).sum().backward()
    assert xs[1].grad.shape == (b, s, kv, d)
    assert xs[2].grad.shape == (b, s, kv, d)
    for x, r in zip(xs, ref):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("kv,groups,block", [(2, 1, 32), (2, 4, 64),
                                             (1, 3, 16)])
def test_function_gradients_match_dense(kv, groups, block):
    """The autograd Function (flash forward + flash backward) against
    autograd through dense causal_attention, on a random cotangent."""
    rng = np.random.default_rng(kv * 10 + groups)
    b, s, d = 2, 64, 16
    q = _normal(rng, b, s, kv * groups, d)
    k, v = _normal(rng, b, s, kv, d), _normal(rng, b, s, kv, d)
    cot = torch.from_numpy(_normal(rng, b, s, kv * groups, d))
    grads = []
    for attention in (
            lambda *x: fa.flash_attention_gqa(*x, block_q=block,
                                              block_k=block),
            causal_attention):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (attention(*xs) * cot).sum().backward()
        grads.append([x.grad for x in xs])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, **GRAD_TOL)


def test_cpu_backward_counts_no_launch():
    fa.reset_launches()
    x = torch.zeros((1, 32, 2, 16), requires_grad=True)
    fa.flash_attention(x, x, x, block_q=16, block_k=16).sum().backward()
    assert sum(fa.launches.values()) == 0
