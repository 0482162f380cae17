"""Flash-attention forward of the PyTorch port (ops/flash_attention.py)
against the JAX package's Pallas kernel, which runs here in interpret mode
as tests/test_pallas_ops.py runs it.  On the CPU the port takes its plain
version, flash_fwd_reference (tests/test_torch_cuda.py holds the Hopper
kernel against that plain version on the card).

Tolerances: o within 2e-5 for MHA and 2e-4 for GQA, the reference's own
(tests/test_pallas_ops.py:23, :240); lse within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.ops.pallas import \
    flash_attention as jax_flash
from parameter_server_distributed_tpu_torch.ops import flash_attention as fa

CASES = [(s, block, kv, groups)
         for s, block in [(64, 32), (128, 128), (96, 32)]
         for kv in (1, 2) for groups in (1, 2, 4)]


def _inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


@pytest.mark.parametrize("s,block,kv,groups", CASES)
def test_flash_fwd_matches_pallas(s, block, kv, groups):
    b, d = 2, 16
    h = kv * groups
    q, k, v = _inputs(s + 7 * kv + groups, b, s, h, kv, d)
    tol = 2e-5 if groups == 1 else 2e-4
    # the folded kernel layout: q [B*KV, G*S, D] against k/v [B*KV, S, D]
    qf = q.reshape(b, s, kv, groups, d).transpose(0, 2, 3, 1, 4).reshape(
        b * kv, groups * s, d)
    kf, vf = (x.transpose(0, 2, 1, 3).reshape(b * kv, s, d) for x in (k, v))
    o_ref, lse_ref = jax_flash._flash_fwd(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), block, block,
        True, s // block)
    o, lse = fa._flash_fwd(torch.from_numpy(qf), torch.from_numpy(kf),
                           torch.from_numpy(vf), block, block, s // block)
    assert o.shape == (b * kv, groups * s, d) and o.dtype == torch.float32
    assert lse.shape == (b * kv, 1, groups * s)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-5,
                               atol=1e-5)
    # the [B, S, H, D] entry point over the same fold
    out = fa.flash_attention_gqa(*map(torch.from_numpy, (q, k, v)),
                                 block_q=block, block_k=block)
    ref = jax_flash.flash_attention_gqa(*map(jnp.asarray, (q, k, v)),
                                        block_q=block, block_k=block)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_flash_attention_mha_matches_pallas():
    q, k, v = _inputs(3, 2, 64, 2, 2, 16)
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             block_q=32, block_k=32)
    ref = jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    block_q=32, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_flash_rejects_indivisible_seq():
    q = torch.zeros((1, 100, 2, 8))
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q, q, q, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1], block_q=64,
                               block_k=64)


def test_cpu_path_counts_no_launch():
    fa.reset_launches()
    q, k, v = _inputs(1, 1, 32, 4, 2, 16)
    fa.flash_attention_gqa(*map(torch.from_numpy, (q, k, v)), block_q=16,
                           block_k=16)
    assert sum(fa.launches.values()) == 0
