"""The PyTorch port's CUDA kernels on the card.  Every test here is marked
``cuda`` and skips without a card (a CUDA kernel has no CPU mode); on one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file
imports neither ``jax`` nor the JAX package, so it runs where only the
port is installed.

TF32 is off (torch.backends.cuda.matmul.allow_tf32 = False), so float32
products are full float32.  Tolerances: float32 o within 2e-4 (the GQA
tolerance of tests/test_pallas_ops.py:240); bf16 o within 2e-2 of the
float32 plain output from the same bf16 inputs, since the kernel rounds o
once to bf16; lse within 1e-4 relative."""

import pytest
import torch

from parameter_server_distributed_tpu_torch.models.generation import generate
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, causal_attention, flash_attention_auto)
from parameter_server_distributed_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv,groups,d,s", [
    (torch.bfloat16, 4, 4, 64, 512), (torch.bfloat16, 16, 1, 64, 256),
    (torch.bfloat16, 4, 2, 128, 256), (torch.float32, 4, 4, 64, 256),
    (torch.float32, 2, 1, 128, 96), (torch.float32, 1, 3, 64, 200)])
def test_kernel_matches_plain(card, dtype, kv, groups, d, s):
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((kv, groups * s, d), generator=gen, device=card,
                    dtype=dtype)
    k, v = (torch.randn((kv, s, d), generator=gen, device=card, dtype=dtype)
            for _ in range(2))
    block = next(b for b in (128, 64, 32, 8) if s % b == 0)
    before = fa.launches
    o, lse = fa._flash_fwd(q, k, v, block, block, s // block)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == (kv, 1, groups * s)
    o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(),
                                            s)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref, rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_grad_and_bad_shapes(card):
    q = torch.zeros((1, 128, 64), device=card, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fa._flash_fwd(q, q.detach(), q.detach(), 128, 128)
    x = torch.zeros((1, 128, 32), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa._flash_fwd(x, x, x, 128, 128)
    h = torch.zeros((1, 128, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._flash_fwd(h, h, h, 128, 128)


@pytest.mark.cuda
def test_model_and_server_through_kernel(card):
    """A small float32 model with head_dim 64: flash logits match dense
    attention, and the server's streams (flash prefill) are token-exact
    against generate."""
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=512,
                            mlp_act="swiglu", dtype=torch.float32)
    model = Transformer(cfg, attention_fn=flash_attention_auto)
    params = model.init_params(0, device=card)
    tokens = torch.randint(0, 512, (2, 256), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    with torch.inference_mode():
        fa.reset_launches()
        flash = model.apply(params, tokens)
        assert fa.launches == cfg.n_layers
        dense = Transformer(cfg, attention_fn=causal_attention).apply(
            params, tokens)
    torch.testing.assert_close(flash, dense, rtol=1e-4, atol=1e-4)
    srv = DecodeServer(model, params, slots=2, max_len=512, device=card)
    prompts = [tokens[0, :128].tolist(), tokens[1].tolist()]
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    results = srv.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert results[rid] == generate(model, params, [p], 6)[0].tolist()
