"""The PyTorch port's CUDA kernels on the card.  Every test here is marked
``cuda`` and skips without a card (a CUDA kernel has no CPU mode); on one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file
imports neither ``jax`` nor the JAX package, so it runs where only the
port is installed.

TF32 is off (torch.backends.cuda.matmul.allow_tf32 = False), so float32
products are full float32.  Tolerances: float32 o within 2e-4 (the GQA
tolerance of tests/test_pallas_ops.py:240); bf16 o within 2e-2 of the
float32 plain output from the same bf16 inputs, since the kernel rounds o
once to bf16; lse within 1e-4 relative.  Backward: float32 gradients
rtol 5e-4, atol 1e-5 (tests/test_pallas_ops.py:195); bf16 gradients
rtol 1e-2, atol 1e-3 against the float32 plain version on the same bf16
inputs (the kernels round each output once to bf16, 2^-9 relative).
Fused updates rtol 1e-5, atol 1e-7 (tests/test_pallas_ops.py:50-88); the
card's training step against the CPU's, gradients rtol 1e-3, atol 1e-5
(the same f32 arithmetic, summed in another order by other GEMMs)."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import PallasOptimizer
from parameter_server_distributed_tpu_torch.device import same_device
from parameter_server_distributed_tpu_torch.models.generation import generate
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig, causal_attention, flash_attention_auto)
from parameter_server_distributed_tpu_torch.ops import flash_attention as fa
from parameter_server_distributed_tpu_torch.ops import fused_update as fu
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer


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
    (torch.float32, 2, 1, 128, 96), (torch.float32, 1, 3, 64, 200),
    # the bf16 tensor-core kernel: the llama_350m training shape (B=8
    # folded into kv), D=128 with G=4, and ragged segments (S=200) whose
    # last q tile runs into the next segment's rows
    (torch.bfloat16, 32, 4, 64, 1024), (torch.bfloat16, 2, 4, 128, 512),
    (torch.bfloat16, 2, 3, 64, 200), (torch.bfloat16, 2, 3, 128, 200)])
def test_kernel_matches_plain(card, dtype, kv, groups, d, s):
    gen = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((kv, groups * s, d), generator=gen, device=card,
                    dtype=dtype)
    k, v = (torch.randn((kv, s, d), generator=gen, device=card, dtype=dtype)
            for _ in range(2))
    block = next(b for b in (128, 64, 32, 8) if s % b == 0)
    before = fa.launches["flash_fwd"]
    o, lse = fa._flash_fwd(q, k, v, block, block, s // block)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == (kv, 1, groups * s)
    o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(), v.float(),
                                            s)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref, rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_grad_and_bad_shapes(card):
    """Gradients flow through the kernels (the autograd Function's
    backward launches dQ and dK/dV once each and matches dense attention
    at the reference's f32 gradient tolerance); head_dim, dtype and
    alignment outside the kernels' contract are refused."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((1, 128, 4, 64), generator=gen, device=card)
    k, v = (torch.randn((1, 128, 2, 64), generator=gen, device=card)
            for _ in range(2))
    grads = []
    before = dict(fa.launches)
    for attention in (fa.flash_attention_gqa, causal_attention):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        (attention(*xs) ** 2).sum().backward()
        grads.append([x.grad for x in xs])
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-5)
    x = torch.zeros((1, 128, 32), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        fa._flash_fwd(x, x, x, 128, 128)
    h = torch.zeros((1, 128, 64), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa._flash_fwd(h, h, h, 128, 128)
    # a contiguous view 2 bytes into its storage: the tile copies need
    # 16-byte aligned operands
    odd = torch.zeros(128 * 64 + 1, device=card,
                      dtype=torch.bfloat16)[1:].view(1, 128, 64)
    before = fa.launches["flash_fwd"]
    with pytest.raises(ValueError, match="aligned"):
        fa._flash_fwd(odd, odd, odd, 128, 128)
    assert fa.launches["flash_fwd"] == before


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
        assert fa.launches["flash_fwd"] == cfg.n_layers
        dense = Transformer(cfg, attention_fn=causal_attention).apply(
            params, tokens)
    torch.testing.assert_close(flash, dense, rtol=1e-4, atol=1e-4)
    srv = DecodeServer(model, params, slots=2, max_len=512, device=card)
    prompts = [tokens[0, :128].tolist(), tokens[1].tolist()]
    rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    results = srv.run_to_completion()
    for rid, p in zip(rids, prompts):
        assert results[rid] == generate(model, params, [p], 6)[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv,groups,d,s", [
    (torch.bfloat16, 4, 4, 64, 1024), (torch.float32, 4, 4, 64, 1024),
    (torch.bfloat16, 2, 3, 64, 200), (torch.float32, 2, 2, 128, 96),
    (torch.bfloat16, 2, 2, 128, 200), (torch.float32, 1, 3, 64, 200),
    (torch.bfloat16, 8, 1, 128, 96), (torch.bfloat16, 2, 4, 128, 512),
    (torch.bfloat16, 2, 3, 128, 200), (torch.bfloat16, 32, 4, 64, 1024)])
def test_backward_kernels_match_plain(card, dtype, kv, groups, d, s):
    """dQ and dK/dV against flash_bwd_reference on the same inputs, with G
    segments whose length need not be a multiple of the 64-row tile."""
    gen = torch.Generator(device=card).manual_seed(s + d + groups)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)

    q, g = randn(kv, groups * s, d), randn(kv, groups * s, d)
    k, v = randn(kv, s, d), randn(kv, s, d)
    o, lse = fa.flash_fwd_reference(q.float(), k.float(), v.float(), s)
    o = o.to(dtype)
    block = next(b for b in (128, 64, 32, 8) if s % b == 0)
    before = dict(fa.launches)
    got = fa._flash_bwd(q, k, v, o, lse, g, block, block, s // block)
    torch.cuda.synchronize()
    assert fa.launches["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert fa.launches["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    ref = fa.flash_bwd_reference(*(x.float() for x in (q, k, v, o)), lse,
                                 g.float(), s)
    tol = (dict(rtol=5e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-3))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b, **tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1000003, 0),
                                      (4099, 1)])
def test_fused_updates_match_plain(card, rule, n, offset):
    """Each update kernel against its plain version on the same inputs:
    the float4 body with a ragged tail, and (offset 1) operands that are
    not 16-byte aligned, which take the scalar path."""
    gen = torch.Generator(device=card).manual_seed(n + offset)

    def randn():
        return torch.randn(n + offset, generator=gen, device=card)[offset:]

    p, g, s0, s1 = randn(), randn(), randn(), randn().abs()
    slots = {"sgd": (), "momentum": (s0,), "adam": (s0, s1)}[rule]
    ref_slots = tuple(s.clone() for s in slots)
    before = fu.launches[f"fused_{rule}"]
    if rule == "sgd":
        out = fu.fused_sgd({"w": p}, {"w": g}, 0.3)["w"]
        ref = fu.sgd_reference(p, g, 0.3)
    elif rule == "momentum":
        out = fu.fused_momentum({"w": p}, {"w": g}, {"w": s0}, 0.1, 0.9)[0]["w"]
        ref = fu.momentum_reference(p, g, *ref_slots, 0.1, 0.9)
    else:
        out = fu.fused_adam({"w": p}, {"w": g}, {"w": s0}, {"w": s1}, 5,
                            lr=0.01)[0]["w"]
        ref = fu.adam_reference(p, g, *ref_slots, 0.01, 0.9, 0.999, 1e-8,
                                *fu.bias_corrections(5, 0.9, 0.999))
    torch.cuda.synchronize()
    assert fu.launches[f"fused_{rule}"] == before + 1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-7)
    for got, want in zip(slots, ref_slots):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_multi_tensor_update_matches_plain(card, rule):
    """One call over 40 tensors of mixed sizes, some of them (or their
    slots) views 4 bytes into their storage, and one param without a
    gradient: one launch per planned table, SGD and momentum bit-exact
    against the plain versions, Adam within rtol 1e-5, atol 1e-7; params
    come back as fresh tensors, the one without a gradient untouched."""
    gen = torch.Generator(device=card).manual_seed(11)

    def randn(shape, offset=0):
        n = int(np.prod(shape))
        return torch.randn(n + offset, generator=gen,
                           device=card)[offset:].view(shape)

    shapes = [(1,), (3,), (4099,), (1024, 1024)] * 10
    params, grads, s0, s1 = {}, {}, {}, {}
    for i, shape in enumerate(shapes):
        name = f"t{i}"
        params[name] = randn(shape, 1 if i % 7 == 2 else 0)
        grads[name] = randn(shape, 1 if i % 9 == 3 else 0)
        s0[name] = randn(shape, 1 if i % 11 == 4 else 0)
        s1[name] = randn(shape).abs()
    del grads["t5"]
    names = [k for k in params if k in grads]
    slots = {"sgd": (), "momentum": (s0,), "adam": (s0, s1)}[rule]
    ref_slots = [{k: s[k].clone() for k in names} for s in slots]
    tables = fu.plan([params[k].numel() for k in names], [True] * len(names))
    before = fu.launches[f"fused_{rule}"]
    if rule == "sgd":
        out = fu.fused_sgd(params, grads, 0.3)
        ref = {k: fu.sgd_reference(params[k], grads[k], 0.3) for k in names}
    elif rule == "momentum":
        out = fu.fused_momentum(params, grads, s0, 0.1, 0.9)[0]
        ref = {k: fu.momentum_reference(params[k], grads[k], ref_slots[0][k],
                                        0.1, 0.9) for k in names}
    else:
        out = fu.fused_adam(params, grads, s0, s1, 5, lr=0.01)[0]
        bc = fu.bias_corrections(5, 0.9, 0.999)
        ref = {k: fu.adam_reference(params[k], grads[k], ref_slots[0][k],
                                    ref_slots[1][k], 0.01, 0.9, 0.999, 1e-8,
                                    *bc) for k in names}
    torch.cuda.synchronize()
    assert fu.launches[f"fused_{rule}"] == before + len(tables)
    assert out["t5"] is params["t5"]
    pairs = [(out[k], ref[k]) for k in names] + [
        (s[k], r[k]) for s, r in zip(slots, ref_slots) for k in names]
    for k in names:
        assert out[k].shape == params[k].shape
        assert out[k].data_ptr() != params[k].data_ptr()
    for got, want in pairs:
        if rule == "adam":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
        else:
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(card):
    """A 2-layer f32 model (head_dim 64, remat, chunked loss) trains on
    the card through the kernels: the launch counts are the expected ones,
    the gradients match the CPU's plain step, and two Adam rounds lower
    the loss."""
    cfg = TransformerConfig(vocab=512, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=256,
                            mlp_act="swiglu", dtype=torch.float32,
                            remat=True, loss_chunk=128)
    model = Transformer(cfg, attention_fn=flash_attention_auto)
    cpu_trainer = Trainer(model, device="cpu")
    store = cpu_trainer.init_params(0)
    batch = np.random.default_rng(1).integers(0, 512, (2, 256),
                                              dtype=np.int32)
    ref_g, ref_loss = cpu_trainer.compute_gradients(store, batch)
    trainer = Trainer(model, device=card)
    opt = PallasOptimizer("adam", 1e-3, device=card)
    fa.reset_launches()
    fu.reset_launches()
    grads, loss = trainer.compute_gradients(store, batch)
    assert fa.launches == {"flash_fwd": 2 * cfg.n_layers,
                           "flash_bwd_dq": cfg.n_layers,
                           "flash_bwd_dkv": cfg.n_layers}
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
    for name, ref in ref_g.items():
        np.testing.assert_allclose(grads[name], ref, rtol=1e-3, atol=1e-5,
                                   err_msg=name)
    params, losses = store, [loss]
    for _ in range(2):
        params = opt.apply(params, grads)
        # card-resident params: the next step packs them on the card
        assert all(same_device(p.device, trainer.device)
                   for p in params.values())
        grads, loss = trainer.compute_gradients(params, batch)
        losses.append(loss)
    # one launch per planned table a step (one for this store)
    tables = fu.plan([np.size(x) for x in store.values()], [True] * len(store))
    assert fu.launches["fused_adam"] == 2 * len(tables)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _ps_store(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 96), "b": (96,), "emb": (300, 64)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(4)]
    return init, grads


@pytest.mark.cuda
@pytest.mark.parametrize("staleness", [0, 2])
def test_ps_core_on_card_matches_cpu(card, staleness):
    """The PS core over the fused Adam update on the card, synchronous
    (2 workers) and async (staleness 2, one worker: the apply's CUDA
    event gates the serve and the next apply), against the same core on
    the CPU (the update's plain version), rtol 1e-5, atol 1e-7; the store
    it serves lies on the card."""
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        ParameterServerCore

    init, grads = _ps_store(0)
    workers = 1 if staleness else 2
    stores = {}
    for where in ("cpu", card):
        ps = ParameterServerCore(
            total_workers=workers, staleness_bound=staleness,
            optimizer=PallasOptimizer("adam", 1e-2, device=where))
        ps.initialize_parameters(init)
        for it in range(1, 3):
            for wid in range(workers):
                result = ps.receive_gradients(wid, it,
                                              grads[2 * (it - 1) + wid])
                assert result.success
            assert result.aggregation_complete
        torch.cuda.synchronize()
        served = ps.serve_parameters()[1]
        assert all(same_device(v.device, torch.device(where))
                   for v in served.values())
        stores[str(where)] = served
    for n in init:
        torch.testing.assert_close(stores["cuda"][n].cpu(), stores["cpu"][n],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam", "adamw",
                                  "adamw_bf16"])
def test_device_optimizer_on_card_matches_cpu(card, rule):
    """DeviceOptimizer's torch ops on the card against the CPU's, two
    applies at rtol 1e-5, atol 1e-7 (adamw_bf16: its first apply; the
    second depends on the generator's bits, which differ by device)."""
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import DeviceOptimizer

    init, grads = _ps_store(1)
    out = {}
    for where in ("cpu", card):
        opt = DeviceOptimizer(rule, 1e-2, device=where)
        p = init
        for g in grads[:1 if rule == "adamw_bf16" else 2]:
            p = opt.apply(p, g)
        out[str(where)] = p
        assert opt.state_dict()["count"] >= 1
    for n in init:
        torch.testing.assert_close(out["cuda"][n].cpu(), out["cpu"][n],
                                   rtol=1e-5, atol=1e-7)
