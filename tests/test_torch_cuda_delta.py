"""Delta serving and live weight publication on the card: the PS's flat
close on the card (``PSDT_DEVICE_APPLY=1 PSDT_ARENA=1``, the sharded
Adam kernels) feeding the delta chain over three closes, its pairs the
ones a chain fed owned host copies of the same stores builds, a receiver
following them holding each close's full bf16 decode; and a followed
version swapped into a bf16 and an int8 server on the card through
``StoreUploader`` (one pinned copy), the uploaded weights and their int8
codes byte-equal to ``params_from_numpy``'s and the streams after the
swap token-exact against servers booted on that store (K5-K7 launched
in the int8 one).  A 2-layer model of head_dim 64.

Marked ``cuda``; skips without a card.  On one, run ``python -m pytest
--noconftest tests/test_torch_cuda_delta.py -m cuda``.  Imports neither
``jax`` nor the JAX package."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import ShardedDeviceOptimizer
from parameter_server_distributed_tpu_torch.core import arena
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import (to_host,
                                                                to_wire)
from parameter_server_distributed_tpu_torch.delta import chain as tchain
from parameter_server_distributed_tpu_torch.delta import messages as dmsg
from parameter_server_distributed_tpu_torch.delta.client import (
    DeltaPullState, apply_frames)
from parameter_server_distributed_tpu_torch.delta.subscriber import \
    WeightFollower
from parameter_server_distributed_tpu_torch.models.convert import (
    StoreUploader, params_from_numpy)
from parameter_server_distributed_tpu_torch.models.quant import (
    QTensor, quantize_params)
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig)
from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.data_plane import \
    decode_gradients
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer

pytestmark = pytest.mark.cuda

VOCAB = 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def config(dtype):
    return TransformerConfig(
        vocab=VOCAB, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=dtype)


def host_store(seed=0) -> dict:
    model = Transformer(config(torch.float32))
    return {k: v.numpy() for k, v in model.init_params(
        seed, device="cpu").items()}


def test_flat_close_on_the_card_feeds_the_chain(card, monkeypatch):
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", "1")
    rng = np.random.default_rng(3)
    store = host_store()
    core = ParameterServerCore(
        total_workers=1, stripes=4,
        optimizer=ShardedDeviceOptimizer("adam", 1e-3, device=card))
    chain = tchain.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=4)
    copies = tchain.DeltaChain(depth=4, wire_dtype=m.WIRE_BF16, stripes=4)
    core.initialize_parameters(store)
    core.set_delta_sink(chain)
    copies.note_apply(to_host(core.get_parameters()), core.params_version)
    decodes = []
    for it in (1, 2, 3):
        grads = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
                 for k, v in store.items()}
        sink = core.begin_push(0, it)
        sink.fold(decode_gradients(to_wire(grads, m.WIRE_RAW_F32),
                                   core.device_fold()))
        assert sink.commit().aggregation_complete
        published = core._params
        assert isinstance(published, arena.ArenaStore)
        copies.note_apply({k: np.array(v) for k, v in published.items()},
                          core.params_version)
        decodes.append({k: m.Tensor.from_array(
            k, np.asarray(v), wire_dtype=m.WIRE_BF16).to_array()
            for k, v in published.items()})
    top = core.params_version
    pairs = chain.pairs_between(top - 3, top)
    want = copies.pairs_between(top - 3, top)
    assert [(p.entries, p.crc, p.changed) for p in pairs] == [
        (p.entries, p.crc, p.changed) for p in want]
    state = DeltaPullState()
    state.note_full({k: m.Tensor.from_array(k, v, wire_dtype=m.WIRE_BF16)
                     .to_array() for k, v in store.items()}, top - 3)
    for pair, full in zip(pairs, decodes):
        frames = [dmsg.DeltaFrame(
            from_version=pair.from_version, to_version=pair.to_version,
            delta=True, wire_dtype=m.WIRE_BF16, crc=pair.crc, last=True,
            entries=[dmsg.DeltaEntry(name=n, indices=i, values=v, dense=d)
                     for n, i, v, d in pair.entries])]
        result = apply_frames(iter(frames), state)
        for name in full:
            assert result.store[name].tobytes() == full[name].tobytes()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_followed_swap_into_a_card_server(card, tmp_path, quant):
    cfg = config(torch.bfloat16)
    model = Transformer(cfg)
    ps = ParameterServer(port_config.ParameterServerConfig(
        bind_address="127.0.0.1", port=0, total_workers=1,
        checkpoint_interval=10**6, optimizer="sgd", learning_rate=0.05,
        checkpoint_dir=str(tmp_path), device="cpu"))
    address = f"127.0.0.1:{ps.start()}"
    follower = None
    try:
        store = host_store(1)
        ps.core.initialize_parameters(store)
        follower = WeightFollower(address, subscriber_id=3).start()
        rng = np.random.default_rng(5)
        ps.core.receive_gradients(0, 1, {
            k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
            for k, v in store.items()})
        version = ps.core.serve_version()
        while True:
            followed, got = follower.wait_for_update(timeout=30.0)
            if got == version:
                break
    finally:
        if follower is not None:
            follower.stop()
        ps.stop()
    uploaded = StoreUploader(cfg, card)(followed)
    reference = params_from_numpy(followed, cfg, device=card)
    assert sorted(uploaded) == sorted(reference)
    for name in reference:
        assert uploaded[name].dtype == torch.bfloat16
        assert torch.equal(uploaded[name].view(torch.int16),
                           reference[name].view(torch.int16)), name
    if quant:
        uploaded, reference = (quantize_params(uploaded),
                               quantize_params(reference))
        for name, value in reference.items():
            if isinstance(value, QTensor):
                assert torch.equal(uploaded[name].q, value.q)
                assert torch.equal(uploaded[name].scale, value.scale)
    kw = dict(slots=2, max_len=256, device=card,
              cache_dtype="int8" if quant else "native")
    boot = model.init_params(9, device=card)
    srv = DecodeServer(model, quantize_params(boot) if quant else boot, **kw)
    srv.swap_params(uploaded, version=version)
    want = DecodeServer(model, reference, **kw)
    prompts = [[int(t) for t in np.random.default_rng(s).integers(
        0, VOCAB, n)] for s, n in ((0, 37), (1, 90))]
    i8.reset_launches()
    got_ids = [srv.submit(p, max_new_tokens=12) for p in prompts]
    got = srv.run_to_completion()
    launched = dict(i8.launches)
    want_ids = [want.submit(p, max_new_tokens=12) for p in prompts]
    expect = want.run_to_completion()
    assert [got[r] for r in got_ids] == [expect[r] for r in want_ids]
    assert srv.params_version == version
    if quant:
        assert min(launched.values()) > 0, launched
