"""The decode fleet on the card: ``DecodeServer.swap_params`` with card
stores (drift and a store off the card refused, an in-flight request
carried through the swap, the prefix cache cleared), a FleetDecodeServer
whose ``transform`` is the int8 quantizer swapping in a published
float32 store (the stream after the swap token-exact against
``generate`` on that store's int8 codes, K5-K7 launched), and a routed
fleet of two servers token-exact against ``generate``.  A 2-layer f32
model of head_dim 64.

Marked ``cuda``; skips without a card.  On one, run ``python -m pytest
--noconftest tests/test_torch_cuda_fleet.py -m cuda``.  Imports neither
``jax`` nor the JAX package.  Prompts are seeded with numpy."""

import time

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch.config import CoordinatorConfig
from parameter_server_distributed_tpu_torch.fleet import messages as fmsg
from parameter_server_distributed_tpu_torch.fleet.decode import \
    FleetDecodeServer
from parameter_server_distributed_tpu_torch.fleet.router import FleetRouter
from parameter_server_distributed_tpu_torch.models.generation import generate
from parameter_server_distributed_tpu_torch.models.quant import \
    quantize_params
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig)
from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
from parameter_server_distributed_tpu_torch.rpc.service import RpcClient
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator

pytestmark = pytest.mark.cuda

VOCAB = 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def small(card):
    return Transformer(TransformerConfig(
        vocab=VOCAB, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=torch.float32))


def prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, VOCAB, n)] for n in lengths]


def want(model, params, prompt, n, cache_dtype="native"):
    return generate(model, params, [prompt], n,
                    cache_dtype=cache_dtype)[0].tolist()


def stream(address, prompt, max_new):
    client = RpcClient(address, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS)
    try:
        chunks = list(client.call("SubmitStream", fmsg.DecodeRequest(
            tokens=prompt, max_new=max_new, temperature=-1.0),
            timeout=120.0))
    finally:
        client.close()
    assert chunks[-1].done and not chunks[-1].error, chunks[-1].error
    return ([int(c.token) for c in chunks if not c.done],
            {int(c.weight_version) for c in chunks if not c.done})


def test_swap_params_on_the_card(small):
    p0 = small.init_params(0, device="cuda")
    p1 = small.init_params(1, device="cuda")
    srv = DecodeServer(small, p0, slots=2, max_len=256, prompt_cache=4,
                       device="cuda")
    prompt = prompts(0, 64)[0]
    rid = srv.submit(prompt, max_new_tokens=4)
    assert srv.run_to_completion()[rid] == want(small, p0, prompt, 4)
    assert srv._prefix_tree.nodes > 0
    with pytest.raises(ValueError, match="lies on cpu"):
        srv.swap_params({k: v.cpu() for k, v in p1.items()})
    with pytest.raises(ValueError, match="drift"):
        srv.swap_params({**p1, "embed/tok": p1["embed/tok"][:-1]})
    assert srv.params is p0
    rid = srv.submit(prompt, max_new_tokens=6)
    srv.step()
    before = srv.peek(rid)
    srv.swap_params(p1, version=1)
    assert srv._prefix_tree.nodes == 0 and srv.params_version == 1
    got = srv.run_to_completion()[rid]
    assert got[:len(before)] == want(small, p0, prompt, 6)[:len(before)]
    rid = srv.submit(prompt, max_new_tokens=6)
    assert srv.run_to_completion()[rid] == want(small, p1, prompt, 6)


def test_int8_transform_on_a_swap(small):
    """A published f32 store goes through the server's quantizer: the
    stream after the swap equals generate on that store's int8 codes,
    and K5-K7 launch on it."""
    p0 = small.init_params(0, device="cuda")
    p1 = small.init_params(1, device="cuda")
    server = FleetDecodeServer(
        DecodeServer(small, quantize_params(p0), slots=2, max_len=256,
                     cache_dtype="int8", device="cuda"),
        server_id=0, transform=quantize_params, auto_advance=False,
        heartbeat_s=0.05)
    server.start()
    try:
        prompt = prompts(1, 128)[0]
        tokens, versions = stream(server.address, prompt, 8)
        assert tokens == want(small, quantize_params(p0), prompt, 8,
                              "int8") and versions == {0}
        server.publish_version(p1, 1)
        resp = server.Control(fmsg.DecodeControlRequest(
            action=fmsg.CTRL_SWAP, version=1), None)
        assert resp.success, resp.message
        i8.reset_launches()
        tokens, versions = stream(server.address, prompt, 8)
        assert tokens == want(small, quantize_params(p1), prompt, 8,
                              "int8") and versions == {1}
        assert all(n > 0 for n in i8.launches.values()), i8.launches
        assert server.server.stats["weight_swaps"] == 1
    finally:
        server.stop()


def test_routed_fleet_token_exact_on_the_card(small):
    params = small.init_params(0, device="cuda")
    coordinator = Coordinator(CoordinatorConfig(bind_address="127.0.0.1",
                                                port=0))
    caddr = f"127.0.0.1:{coordinator.start()}"
    servers, router = [], None
    try:
        for sid in (0, 1):
            servers.append(FleetDecodeServer(
                DecodeServer(small, params, slots=2, max_len=512,
                             device="cuda"),
                server_id=sid, coordinator=caddr, heartbeat_s=0.05))
            servers[-1].start()
        deadline = time.monotonic() + 30.0
        while sum(f.state == fmsg.MEMBER_ACTIVE
                  for f in coordinator.core.fleet_table()[1]) < 2:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        router = FleetRouter(caddr, poll_s=0.05)
        raddr = f"127.0.0.1:{router.start()}"
        for prompt in prompts(2, 64, 128, 256):
            tokens, _ = stream(raddr, prompt, 8)
            assert tokens == want(small, params, prompt, 8)
        assert sum(s.streams_served for s in servers) == 3
    finally:
        if router is not None:
            router.stop()
        for server in servers:
            server.stop()
        coordinator.stop()
