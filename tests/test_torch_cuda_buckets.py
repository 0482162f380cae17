"""The port's bucketed gradient download on the card
(worker/trainer.py ``GradientBuckets``: a pinned host buffer, a side copy
stream, one event a bucket), and the buckets through the same-host rings
(rpc/shm_transport.py).  Marked ``cuda``; skips without a card.  On one,
run ``python -m pytest --noconftest tests/test_torch_cuda_buckets.py -m
cuda``.  Imports neither ``jax`` nor the JAX package.  Tolerance: rtol
1e-5, atol 1e-7 against ``compute_gradients`` of the same step (the
card's GEMMs may sum in another order from run to run); the rings are
held bit for bit."""

import threading
import time
import uuid

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig)
from parameter_server_distributed_tpu_torch.rpc import data_plane
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc import shm_transport as shm
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the copy stream has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_gradient_buckets_on_card(card):
    """The bucketed download (pinned buffer, side copy stream, one event
    a bucket) gives compute_gradients' values and loss, fetches lazily,
    and refuses buckets of a step whose host buffer a newer step reused."""
    cfg = TransformerConfig(vocab=256, d_model=64, n_heads=2, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
    trainer = Trainer(Transformer(cfg), device=card)
    params = trainer.init_params(0)
    batch = np.random.default_rng(0).integers(0, 256, (2, 64),
                                              dtype=np.int32)
    grads, loss = trainer.compute_gradients(params, batch)
    fetched = []
    buckets = trainer.compute_gradient_buckets(
        params, batch, bucket_bytes=16384,
        on_fetch=lambda i, n: fetched.append(i))
    assert buckets.num_buckets > 2 and fetched == []
    # the card's GEMMs may sum in another order from run to run
    assert buckets.loss == pytest.approx(loss, rel=1e-6)
    got = dict(buckets)
    assert fetched == list(range(buckets.num_buckets))
    for name in grads:
        np.testing.assert_allclose(got[name], grads[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert buckets.dtoh_ms > 0
    dict(buckets)
    assert fetched == list(range(buckets.num_buckets))
    trainer.compute_gradient_buckets(params, batch)
    with pytest.raises(RuntimeError, match="older step"):
        dict(buckets)


def _small(card):
    cfg = TransformerConfig(vocab=256, d_model=64, n_heads=2, n_layers=2,
                            d_ff=128, max_seq=64, dtype=torch.float32)
    trainer = Trainer(Transformer(cfg), device=card)
    batch = np.random.default_rng(0).integers(0, 256, (2, 64),
                                              dtype=np.int32)
    return trainer, trainer.init_params(0), batch


@pytest.mark.cuda
def test_gradient_buckets_through_the_rings(card, tmp_path, monkeypatch):
    """Each bucket, straight from the pinned buffer (``psdt_copy``'s raw
    source, held by the ring for the copy), through a ring pair of 4 KB:
    the same bytes out.  Then the same buckets (their second pass replays
    the host copies) in one fused round to a PS on the card at its
    default optimizer, over the rings and over gRPC: the same fresh
    params, bit for bit."""
    if native.copy_fn() is None:
        pytest.skip("the native library cannot be built here (no g++)")
    trainer, params, batch = _small(card)
    buckets = trainer.compute_gradient_buckets(params, batch,
                                               bucket_bytes=16384)
    name = f"psdt-test-{uuid.uuid4().hex[:12]}"
    owner = shm._create_segment(name, shm._HEADER + 4096)
    peer = shm._attach_segment(name)
    prod, cons = shm.ShmRing(owner, 4096), shm.ShmRing(peer, 4096)
    try:
        assert prod._copy is not None
        out = []
        reader = threading.Thread(target=lambda: out.extend(
            cons.read_frame(time.monotonic() + 60.0)
            for _ in range(buckets.num_buckets)), daemon=True)
        reader.start()
        sent = []
        for i in range(buckets.num_buckets):
            view = buckets._fetch(i)          # a view of the pinned buffer
            prod.write_frame(view, time.monotonic() + 60.0)
            sent.append(view.tobytes())
        reader.join(60.0)
        assert not reader.is_alive() and out == sent
    finally:
        for ring in (prod, cons):
            ring.invalidate()
        peer.close()
        owner.close()
        owner.unlink()

    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(1 << 16))
    fresh = {}
    for transport in ("shm", "grpc"):
        monkeypatch.setenv("PSDT_SHM", "1" if transport == "shm" else "0")
        ps = ParameterServer(port_config.ParameterServerConfig(
            bind_address="127.0.0.1", port=0, total_workers=1,
            learning_rate=0.1, checkpoint_interval=1000,
            checkpoint_dir=str(tmp_path / transport)))
        client = data_plane.PSClient(f"127.0.0.1:{ps.start()}")
        try:
            ps.core.initialize_parameters(params)
            push, update = client.push_pull(
                0, 0, lambda: (m.Tensor.from_array(n, g)
                               for n, g in buckets),
                timeout=60.0)
            assert push.success and update is not None
            assert client.shm_active == (transport == "shm")
            fresh[transport] = {t.name: t.to_array()
                                for t in update.parameters}
        finally:
            client.close()
            ps.stop()
    assert sorted(fresh["shm"]) == sorted(params)
    for n, value in fresh["shm"].items():
        assert value.tobytes() == fresh["grpc"][n].tobytes(), n
