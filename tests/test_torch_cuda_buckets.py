"""The port's bucketed gradient download on the card
(worker/trainer.py ``GradientBuckets``: a pinned host buffer, a side copy
stream, one event a bucket).  Marked ``cuda``; skips without a card.  On
one, run ``python -m pytest --noconftest tests/test_torch_cuda_buckets.py
-m cuda``.  Imports neither ``jax`` nor the JAX package.  Tolerance:
rtol 1e-5, atol 1e-7 against ``compute_gradients`` of the same step (the
card's GEMMs may sum in another order from run to run)."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu_torch.models.transformer import (
    Transformer, TransformerConfig)
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
