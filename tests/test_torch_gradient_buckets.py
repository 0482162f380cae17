"""The port's ``GradientBuckets`` (worker/trainer.py) on the CPU: its
bucket plan is the JAX package's over the same layout and budget, its
values and loss are ``compute_gradients``' bit for bit, and ``on_fetch``
fires lazily, once per bucket, never again on a second iteration.

torch's CPU backward of the embedding gather adds rows in a
thread-dependent order, so the bit-for-bit comparison runs on one intra-op
thread; the tests restore the thread count they found."""

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu.worker.trainer import \
    GradientBuckets as RefBuckets
from parameter_server_distributed_tpu_torch.models.registry import \
    get_model_and_batches
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def step():
    model, batches = get_model_and_batches("small_lm", 2, device="cpu")
    trainer = Trainer(model, device="cpu")
    return trainer, trainer.init_params(0), next(batches)


@pytest.mark.parametrize("budget", [0, 1, 4096, 65536, 300_000, 1 << 30])
def test_plan_matches_reference(step, budget):
    trainer, params, batch = step
    layout = trainer._layout
    ref = RefBuckets(layout, np.zeros(1 + trainer._packed_size, np.float32),
                     budget)
    ref_plan = [(a, b, [e[0] for e in entries])
                for a, b, entries in ref._plan]
    got = trainer.compute_gradient_buckets(params, batch,
                                           bucket_bytes=budget)
    assert got.plan == ref_plan
    assert got.num_buckets == ref.num_buckets


@pytest.mark.parametrize("budget", [4096, 65536, 1 << 30])
def test_values_and_loss_bit_equal(one_thread, step, budget):
    trainer, params, batch = step
    grads, loss = trainer.compute_gradients(params, batch)
    buckets = trainer.compute_gradient_buckets(params, batch,
                                               bucket_bytes=budget)
    assert buckets.loss == loss
    got = dict(buckets)
    assert list(got) == list(grads)
    for name in grads:
        assert got[name].shape == grads[name].shape
        np.testing.assert_array_equal(got[name], grads[name], err_msg=name)


def test_on_fetch_lazy_once_per_bucket(step):
    trainer, params, batch = step
    fetched = []
    buckets = trainer.compute_gradient_buckets(
        params, batch, bucket_bytes=65536,
        on_fetch=lambda i, n: fetched.append((i, n)))
    n = buckets.num_buckets
    assert n > 3 and fetched == []
    it = iter(buckets)
    next(it)                       # the first tensor: bucket 0 only
    assert fetched == [(0, n)]
    _ = buckets.loss               # bucket 0 again: cached
    assert fetched == [(0, n)]
    first = dict(buckets)          # the rest, in order
    assert fetched == [(i, n) for i in range(n)]
    second = dict(buckets)         # replayed from the cache
    assert fetched == [(i, n) for i in range(n)]
    assert all(second[k] is not None and np.array_equal(second[k], first[k])
               for k in first)
