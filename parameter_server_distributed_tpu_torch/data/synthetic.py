"""Synthetic data: the port's copy of ``synthetic_tokens``,
``ClassClusterDataset``, ``xy_batch_stream``, ``synthetic_mnist``,
``synthetic_cifar10`` and ``synthetic_image_batches`` from
parameter_server_distributed_tpu/data/synthetic.py.  The numbers come
from the same numpy streams as the JAX package's, so one seed gives both
packages the same batches.  Token batches are int32 tensors on the card
unless the caller asks for the CPU; the classification datasets and the
image stream yield numpy ``(x, y)`` batches, which the registry moves to
the device (models/registry.py)."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


def synthetic_tokens(batch_size: int, seq_len: int, vocab: int = 32000,
                     seed: int = 0, device=None) -> Iterator[torch.Tensor]:
    """Endless [batch, seq_len] int32 token batches for LM training, on
    ``device`` (default: the card; raises here when there is none)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def stream():
        while True:
            batch = rng.integers(0, vocab, size=(batch_size, seq_len),
                                 dtype=np.int32)
            yield torch.from_numpy(batch).to(dev)

    return stream()


def xy_batch_stream(x: np.ndarray, y: np.ndarray, batch_size: int,
                    seed: int = 0, drop_remainder: bool = True
                    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled ``(x, y)`` batches, reshuffled each epoch from the
    ``(seed, epoch)`` sequence."""
    epoch = 0
    while True:
        rng = np.random.default_rng([seed, epoch])
        order = rng.permutation(len(y))
        end = (len(order) // batch_size) * batch_size if drop_remainder \
            else len(order)
        for start in range(0, end, batch_size):
            idx = order[start:start + batch_size]
            yield x[idx], y[idx]
        epoch += 1


class ClassClusterDataset:
    """Gaussian class-cluster classification data (an MNIST stand-in:
    training measurably lowers the loss)."""

    def __init__(self, num_features: int, num_classes: int,
                 num_examples: int = 4096, seed: int = 0, scale: float = 2.0):
        rng = np.random.default_rng(seed)
        self.num_features = num_features
        self.num_classes = num_classes
        self.centers = rng.standard_normal(
            (num_classes, num_features)).astype(np.float32)
        labels = rng.integers(0, num_classes, size=num_examples)
        noise = rng.standard_normal(
            (num_examples, num_features)).astype(np.float32)
        self.x = (scale * self.centers[labels] + noise).astype(np.float32)
        self.y = labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.y)

    def batch_stream(self, batch_size: int, seed: int = 0
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Endless stream of batches (reshuffled each epoch)."""
        return xy_batch_stream(self.x, self.y, batch_size, seed=seed)


def synthetic_mnist(num_examples: int = 4096,
                    seed: int = 0) -> ClassClusterDataset:
    return ClassClusterDataset(784, 10, num_examples, seed)


def synthetic_cifar10(num_examples: int = 4096,
                      seed: int = 0) -> ClassClusterDataset:
    """Flat 32*32*3 features; image models reshape to NHWC."""
    return ClassClusterDataset(32 * 32 * 3, 10, num_examples, seed)


def synthetic_image_batches(batch_size: int, image_size: int = 32,
                            channels: int = 3, num_classes: int = 10,
                            seed: int = 0, dataset_seed: int = 0
                            ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless NHWC float32 image batches and int32 labels for the image
    models.  ``seed`` varies the sampling order only; the dataset (its
    cluster centers, the task) comes from ``dataset_seed``, so
    differently seeded streams (one a worker) draw from one task.  The
    dataset holds 64 batches below a batch of 64, else 4096 examples."""
    ds = ClassClusterDataset(
        image_size * image_size * channels, num_classes,
        num_examples=64 * batch_size if batch_size < 64 else 4096,
        seed=dataset_seed)
    for x, y in ds.batch_stream(batch_size, seed=seed):
        yield x.reshape(-1, image_size, image_size, channels), y
