"""Synthetic token data: the port's copy of ``synthetic_tokens`` from
parameter_server_distributed_tpu/data/synthetic.py.  The numbers come
from the same numpy stream as the JAX package's, so one seed gives both
packages the same batches; the port's batches are int32 tensors on the
card unless the caller asks for the CPU."""

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
