"""File-backed datasets: the port's copy of
parameter_server_distributed_tpu/data/files.py.

- **Token shards** (:func:`token_stream`): flat binary files of token ids
  (uint16 or uint32 little-endian, the GPT-style ``.bin`` layout), opened
  with ``np.memmap`` so a large corpus streams from the page cache.
  Batches are random ``[seq_len]`` crops.
- **Example sets** (:func:`npz_stream`): an ``.npz`` with arrays ``x``
  and ``y`` (any model input and label pair), shuffled each epoch.

Both yield numpy batches, the same as the JAX package's from one seed;
``models/registry.py`` moves them to the device.  A distinct ``seed`` a
worker (worker_main defaults it to the worker id) gives each worker its
own crops and order.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from .synthetic import xy_batch_stream


def load_tokens(path: str, dtype: str | None = None) -> np.ndarray:
    """Memmap a flat binary token file.  The dtype: a ``.u32`` extension
    means uint32, anything else uint16 (the common GPT shard format)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"token file {path!r} does not exist")
    if dtype is None:
        dtype = {".u32": "<u4"}.get(os.path.splitext(path)[1], "<u2")
    tokens = np.memmap(path, dtype=dtype, mode="r")
    if tokens.size == 0:
        raise ValueError(f"token file {path!r} is empty")
    return tokens


def token_stream(path: str, batch_size: int, seq_len: int,
                 seed: int = 0, dtype: str | None = None,
                 vocab: int | None = None) -> Iterator[np.ndarray]:
    """Endless ``[batch, seq_len]`` int32 batches of random crops from a
    token shard.  ``vocab`` checks every batch's ids: an embedding lookup
    past the vocabulary must not train on a shard of another tokenizer.
    The check runs before the int32 cast, so an id of 2^31 or more cannot
    wrap negative and slip past it."""
    tokens = load_tokens(path, dtype)
    if tokens.size < seq_len:
        raise ValueError(
            f"token file {path!r} has {tokens.size} tokens, need at least "
            f"seq_len = {seq_len}")
    rng = np.random.default_rng(seed)
    high = tokens.size - seq_len + 1  # inclusive of the final full crop
    limit = vocab if vocab is not None else np.int64(1) << 31
    while True:
        starts = rng.integers(0, high, size=batch_size)
        batch = np.stack([tokens[s:s + seq_len] for s in starts])
        if batch.max() >= limit:
            what = (f"model vocab {vocab}" if vocab is not None
                    else "int32 range")
            raise ValueError(
                f"token file {path!r} has id {int(batch.max())} >= {what} "
                f"— wrong tokenizer/shard for this model")
        yield batch.astype(np.int32)


def npz_stream(path: str, batch_size: int, seed: int = 0,
               drop_remainder: bool = True
               ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless shuffled ``(x, y)`` batches from an npz with arrays ``x``
    and ``y``, reshuffled each epoch as ``xy_batch_stream`` does."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"dataset {path!r} does not exist")
    with np.load(path) as data:
        missing = {"x", "y"} - set(data.files)
        if missing:
            raise ValueError(f"{path!r} lacks arrays {sorted(missing)} "
                             f"(has {sorted(data.files)})")
        x, y = np.asarray(data["x"]), np.asarray(data["y"])
    if len(x) != len(y):
        raise ValueError(f"{path!r}: len(x)={len(x)} != len(y)={len(y)}")
    if len(x) < batch_size and drop_remainder:
        raise ValueError(f"{path!r} has {len(x)} examples < batch_size "
                         f"{batch_size}")
    return xy_batch_stream(x, y, batch_size, seed=seed,
                           drop_remainder=drop_remainder)
