"""Model registry: name -> model factory and its synthetic data stream
(the LM and MLP rows of parameter_server_distributed_tpu/models/registry.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from ..data.synthetic import synthetic_mnist, synthetic_tokens
from ..device import resolve_device
from .mlp import MLP, billion_param_mlp, mnist_mlp
from .transformer import Transformer, llama_350m, lm_350m, small_lm, tiny_lm

# file- and text-backed token data (data/files.py, data/text.py
# text_stream) are not ported yet
ROADMAP_DATA = "ROADMAP.md Queue 1, item 2 (file-backed token data)"

REGISTRY: dict[str, Callable[..., Transformer]] = {
    "small_lm": partial(small_lm, vocab=1024, seq=256),
    "small_lm4": partial(small_lm, vocab=1024, seq=256, n_layers=4),
    "tiny_lm": partial(tiny_lm, vocab=1024, seq=256),
    "lm_350m": lm_350m,
    "lm_350m_gqa": partial(lm_350m, kv_heads=4),
    # head_dim-128 flagship: 8 heads x 128
    "lm_350m_hd128": partial(lm_350m, n_heads=8),
    # LLaMA-architecture flagship (SwiGLU + GQA)
    "llama_350m": llama_350m,
}


def _mnist_batches(batch_size: int, seed: int):
    # the seed varies the sampling only: the dataset (the task) is fixed,
    # as real MNIST is, so differently seeded workers share one task
    return synthetic_mnist(seed=0).batch_stream(batch_size, seed=seed)


def _mlp_1b_batches(batch_size: int, seed: int, hidden: int = 16384):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((batch_size, hidden)).astype(np.float32)
        y = rng.integers(0, hidden, batch_size).astype(np.int32)
        yield x, y


# classification rows: name -> (model factory, numpy (x, y) stream)
XY_REGISTRY: dict[str, tuple[Callable[..., MLP], Callable]] = {
    "mnist_mlp": (mnist_mlp, _mnist_batches),
    "mlp_1b": (billion_param_mlp, _mlp_1b_batches),
}

DTYPE_NAMES = {"f32": torch.float32, "float32": torch.float32,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPE_NAMES:
        raise ValueError(f"unknown dtype {name!r}; "
                         f"options {sorted(DTYPE_NAMES)}")
    return DTYPE_NAMES[name]


def get_model(name: str, dtype: str = "", remat: bool | None = None,
              scan: bool | None = None) -> Transformer | MLP:
    """Build a registry model at its factory's defaults; ``dtype``
    ("f32"/"bf16"), ``remat`` and ``scan`` (the stacked-layer layout)
    override the factory's where given (None keeps its default).  An MLP
    takes neither remat nor scan: asking for either raises, turning
    either off is a no-op, as in the reference."""
    kwargs: dict = {"dtype": resolve_dtype(dtype)} if dtype else {}
    if name in XY_REGISTRY:
        for flag, value in (("remat", remat), ("scan_layers", scan)):
            if value:
                raise ValueError(f"model {name!r} does not support {flag} "
                                 f"(transformer LMs only)")
        return XY_REGISTRY[name][0](**kwargs)
    if name not in REGISTRY:
        raise ValueError(f"unknown model {name!r}; have "
                         f"{sorted(REGISTRY) + sorted(XY_REGISTRY)}")
    if remat is not None:
        kwargs["remat"] = remat
    if scan is not None:
        kwargs["scan_layers"] = scan
    return REGISTRY[name](**kwargs)


def _on_device(batches, dev: torch.device) -> Iterator[tuple]:
    for x, y in batches:
        yield (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


def get_model_and_batches(name: str, batch_size: int, seed: int = 0,
                          data_path: str = "", dtype: str = "", device=None,
                          remat: bool | None = None, scan: bool | None = None
                          ) -> tuple[Transformer | MLP, Iterator]:
    """(model, batch iterator): the model from :func:`get_model` and the
    registry's synthetic stream, on ``device`` (default: the card).  The
    flagship LMs stream batch x 1024 tokens of a 32000 vocab and the
    test-scale LMs batch x 256 of 1024, as the JAX registry's
    ``_lm_350m_batches`` and ``_lm_batches`` do; the MLP rows stream
    ``(x, y)`` tensor pairs drawn from the JAX registry's numpy streams
    (the fixed MNIST stand-in of seed 0 sampled with ``seed``; Gaussian
    inputs and uniform labels for ``mlp_1b``)."""
    if data_path:
        raise NotImplementedError(f"file-backed data ({data_path!r}): "
                                  f"{ROADMAP_DATA}")
    model = get_model(name, dtype, remat=remat, scan=scan)
    if name in XY_REGISTRY:
        dev = resolve_device(device)
        return model, _on_device(XY_REGISTRY[name][1](batch_size, seed), dev)
    batches = synthetic_tokens(batch_size, seq_len=model.config.max_seq,
                               vocab=model.config.vocab, seed=seed,
                               device=device)
    return model, batches
