"""Model registry: name -> model factory and its synthetic data stream
(the LM, MLP and image rows of
parameter_server_distributed_tpu/models/registry.py), and the
file-backed data of ``data_path`` (data/files.py, data/text.py).
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Callable, Iterator

import numpy as np
import torch

from ..data.synthetic import (synthetic_image_batches, synthetic_mnist,
                              synthetic_tokens)
from ..device import resolve_device
from .mlp import MLP, billion_param_mlp, mnist_mlp
from .resnet import ResNet, resnet18, resnet50
from .transformer import (Transformer, llama_350m, lm_350m, moe_350m, moe_lm,
                          small_lm, switch_lm, tiny_lm)
from .vit import ViT, vit_s16, vit_tiny

# token rows (file data: a token shard, or a .txt corpus)
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
    # mixture-of-experts rows (models/moe.py): test-scale Switch top-1,
    # top-2 and all-MoE, and the flagship-scale sparse LM (lm_350m's
    # trunk, every 2nd FFN routed over 8 experts, ~1.07B parameters)
    "moe_lm": partial(moe_lm, vocab=1024, seq=256),
    "moe_lm_top2": partial(moe_lm, vocab=1024, seq=256, top_k=2),
    "switch_lm": partial(switch_lm, vocab=1024, seq=256),
    "moe_350m": moe_350m,
}


def _mnist_batches(batch_size: int, seed: int):
    # the seed varies the sampling only: the dataset (the task) is fixed,
    # as real MNIST is, so differently seeded workers share one task
    return synthetic_mnist(seed=0).batch_stream(batch_size, seed=seed)


def _cifar_batches(batch_size: int, seed: int):
    return synthetic_image_batches(batch_size, image_size=32, seed=seed)


def _imagenet_batches(batch_size: int, seed: int):
    return synthetic_image_batches(batch_size, image_size=224,
                                   num_classes=1000, seed=seed)


def _mlp_1b_batches(batch_size: int, seed: int, hidden: int = 16384):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.standard_normal((batch_size, hidden)).astype(np.float32)
        y = rng.integers(0, hidden, batch_size).astype(np.int32)
        yield x, y


# classification rows (file data: an npz of x and y): name -> (model
# factory, numpy (x, y) stream)
XY_REGISTRY: dict[str, tuple[Callable[..., MLP | ResNet | ViT],
                             Callable]] = {
    "mnist_mlp": (mnist_mlp, _mnist_batches),
    "mlp_1b": (billion_param_mlp, _mlp_1b_batches),
    "resnet18_cifar": (partial(resnet18, num_classes=10), _cifar_batches),
    "resnet50_imagenet": (partial(resnet50, num_classes=1000),
                          _imagenet_batches),
    # vision transformers: CIFAR-scale and ImageNet-scale
    "vit_tiny_cifar": (partial(vit_tiny, num_classes=10, image_size=32),
                       _cifar_batches),
    "vit_s16_imagenet": (partial(vit_s16, num_classes=1000,
                                 image_size=224), _imagenet_batches),
}

DTYPE_NAMES = {"f32": torch.float32, "float32": torch.float32,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPE_NAMES:
        raise ValueError(f"unknown dtype {name!r}; "
                         f"options {sorted(DTYPE_NAMES)}")
    return DTYPE_NAMES[name]


def get_model(name: str, dtype: str = "", remat: bool | None = None,
              scan: bool | None = None,
              seq_len: int = 0) -> Transformer | MLP | ResNet | ViT:
    """Build a registry model at its factory's defaults; ``dtype``
    ("f32"/"bf16"), ``remat``, ``scan`` (the stacked-layer layout) and
    ``seq_len`` (an LM's sequence length) override the factory's where
    given (None or 0 keeps its default).  A model that cannot honour
    remat or scan (a classification model; an MoE LM's layers are not
    homogeneous, so it takes no scan) raises when asked for it, and
    turning it off is a no-op, as in the reference."""
    kwargs: dict = {"dtype": resolve_dtype(dtype)} if dtype else {}
    if name in XY_REGISTRY:
        for flag, value in (("remat", remat), ("scan_layers", scan)):
            if value:
                raise ValueError(f"model {name!r} does not support {flag} "
                                 f"(transformer LMs only)")
        if seq_len:
            raise ValueError(f"model {name!r} has no sequence length "
                             f"(transformer LMs only)")
        return XY_REGISTRY[name][0](**kwargs)
    if name not in REGISTRY:
        raise ValueError(f"unknown model {name!r}; have "
                         f"{sorted(REGISTRY) + sorted(XY_REGISTRY)}")
    factory = REGISTRY[name]
    if remat is not None:
        kwargs["remat"] = remat
    if scan is not None:
        if "scan_layers" in inspect.signature(factory).parameters:
            kwargs["scan_layers"] = scan
        elif scan:
            raise ValueError(f"model {name!r} does not support scan_layers "
                             f"(dense transformer LMs only)")
    if seq_len:
        kwargs["seq"] = seq_len
    return factory(**kwargs)


def _xy_on_device(batches, dev: torch.device) -> Iterator[tuple]:
    for x, y in batches:
        yield (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


def _tokens_on_device(batches, dev: torch.device) -> Iterator[torch.Tensor]:
    for batch in batches:
        yield torch.from_numpy(batch).to(dev)


def get_model_and_batches(name: str, batch_size: int, seed: int = 0,
                          data_path: str = "", dtype: str = "", device=None,
                          remat: bool | None = None, scan: bool | None = None,
                          seq_len: int = 0
                          ) -> tuple[Transformer | MLP | ResNet | ViT,
                                     Iterator]:
    """(model, batch iterator): the model from :func:`get_model` and its
    batches on ``device`` (default: the card).  Without ``data_path`` the
    registry's synthetic stream: the flagship LMs stream batch x 1024
    tokens of a 32000 vocab and the test-scale LMs batch x 256 of 1024;
    the classification rows stream ``(x, y)`` tensor pairs drawn from the
    JAX registry's numpy streams (the fixed MNIST stand-in of seed 0
    sampled with ``seed``, Gaussian inputs for ``mlp_1b``, NHWC
    class-cluster images at 32 or 224 pixels for the image rows).  With
    ``data_path``, file-backed data by the row's kind: an LM reads a
    token shard or a ``.txt`` corpus (:func:`lm_batches`), a
    classification row an npz of ``x`` and ``y`` (``npz_stream``)."""
    model = get_model(name, dtype, remat=remat, scan=scan, seq_len=seq_len)
    dev = resolve_device(device)
    if name in XY_REGISTRY:
        if data_path:
            from ..data.files import npz_stream
            numpy_batches = npz_stream(data_path, batch_size, seed=seed)
        else:
            numpy_batches = XY_REGISTRY[name][1](batch_size, seed)
        return model, _xy_on_device(numpy_batches, dev)
    return model, lm_batches(model, batch_size, seed=seed,
                             data_path=data_path, device=dev)


def lm_batches(model: Transformer, batch_size: int, seed: int = 0,
               data_path: str = "", device=None) -> Iterator[torch.Tensor]:
    """int32 token batches ``[batch, max_seq]`` for any transformer LM,
    on ``device`` (default: the card): synthetic crops of the model's
    vocab without ``data_path``; with it, a ``.txt`` corpus
    byte-tokenized into a cached shard (the model's vocab must cover the
    byte tokenizer's 258 ids), or else a token shard whose ids are
    checked against the model's vocab."""
    if not data_path:
        return synthetic_tokens(batch_size, seq_len=model.config.max_seq,
                                vocab=model.config.vocab, seed=seed,
                                device=device)
    dev = resolve_device(device)
    if data_path.endswith(".txt"):
        from ..data.text import ByteTokenizer, require_vocab, text_stream
        tok = ByteTokenizer()
        require_vocab(model.config.vocab, tok)
        numpy_batches = text_stream(data_path, batch_size,
                                    seq_len=model.config.max_seq, seed=seed,
                                    tokenizer=tok)
    else:
        from ..data.files import token_stream
        numpy_batches = token_stream(data_path, batch_size,
                                     seq_len=model.config.max_seq, seed=seed,
                                     vocab=model.config.vocab)
    return _tokens_on_device(numpy_batches, dev)
