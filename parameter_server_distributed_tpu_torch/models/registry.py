"""Model registry, LM rows: name -> transformer factory and its synthetic
token stream (the LM part of
parameter_server_distributed_tpu/models/registry.py)."""

from __future__ import annotations

from functools import partial
from typing import Callable, Iterator

import torch

from ..data.synthetic import synthetic_tokens
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

DTYPE_NAMES = {"f32": torch.float32, "float32": torch.float32,
               "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in DTYPE_NAMES:
        raise ValueError(f"unknown dtype {name!r}; "
                         f"options {sorted(DTYPE_NAMES)}")
    return DTYPE_NAMES[name]


def get_model(name: str, dtype: str = "") -> Transformer:
    """Build a registry LM at its factory's defaults; ``dtype``
    ("f32"/"bf16") overrides the factory's where given."""
    if name not in REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    kwargs: dict = {"dtype": resolve_dtype(dtype)} if dtype else {}
    return REGISTRY[name](**kwargs)


def get_model_and_batches(name: str, batch_size: int, seed: int = 0,
                          data_path: str = "", dtype: str = "", device=None
                          ) -> tuple[Transformer, Iterator[torch.Tensor]]:
    """(model, batch iterator): the model from :func:`get_model` and the
    registry's synthetic token stream at the model's (vocab, max_seq), on
    ``device`` (default: the card).  The flagships stream batch x 1024
    tokens of a 32000 vocab, the test-scale LMs batch x 256 of 1024, as
    the JAX registry's ``_lm_350m_batches`` and ``_lm_batches`` do."""
    if data_path:
        raise NotImplementedError(f"file-backed data ({data_path!r}): "
                                  f"{ROADMAP_DATA}")
    model = get_model(name, dtype)
    batches = synthetic_tokens(batch_size, seq_len=model.config.max_seq,
                               vocab=model.config.vocab, seed=seed,
                               device=device)
    return model, batches
