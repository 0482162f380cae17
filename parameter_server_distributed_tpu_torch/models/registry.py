"""Model registry, LM rows: name -> transformer factory (the LM part of
parameter_server_distributed_tpu/models/registry.py)."""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from .transformer import Transformer, llama_350m, lm_350m, small_lm, tiny_lm

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
    """Build a registry LM; ``dtype`` ("f32"/"bf16", empty = the
    factory's default) overrides the weight and activation type."""
    if name not in REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(REGISTRY)}")
    kwargs = {"dtype": resolve_dtype(dtype)} if dtype else {}
    return REGISTRY[name](**kwargs)
