"""LoRA, the serving side: the port of
parameter_server_distributed_tpu/models/lora.py's adapter layout, merge
and spec parsing.

Adapters are ordinary store entries beside their base weight,
``<weight>/lora_a`` [in, r] and ``<weight>/lora_b`` [r, out] (leading
axes of a stacked weight carried over), and the adapted weight is ``W +
(alpha / r) * A @ B``.  :func:`merge_lora` folds them into the base
weights for serving, the rank read from the stored A factor.  Training
with adapters (``lora_loss``, ``lora_value_and_grad``, ``freeze_base``)
comes with the port's training loop and raises until then.
"""

from __future__ import annotations

import math
import re
from typing import Mapping, Sequence

import torch

Tensor = torch.Tensor

A_SUFFIX = "/lora_a"
B_SUFFIX = "/lora_b"

# default adaptation targets: the attention q/v projections, matched as
# name suffixes so layer prefixes and stacked blocks both hit
DEFAULT_TARGETS = ("attn/wq", "attn/wv")
DEFAULT_ALPHA = 16.0

ROADMAP_LORA_TRAINING = ("ROADMAP.md Queue 1, item 8 (train_loop): LoRA "
                         "training lands with train_main")


def init_lora(params: Mapping[str, Tensor], rank: int = 8,
              targets: Sequence[str] = DEFAULT_TARGETS,
              rng: torch.Generator | int = 0) -> dict[str, Tensor]:
    """``params`` plus fresh adapters for every >= 2-D weight whose name
    ends with one of ``targets``: A Gaussian / sqrt(in), B zero, so the
    adapted model starts exactly at the base model.  Leading axes of a
    stacked weight become batch axes of its factors.  The same scheme as
    the reference from another random stream (a ``torch.Generator`` on
    the weights' device, or a seed)."""
    matched = [name for name, w in params.items()
               if name.endswith(tuple(targets)) and w.ndim >= 2]
    if not matched:
        raise ValueError(f"no parameters match LoRA targets {targets}; "
                         f"store has e.g. {sorted(params)[:5]}")
    out = dict(params)
    for name in matched:
        w = params[name]
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=w.device).manual_seed(int(rng)))
        rng = gen
        *lead, d_in, d_out = w.shape
        out[name + A_SUFFIX] = (torch.randn((*lead, d_in, rank),
                                            generator=gen, dtype=w.dtype,
                                            device=w.device)
                                / math.sqrt(d_in))
        out[name + B_SUFFIX] = torch.zeros((*lead, rank, d_out),
                                           dtype=w.dtype, device=w.device)
    return out


def lora_names(params: Mapping[str, Tensor]) -> list[str]:
    return [n for n in params if n.endswith((A_SUFFIX, B_SUFFIX))]


def _effective(params: Mapping[str, Tensor],
               alpha: float) -> dict[str, Tensor]:
    """Collapse adapters: base + (alpha / r) * A @ B, adapter entries
    removed.  The rank is read from the stored A factor (its trailing
    dim), never passed.  Stacked [L, ...] factors multiply batched."""
    eff = {}
    for name, value in params.items():
        if name.endswith((A_SUFFIX, B_SUFFIX)):
            continue
        a = params.get(name + A_SUFFIX)
        if a is not None:
            b = params[name + B_SUFFIX]
            delta = torch.matmul(a, b) * (alpha / a.shape[-1])
            value = (value + delta).to(value.dtype)
        eff[name] = value
    return eff


def merge_lora(params: Mapping[str, Tensor],
               alpha: float = DEFAULT_ALPHA) -> dict[str, Tensor]:
    """Fold adapters into the base weights for serving or export (rank
    read from the stored factors; only alpha must match training).  The
    result serves exactly like a dense store, and its forward equals the
    adapted model's."""
    return _effective(params, alpha)


def trainable_mask(params: Mapping[str, Tensor]) -> dict[str, bool]:
    """True for adapter entries, False for frozen base weights."""
    return {name: name.endswith((A_SUFFIX, B_SUFFIX)) for name in params}


def split_rank_alpha(spec: str) -> tuple[int, float]:
    """Parse a ``--lora=R[:ALPHA]`` spec (alpha defaults to 2 * R)."""
    m = re.fullmatch(r"(\d+)(?::([\d.]+))?", spec)
    if not m:
        raise ValueError(f"--lora expects R or R:ALPHA, got {spec!r}")
    rank = int(m.group(1))
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    alpha = float(m.group(2)) if m.group(2) else 2.0 * rank
    return rank, alpha


def lora_loss(*args, **kwargs):
    raise NotImplementedError(f"lora_loss: {ROADMAP_LORA_TRAINING}")


def lora_value_and_grad(*args, **kwargs):
    raise NotImplementedError(f"lora_value_and_grad: {ROADMAP_LORA_TRAINING}")


def freeze_base(*args, **kwargs):
    raise NotImplementedError(f"freeze_base: {ROADMAP_LORA_TRAINING}")
