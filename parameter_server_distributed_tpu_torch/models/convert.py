"""Parameter stores from numpy: the JAX package's parameters, converted
with ``np.asarray``, become the port's store of torch tensors."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .transformer import (Transformer, TransformerConfig, stack_layers,
                          unstack_layers)


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: same bits
        # through a uint16 view
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(store: Mapping[str, np.ndarray],
                      config: TransformerConfig,
                      device=None) -> dict[str, torch.Tensor]:
    """Convert a numpy parameter store, in the unrolled (``layer<i>/*``)
    or the stacked (``blocks/*``) layout, into the layout ``config``
    names, in ``config.dtype``, on ``device`` (default: the card).
    Raises on names or shapes the config does not expect."""
    dev = resolve_device(device)
    params = {name: _tensor(value) for name, value in store.items()}
    stacked = any(name.startswith("blocks/") for name in params)
    if config.scan_layers and not stacked:
        params = stack_layers(params, config.n_layers)
    elif stacked and not config.scan_layers:
        params = unstack_layers(params)
    expected = Transformer(config).param_shapes()
    got = {name: tuple(value.shape) for name, value in params.items()}
    if got != expected:
        drift = sorted(set(got) ^ set(expected)) + sorted(
            name for name in set(got) & set(expected)
            if got[name] != expected[name])
        raise ValueError(f"store does not match the config "
                         f"(name/shape drift: {drift[:4]}...)")
    return {name: value.to(device=dev, dtype=config.dtype)
            for name, value in params.items()}
