"""Parameter stores from numpy: the JAX package's parameters (a
transformer's or an MLP's), converted with ``np.asarray``, become the
port's store of torch tensors.  A quantized leaf (the JAX package's
``quantize_params`` QTensor) crosses as its ``(q, scale)`` numpy pair and
becomes the port's :class:`~.quant.QTensor`."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .mlp import MLP, MLPConfig
from .quant import QTensor
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
                      config: TransformerConfig | MLPConfig,
                      device=None) -> dict[str, torch.Tensor]:
    """Convert a numpy parameter store into the layout ``config`` names,
    in ``config.dtype``, on ``device`` (default: the card): a
    transformer's in the unrolled (``layer<i>/*``) or the stacked
    (``blocks/*``) layout, or an MLP's (``layer<i>/w``, ``layer<i>/b``);
    a ``(q, scale)`` pair keeps its int8 codes and f32 scales.  Raises
    on names or shapes the config does not expect."""
    dev = resolve_device(device)
    params = {name: QTensor(_tensor(value[0]), _tensor(value[1]))
              if isinstance(value, (tuple, list)) else _tensor(value)
              for name, value in store.items()}
    if isinstance(config, MLPConfig):
        expected = MLP(config.layer_sizes, config.dtype).param_shapes()
    else:
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
    return {name: value.to(dev) if isinstance(value, QTensor)
            else value.to(device=dev, dtype=config.dtype)
            for name, value in params.items()}
