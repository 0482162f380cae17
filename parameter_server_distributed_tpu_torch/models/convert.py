"""Parameter stores from numpy: the JAX package's parameters (a
transformer's, an MLP's, a ResNet's or a ViT's), converted with
``np.asarray``, become the port's store of torch tensors (a ResNet's
conv weights stay HWIO, as the JAX store holds them).  A quantized leaf
(the JAX package's ``quantize_params`` QTensor) crosses as its ``(q,
scale)`` numpy pair and becomes the port's :class:`~.quant.QTensor`.
:class:`StoreUploader` moves a host float32 store (a PS's, as a weight
follower holds it) to the card through one pinned buffer and one
copy."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from .mlp import MLP, MLPConfig
from .quant import QTensor
from .resnet import ResNet, ResNetConfig
from .transformer import (Transformer, TransformerConfig, stack_layers,
                          unstack_layers)
from .vit import ViT, ViTConfig

Config = TransformerConfig | MLPConfig | ResNetConfig | ViTConfig


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses: same bits
        # through a uint16 view
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(store: Mapping[str, np.ndarray],
                      config: Config, device=None) -> dict[str, torch.Tensor]:
    """Convert a numpy parameter store into the layout ``config`` names,
    in ``config.dtype``, on ``device`` (default: the card): a
    transformer's in the unrolled (``layer<i>/*``) or the stacked
    (``blocks/*``) layout, an MLP's (``layer<i>/w``, ``layer<i>/b``), a
    ResNet's or a ViT's; a ``(q, scale)`` pair keeps its int8 codes and
    f32 scales.  Raises on names or shapes the config does not expect."""
    dev = resolve_device(device)
    params = _in_layout({name: QTensor(_tensor(value[0]), _tensor(value[1]))
                         if isinstance(value, (tuple, list))
                         else _tensor(value)
                         for name, value in store.items()}, config)
    return {name: value.to(dev) if isinstance(value, QTensor)
            else value.to(device=dev, dtype=config.dtype)
            for name, value in params.items()}


def _in_layout(params: dict, config: Config) -> dict:
    """``params`` in the layout ``config`` names (stacked or unrolled
    layers); raises on names or shapes the config does not expect."""
    if isinstance(config, MLPConfig):
        expected = MLP(config.layer_sizes, config.dtype).param_shapes()
    elif isinstance(config, ResNetConfig):
        expected = ResNet.from_config(config).param_shapes()
    elif isinstance(config, ViTConfig):
        expected = ViT(config).param_shapes()
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
    return params


class StoreUploader:
    """Host float32 store -> tensors in ``config``'s dtype and layout on
    ``device``: every tensor packed into one pinned host buffer (kept
    and reused, grown when a store outgrows it), one copy to the device,
    one dtype conversion there, and views into the result.  The copy is
    waited on, so the buffer may be refilled at the next call.  Values
    are those of :func:`params_from_numpy` (the same round-to-nearest
    conversion), at one copy instead of one a tensor."""

    def __init__(self, config: Config, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._host: torch.Tensor | None = None

    def __call__(self, store: Mapping[str, np.ndarray]
                 ) -> dict[str, torch.Tensor]:
        arrays = {name: np.asarray(value, np.float32)
                  for name, value in store.items()}
        total = sum(int(a.size) for a in arrays.values())
        if self._host is None or self._host.numel() < total:
            self._host = torch.empty(
                total, dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
        flat = self._host.numpy()
        offsets = {}
        offset = 0
        for name, arr in arrays.items():
            flat[offset:offset + arr.size] = arr.reshape(-1)
            offsets[name] = offset
            offset += arr.size
        staged = self._host[:total]
        if self.device.type != "cpu":
            staged = staged.to(self.device)
        # a fresh buffer even on the host: the staging buffer is reused
        cast = staged.to(dtype=self.config.dtype, copy=True)
        params = {name: cast[offsets[name]:offsets[name] + arr.size]
                  .view(arr.shape) for name, arr in arrays.items()}
        return _in_layout(params, self.config)
