"""The MLP family: the port of parameter_server_distributed_tpu/models/mlp.py.

From the MNIST-scale model of BASELINE config 1 (784-256-10) up to the
1.34B-parameter MLP of the MFU configurations.  Parameters are a flat
named store (``layer{i}/w`` [fan_in, fan_out], ``layer{i}/b``
[fan_out]), so they cross the PS wire, the checkpoint codec and the
trainer's packed step as they are.  Products take the model dtype's
inputs and keep an f32 result, as the reference's ``jnp.dot(...,
preferred_element_type=float32)``: a bf16 ``torch.matmul`` would round
its output to bf16 where the reference does not (``_dot_f32``); the
activations between layers are in the model dtype.  The weights come
from a ``torch.Generator`` (He init for the ReLU layers, zero biases):
the same scheme as the reference, another random stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import Tensor

from ..device import resolve_device
from .transformer import _dot_f32


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    layer_sizes: tuple[int, ...]
    dtype: torch.dtype = torch.float32


class MLP:
    """ReLU MLP with a mean softmax cross-entropy loss."""

    def __init__(self, layer_sizes: tuple[int, ...] = (784, 256, 10),
                 dtype: torch.dtype = torch.float32):
        if len(layer_sizes) < 2:
            raise ValueError("need at least input and output sizes")
        self.config = MLPConfig(tuple(int(s) for s in layer_sizes), dtype)

    @property
    def layer_sizes(self) -> tuple[int, ...]:
        return self.config.layer_sizes

    @property
    def dtype(self) -> torch.dtype:
        return self.config.dtype

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes) - 1

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        shapes: dict[str, tuple[int, ...]] = {}
        for i, (fan_in, fan_out) in enumerate(
                zip(self.layer_sizes[:-1], self.layer_sizes[1:])):
            shapes[f"layer{i}/w"] = (fan_in, fan_out)
            shapes[f"layer{i}/b"] = (fan_out,)
        return shapes

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def init_params(self, rng: torch.Generator | int = 0,
                    device=None) -> dict[str, Tensor]:
        """Fresh weights from ``rng`` (a seed or a ``torch.Generator`` on
        the target device), on ``device`` (default: the card)."""
        dev = resolve_device(device)
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(rng)))
        params: dict[str, Tensor] = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("/w"):
                scale = math.sqrt(2.0 / shape[0])   # He init for ReLU
                params[name] = scale * torch.randn(
                    shape, generator=gen, dtype=self.dtype, device=dev)
            else:
                params[name] = torch.zeros(shape, dtype=self.dtype,
                                           device=dev)
        return params

    def apply(self, params: Mapping[str, Tensor], x: Tensor) -> Tensor:
        """x [batch, features] -> f32 logits [batch, classes]."""
        h = x.to(self.dtype)
        for i in range(self.num_layers):
            h = _dot_f32(h, params[f"layer{i}/w"]) \
                + params[f"layer{i}/b"].float()
            if i < self.num_layers - 1:
                h = F.relu(h).to(self.dtype)
        return h

    def loss(self, params: Mapping[str, Tensor], batch) -> Tensor:
        """Mean softmax cross-entropy over the batch ``(x, y)``."""
        x, y = batch
        logp = F.log_softmax(self.apply(params, x), dim=-1)
        return -logp.gather(-1, y.long()[:, None]).mean()

    def accuracy(self, params: Mapping[str, Tensor], batch) -> Tensor:
        x, y = batch
        return (self.apply(params, x).argmax(-1) == y.long()).float().mean()


def mnist_mlp(dtype: torch.dtype = torch.float32) -> MLP:
    """BASELINE config 1's model: the 784-256-10 MNIST MLP."""
    return MLP((784, 256, 10), dtype=dtype)


def billion_param_mlp(hidden: int = 16384, layers: int = 4,
                      dtype: torch.dtype = torch.bfloat16) -> MLP:
    """The ~1B-parameter MLP of the MFU configurations: ``layers`` hidden
    layers of ``hidden`` units between a ``hidden``-wide input and
    output, 5 * 16384^2 + 5 * 16384 = 1,342,259,200 parameters at the
    defaults; bf16 weights and activations, f32 products."""
    return MLP((hidden,) * (layers + 2), dtype=dtype)
