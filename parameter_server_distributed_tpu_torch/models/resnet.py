"""The ResNet family (ResNet-18 / ResNet-50): the port of
parameter_server_distributed_tpu/models/resnet.py.

BASELINE config 2 (async-SGD CIFAR-10 ResNet-18) and config 4
(ResNet-50).  The store is the reference's, names and shapes: conv
weights stay HWIO ``[kh, kw, in, out]``, so a store crosses the PS wire
and the checkpoint codec as it is and one PS serves a fleet of both
packages.  Batches arrive NHWC as the registry streams them; ``apply``
copies the images to NCHW and views each weight as OIHW for
``F.conv2d``.  The activations are NCHW in memory: left channels-last
(the permuted batch's strides), torch 2.13's CPU convolution backward
crashed at 8 threads.

What the reference computes and the port keeps:

- SAME padding, which XLA splits ``lo = total // 2``, ``hi = total -
  lo``: a 3x3 stride-2 conv on an even size pads (0, 1), the 7x7/s2 stem
  on 224 pads (2, 3), the 3x3/s2 max pool (0, 1) with -inf.  torch's
  symmetric ``padding=`` gives the same shape and other values, so every
  pad is an explicit ``F.pad``.
- The conv input is cast to the weight's dtype (bf16 for ResNet-50); the
  product accumulates in f32 and rounds once to that dtype.
- Normalization is batch-statistics BN in f32 with the population
  variance (no running statistics): scale and bias are learned
  parameters, and ``relu(out + shortcut)`` is f32.
- The head is an f32 product of the pooled f32 features.

The weights come from a ``torch.Generator``: He normal on
``prod(shape[:-1])`` for conv and projection weights, ones and zeros for
the norms, ``sqrt(1/fan_in)`` for ``head/w``; the reference's scheme,
another random stream.
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


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: Tensor, kh: int, kw: int, stride: int,
              value: float = 0.0) -> Tensor:
    """NCHW ``x`` padded for a (kh, kw) window at ``stride``, SAME."""
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    """NCHW x by an HWIO weight -> NCHW in the weight's dtype, SAME."""
    x = _pad_same(x.to(w.dtype), w.shape[0], w.shape[1], stride)
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _max_pool(x: Tensor) -> Tensor:
    """3x3 stride-2 max pool, SAME with -inf padding."""
    return F.max_pool2d(_pad_same(x, 3, 3, 2, value=-math.inf), 3, 2)


def _norm(x: Tensor, scale: Tensor, bias: Tensor,
          eps: float = 1e-5) -> Tensor:
    """Per-channel batch-statistics normalization (train-mode BN) of an
    NCHW tensor, in f32, with the population variance."""
    x = x.float()
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    inv = torch.rsqrt(var + eps)
    return ((x - mean) * inv * scale.float()[:, None, None]
            + bias.float()[:, None, None])


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: tuple[int, ...] = (2, 2, 2, 2)
    bottleneck: bool = False
    num_classes: int = 10
    width: int = 64
    input_channels: int = 3
    # CIFAR-style 3x3 stem and no pool (else the 7x7/s2 stem and pool)
    small_inputs: bool = True
    dtype: torch.dtype = torch.float32


class ResNet:
    """Configurable ResNet.  ``stages``: blocks a stage; ``bottleneck``:
    False for ResNet-18/34 basic blocks, True for the 1-3-1 bottleneck
    blocks of ResNet-50."""

    def __init__(self, stages: tuple[int, ...] = (2, 2, 2, 2),
                 bottleneck: bool = False, num_classes: int = 10,
                 width: int = 64, input_channels: int = 3,
                 small_inputs: bool = True,
                 dtype: torch.dtype = torch.float32):
        self.config = ResNetConfig(tuple(int(s) for s in stages),
                                   bool(bottleneck), int(num_classes),
                                   int(width), int(input_channels),
                                   bool(small_inputs), dtype)
        self._shapes = self._build_shapes()

    @classmethod
    def from_config(cls, config: ResNetConfig) -> "ResNet":
        return cls(**dataclasses.asdict(config))

    @property
    def dtype(self) -> torch.dtype:
        return self.config.dtype

    # ------------------------------------------------------------ structure
    def _block_names(self) -> list[tuple[str, int, int, int, bool]]:
        """(block prefix, in channels, base channels, stride, has a
        projection) a block."""
        c = self.config
        blocks = []
        expansion = 4 if c.bottleneck else 1
        in_ch = c.width
        for stage_idx, num_blocks in enumerate(c.stages):
            base = c.width * (2 ** stage_idx)
            out_ch = base * expansion
            for block_idx in range(num_blocks):
                stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
                needs_proj = (in_ch != out_ch) or stride != 1
                blocks.append((f"stage{stage_idx}/block{block_idx}",
                               in_ch, base, stride, needs_proj))
                in_ch = out_ch
        return blocks

    def _build_shapes(self) -> dict[str, tuple[int, ...]]:
        c = self.config
        shapes: dict[str, tuple[int, ...]] = {}
        stem_k = 3 if c.small_inputs else 7
        shapes["stem/conv/w"] = (stem_k, stem_k, c.input_channels, c.width)
        shapes["stem/norm/scale"] = (c.width,)
        shapes["stem/norm/bias"] = (c.width,)
        expansion = 4 if c.bottleneck else 1
        for prefix, in_ch, base, _stride, needs_proj in self._block_names():
            out_ch = base * expansion
            if c.bottleneck:
                shapes[f"{prefix}/conv1/w"] = (1, 1, in_ch, base)
                shapes[f"{prefix}/conv2/w"] = (3, 3, base, base)
                shapes[f"{prefix}/conv3/w"] = (1, 1, base, out_ch)
                norms = ((1, base), (2, base), (3, out_ch))
            else:
                shapes[f"{prefix}/conv1/w"] = (3, 3, in_ch, base)
                shapes[f"{prefix}/conv2/w"] = (3, 3, base, base)
                norms = ((1, base), (2, base))
            for i, ch in norms:
                shapes[f"{prefix}/norm{i}/scale"] = (ch,)
                shapes[f"{prefix}/norm{i}/bias"] = (ch,)
            if needs_proj:
                shapes[f"{prefix}/proj/w"] = (1, 1, in_ch, out_ch)
                shapes[f"{prefix}/proj_norm/scale"] = (out_ch,)
                shapes[f"{prefix}/proj_norm/bias"] = (out_ch,)
        final_ch = c.width * (2 ** (len(c.stages) - 1)) * expansion
        shapes["head/w"] = (final_ch, c.num_classes)
        shapes["head/b"] = (c.num_classes,)
        return shapes

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        return dict(self._shapes)

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self._shapes.values())

    # ----------------------------------------------------------------- init
    def init_params(self, rng: torch.Generator | int = 0,
                    device=None) -> dict[str, Tensor]:
        """Fresh weights from ``rng`` (a seed or a ``torch.Generator`` on
        the target device), on ``device`` (default: the card)."""
        dev = resolve_device(device)
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(rng)))
        dtype = self.config.dtype
        params: dict[str, Tensor] = {}
        for name, shape in self._shapes.items():
            if name.endswith("conv/w") or "/conv" in name \
                    or "/proj/w" in name:
                scale = math.sqrt(2.0 / math.prod(shape[:-1]))
            elif name == "head/w":
                scale = math.sqrt(1.0 / shape[0])
            elif name.endswith("/scale"):
                params[name] = torch.ones(shape, dtype=dtype, device=dev)
                continue
            elif name.endswith("/bias") or name.endswith("/b"):
                params[name] = torch.zeros(shape, dtype=dtype, device=dev)
                continue
            else:
                raise AssertionError(f"unhandled param {name}")
            params[name] = scale * torch.randn(
                shape, generator=gen, dtype=dtype, device=dev)
        return params

    # -------------------------------------------------------------- forward
    def apply(self, params: Mapping[str, Tensor], x: Tensor) -> Tensor:
        """NHWC images -> f32 logits [batch, classes]."""
        c = self.config
        p = params
        h = _conv(x.permute(0, 3, 1, 2).contiguous(), p["stem/conv/w"],
                  stride=1 if c.small_inputs else 2)
        h = F.relu(_norm(h, p["stem/norm/scale"], p["stem/norm/bias"]))
        if not c.small_inputs:
            h = _max_pool(h)
        for prefix, _in_ch, _base, stride, needs_proj in self._block_names():
            shortcut = h
            if c.bottleneck:
                out = _conv(h, p[f"{prefix}/conv1/w"])
                out = F.relu(_norm(out, p[f"{prefix}/norm1/scale"],
                                   p[f"{prefix}/norm1/bias"]))
                out = _conv(out, p[f"{prefix}/conv2/w"], stride=stride)
                out = F.relu(_norm(out, p[f"{prefix}/norm2/scale"],
                                   p[f"{prefix}/norm2/bias"]))
                out = _conv(out, p[f"{prefix}/conv3/w"])
                out = _norm(out, p[f"{prefix}/norm3/scale"],
                            p[f"{prefix}/norm3/bias"])
            else:
                out = _conv(h, p[f"{prefix}/conv1/w"], stride=stride)
                out = F.relu(_norm(out, p[f"{prefix}/norm1/scale"],
                                   p[f"{prefix}/norm1/bias"]))
                out = _conv(out, p[f"{prefix}/conv2/w"])
                out = _norm(out, p[f"{prefix}/norm2/scale"],
                            p[f"{prefix}/norm2/bias"])
            if needs_proj:
                shortcut = _conv(h, p[f"{prefix}/proj/w"], stride=stride)
                shortcut = _norm(shortcut, p[f"{prefix}/proj_norm/scale"],
                                 p[f"{prefix}/proj_norm/bias"])
            h = F.relu(out + shortcut)
        h = h.mean(dim=(2, 3))  # global average pool
        return _dot_f32(h, p["head/w"]) + p["head/b"].float()

    def loss(self, params: Mapping[str, Tensor], batch) -> Tensor:
        """Mean softmax cross-entropy over the batch ``(x, y)``."""
        x, y = batch
        logp = F.log_softmax(self.apply(params, x), dim=-1)
        return -logp.gather(-1, y.long()[:, None]).mean()


def resnet18(num_classes: int = 10, small_inputs: bool = True,
             dtype: torch.dtype = torch.float32) -> ResNet:
    return ResNet((2, 2, 2, 2), bottleneck=False, num_classes=num_classes,
                  small_inputs=small_inputs, dtype=dtype)


def resnet50(num_classes: int = 1000, small_inputs: bool = False,
             dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet((3, 4, 6, 3), bottleneck=True, num_classes=num_classes,
                  small_inputs=small_inputs, dtype=dtype)
