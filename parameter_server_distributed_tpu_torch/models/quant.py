"""Weight-only int8 quantization for serving: the port of
parameter_server_distributed_tpu/models/quant.py.

A trained store is quantized offline (:func:`quantize_params`) into
:class:`QTensor` leaves, symmetric int8 with a per-output-channel f32
scale, that flow through the model code unchanged: the transformer's
product sites send a ``QTensor`` through :func:`wdot`, which on the card
is the ``int8_wdot`` kernel (ops/int8_serve.py, K5): only int8 weight
bytes leave device memory, and the f32 product is scaled per channel.
Stacked ``blocks/*`` leaves slice per layer with ``value[layer]``.

Embeddings stay in the model dtype (a gather, not a product), norms and
biases too.  Training on quantized weights is not supported: this is a
post-training serving transform (``Transformer.loss`` refuses such a
store).
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ops import int8_serve

Tensor = torch.Tensor

# matmul-weight name suffixes eligible for quantization, in both layouts
# (unrolled "layer<i>/attn/wq" and the stacked "blocks/attn/wq")
_WEIGHT_SUFFIXES = ("/attn/wq", "/attn/wk", "/attn/wv", "/attn/wo",
                    "/mlp/w1", "/mlp/w2", "/mlp/w3")


class QTensor:
    """Symmetric weight-only int8 matrix.

    ``q``: int8 ``[..., d_in, d_out]`` (leading axes: stacked layers).
    ``scale``: f32 ``[..., d_out]``, per output channel the absmax over
    d_in over 127, so dequant is ``q * scale`` broadcast over d_in."""

    __slots__ = ("q", "scale")

    def __init__(self, q: Tensor, scale: Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> tuple:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def device(self) -> torch.device:
        return self.q.device

    def __getitem__(self, idx) -> "QTensor":
        # layer_view slices stacked [L, ...] params per layer: the scale
        # takes the same leading index
        return QTensor(self.q[idx], self.scale[idx])

    def dequant(self, dtype=torch.float32) -> Tensor:
        return self.q.to(dtype) * self.scale[..., None, :].to(dtype)

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))

    def __repr__(self) -> str:
        return f"QTensor(int8 {self.shape})"


def quantize(w: Tensor) -> QTensor:
    """Symmetric per-output-channel int8 quantization of ``w [..., d_in,
    d_out]`` (absmax over the contracted d_in axis), on w's device.
    Divisions by tensors on that device, not by Python scalars: CUDA
    divides by a host scalar through its reciprocal."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2)
    scale = absmax / torch.tensor(127.0, device=w.device)
    scale = torch.where(scale == 0, torch.ones((), device=w.device), scale)
    q = torch.clamp(torch.round(w32 / scale[..., None, :]), -127, 127)
    return QTensor(q.to(torch.int8), scale)


def wdot(x: Tensor, w: Tensor | QTensor) -> Tensor:
    """``x @ w`` as an f32 result: against a :class:`QTensor` the int8
    product scaled per channel (K5 on the card), else the f32 product."""
    if isinstance(w, QTensor):
        return int8_serve.int8_wdot(x, w.q, w.scale)
    return torch.matmul(x.float(), w.float())


def _eligible(name: str, value) -> bool:
    if name == "lm_head/w":
        return True
    return (any(name.endswith(suffix) for suffix in _WEIGHT_SUFFIXES)
            and getattr(value, "ndim", 0) >= 2)


def quantize_params(params: Mapping[str, Tensor]) -> dict:
    """Quantize a trained store for serving: the attention, MLP and LM
    head weights (both layouts) become QTensor; embeddings and norm
    scales pass through."""
    return {name: quantize(value) if _eligible(name, value) else value
            for name, value in params.items()}


def is_quantized(params: Mapping) -> bool:
    return any(isinstance(v, QTensor) for v in params.values())


def store_bytes(params: Mapping, unquantized_itemsize: int = 2
                ) -> tuple[int, int]:
    """(bytes as is, bytes had nothing been quantized) of a store that may
    hold QTensor leaves; ``unquantized_itemsize`` is what a QTensor's
    weight would weigh per element unquantized (2: bf16 serving)."""
    as_is = dense = 0
    for value in params.values():
        if isinstance(value, QTensor):
            nq = value.q.numel()
            as_is += nq + value.scale.numel() * 4
            dense += nq * unquantized_itemsize
        else:
            b = value.numel() * value.element_size()
            as_is += b
            dense += b
    return as_is, dense
