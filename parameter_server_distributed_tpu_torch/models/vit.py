"""Vision Transformer (ViT): the port of
parameter_server_distributed_tpu/models/vit.py.

Non-overlapping patches linearly embedded, a learned [CLS] token and
learned positions, pre-norm encoder blocks with bidirectional attention,
and a linear head on the [CLS] token (``pool="cls"``) or on the mean of
the patch tokens (``pool="mean"``).  The store's names and shapes are
the reference's (``layer<i>/attn/wq`` ... ``mlp/w2``, ``lm_head/w`` for
the classifier), and so is the arithmetic: products as f32 results
(:func:`~.quant.wdot`) cast to the model dtype, RMS norms
(:func:`~.transformer.rms_norm`), f32 attention logits and softmax, and
the tanh approximation of GELU (``jax.nn.gelu``'s default, not
``F.gelu``'s).  A patch vector is ordered (row, column, channel) within
its patch, as the reference's ``_patchify``, so ``patch/w`` means the
same in both packages.  The attention is an unmasked product of plain
torch ops: the reference's is an XLA einsum, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import Tensor

from ..device import resolve_device
from .quant import wdot
from .transformer import rms_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    num_classes: int = 10
    d_model: int = 192
    n_heads: int = 3
    n_layers: int = 6
    d_ff: int = 768
    dtype: torch.dtype = torch.float32
    norm_eps: float = 1e-6
    # classifier input: the [CLS] token ("cls") or the mean of the patch
    # tokens ("mean")
    pool: str = "cls"

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(f"image_size {self.image_size} must divide by "
                             f"patch_size {self.patch_size}")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got "
                             f"{self.pool!r}")

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + 1  # + [CLS]

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def bidirectional_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Unmasked attention, every patch on every patch: q, k, v [B, S, H,
    D] -> [B, S, H, D] in v's dtype, f32 logits and softmax."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


class ViT:
    def __init__(self, config: ViTConfig):
        self.config = config

    # ------------------------------------------------------------ params
    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        c = self.config
        patch_dim = c.patch_size * c.patch_size * c.channels
        shapes: dict[str, tuple[int, ...]] = {
            "patch/w": (patch_dim, c.d_model),
            "patch/bias": (c.d_model,),
            "embed/cls": (1, 1, c.d_model),
            "embed/pos": (c.seq_len, c.d_model),
        }
        for i in range(c.n_layers):
            p = f"layer{i}"
            shapes[f"{p}/ln1/scale"] = (c.d_model,)
            shapes[f"{p}/attn/wq"] = (c.d_model, c.d_model)
            shapes[f"{p}/attn/wk"] = (c.d_model, c.d_model)
            shapes[f"{p}/attn/wv"] = (c.d_model, c.d_model)
            shapes[f"{p}/attn/wo"] = (c.d_model, c.d_model)
            shapes[f"{p}/ln2/scale"] = (c.d_model,)
            shapes[f"{p}/mlp/w1"] = (c.d_model, c.d_ff)
            shapes[f"{p}/mlp/w2"] = (c.d_ff, c.d_model)
        shapes["final_ln/scale"] = (c.d_model,)
        shapes["lm_head/w"] = (c.d_model, c.num_classes)  # classifier
        return shapes

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def init_params(self, rng: torch.Generator | int = 0,
                    device=None) -> dict[str, Tensor]:
        """Fresh weights from ``rng`` (a seed or a ``torch.Generator`` on
        the target device), on ``device`` (default: the card): norm
        scales one, the patch bias and [CLS] zero, positions N(0, 0.02²),
        every other matrix N(0, 1/fan_in)."""
        c = self.config
        dev = resolve_device(device)
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(rng)))
        params: dict[str, Tensor] = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("/scale"):
                params[name] = torch.ones(shape, dtype=c.dtype, device=dev)
                continue
            if name.endswith(("/bias", "cls")):
                params[name] = torch.zeros(shape, dtype=c.dtype, device=dev)
                continue
            noise = torch.randn(shape, generator=gen, dtype=c.dtype,
                                device=dev)
            if name == "embed/pos":
                params[name] = noise * 0.02
            else:
                fan_in = shape[0] if len(shape) > 1 else shape[-1]
                params[name] = noise / math.sqrt(fan_in)
        return params

    # ----------------------------------------------------------- forward
    def _patchify(self, x: Tensor) -> Tensor:
        """[B, H, W, C] images -> [B, N, patch*patch*C] patch vectors."""
        c = self.config
        b = x.shape[0]
        g = c.image_size // c.patch_size
        x = x.reshape(b, g, c.patch_size, g, c.patch_size, c.channels)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, g * g, c.patch_size * c.patch_size * c.channels)

    def apply(self, params: Mapping[str, Tensor], x: Tensor) -> Tensor:
        """NHWC images -> f32 logits [batch, classes]."""
        c = self.config
        h = wdot(self._patchify(x.to(c.dtype)), params["patch/w"])
        h = (h + params["patch/bias"].float()).to(c.dtype)
        cls = params["embed/cls"].expand(h.shape[0], 1, c.d_model)
        h = torch.cat([cls, h], dim=1) + params["embed/pos"]
        shape = (h.shape[0], c.seq_len, c.n_heads, c.head_dim)
        for i in range(c.n_layers):
            p = f"layer{i}"
            y = rms_norm(h, params[f"{p}/ln1/scale"], c.norm_eps)
            q = wdot(y, params[f"{p}/attn/wq"]).to(c.dtype)
            k = wdot(y, params[f"{p}/attn/wk"]).to(c.dtype)
            v = wdot(y, params[f"{p}/attn/wv"]).to(c.dtype)
            attn = bidirectional_attention(q.reshape(shape),
                                           k.reshape(shape),
                                           v.reshape(shape))
            attn = attn.reshape(h.shape[0], c.seq_len, c.d_model)
            h = h + wdot(attn, params[f"{p}/attn/wo"]).to(c.dtype)
            y = rms_norm(h, params[f"{p}/ln2/scale"], c.norm_eps)
            ff = F.gelu(wdot(y, params[f"{p}/mlp/w1"]).to(c.dtype),
                        approximate="tanh")
            h = h + wdot(ff, params[f"{p}/mlp/w2"]).to(c.dtype)
        h = rms_norm(h, params["final_ln/scale"], c.norm_eps)
        pooled = h[:, 0] if c.pool == "cls" else h[:, 1:].mean(dim=1)
        return wdot(pooled, params["lm_head/w"])

    def loss(self, params: Mapping[str, Tensor], batch) -> Tensor:
        """Mean softmax cross-entropy over the batch ``(x, y)``: images
        [B, H, W, C] and int labels [B]."""
        x, y = batch
        logp = F.log_softmax(self.apply(params, x), dim=-1)
        return -logp.gather(-1, y.long()[:, None]).mean()


def vit_tiny(num_classes: int = 10, image_size: int = 32,
             dtype: torch.dtype = torch.float32) -> ViT:
    """ViT-Ti-ish at CIFAR scale: 6 layers, d_model 192, patch 4."""
    return ViT(ViTConfig(image_size=image_size, patch_size=4,
                         num_classes=num_classes, d_model=192, n_heads=3,
                         n_layers=6, d_ff=768, dtype=dtype))


def vit_s16(num_classes: int = 1000, image_size: int = 224,
            dtype: torch.dtype = torch.bfloat16) -> ViT:
    """ViT-S/16 (ImageNet scale): 12 layers, d_model 384, patch 16."""
    return ViT(ViTConfig(image_size=image_size, patch_size=16,
                         num_classes=num_classes, d_model=384, n_heads=6,
                         n_layers=12, d_ff=1536, dtype=dtype))
