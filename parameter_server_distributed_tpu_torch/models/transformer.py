"""Decoder-only Transformer LM, forward and training loss, in PyTorch: the
port of parameter_server_distributed_tpu/models/transformer.py.

Parameters stay a flat ``dict[str, Tensor]`` keyed by the JAX names
(``layer{i}/attn/wq``, ... or the stacked ``blocks/*`` layout), which is
what the PS protocol and checkpoints carry.  Functions take and return
the JAX layouts ([B, S, H, D] for attention), so the parity tests compare
like with like.

Numerics follow the reference: bf16 weights and activations, f32
accumulation, f32 norms, softmax and RoPE.  A bf16 ``torch.matmul``
accumulates in f32 and rounds once to bf16, which is what the reference's
``dot(..., preferred_element_type=f32).astype(bf16)`` does; where the
reference keeps the f32 product (a bias add before the cast, the logits),
the port multiplies in f32 (:func:`_dot_f32`).

Training: :meth:`Transformer.loss` is the mean next-token cross-entropy,
with the LM head in ``loss_chunk`` pieces under ``torch.utils.checkpoint``
when configured; ``remat`` checkpoints each layer (non-reentrant), and
``remat_policy="dots"`` keeps the projection products (``aten.mm``, the
matmuls with no batch dims) and recomputes the rest, as JAX's
``dots_with_no_batch_dims_saveable`` does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..device import resolve_device
from .quant import QTensor, is_quantized, wdot

Tensor = torch.Tensor

# where each unported capability is planned
ROADMAP_SPMD = "ROADMAP.md Queue 1, multi-device SPMD"
ROADMAP_MOE = "ROADMAP.md Queue 1, other model families (models/moe.py)"


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # grouped-query attention: K/V heads (0 = n_heads, MHA; 1 = MQA)
    n_kv_heads: int = 0
    n_layers: int = 6
    d_ff: int = 2048
    max_seq: int = 2048
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    # recompute each layer in the backward pass (torch.utils.checkpoint);
    # "full" saves nothing inside a layer, "dots" saves its projection
    # products; the serving forward does not read them
    remat: bool = False
    remat_policy: str = "full"
    # LM head + loss in seq chunks of this many positions, each recomputed
    # in the backward pass (0 = one pass over the whole sequence)
    loss_chunk: int = 0
    # mixture-of-experts fields are carried; moe_every > 0 is refused by
    # Transformer until models/moe.py is ported
    moe_every: int = 0
    moe_experts: int = 8
    moe_top_k: int = 1
    # stacked layout: block weights as blocks/<suffix> with a leading [L]
    scan_layers: bool = False
    moe_capacity: float = 1.25
    moe_aux_coef: float = 0.01
    # GPT-2-family knobs: learned positions, LayerNorm, biases
    pos_emb: str = "rope"         # rope | learned ("embed/pos" table)
    norm: str = "rms"             # rms | layernorm
    bias: bool = False
    norm_eps: float = 1e-6
    # gelu: w2(gelu(w1 x)); swiglu: w2(silu(w1 x) * (w3 x))
    mlp_act: str = "gelu"

    def __post_init__(self):
        if self.pos_emb not in ("rope", "learned"):
            raise ValueError(
                f"pos_emb must be 'rope' or 'learned', got {self.pos_emb!r}")
        if self.norm not in ("rms", "layernorm"):
            raise ValueError(
                f"norm must be 'rms' or 'layernorm', got {self.norm!r}")
        if self.mlp_act not in ("gelu", "swiglu"):
            raise ValueError(
                f"mlp_act must be 'gelu' or 'swiglu', got {self.mlp_act!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', "
                             f"got {self.remat_policy!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_groups(self) -> int:
        """Query heads per K/V head."""
        return self.n_heads // self.kv_heads

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_every > 0 and (i + 1) % self.moe_every == 0


def next_token_nll(logits: Tensor, tokens: Tensor) -> Tensor:
    """Mean next-token cross-entropy from full-sequence logits."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None]).mean()


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of matmuls with no batch dims (``torch.matmul`` of activations
    by a weight runs as ``aten.mm``), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dot(x: Tensor, w: Tensor) -> Tensor:
    """x @ w accumulated in f32, rounded once to x's type."""
    return torch.matmul(x, w)


def _dot_f32(x: Tensor, w: Tensor | QTensor) -> Tensor:
    """x @ w as an f32 result with no rounding to bf16 on the way (bf16
    products are exact in f32); an int8 QTensor ``w`` goes through
    :func:`models.quant.wdot`, the f32 product scaled per channel."""
    return wdot(x, w)


def _proj(x: Tensor, w: Tensor | QTensor, b: Tensor | None,
          dtype: torch.dtype) -> Tensor:
    """Projection (+ bias) cast once to ``dtype``: the bias is added to
    the f32 product before the one cast, as in the reference."""
    if b is not None:
        return (_dot_f32(x, w) + b.float()).to(dtype)
    if isinstance(w, QTensor):
        return _dot_f32(x, w).to(dtype)
    return _dot(x, w).to(dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * scale.float()).to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """Mean-centering LayerNorm with bias (the GPT-2-family norm)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary position embedding.  x: [..., seq, heads, head_dim]; rotated
    in f32 and cast back to x's type."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs   # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :]           # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def repeat_kv(x: Tensor, groups: int) -> Tensor:
    """[B, S, KV, D] -> [B, S, KV*groups, D], each K/V head repeated for
    its query group."""
    if groups == 1:
        return x
    return x.repeat_interleave(groups, dim=2)


def expand_gqa(q: Tensor, k: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
    """Repeat grouped-query K/V heads up to the query head count."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} must divide by "
                         f"kv heads {k.shape[2]}")
    groups = q.shape[2] // k.shape[2]
    return repeat_kv(k, groups), repeat_kv(v, groups)


def prepare_gqa_kv(q: Tensor, k: Tensor, v: Tensor,
                   n_tp: int) -> tuple[Tensor, Tensor]:
    """Validate GQA head grouping and, when the unexpanded kv_heads axis
    cannot be split over ``n_tp`` tensor-parallel shards (kv_heads % n_tp
    != 0), pre-expand K/V to the query head count; otherwise keep the
    small kv_heads-sized tensors."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} must divide by "
                         f"kv heads {k.shape[2]}")
    if n_tp > 1 and k.shape[2] % n_tp:
        k, v = expand_gqa(q, k, v)
    return k, v


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Reference dense attention.  q: [B, S, H, D], k/v: [B, S, H, D] or
    the GQA [B, S, KV, D] (expanded here) -> [B, S, H, D].  f32 scores and
    softmax; probabilities cast to v's type before the value product."""
    k, v = expand_gqa(q, k, v)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    s_q, s_k = q.shape[1], k.shape[1]
    mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def flash_attention_auto(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal attention through the flash kernel
    (ops/flash_attention.py) when the sequence divides by the blocks,
    dense :func:`causal_attention` otherwise.  GQA K/V stay unexpanded.
    ``PSDT_FLASH_BLOCK_Q`` / ``PSDT_FLASH_BLOCK_K`` (default 128) set the
    divisibility blocks; an empty value means unset."""
    from ..ops.flash_attention import flash_attention_gqa

    block_q = int(os.environ.get("PSDT_FLASH_BLOCK_Q") or "128")
    block_k = int(os.environ.get("PSDT_FLASH_BLOCK_K") or "128")
    seq = q.shape[1]
    if seq % block_q == 0 and seq % block_k == 0:
        return flash_attention_gqa(q, k, v, block_q=block_q,
                                   block_k=block_k)
    return causal_attention(q, k, v)


ATTENTION_CHOICES = ("dense", "flash")


def select_attention(name: str, mesh=None) -> Callable | None:
    """Attention implementation by name: ``dense`` (None — the model's
    default) or ``flash``.  The mesh variants and the sequence-parallel
    kinds of the reference are not ported yet."""
    if mesh is not None:
        raise NotImplementedError(f"attention over a mesh: {ROADMAP_SPMD}")
    if name == "dense":
        return None
    if name == "flash":
        return flash_attention_auto
    if name in ("xla_flash", "ring", "ulysses", "ulysses_flash",
                "ulysses_xla_flash"):
        raise NotImplementedError(f"--attention={name} is not ported yet: "
                                  f"{ROADMAP_SPMD}")
    raise ValueError(f"unknown attention {name!r}; options "
                     f"{ATTENTION_CHOICES} (the reference's others are "
                     f"planned in {ROADMAP_SPMD})")


def _default_attention() -> Callable:
    """``PSDT_FLASH_ATTENTION=1`` makes the flash kernel the model default
    where a CUDA card is present; dense attention otherwise."""
    if (os.environ.get("PSDT_FLASH_ATTENTION", "") not in ("", "0")
            and torch.cuda.is_available()):
        return flash_attention_auto
    return causal_attention


_BIAS_SUFFIXES = ("/bias", "/b1", "/b2", "/bq", "/bk", "/bv", "/bo")


class Transformer:
    def __init__(self, config: TransformerConfig,
                 attention_fn: Callable | None = None, mesh=None):
        if config.d_model % config.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if config.n_heads % config.kv_heads:
            raise ValueError(
                f"n_heads={config.n_heads} must divide by "
                f"n_kv_heads={config.kv_heads}")
        if config.moe_every > 0:
            raise NotImplementedError(f"MoE layers: {ROADMAP_MOE}")
        if mesh is not None:
            raise NotImplementedError(f"a mesh: {ROADMAP_SPMD}")
        self.config = config
        self.attention_fn = attention_fn or _default_attention()

    # ------------------------------------------------------------- shapes
    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        c = self.config
        shapes: dict[str, tuple[int, ...]] = {"embed/tok": (c.vocab, c.d_model)}
        if c.pos_emb == "learned":
            shapes["embed/pos"] = (c.max_seq, c.d_model)
        kv_dim = c.kv_heads * c.head_dim
        block = {"ln1/scale": (c.d_model,),
                 "attn/wq": (c.d_model, c.d_model),
                 "attn/wk": (c.d_model, kv_dim),
                 "attn/wv": (c.d_model, kv_dim),
                 "attn/wo": (c.d_model, c.d_model),
                 "ln2/scale": (c.d_model,)}
        if c.norm == "layernorm":
            block["ln1/bias"] = (c.d_model,)
            block["ln2/bias"] = (c.d_model,)
        if c.bias:
            block.update({"attn/bq": (c.d_model,), "attn/bk": (kv_dim,),
                          "attn/bv": (kv_dim,), "attn/bo": (c.d_model,)})
        block["mlp/w1"] = (c.d_model, c.d_ff)
        block["mlp/w2"] = (c.d_ff, c.d_model)
        if c.mlp_act == "swiglu":
            block["mlp/w3"] = (c.d_model, c.d_ff)
        if c.bias:
            block.update({"mlp/b1": (c.d_ff,), "mlp/b2": (c.d_model,)})
        if c.scan_layers:
            for suffix, shape in block.items():
                shapes[f"blocks/{suffix}"] = (c.n_layers, *shape)
        else:
            for i in range(c.n_layers):
                for suffix, shape in block.items():
                    shapes[f"layer{i}/{suffix}"] = shape
        shapes["final_ln/scale"] = (c.d_model,)
        if c.norm == "layernorm":
            shapes["final_ln/bias"] = (c.d_model,)
        shapes["lm_head/w"] = (c.d_model, c.vocab)
        return shapes

    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.param_shapes().values())

    def init_params(self, rng: torch.Generator | int = 0,
                    device=None) -> dict[str, Tensor]:
        """Fresh weights from ``rng`` (a seed or a ``torch.Generator`` on
        the target device), on ``device`` (default: the card).  Same
        scheme as the reference — unit norm scales, zero biases, N(0,
        0.02) embeddings, fan-in-scaled matrices with depth-scaled
        residual outputs — but a different random stream."""
        c = self.config
        dev = resolve_device(device)
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(rng)))
        params: dict[str, Tensor] = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("/scale"):
                params[name] = torch.ones(shape, dtype=c.dtype, device=dev)
            elif name.endswith(_BIAS_SUFFIXES):
                params[name] = torch.zeros(shape, dtype=c.dtype, device=dev)
            else:
                x = torch.randn(shape, generator=gen, dtype=c.dtype,
                                device=dev)
                if name in ("embed/tok", "embed/pos"):
                    scale = 0.02
                else:
                    scale = 1.0 / math.sqrt(shape[-2])
                    if name.endswith(("attn/wo", "mlp/w2")):
                        scale /= math.sqrt(2.0 * c.n_layers)
                params[name] = x * scale
        return params

    # ------------------------------------------------------------ forward
    def apply(self, params: Mapping[str, Tensor], tokens: Tensor) -> Tensor:
        """tokens [B, S] -> logits [B, S, vocab] float32."""
        h, _, _ = self._forward(params, tokens, collect_kv=False)
        return self.final_logits(params, h)

    def apply_collect_kv(self, params: Mapping[str, Tensor],
                         tokens: Tensor) -> tuple[Tensor, list]:
        """Forward that also returns each layer's post-rope (k, v) — the
        prefill half of KV-cached generation (models/generation.py)."""
        h, kvs, _ = self._forward(params, tokens, collect_kv=True)
        return self.final_logits(params, h), kvs

    # --- layer pieces shared by _forward and generation.decode_block ---
    def _norm(self, params: Mapping[str, Tensor], key: str,
              x: Tensor) -> Tensor:
        c = self.config
        if c.norm == "layernorm":
            return layer_norm(x, params[f"{key}/scale"],
                              params[f"{key}/bias"], c.norm_eps)
        return rms_norm(x, params[f"{key}/scale"], c.norm_eps)

    def qkv(self, params: Mapping[str, Tensor], prefix: str, h: Tensor,
            positions: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """ln1 -> q/k/v projections (+ biases) -> head split -> rope.
        h: [B, S, d].  K/V come back with ``kv_heads`` heads."""
        c = self.config
        batch, seq = h.shape[:2]
        x = self._norm(params, f"{prefix}/ln1", h)
        bias = c.bias
        q = _proj(x, params[f"{prefix}/attn/wq"],
                  params[f"{prefix}/attn/bq"] if bias else None, c.dtype)
        k = _proj(x, params[f"{prefix}/attn/wk"],
                  params[f"{prefix}/attn/bk"] if bias else None, c.dtype)
        v = _proj(x, params[f"{prefix}/attn/wv"],
                  params[f"{prefix}/attn/bv"] if bias else None, c.dtype)
        q = q.reshape(batch, seq, c.n_heads, c.head_dim)
        k = k.reshape(batch, seq, c.kv_heads, c.head_dim)
        v = v.reshape(batch, seq, c.kv_heads, c.head_dim)
        if c.pos_emb == "learned":
            return q, k, v
        return (rope(q, positions, c.rope_theta),
                rope(k, positions, c.rope_theta), v)

    def attn_residual(self, params: Mapping[str, Tensor], prefix: str,
                      h: Tensor, attn: Tensor) -> Tensor:
        """h + wo(attn) (+ bias).  attn: [B, S, H, D]."""
        c = self.config
        batch, seq = h.shape[:2]
        out = _proj(attn.reshape(batch, seq, c.d_model),
                    params[f"{prefix}/attn/wo"],
                    params[f"{prefix}/attn/bo"] if c.bias else None, c.dtype)
        return h + out

    def mlp_residual(self, params: Mapping[str, Tensor], prefix: str,
                     h: Tensor) -> Tensor:
        """h + w2(gelu(w1(ln2(h)))) (+ biases), or the SwiGLU form
        h + w2(silu(w1 x) * (w3 x)).  GELU is the tanh approximation, the
        reference's jax.nn.gelu default."""
        c = self.config
        x = self._norm(params, f"{prefix}/ln2", h)
        ff = _proj(x, params[f"{prefix}/mlp/w1"],
                   params[f"{prefix}/mlp/b1"] if c.bias else None, c.dtype)
        if c.mlp_act == "swiglu":
            up = _proj(x, params[f"{prefix}/mlp/w3"], None, c.dtype)
            ff = F.silu(ff) * up
        else:
            ff = F.gelu(ff, approximate="tanh")
        out = _proj(ff, params[f"{prefix}/mlp/w2"],
                    params[f"{prefix}/mlp/b2"] if c.bias else None, c.dtype)
        return h + out

    def layer_view(self, params: Mapping[str, Tensor],
                   layer: int) -> tuple[Mapping[str, Tensor], str]:
        """(param view, key prefix) for one layer in either layout."""
        if self.config.scan_layers:
            return ({f"blk/{name[len('blocks/'):]}": value[layer]
                     for name, value in params.items()
                     if name.startswith("blocks/")}, "blk")
        return params, f"layer{layer}"

    def ffn_residual(self, params: Mapping[str, Tensor], layer: int,
                     h: Tensor, decode: bool = False) -> tuple[Tensor, Tensor]:
        """The layer's dense FFN branch: (new_h, aux_loss = 0)."""
        lp, p = self.layer_view(params, layer)
        return (self.mlp_residual(lp, p, h),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def final_logits(self, params: Mapping[str, Tensor], h: Tensor) -> Tensor:
        h = self._norm(params, "final_ln", h)
        return _dot_f32(h, params["lm_head/w"])

    def embed(self, params: Mapping[str, Tensor], tokens: Tensor,
              positions: Tensor) -> Tensor:
        """Token (+ learned positional) embedding.  Positions clip into
        the table, as the reference's mode="clip" gather; the entry points
        reject real overflow before it reaches here."""
        h = params["embed/tok"][tokens.long()]
        if self.config.pos_emb == "learned":
            pos = positions.long().clamp(0, self.config.max_seq - 1)
            h = h + params["embed/pos"][pos].to(h.dtype)
        return h

    def _forward(self, params: Mapping[str, Tensor], tokens: Tensor,
                 collect_kv: bool) -> tuple[Tensor, list, Tensor]:
        c = self.config
        batch, seq = tokens.shape
        if c.pos_emb == "learned" and seq > c.max_seq:
            raise ValueError(
                f"sequence length {seq} exceeds the learned-position "
                f"table max_seq={c.max_seq}")
        positions = torch.arange(seq, dtype=torch.int32,
                                 device=tokens.device)[None].expand(batch, seq)
        h = self.embed(params, tokens, positions)
        kvs: list = []
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        # remat recomputes each layer in the backward pass; never combined
        # with collect_kv, which exists to save per-layer tensors
        remat = c.remat and not collect_kv and torch.is_grad_enabled()
        for i in range(c.n_layers):
            if remat:
                h, aux = checkpoint(self._remat_layer, params, i, h,
                                    positions, use_reentrant=False,
                                    context_fn=self._remat_context)
            else:
                h, aux, kv = self._layer(params, i, h, positions)
                if collect_kv:
                    kvs.append(kv)
            aux_total = aux_total + aux
        return h, kvs, aux_total

    def _layer(self, params: Mapping[str, Tensor], i: int, h: Tensor,
               positions: Tensor) -> tuple[Tensor, Tensor, tuple]:
        """One block: (new h, aux loss, post-rope (k, v)).  Under the
        stacked layout the layer's slice of ``blocks/*`` is taken here, so
        a checkpointed layer recomputes its own view."""
        lp, p = self.layer_view(params, i)
        q, k, v = self.qkv(lp, p, h, positions)
        # K/V go to the attention fn unexpanded (kv_heads-sized)
        attn = self.attention_fn(q, k, v)
        h = self.attn_residual(lp, p, h, attn)
        h, aux = self.ffn_residual(params, i, h)
        return h, aux, (k, v)

    def _remat_layer(self, params, i, h, positions):
        return self._layer(params, i, h, positions)[:2]

    def _remat_context(self):
        if self.config.remat_policy == "dots":
            return create_selective_checkpoint_contexts(_save_dots)
        return noop_context_fn()

    # ------------------------------------------------------------- loss
    def loss(self, params: Mapping[str, Tensor], batch) -> Tensor:
        """Mean next-token cross-entropy (f32 scalar).  batch: [B, S]
        integer tokens (or a (tokens,) tuple)."""
        if is_quantized(params):
            raise ValueError("training on an int8 (quantize_params) store is "
                             "not supported: quantization is a post-training "
                             "serving transform")
        tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
        # run the full sequence and drop the last position's logits
        h, _, aux = self._forward(params, tokens, collect_kv=False)
        if self.config.loss_chunk:
            nll = self._chunked_next_token_nll(params, h, tokens)
        else:
            nll = next_token_nll(self.final_logits(params, h), tokens)
        return nll + self.config.moe_aux_coef * aux

    def _chunked_next_token_nll(self, params: Mapping[str, Tensor],
                                h: Tensor, tokens: Tensor) -> Tensor:
        """Mean next-token NLL with the LM head computed in seq chunks of
        ``config.loss_chunk`` positions, each under
        ``torch.utils.checkpoint``: peak logits memory is O(chunk * vocab)
        instead of O(S * vocab), with the chunk recomputed in the backward
        pass.  Equal to the unchunked loss (tested)."""
        batch, seq = tokens.shape
        chunk = self.config.loss_chunk
        if seq % chunk:
            raise ValueError(f"loss_chunk={chunk} must divide seq len {seq}")
        # shift targets; the final position has no target (masked out)
        targets = torch.cat([tokens[:, 1:], tokens.new_zeros((batch, 1))],
                            dim=1)
        valid = (torch.arange(seq, device=h.device) < seq - 1).float()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for start in range(0, seq, chunk):
            part = (h[:, start:start + chunk], targets[:, start:start + chunk],
                    valid[start:start + chunk])
            if torch.is_grad_enabled():
                total = total + checkpoint(self._chunk_nll_sum, params, *part,
                                           use_reentrant=False)
            else:
                total = total + self._chunk_nll_sum(params, *part)
        return total / (batch * (seq - 1))

    def _chunk_nll_sum(self, params: Mapping[str, Tensor], h_c: Tensor,
                       t_c: Tensor, v_c: Tensor) -> Tensor:
        logp = torch.log_softmax(self.final_logits(params, h_c), dim=-1)
        nll = -logp.gather(-1, t_c[..., None].long())[..., 0]
        return (nll * v_c[None, :]).sum()


def stack_layers(params: Mapping[str, Tensor], n_layers: int) -> dict:
    """Unrolled store (``layer<i>/<suffix>``) -> stacked ``blocks/<suffix>``
    with a leading [L] (a QTensor's codes and scales stacked alike).
    Dense layers only."""
    out: dict = {}
    by_suffix: dict[str, list] = {}
    for i in range(n_layers):
        prefix = f"layer{i}/"
        for name, value in params.items():
            if name.startswith(prefix):
                by_suffix.setdefault(name[len(prefix):], []).append(value)
    for suffix, values in by_suffix.items():
        if len(values) != n_layers:
            raise ValueError(
                f"suffix {suffix!r} present in {len(values)}/{n_layers} "
                f"layers — stacking requires homogeneous blocks")
        if isinstance(values[0], QTensor):
            out[f"blocks/{suffix}"] = QTensor(
                torch.stack([v.q for v in values]),
                torch.stack([v.scale for v in values]))
        else:
            out[f"blocks/{suffix}"] = torch.stack(values)
    for name, value in params.items():
        if not name.startswith("layer"):
            out[name] = value
    return out


def unstack_layers(params: Mapping[str, Tensor]) -> dict:
    """Inverse of :func:`stack_layers`."""
    out: dict = {}
    for name, value in params.items():
        if name.startswith("blocks/"):
            suffix = name[len("blocks/"):]
            for i in range(value.shape[0]):
                out[f"layer{i}/{suffix}"] = value[i]
        else:
            out[name] = value
    return out


def small_lm(vocab: int = 1024, seq: int = 256, dtype=torch.float32,
             remat: bool = False, scan_layers: bool = False,
             n_layers: int = 2) -> Transformer:
    """Test-scale LM (``small_lm4`` in the registry is the 4-layer
    variant)."""
    return Transformer(TransformerConfig(
        vocab=vocab, d_model=128, n_heads=4, n_layers=n_layers, d_ff=512,
        max_seq=seq, dtype=dtype, remat=remat, scan_layers=scan_layers))


def tiny_lm(vocab: int = 1024, seq: int = 256, dtype=torch.float32,
            remat: bool = False, scan_layers: bool = False) -> Transformer:
    """1-layer draft-scale LM."""
    return Transformer(TransformerConfig(
        vocab=vocab, d_model=64, n_heads=2, n_layers=1, d_ff=256,
        max_seq=seq, dtype=dtype, remat=remat, scan_layers=scan_layers))


def lm_350m(vocab: int = 32000, seq: int = 1024, dtype=torch.bfloat16,
            remat: bool = True, scan_layers: bool = False,
            kv_heads: int = 0, n_heads: int = 16,
            remat_policy: str = "full") -> Transformer:
    """~370M-param GPT-style flagship: 24 layers, d_model 1024, GELU MLP
    d_ff 4096; ``kv_heads`` switches to GQA, ``n_heads=8`` gives
    head_dim 128."""
    return Transformer(TransformerConfig(
        vocab=vocab, d_model=1024, n_heads=n_heads, n_layers=24, d_ff=4096,
        n_kv_heads=kv_heads, remat_policy=remat_policy,
        max_seq=seq, dtype=dtype, remat=remat, scan_layers=scan_layers,
        loss_chunk=math.gcd(128, seq)))


def llama_350m(vocab: int = 32000, seq: int = 1024, dtype=torch.bfloat16,
               remat: bool = True, scan_layers: bool = False,
               kv_heads: int = 4,
               remat_policy: str = "full") -> Transformer:
    """LLaMA-architecture sibling of :func:`lm_350m` (~334M params):
    SwiGLU with d_ff 2816, GQA kv_heads=4, RoPE/RMSNorm."""
    return Transformer(TransformerConfig(
        vocab=vocab, d_model=1024, n_heads=16, n_layers=24, d_ff=2816,
        n_kv_heads=kv_heads, mlp_act="swiglu", remat_policy=remat_policy,
        max_seq=seq, dtype=dtype, remat=remat, scan_layers=scan_layers,
        loss_chunk=math.gcd(128, seq)))
