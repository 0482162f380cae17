"""KV-cached autoregressive generation in PyTorch: the port of what
serving needs from parameter_server_distributed_tpu/models/generation.py.

The reference jits a prefill and a ``lax.scan`` decode loop and donates
the cache buffers.  PyTorch runs eagerly, so there is no compiled runner:
the prefill is one full-sequence forward, decoding is a host loop of
single-token forwards, and the cache is updated in place (slice
assignment and ``index_put_``) instead of being donated and rebuilt.

Sampling takes explicit ``torch.Generator``s.  Greedy decoding is
token-exact against the reference; sampled streams follow the same
distribution from a different random stream.

``cache_dtype="int8"`` keeps the cache as int8 codes with an f32 scale a
(position, head) (:class:`QuantKVCache`).  On the card its writes are the
``kv_quantize`` kernel and a decode block's attention against it the
``decode_attention_int8`` kernel (ops/int8_serve.py, K7 and K6), which
read only int8 bytes up to each row's limit; on the CPU their plain
versions run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np
import torch

from ..device import check_on_device, resolve_device
from ..ops import int8_serve
from .transformer import Transformer

Tensor = torch.Tensor


@dataclasses.dataclass
class KVCache:
    """Per-layer key/value cache.  k/v: [L, B, max_len, KV, D]; length is
    the number of valid positions (non-ragged decoding)."""
    k: Tensor
    v: Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


@dataclasses.dataclass
class QuantKVCache:
    """int8 KV cache: k/v int8 [L, B, max_len, KV, D] with a per-(position,
    head) f32 absmax scale [L, B, max_len, KV].  Decode at long context
    is bound by the cache bytes each step reads; int8 codes nearly halve
    them against bf16 (the scales add 4/D bytes an element)."""
    k: Tensor
    v: Tensor
    k_scale: Tensor
    v_scale: Tensor
    length: int

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def _kv_quantize(k: Tensor, v: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Symmetric int8 over the head dim (last axis) of ``k`` and ``v``
    ``[..., S, KV, D]``: (k8, v8, k_scale, v_scale), one launch of the
    ``kv_quantize`` kernel on the card."""
    lead = k.shape[:-3]
    flat = (-1, *k.shape[-3:])
    k8, v8, ks, vs = int8_serve.kv_quantize_rows(
        k.reshape(flat).contiguous(), v.reshape(flat).contiguous())
    return (k8.reshape(*lead, *k8.shape[1:]),
            v8.reshape(*lead, *v8.shape[1:]),
            ks.reshape(*lead, *ks.shape[1:]),
            vs.reshape(*lead, *vs.shape[1:]))


def init_cache(model: Transformer, batch: int, max_len: int,
               cache_dtype: str = "native", device=None
               ) -> KVCache | QuantKVCache:
    c = model.config
    if cache_dtype not in ("native", "int8"):
        raise ValueError(
            f"cache_dtype must be 'native' or 'int8', got {cache_dtype!r}")
    dev = resolve_device(device)
    # GQA: the cache stores kv_heads, expanded to the query heads only
    # inside the attention product
    shape = (c.n_layers, batch, max_len, c.kv_heads, c.head_dim)
    if cache_dtype == "int8":
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            length=0)
    return KVCache(k=torch.zeros(shape, dtype=c.dtype, device=dev),
                   v=torch.zeros(shape, dtype=c.dtype, device=dev),
                   length=0)


def check_position_budget(model: Transformer, prompt_len: int,
                          max_new_tokens: int) -> None:
    """Reject generations that would run past a learned-position table."""
    c = model.config
    if c.pos_emb == "learned" and prompt_len + max_new_tokens > c.max_seq:
        raise ValueError(
            f"prompt {prompt_len} + max_new {max_new_tokens} exceeds the "
            f"learned-position table max_seq={c.max_seq}")


def check_token_ids(model: Transformer, tokens) -> None:
    """Reject token ids outside [0, vocab) before they reach the embedding
    gather, where the card would fault on them (the reference's gather
    clamps them silently)."""
    tokens = np.asarray(tokens)
    if tokens.size and (tokens.min() < 0 or tokens.max() >= model.config.vocab):
        raise ValueError(f"token ids must lie in [0, {model.config.vocab}), "
                         f"got [{tokens.min()}, {tokens.max()}]")


def prefill(model: Transformer, params: Mapping[str, Tensor], tokens: Tensor,
            max_len: int, cache_dtype: str = "native",
            ) -> tuple[Tensor, KVCache | QuantKVCache]:
    """Run the prompt through the full-sequence forward; returns the last
    position's logits [B, vocab] and a cache holding the prompt's K/V
    (quantized on write when ``cache_dtype="int8"``)."""
    batch, prompt_len = tokens.shape
    if prompt_len > max_len:
        raise ValueError(f"prompt {prompt_len} exceeds cache {max_len}")
    logits, kvs = model.apply_collect_kv(params, tokens)
    cache = init_cache(model, batch, max_len, cache_dtype,
                       device=tokens.device)
    if isinstance(cache, QuantKVCache):
        rows = _kv_quantize(torch.stack([k for k, _ in kvs]),
                            torch.stack([v for _, v in kvs]))
        for dst, src in zip((cache.k, cache.v, cache.k_scale,
                             cache.v_scale), rows):
            dst[:, :, :prompt_len] = src
        cache.length = prompt_len
        return logits[:, -1], cache
    for i, (k, v) in enumerate(kvs):
        cache.k[i, :, :prompt_len] = k
        cache.v[i, :, :prompt_len] = v
    cache.length = prompt_len
    return logits[:, -1], cache


def decode_block(model: Transformer, params: Mapping[str, Tensor],
                 tokens: Tensor, cache: KVCache | QuantKVCache,
                 lengths: Tensor | None = None
                 ) -> tuple[Tensor, KVCache | QuantKVCache]:
    """Forward a block of ``tokens`` [B, T] against the cache at positions
    length..length+T-1, causally masked within the block.  Returns (logits
    [B, T, vocab] f32, the cache) — the cache is written in place, and its
    length advances by T.

    ``lengths`` [B] switches to ragged mode: row b writes at its own
    positions lengths[b].. and attends within its own prefix; cache.length
    is left alone.  Writes past max_len are dropped, not clamped (the
    reference's mode="drop"): a retired serving lane keeps advancing.

    An int8 cache (:class:`QuantKVCache`) takes the block's K/V through
    ``kv_quantize`` and its attention through ``decode_attention_int8``
    (ops/int8_serve.py), one launch of each a layer on the card."""
    c = model.config
    batch, t = tokens.shape
    dev = tokens.device
    max_len = cache.max_len
    quant = isinstance(cache, QuantKVCache)
    offsets = torch.arange(t, dtype=torch.int64, device=dev)
    if lengths is not None:
        lengths = lengths.to(device=dev, dtype=torch.int64).contiguous()
        positions = lengths[:, None] + offsets
        base = 0
    else:
        pos = base = cache.length
        if pos + t > max_len:
            raise ValueError(f"decode block at {pos}+{t} overruns cache "
                             f"{max_len}")
        positions = (pos + offsets)[None].expand(batch, t)
    if not quant:
        # row b's query j may attend its cache positions 0..positions[b, j]
        slots = torch.arange(max_len, device=dev)
        mask = (slots[None, None, :] <= positions[:, :, None])[:, None, None]
        if lengths is not None:
            # index_put_ raises on out-of-range positions: keep the
            # in-range writes (one host sync per block, shared by every
            # layer)
            keep = (positions < max_len).reshape(-1).nonzero().squeeze(1)
            rows = torch.arange(batch, device=dev)[:, None].expand(batch, t)
            w_rows = rows.reshape(-1)[keep]
            w_pos = positions.reshape(-1)[keep]
    h = model.embed(params, tokens, positions)
    for i in range(c.n_layers):
        lp, p = model.layer_view(params, i)
        q, k, v = model.qkv(lp, p, h, positions)   # k/v: [B, T, KV, D]
        if quant:
            layer = (cache.k[i], cache.v[i], cache.k_scale[i],
                     cache.v_scale[i])
            int8_serve.kv_quantize(k.contiguous(), v.contiguous(), *layer,
                                   lengths=lengths, base=base)
            attn = int8_serve.decode_attention_int8(
                q.contiguous(), *layer, lengths=lengths, base=base)
        else:
            if lengths is not None:
                cache.k[i].index_put_((w_rows, w_pos),
                                      k.reshape(batch * t, *k.shape[2:])[keep])
                cache.v[i].index_put_((w_rows, w_pos),
                                      v.reshape(batch * t, *v.shape[2:])[keep])
            else:
                cache.k[i, :, pos:pos + t] = k
                cache.v[i, :, pos:pos + t] = v
            attn = _cached_attention(c, q, cache.k[i], cache.v[i], mask)
        h = model.attn_residual(lp, p, h, attn)
        h, _ = model.ffn_residual(params, i, h, decode=True)
    logits = model.final_logits(params, h)
    if lengths is None:
        cache.length = pos + t
    return logits, cache


def _cached_attention(c, q: Tensor, k: Tensor, v: Tensor,
                      mask: Tensor) -> Tensor:
    """Dense attention of q [B, T, H, D] against a native cache layer
    [B, max_len, KV, D], f32 scores and softmax: query-head groups
    contract against their unexpanded kv head."""
    b, s_q = q.shape[:2]
    qg = q.reshape(b, s_q, c.kv_heads, c.kv_groups, c.head_dim)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(c.head_dim)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(c.dtype)
    attn = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(),
                        v.float()).to(c.dtype)
    return attn.reshape(b, s_q, c.n_heads, c.head_dim)


def decode_step(model: Transformer, params: Mapping[str, Tensor],
                token: Tensor, cache: KVCache) -> tuple[Tensor, KVCache]:
    """One single-token forward against the cache.  token: [B] ->
    (logits [B, vocab] float32, the cache)."""
    logits, cache = decode_block(model, params, token[:, None], cache)
    return logits[:, 0], cache


def _truncate_logits(logits: Tensor, top_k: int, top_p: float) -> Tensor:
    """Top-k and/or nucleus truncation on temperature-scaled logits."""
    top_k = min(top_k, logits.shape[-1])   # top_k > vocab = no truncation
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cumulative = torch.cumsum(probs, dim=-1)
        # keep a token while the mass BEFORE it is < top_p (the argmax
        # token is always kept); cut logits below the smallest kept one
        keep = (cumulative - probs) < top_p
        kth = torch.where(keep, sorted_desc,
                          torch.full_like(sorted_desc, float("inf"))
                          ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def _categorical(logits: Tensor, gen: torch.Generator) -> Tensor:
    """One draw per row from softmax(logits): argmax of logits - log(E),
    E ~ Exp(1) (the Gumbel-max trick)."""
    noise = torch.empty(logits.shape, dtype=torch.float32,
                        device=logits.device).exponential_(generator=gen)
    return torch.argmax(logits.float() - noise.log(), dim=-1)


def sample_token(logits: Tensor, gen: torch.Generator,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0) -> Tensor:
    """Greedy when temperature == 0; otherwise temperature sampling,
    optionally truncated to the top_k logits and/or the nucleus."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _truncate_logits(logits / temperature, top_k, top_p)
    return _categorical(logits, gen).to(torch.int32)


def sample_token_rowwise(logits: Tensor, gen: torch.Generator, temps: Tensor,
                         top_k: int = 0, top_p: float = 0.0) -> Tensor:
    """Per-row temperature: row i is greedy when ``temps[i] == 0`` and
    temperature-sampled otherwise (top_k/top_p shared by all rows).
    logits: [B, V]; temps: [B]."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = _categorical(_truncate_logits(scaled, top_k, top_p), gen)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


@torch.inference_mode()
def generate(model: Transformer, params: Mapping[str, Tensor], prompt,
             max_new_tokens: int, *, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 0.0,
             rng: torch.Generator | int = 0, cache_dtype: str = "native",
             device=None) -> Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, S].
    Returns [B, max_new_tokens] int32 on ``device`` (default: the card;
    ``params`` must lie there)."""
    dev = resolve_device(device)
    check_on_device(params, dev)
    prompt = torch.as_tensor(prompt)      # a list, an array or a tensor
    check_token_ids(model, prompt.cpu())
    prompt = prompt.to(dev)
    check_position_budget(model, int(prompt.shape[1]), max_new_tokens)
    gen = (rng if isinstance(rng, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(rng)))
    max_len = prompt.shape[1] + max_new_tokens
    logits, cache = prefill(model, params, prompt, max_len, cache_dtype)
    token = sample_token(logits, gen, temperature, top_k, top_p)
    out = [token]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(model, params, token, cache)
        token = sample_token(logits, gen, temperature, top_k, top_p)
        out.append(token)
    return torch.stack(out, dim=1)
