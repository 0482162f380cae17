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

Beam search and speculative decoding follow the reference's math.  The
reference's jitted ``lax.scan`` and ``lax.while_loop`` runners are Python
loops over ``decode_block`` here: a speculative segment reads ``n_out``
on the host once a round to decide whether to go on, and a rejection
rolls back by moving ``cache.length`` (batch 1) or the per-row lengths
(batched).  Sampled acceptance draws from a ``torch.Generator`` whose
state the segment carry holds, so a segment is a function of its carry,
as the reference's is of its key.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import OrderedDict
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
    So are writes at negative positions, which the reference wraps to
    the end of the row: a never-used lane's draft catch-up writes at -1
    (ROADMAP.md Queue 3).

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
            # index_put_ raises past the end and wraps a negative
            # position: keep the writes in [0, max_len) (one host sync
            # per block, shared by every layer)
            keep = ((positions >= 0) & (positions < max_len)).reshape(
                -1).nonzero().squeeze(1)
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


def _prompt_on(model: Transformer, prompt, dev: torch.device) -> Tensor:
    """``prompt`` (a list, an array or a tensor) as a [B, S] tensor on
    ``dev``, its ids checked against the vocab."""
    prompt = torch.as_tensor(prompt)
    check_token_ids(model, prompt.cpu())
    return prompt.to(dev)


# ------------------------------------------------------------- beam search
@torch.inference_mode()
def beam_search(model: Transformer, params: Mapping[str, Tensor], prompt,
                max_new_tokens: int, beam_width: int = 4,
                eos_id: int | None = None, length_penalty: float = 0.0,
                device=None) -> tuple[Tensor, Tensor]:
    """Fixed-length beam search over ``max_new_tokens`` continuations of
    ``prompt`` [B, S], on a native cache: keeps the ``beam_width`` highest
    joint-log-prob prefixes each step.  Beams live interleaved in the
    cache's batch dimension (row b*W + j) and each step gathers the cache
    rows onto the surviving beams.  Returns (tokens [B, max_new], joint
    log-prob [B]) of each item's best beam; ``beam_width=1`` is greedy
    decoding.  With ``eos_id`` a beam that emits it finishes: it may only
    continue with EOS at log-prob 0, so its score freezes and it stays
    comparable against live beams.  ``length_penalty`` alpha > 0 divides
    each final score by ((5 + len) / 6) ** alpha (GNMT) at the final
    selection only."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    vocab = model.config.vocab
    if not 1 <= beam_width <= vocab:
        raise ValueError(f"beam_width={beam_width} must be in "
                         f"[1, vocab={vocab}]")
    if eos_id is not None and not 0 <= eos_id < vocab:
        raise ValueError(f"eos_id={eos_id} outside vocab {vocab}")
    dev = resolve_device(device)
    check_on_device(params, dev)
    prompt = _prompt_on(model, prompt, dev)
    b, s = prompt.shape
    check_position_budget(model, int(s), max_new_tokens)
    w = beam_width
    logits, cache = prefill(model, params, prompt, s + max_new_tokens)
    scores, first = torch.topk(torch.log_softmax(logits, dim=-1), w)
    first = first.to(torch.int32)
    finished = (torch.zeros((b, w), dtype=torch.bool, device=dev)
                if eos_id is None else first == eos_id)
    lengths = torch.ones((b, w), dtype=torch.int32, device=dev)
    cache = KVCache(k=cache.k.repeat_interleave(w, dim=1),
                    v=cache.v.repeat_interleave(w, dim=1),
                    length=cache.length)
    seqs = torch.zeros((b, w, max_new_tokens), dtype=torch.int32, device=dev)
    seqs[:, :, 0] = first
    if eos_id is not None:
        pad = torch.full((vocab,), float("-inf"), device=dev)
        pad[eos_id] = 0.0
    base = (torch.arange(b, device=dev) * w)[:, None]
    for i in range(1, max_new_tokens):
        logits, cache = decode_step(model, params,
                                    seqs[:, :, i - 1].reshape(b * w), cache)
        logp = torch.log_softmax(logits, dim=-1).reshape(b, w, vocab)
        if eos_id is not None:
            logp = torch.where(finished[:, :, None], pad, logp)
        scores, flat = torch.topk((scores[:, :, None] + logp).reshape(
            b, w * vocab), w)
        parent = flat // vocab
        token = (flat % vocab).to(torch.int32)
        # reorder the histories and the cache rows onto the winning beams
        seqs = torch.gather(seqs, 1, parent[:, :, None].expand(
            b, w, max_new_tokens)).clone()
        seqs[:, :, i] = token
        finished = torch.gather(finished, 1, parent)
        # a finished beam keeps its length; a live one (one finishing now
        # included: its EOS counts) is i + 1 tokens long
        lengths = torch.where(finished, torch.gather(lengths, 1, parent),
                              i + 1)
        if eos_id is not None:
            finished = finished | (token == eos_id)
        rows = (base + parent).reshape(-1)
        cache = KVCache(k=cache.k.index_select(1, rows),
                        v=cache.v.index_select(1, rows), length=cache.length)
    if length_penalty:
        lp = ((5.0 + lengths.float()) / 6.0) ** float(length_penalty)
        best = torch.argmax(scores / lp, dim=1)
    else:
        best = torch.argmax(scores, dim=1)
    items = torch.arange(b, device=dev)
    return seqs[items, best], scores[items, best]


# ------------------------------------------------ speculative decoding
def accept_or_resample(p: np.ndarray, q: np.ndarray, x: int,
                       rng: np.random.Generator) -> tuple[int, bool]:
    """The speculative-sampling rejection rule (Leviathan/Chen): accept
    draft token ``x`` (drawn from q) with probability min(1, p[x]/q[x]);
    on reject, sample from the residual normalize(max(p - q, 0)).  Over
    x ~ q and this rule, the returned token is distributed as p.  Returns
    (token, accepted)."""
    if rng.uniform() < min(1.0, float(p[x]) / max(float(q[x]), 1e-20)):
        return x, True
    residual = np.maximum(p - q, 0.0)
    total = residual.sum()
    if total <= 0.0:   # p == q: acceptance was certain, but guard anyway
        return int(rng.choice(len(p), p=p / p.sum())), False
    return int(rng.choice(len(p), p=residual / total)), False


def _check_draft(target: Transformer, draft: Transformer,
                 draft_len: int) -> None:
    if target.config.vocab != draft.config.vocab:
        raise ValueError(
            f"vocab mismatch: target {target.config.vocab} vs draft "
            f"{draft.config.vocab}")
    if draft_len < 1:
        raise ValueError("draft_len must be >= 1")


@torch.inference_mode()
def speculative_generate(target: Transformer, target_params,
                         draft: Transformer, draft_params, prompt,
                         max_new_tokens: int, *, draft_len: int = 4,
                         temperature: float = 0.0, seed: int = 0,
                         device=None) -> tuple[Tensor, dict]:
    """Batch-1 speculative decoding, the host-loop form: the ``draft``
    proposes ``draft_len`` tokens one step at a time, the ``target``
    verifies them in one ``decode_block`` of draft_len + 1 tokens, and
    the longest agreeing prefix plus the target's own next token commit.
    A rejection rolls back by moving ``cache.length``: the stale entries
    past it are masked and overwritten.  ``temperature=0`` is greedy and
    token-exact against the target's greedy decoding; ``temperature>0``
    applies :func:`accept_or_resample` with a numpy Generator seeded with
    ``seed``.  Returns (tokens [1, max_new] int32, stats: verify calls,
    draft accept rate, tokens per target forward)."""
    dev = resolve_device(device)
    check_on_device(target_params, dev)
    check_on_device(draft_params, dev)
    prompt = _prompt_on(target, prompt, dev)
    if prompt.shape[0] != 1:
        raise ValueError("speculative decoding is batch-1 (per-row "
                         "acceptance lengths diverge)")
    _check_draft(target, draft, draft_len)
    s = int(prompt.shape[1])
    # + draft_len + 1: a verify block may run past the committed length
    # before rolling back
    check_position_budget(target, s, max_new_tokens + draft_len + 1)
    check_position_budget(draft, s, max_new_tokens + draft_len + 1)
    sampling = temperature > 0.0
    host_rng = np.random.default_rng(seed)

    def host_probs(logits_row: Tensor) -> np.ndarray:
        p = torch.softmax(logits_row / temperature, dim=-1).cpu().numpy()
        p = p.astype(np.float64)
        return p / p.sum()

    def one(tok: int) -> Tensor:
        return torch.tensor([tok], dtype=torch.int32, device=dev)

    max_len = s + max_new_tokens + draft_len + 1
    t_logits, t_cache = prefill(target, target_params, prompt, max_len)
    _, d_cache = prefill(draft, draft_params, prompt, max_len)
    if sampling:
        p0 = host_probs(t_logits[0])
        cur = int(host_rng.choice(len(p0), p=p0))
    else:
        cur = int(torch.argmax(t_logits[0]))
    out = [cur]
    pending: list[int] = []   # committed tokens not yet in the draft cache
    verify_calls = accepted_total = 0
    while len(out) < max_new_tokens:
        for tok in pending:   # catch the draft cache up to the context
            _, d_cache = decode_step(draft, draft_params, one(tok), d_cache)
        pending = []
        proposals: list[int] = []
        d_probs: list[np.ndarray] = []
        dtok = cur
        for _ in range(draft_len):
            dl, d_cache = decode_step(draft, draft_params, one(dtok),
                                      d_cache)
            if sampling:
                q = host_probs(dl[0])
                dtok = int(host_rng.choice(len(q), p=q))
                d_probs.append(q)
            else:
                dtok = int(torch.argmax(dl[0]))
            proposals.append(dtok)
        # the target verifies [cur, p1..pk] in one forward: logits[i]
        # scores the target's token after ...cur, p1..p_i
        block = torch.tensor([[cur] + proposals], dtype=torch.int32,
                             device=dev)
        base = t_cache.length
        logits, t_cache = decode_block(target, target_params, block,
                                       t_cache)
        verify_calls += 1
        if sampling:
            p_all = [host_probs(row) for row in logits[0]]
            m = 0
            committed: list[int] = []
            while m < draft_len:
                token, ok = accept_or_resample(p_all[m], d_probs[m],
                                               proposals[m], host_rng)
                committed.append(token)
                if not ok:
                    break
                m += 1
            else:
                # full accept: the bonus token from the target's own
                # distribution
                committed.append(int(host_rng.choice(
                    len(p_all[draft_len]), p=p_all[draft_len])))
        else:
            greedy = torch.argmax(logits[0], dim=-1).tolist()    # [k+1]
            m = 0
            while m < draft_len and proposals[m] == greedy[m]:
                m += 1
            committed = proposals[:m] + [greedy[m]]
        accepted_total += m
        out.extend(committed)
        cur = committed[-1]
        if m == draft_len:
            # full accept + bonus: every block entry (cur, p1..pk) is
            # committed context; the draft cache is missing p_k
            t_cache.length = base + draft_len + 1
            pending = [proposals[-1]]
        else:
            # keep cur..p_{m-1} (m + 1 entries) in both caches
            t_cache.length = base + m + 1
            d_cache.length = base + m + 1
    tokens = torch.tensor([out[:max_new_tokens]], dtype=torch.int32,
                          device=dev)
    return tokens, {
        "verify_calls": verify_calls,
        "draft_accept_rate": accepted_total / max(1, verify_calls
                                                  * draft_len),
        # +1: the prefill forward produced out[0] and also counts
        "tokens_per_target_forward": max_new_tokens / (verify_calls + 1)}


def _draft_propose(draft: Transformer, dparams, q_logits: Tensor, d_cache,
                   pc: Tensor, k_draft: int, temperature: float,
                   gen: torch.Generator) -> tuple[Tensor, list, object]:
    """The draft's k-proposal loop after its catch-up block: draw (or
    argmax) each proposal, keeping the tempered proposal distributions
    the rejection rule needs, stepping the draft cache k - 1 times at the
    per-row positions.  Returns (props [B, k] int32, q_rows, d_cache)."""
    sampling = temperature > 0.0
    proposals, q_rows = [], []
    for i in range(k_draft):
        if sampling:
            tok = _categorical(q_logits / temperature, gen).to(torch.int32)
            q_rows.append(torch.softmax(q_logits / temperature, dim=-1))
        else:
            tok = torch.argmax(q_logits, dim=-1).to(torch.int32)
        proposals.append(tok)
        if i < k_draft - 1:
            dl, d_cache = decode_block(draft, dparams, tok[:, None],
                                       d_cache, lengths=pc + 1 + i)
            q_logits = dl[:, 0]
    return torch.stack(proposals, dim=1), q_rows, d_cache


def _greedy_accept(vlogits: Tensor, props: Tensor) -> tuple[Tensor, Tensor]:
    """Longest-matching-prefix acceptance of a verify block [cur, p_1..p_k]:
    (m accepted counts [B] int64, the target's next token [B] int32)."""
    k_draft = props.shape[1]
    g = torch.argmax(vlogits, dim=-1).to(torch.int32)        # [B, k+1]
    match = (props == g[:, :k_draft]).to(torch.int64)
    m = torch.cumprod(match, dim=1).sum(dim=1)
    corr = torch.gather(g, 1, m[:, None])[:, 0]
    return m, corr


def _sampling_accept(vlogits: Tensor, props: Tensor, q_rows: list,
                     temperature: float,
                     gen: torch.Generator) -> tuple[Tensor, Tensor]:
    """Vectorized Leviathan/Chen rejection of a verify block [cur,
    p_1..p_k]: accept each proposal with probability min(1, p/q),
    resample the first rejected position from the residual (a clamped
    gather, overridden by the bonus draw when all k were accepted).
    Preserves the target's tempered distribution.  Returns (m [B] int64,
    the next token [B] int32)."""
    k_draft = props.shape[1]
    probs_t = torch.softmax(vlogits / temperature, dim=-1)
    probs_q = torch.stack(q_rows, dim=1)                      # [B, k, V]
    idx = props.long()[..., None]
    px = torch.gather(probs_t[:, :k_draft], 2, idx)[..., 0]
    qx = torch.gather(probs_q, 2, idx)[..., 0]
    u = torch.rand(px.shape, generator=gen, device=px.device)
    acc = u < px / torch.clamp(qx, min=1e-20)
    m = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
    rows = torch.arange(props.shape[0], device=props.device)
    at = torch.clamp(m, 0, k_draft - 1)
    p_m, q_m = probs_t[rows, at], probs_q[rows, at]
    residual = torch.clamp(p_m - q_m, min=0.0)
    total = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(total > 0, residual, p_m)
    resampled = _categorical(torch.log(residual + 1e-30), gen)
    bonus = _categorical(torch.log(probs_t[:, k_draft] + 1e-30), gen)
    return m, torch.where(m == k_draft, bonus, resampled).to(torch.int32)


def spec_round(target: Transformer, tparams, draft: Transformer, dparams,
               cur: Tensor, y: Tensor, t_cache, d_cache, lt: Tensor,
               pc: Tensor, k_draft: int, temperature: float,
               gen: torch.Generator):
    """ONE speculative round over all rows: the draft's catch-up block
    [y, cur] at its positions pc - 1, pc (rewriting y's slot is a no-op;
    writing it fresh is the full-accept catch-up), k - 1 single draft
    steps, one target verify block [cur, p_1..p_k] at the positions lt
    (a ragged block of k + 1 tokens), and the vectorized acceptance.
    The caches are written in place.  Returns (commit [B, k+1] int32, m
    [B] int64 (the round commits m + 1 tokens), the next token [B], the
    token before it [B])."""
    dl, _ = decode_block(draft, dparams, torch.stack([y, cur], dim=1),
                         d_cache, lengths=pc - 1)
    props, q_rows, _ = _draft_propose(draft, dparams, dl[:, 1], d_cache, pc,
                                      k_draft, temperature, gen)
    block = torch.cat([cur[:, None], props], dim=1)
    vlogits, _ = decode_block(target, tparams, block, t_cache, lengths=lt)
    if temperature > 0.0:
        m, corr = _sampling_accept(vlogits, props, q_rows, temperature, gen)
    else:
        m, corr = _greedy_accept(vlogits, props)
    batch = cur.shape[0]
    iota = torch.arange(k_draft + 1, device=cur.device)
    ext = torch.cat([props, torch.zeros((batch, 1), dtype=torch.int32,
                                        device=cur.device)], dim=1)
    commit = torch.where(iota[None, :] < m[:, None], ext, corr[:, None])
    prev = torch.gather(props, 1, torch.clamp(m - 1, 0, k_draft - 1)[:, None])
    y_new = torch.where(m == 0, cur, prev[:, 0])
    return commit, m, corr, y_new


@dataclasses.dataclass
class _SpecCarry:
    """The state a speculative segment threads: per row the tokens out so
    far (``n_out``), the output frontier ``out`` [B, cap], the current
    token ``cur`` and the one before it ``y``, the target's and the
    draft's cache lengths ``lt`` and ``pc``; both caches; the Generator
    state; stats [verify rounds, accepted, active rows]."""
    n_out: Tensor
    out: Tensor
    cur: Tensor
    y: Tensor
    lt: Tensor
    pc: Tensor
    t_cache: object
    d_cache: object
    rng: Tensor
    stats: Tensor


def _generator(carry: _SpecCarry) -> torch.Generator:
    gen = torch.Generator(device=carry.out.device)
    gen.set_state(carry.rng)
    return gen


def _init_spec_carry(target, tparams, draft, dparams, prompt: Tensor,
                     cap: int, max_len: int, temperature: float, seed: int,
                     cache_dtype: str) -> _SpecCarry:
    """Prefill both models and build the carry the speculative segments
    thread (shared by the fixed-depth and the adaptive paths)."""
    batch, s = prompt.shape
    dev = prompt.device
    t_logits, t_cache = prefill(target, tparams, prompt, max_len,
                                cache_dtype)
    _, d_cache = prefill(draft, dparams, prompt, max_len, cache_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if temperature > 0.0:
        cur = _categorical(t_logits / temperature, gen).to(torch.int32)
    else:
        cur = torch.argmax(t_logits, dim=-1).to(torch.int32)
    out = torch.zeros((batch, cap), dtype=torch.int32, device=dev)
    out[:, 0] = cur
    full = torch.full((batch,), s, dtype=torch.int64, device=dev)
    return _SpecCarry(
        n_out=torch.ones((batch,), dtype=torch.int64, device=dev), out=out,
        cur=cur, y=prompt[:, -1].to(torch.int32), lt=full, pc=full.clone(),
        t_cache=t_cache, d_cache=d_cache, rng=gen.get_state(),
        stats=torch.zeros((3,), dtype=torch.int64, device=dev))


def _spec_segment(target, tparams, draft, dparams, carry: _SpecCarry,
                  seg_target: int, max_new_tokens: int, k_draft: int,
                  temperature: float) -> _SpecCarry:
    """Speculative rounds until every row has ``seg_target`` tokens out:
    the reference's device while_loop as a host loop, with one host read
    of ``n_out`` a round.  Rows that reached ``max_new_tokens`` keep
    verifying into slack columns until the slowest row is done (their
    stats are masked out).  Returns a new carry; the input carry's
    tensors are not changed (the caches are written in place, each
    position with what any run from this carry writes there)."""
    gen = _generator(carry)
    n_out, out, cur, y, lt, pc, stats = (carry.n_out, carry.out, carry.cur,
                                         carry.y, carry.lt, carry.pc,
                                         carry.stats)
    cap = out.shape[1]
    iota = torch.arange(k_draft + 1, device=out.device)
    while bool((n_out < seg_target).any()):
        active = n_out < max_new_tokens
        commit, m, corr, y = spec_round(
            target, tparams, draft, dparams, cur, y, carry.t_cache,
            carry.d_cache, lt, pc, k_draft, temperature, gen)
        idx = torch.clamp(n_out[:, None] + iota[None, :], 0, cap - 1)
        out = out.scatter(1, idx, commit)
        stats = stats + torch.stack([
            torch.ones((), dtype=torch.int64, device=m.device),
            torch.where(active, m, 0).sum(), active.sum()])
        n_out, lt, pc, cur = n_out + m + 1, lt + m + 1, pc + m + 1, corr
    return dataclasses.replace(carry, n_out=n_out, out=out, cur=cur, y=y,
                               lt=lt, pc=pc, rng=gen.get_state(),
                               stats=stats)


def _greedy_segment(target, tparams, carry: _SpecCarry, seg_target: int,
                    temperature: float) -> _SpecCarry:
    """Plain decode rounds over the same carry until every row has
    ``seg_target`` tokens out: the k = 0 arm of adaptive speculation.
    The draft's fields (y, pc, d_cache) pass through untouched."""
    gen = _generator(carry)
    n_out, out, cur, lt, stats = (carry.n_out, carry.out, carry.cur,
                                  carry.lt, carry.stats)
    cap = out.shape[1]
    step = torch.tensor([1, 0, 0], dtype=torch.int64, device=out.device)
    while bool((n_out < seg_target).any()):
        logits, _ = decode_block(target, tparams, cur[:, None],
                                 carry.t_cache, lengths=lt)
        if temperature > 0.0:
            cur = _categorical(logits[:, 0] / temperature,
                               gen).to(torch.int32)
        else:
            cur = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        out = out.scatter(1, torch.clamp(n_out, 0, cap - 1)[:, None],
                          cur[:, None])
        stats = stats + step
        n_out, lt = n_out + 1, lt + 1
    return dataclasses.replace(carry, n_out=n_out, out=out, cur=cur, lt=lt,
                               rng=gen.get_state(), stats=stats)


def _spec_catchup(draft, dparams, carry: _SpecCarry, gap: int) -> _SpecCarry:
    """Advance the draft cache over ``gap`` committed tokens the target
    decoded alone (the greedy probe leaves d_cache, pc and y behind): one
    ragged ``decode_block`` of the committed tokens at positions pc - 1 ..
    lt - 2 (out columns n_out - gap - 2 ..), then pc = lt and y = the
    token at position lt - 1."""
    out, n_out = carry.out, carry.n_out
    cap = out.shape[1]
    cols = ((n_out - gap - 2)[:, None]
            + torch.arange(gap, device=out.device)[None, :])
    block = torch.gather(out, 1, torch.clamp(cols, 0, cap - 1))
    decode_block(draft, dparams, block, carry.d_cache, lengths=carry.pc - 1)
    y = torch.gather(out, 1, torch.clamp(n_out - 2, 0, cap - 1)[:, None])
    return dataclasses.replace(carry, y=y[:, 0], pc=carry.lt.clone())


# Memo keys name a model by a token that is never reused (an id() can be
# recycled after garbage collection).
_MODEL_TOKENS = itertools.count()
_MODEL_TOKENS_LOCK = threading.Lock()


def _model_key(model) -> int:
    token = getattr(model, "_generation_token", None)
    if token is None:
        with _MODEL_TOKENS_LOCK:
            token = getattr(model, "_generation_token", None)
            if token is None:
                token = next(_MODEL_TOKENS)
                model._generation_token = token
    return token


# Calibrated depths memoized per (target, draft, sampling, cache) pair:
# the first adaptive call pays a segmented calibration run; every later
# call goes straight to the winning configuration.  The depth is a
# property of the params (the pair's agreement), assumed fixed per model
# object: swapping params under a model kept in use must call
# clear_depth_memo.  Bounded LRU under a lock.
_DEPTH_MEMO: "OrderedDict[tuple, int]" = OrderedDict()
_DEPTH_MEMO_MAX = 64
_DEPTH_MEMO_LOCK = threading.Lock()


def clear_depth_memo(model=None) -> int:
    """Invalidate memoized calibrated draft depths: all of them, or only
    the entries involving ``model`` (as target or draft).  Returns the
    number of entries dropped."""
    with _DEPTH_MEMO_LOCK:
        if model is None:
            n = len(_DEPTH_MEMO)
            _DEPTH_MEMO.clear()
            return n
        mkey = _model_key(model)
        stale = [k for k in _DEPTH_MEMO if mkey in k[:2]]
        for k in stale:
            del _DEPTH_MEMO[k]
        return len(stale)


def _depth_memo_get(key: tuple) -> int | None:
    with _DEPTH_MEMO_LOCK:
        k = _DEPTH_MEMO.get(key)
        if k is not None:
            _DEPTH_MEMO.move_to_end(key)
        return k


def _depth_memo_put(key: tuple, k: int) -> None:
    with _DEPTH_MEMO_LOCK:
        _DEPTH_MEMO[key] = k
        _DEPTH_MEMO.move_to_end(key)
        while len(_DEPTH_MEMO) > _DEPTH_MEMO_MAX:
            _DEPTH_MEMO.popitem(last=False)


def _invert_accept_fraction(f: float, k: int) -> float:
    """Per-proposal agreement p from a measured accept fraction f = E[m]/k
    at depth k, under the geometric model E[m] = sum_{i=1..k} p^i
    (monotone in p: bisection)."""
    if f <= 0.0:
        return 0.0
    if f >= 1.0:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(40):
        mid = (lo + hi) / 2
        if sum(mid ** i for i in range(1, k + 1)) / k < f:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def _depth_score(p: float, j: int, cost_ratio: float,
                 round_overhead: float = 0.25) -> float:
    """Expected tokens per round cost at depth j: (1 - p^(j+1)) / (1 - p)
    tokens for ``round_overhead`` + 1 target forward + j draft forwards."""
    expect = j + 1.0 if p >= 1.0 else (1.0 - p ** (j + 1)) / (1.0 - p)
    return expect / (round_overhead + 1.0 + cost_ratio * j)


def optimal_draft_depth(accept_frac: float, k: int, k_max: int,
                        cost_ratio: float, round_overhead: float = 0.25,
                        allow_disable: bool = False) -> int:
    """The depth in 1..k_max maximizing expected tokens per round cost
    (:func:`_depth_score`), from the accept fraction measured at depth k
    (inverted to per-proposal agreement first).  ``round_overhead`` is a
    round's fixed cost beyond a plain greedy step, so plain greedy scores
    exactly 1.0; with ``allow_disable``, a best score under 1.0 returns 0
    (decode greedy: speculation cannot pay with this draft)."""
    p = _invert_accept_fraction(accept_frac, k)
    best_k, best = 1, -1.0
    for j in range(1, max(1, k_max) + 1):
        score = _depth_score(p, j, cost_ratio, round_overhead)
        if score > best:
            best, best_k = score, j
    if allow_disable and best < 1.0:
        return 0
    return best_k


def _speculative_adaptive(target, tparams, draft, dparams, prompt: Tensor,
                          max_new_tokens: int, k_max: int,
                          temperature: float, seed: int, cache_dtype: str,
                          cost_ratio: float,
                          calibration: str = "measured"
                          ) -> tuple[Tensor, dict]:
    """Adaptive-depth speculative decoding (speculative_generate_batched
    ``adaptive=True``): a spec segment at k0 = min(2, k_max), then (in
    "measured" calibration) a timed greedy segment, then the rest at the
    depth the controller picks from the measured accept fraction and the
    caller's draft/target ``cost_ratio`` (0: plain greedy).  Each probe
    runs twice from the same carry; the second run is timed.  The depth
    is memoized per pair: later calls run the fixed depth (or plain
    ``generate``) straight away.  Token-exact for greedy at any depth."""
    if calibration not in ("measured", "model"):
        raise ValueError(f"calibration must be 'measured' or 'model', "
                         f"got {calibration!r}")
    memo_key = (_model_key(target), _model_key(draft), k_max, temperature,
                cache_dtype, cost_ratio, calibration)
    k_known = _depth_memo_get(memo_key)
    if k_known == 0:
        out = generate(target, tparams, prompt, max_new_tokens,
                       temperature=temperature, rng=seed,
                       cache_dtype=cache_dtype, device=prompt.device)
        return out, {"verify_calls": max_new_tokens,
                     "draft_accept_rate": 0.0,
                     "tokens_per_target_forward": 1.0,
                     "draft_depth": 0, "draft_depths": ["memo"]}
    if k_known is not None:
        out, stats = _run_fixed_spec(target, tparams, draft, dparams,
                                     prompt, max_new_tokens, k_known,
                                     temperature, seed, cache_dtype)
        stats["draft_depth"] = k_known
        stats["draft_depths"] = ["memo"]
        return out, stats

    batch, s = prompt.shape
    cap = max_new_tokens + k_max + 1
    max_len = s + cap + k_max + 2
    carry = _init_spec_carry(target, tparams, draft, dparams, prompt, cap,
                             max_len, temperature, seed, cache_dtype)
    k0 = min(2, k_max)
    seg = max(8, min(24, max_new_tokens // 4))
    t1 = min(max_new_tokens, seg)
    t2 = min(max_new_tokens, 3 * seg)

    def spec(carry, target_n, k=k0):
        return _spec_segment(target, tparams, draft, dparams, carry,
                             target_n, max_new_tokens, k, temperature)

    def greedy(carry, target_n):
        return _greedy_segment(target, tparams, carry, target_n,
                               temperature)

    def timed(run, carry, target_n):
        run(carry, target_n)                  # warm-up, same carry
        t0 = time.perf_counter()
        res = run(carry, target_n)            # ends on a host read
        return res, time.perf_counter() - t0

    tokens_before = int(carry.n_out.sum())
    carry, dt_spec = timed(spec, carry, t1)
    stats1 = carry.stats.tolist()
    rate_spec = (int(carry.n_out.sum()) - tokens_before) / max(dt_spec, 1e-9)
    frac = stats1[1] / max(1, stats1[2] * k0)
    proposed_total = stats1[2] * k0
    depths: list = [k0]
    p = _invert_accept_fraction(frac, k0)
    rate_greedy = float("nan")
    if calibration == "measured":
        # the greedy probe, then the measured spec rate extrapolated
        # across depths by the model's relative scores
        tokens_before = int(carry.n_out.sum())
        carry, dt_greedy = timed(greedy, carry, t2)
        rate_greedy = ((int(carry.n_out.sum()) - tokens_before)
                       / max(dt_greedy, 1e-9))
        depths.append(0)
        best_j = max(range(1, max(1, k_max) + 1),
                     key=lambda j: _depth_score(p, j, cost_ratio))
        est_best = (rate_spec * _depth_score(p, best_j, cost_ratio)
                    / _depth_score(p, k0, cost_ratio))
        k = best_j if est_best > rate_greedy * 1.02 else 0
    else:
        # "model": a timing-free decision
        k = optimal_draft_depth(frac, k0, k_max, cost_ratio,
                                allow_disable=True)
    _depth_memo_put(memo_key, k)

    if k == 0:
        carry = greedy(carry, max_new_tokens)
        depths.append(0)
    else:
        gap = int(carry.lt[0] - carry.pc[0])
        if gap > 0:
            # the greedy probe ran: catch the draft up over its tokens
            carry = _spec_catchup(draft, dparams, carry, gap)
        pre = int(carry.stats[2])
        carry = spec(carry, max_new_tokens, k)
        proposed_total += (int(carry.stats[2]) - pre) * k
        depths.append(k)
    verifies, accepted, _ = carry.stats.tolist()
    tokens = carry.out[:, :max_new_tokens]
    return tokens, {
        "verify_calls": verifies,
        "draft_accept_rate": accepted / max(1, proposed_total),
        "tokens_per_target_forward": tokens.numel() / max(
            1, batch * (verifies + 1)),
        "draft_depth": k,            # the depth the controller settled on
        "draft_depths": depths,      # [probe k, 0 (greedy probe), chosen]
        "calibration": {"rate_spec": rate_spec, "rate_greedy": rate_greedy,
                        "p": p}}


def _run_fixed_spec(target, tparams, draft, dparams, prompt: Tensor,
                    max_new_tokens: int, k: int, temperature: float,
                    seed: int, cache_dtype: str) -> tuple[Tensor, dict]:
    """One fixed-depth run: init the carry, one full-length segment."""
    batch, s = prompt.shape
    cap = max_new_tokens + k + 1
    carry = _init_spec_carry(target, tparams, draft, dparams, prompt, cap,
                             s + cap + k + 2, temperature, seed, cache_dtype)
    carry = _spec_segment(target, tparams, draft, dparams, carry,
                          max_new_tokens, max_new_tokens, k, temperature)
    verifies, accepted, active_rows = carry.stats.tolist()
    return carry.out[:, :max_new_tokens], {
        "verify_calls": verifies,
        "draft_accept_rate": accepted / max(1, active_rows * k),
        # +1: the prefill forward produced each row's first token
        "tokens_per_target_forward": batch * max_new_tokens / max(
            1, batch * (verifies + 1))}


@torch.inference_mode()
def speculative_generate_batched(
        target: Transformer, target_params, draft: Transformer,
        draft_params, prompt, max_new_tokens: int, *, draft_len: int = 4,
        temperature: float = 0.0, seed: int = 0, cache_dtype: str = "native",
        adaptive: bool = False, draft_cost_ratio: float = 0.5,
        calibration: str = "measured", device=None) -> tuple[Tensor, dict]:
    """Batched speculative decoding: rounds of draft-propose, one ragged
    verify block and vectorized accept-or-resample over all rows.  Rows
    accept different numbers of draft tokens, so each row's caches
    advance at their own rate through ragged ``decode_block`` (per-row
    lengths), committed tokens scatter into a per-row output frontier,
    and rows that reach ``max_new_tokens`` keep verifying into slack
    slots until the slowest row finishes.  ``temperature=0`` is greedy
    and token-exact against the target's greedy decoding;
    ``temperature>0`` applies the Leviathan/Chen rule.
    ``cache_dtype="int8"`` quantizes both models' caches.  ``adaptive``
    makes ``draft_len`` the depth cap and lets the controller pick the
    depth (:func:`_speculative_adaptive`).  Returns (tokens [B,
    max_new_tokens] int32, stats)."""
    _check_draft(target, draft, draft_len)
    dev = resolve_device(device)
    check_on_device(target_params, dev)
    check_on_device(draft_params, dev)
    prompt = _prompt_on(target, prompt, dev)
    prompt_len = int(prompt.shape[1])
    # + draft_len: the last verify round may write a full draft block
    # before the loop notices every row is done
    check_position_budget(target, prompt_len, max_new_tokens + draft_len)
    check_position_budget(draft, prompt_len, max_new_tokens + draft_len)
    if adaptive:
        return _speculative_adaptive(
            target, target_params, draft, draft_params, prompt,
            max_new_tokens, draft_len, float(temperature), seed,
            cache_dtype, float(draft_cost_ratio), calibration)
    return _run_fixed_spec(target, target_params, draft, draft_params,
                           prompt, max_new_tokens, draft_len,
                           float(temperature), seed, cache_dtype)
