"""Continuous-batching decode server in PyTorch: the port of
parameter_server_distributed_tpu/models/serving.py ``DecodeServer``.

Slot-based continuous batching, as in the reference:

- the KV cache is allocated once with B slots;
- every step decodes all B slots in one ragged ``decode_block`` (per-row
  lengths — rows sit at different positions);
- a request holds a slot from submit to EOS/limit; a finished slot is
  refilled by the next request's prefill, whose K/V are written into that
  slot's cache rows while the other slots' state is untouched.

Prefill pads prompts up to a power-of-two bucket (capped at max_len).
Pad positions write garbage K/V beyond the row's real length, which the
ragged mask hides and later decode steps overwrite.

The reference's compiled prefill/splice/extend/step runners are plain
methods here, and the cache is written in place.  ``cache_dtype="int8"``
quantizes the slot cache (generation.QuantKVCache), and a
models/quant.py ``quantize_params`` store serves unchanged.
``prompt_cache > 0`` turns on the radix prefix cache
(models/prefix_tree.py).  ``draft=`` turns on speculative continuous
batching: each step is one speculative round over all slots
(generation.spec_round), so a request advances 1..k+1 tokens a target
forward.  A mesh is not ported yet; asking for one raises and names its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping

import numpy as np
import torch

from ..device import check_on_device, resolve_device
from ..obs import stats as obs_stats
from .generation import (KVCache, QuantKVCache, _invert_accept_fraction,
                         _kv_quantize, check_position_budget,
                         check_token_ids, decode_block, init_cache,
                         optimal_draft_depth, sample_token,
                         sample_token_rowwise, spec_round)
from .prefix_tree import PrefixTree, RowRef
from .transformer import ROADMAP_SPMD, Transformer


@dataclasses.dataclass
class _Slot:
    request_id: int
    tokens: list[int]          # generated tokens so far
    max_new: int
    # per-request finish tokens checked alongside the server eos_id
    stop: frozenset = frozenset()


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _row_nbytes(row) -> int:
    """Device bytes pinned by one cached K/V row (native: (k, v); int8:
    (k8, v8, k_scale, v_scale)): what the radix tree's byte-accounted LRU
    charges against its budget."""
    return sum(t.numel() * t.element_size() for t in row)


class DecodeServer:
    """Slot-based continuous-batching decoder.

    >>> srv = DecodeServer(model, params, slots=8, max_len=2048)
    >>> rid = srv.submit([1, 2, 3], max_new_tokens=64)
    >>> while not srv.idle:
    ...     for request_id, token in srv.step():
    ...         ...                      # stream tokens as they decode
    >>> srv.result(rid)                  # full generation for a request

    Runs on ``device`` (default: the card); ``params`` must lie there.
    ``eos_id`` frees a slot early; a freed slot is reused by the next
    ``submit``.

    ``prompt_cache`` > 0 turns on the radix-tree prefix cache
    (models/prefix_tree.py): admitted prompts' prefill results (the
    final-position logits and the prompt's K/V row) are indexed token by
    token, so an identical resubmission skips the prefill and only
    splices, while a prompt sharing any cached prefix (the interior of a
    longer cached prompt included) forwards only its suffix
    (:meth:`_extend`).  Cached rows pin device memory, bounded by
    byte-accounted LRU over tree nodes: ``prefix_cache_bytes`` (default
    ``PSDT_PREFIX_CACHE_BYTES``, 256 MiB).  In speculative mode a node
    also keeps the draft's row.

    ``draft`` (with ``draft_params``) turns on speculative continuous
    batching: every step runs one draft-propose / verify round over all
    slots, so each request advances 1..k+1 tokens a target forward at its
    own accept rate.  Greedy stays token-exact against the plain greedy
    server whatever the draft; ``temperature>0`` applies the
    Leviathan/Chen rule (top_k/top_p do not combine).  The draft shares
    the cache dtype.  ``adaptive_draft`` (default on) treats
    ``draft_len`` as the cap and re-picks the depth k every few rounds
    (generation.optimal_draft_depth on an EMA of the per-proposal
    agreement, a draft forward costing ``draft_cost_ratio`` target
    forwards); k = 0 serves plain rounds until an idle admission re-arms
    speculation.  ``adaptive_draft=False`` pins k = draft_len."""

    def __init__(self, model: Transformer, params: Mapping[str, torch.Tensor],
                 slots: int = 8, max_len: int = 2048, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int | None = None,
                 cache_dtype: str = "native", seed: int = 0, mesh=None,
                 draft: Transformer | None = None, draft_params=None,
                 draft_len: int = 4, adaptive_draft: bool = True,
                 draft_cost_ratio: float = 0.5, prompt_cache: int = 0,
                 prefix_cache_bytes: int | None = None, device=None):
        if mesh is not None:
            raise NotImplementedError(f"mesh=: {ROADMAP_SPMD}")
        if prompt_cache < 0:
            raise ValueError(f"prompt_cache must be >= 0, "
                             f"got {prompt_cache}")
        self.device = resolve_device(device)
        check_on_device(params, self.device)
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self._cache = init_cache(model, slots, max_len, cache_dtype,
                                 device=self.device)
        self._lengths = np.zeros((slots,), np.int64)
        self._tokens = np.zeros((slots,), np.int32)
        self._slot: list[_Slot | None] = [None] * slots
        self._results: dict[int, list[int]] = {}
        self._next_id = 0
        # observability counters (the stats property)
        self._n_steps = 0
        self._n_emitted = 0
        self._n_requests = 0
        self._n_retired = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._plain_rounds = 0   # non-speculative rounds since the last probe
        # tokens forwarded in a prompt phase (exact hit: 0, extension: the
        # suffix, miss: all) against prompt tokens admitted
        self._prefill_tokens = 0
        self._prompt_tokens = 0
        self._obs_round = obs_stats.histogram("serve.round_s")
        self._obs_tokens = obs_stats.counter("serve.tokens")
        self._obs_active = obs_stats.gauge("serve.active_slots")
        self._obs_rate = obs_stats.gauge("serve.tokens_per_s")
        self._obs_accept = obs_stats.gauge("serve.accept_rate")
        # the radix prefix cache: exact hits replay, a shared prefix
        # seeds a suffix-only extension, byte-accounted LRU eviction
        self.prompt_cache_size = prompt_cache
        budget = (int(prefix_cache_bytes) if prefix_cache_bytes is not None
                  else int(os.environ.get("PSDT_PREFIX_CACHE_BYTES",
                                          "268435456")))
        self._prefix_tree = PrefixTree(budget) if prompt_cache else None
        self._prompt_hits = 0
        self._prefix_hits = 0
        self._obs_prefix = obs_stats.counter("serve.prefix_hits")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        # per-slot sampling temperature (submit(..., temperature=)
        # overrides the server default per slot)
        self._temps = np.full((slots,), temperature, np.float32)
        # speculative mode
        self.draft = draft
        self.draft_len = draft_len          # the cap (verify slack)
        self.adaptive_draft = adaptive_draft
        if draft is not None:
            if top_k or top_p:
                raise ValueError("speculative serving supports greedy "
                                 "(default) or plain --temperature "
                                 "sampling; top_k/top_p must be off")
            if draft.config.vocab != model.config.vocab:
                raise ValueError(
                    f"vocab mismatch: target {model.config.vocab} vs "
                    f"draft {draft.config.vocab}")
            if draft_len < 1:
                raise ValueError("draft_len must be >= 1")
            if draft_params is None:
                raise ValueError("draft requires draft_params")
            check_on_device(draft_params, self.device)
            self.draft_params = draft_params
            self._d_cache = init_cache(draft, slots, max_len, cache_dtype,
                                       device=self.device)
            self._d_lengths = np.zeros((slots,), np.int64)   # pc a slot
            self._prev = np.zeros((slots,), np.int32)        # y a slot
            # the depth and the controller's state
            self._k = min(2, draft_len) if adaptive_draft else draft_len
            self.draft_cost_ratio = draft_cost_ratio
            self._accept_ema: float | None = None
            self._rounds_since_adapt = 0
            self._ema_proposals = 0  # proposals folded into the EMA so far

    _ADAPT_EVERY = 4        # rounds between depth decisions
    _ADAPT_DECAY = 0.8      # EMA decay on the per-round agreement
    _MIN_DISABLE_PROPOSALS = 16  # EMA evidence required before k = 0
    _REPROBE_AFTER_PLAIN = 64    # plain rounds between k = 0 re-probes

    def _adapt_depth(self, accepted: int, proposed: int) -> None:
        """Fold this round's active-slot stats into the agreement EMA and
        re-pick k every _ADAPT_EVERY rounds
        (generation.optimal_draft_depth).  The EMA runs in per-proposal
        agreement (each round's accept fraction inverted at the depth it
        was measured at), so samples taken at different depths stay
        comparable."""
        if not self.adaptive_draft or not proposed:
            return
        p_round = _invert_accept_fraction(accepted / proposed, self._k)
        self._accept_ema = (p_round if self._accept_ema is None else
                            self._ADAPT_DECAY * self._accept_ema
                            + (1.0 - self._ADAPT_DECAY) * p_round)
        self._ema_proposals += proposed
        self._rounds_since_adapt += 1
        if self._rounds_since_adapt < self._ADAPT_EVERY:
            return
        self._rounds_since_adapt = 0
        # the EMA is p already: invert at k = 1 (the identity).  k = 0
        # needs _MIN_DISABLE_PROPOSALS of evidence in the EMA
        self._k = optimal_draft_depth(
            self._accept_ema, 1, self.draft_len, self.draft_cost_ratio,
            allow_disable=self._ema_proposals >= self._MIN_DISABLE_PROPOSALS)
        if self._k == 0:
            self._plain_rounds = 0

    def _maybe_rearm_speculation(self) -> None:
        """After _REPROBE_AFTER_PLAIN plain rounds at k = 0, the next idle
        admission re-arms speculation at depth 1 with fresh adaptation
        state.  Idle, because requests admitted at k = 0 skipped their
        draft prefill: their draft rows are holes."""
        if (self.draft is None or not self.adaptive_draft or self._k > 0
                or not self.idle
                or self._plain_rounds < self._REPROBE_AFTER_PLAIN):
            return
        self._k = 1
        self._plain_rounds = 0
        self._accept_ema = None
        self._ema_proposals = 0
        self._rounds_since_adapt = 0

    @property
    def _speculating(self) -> bool:
        return self.draft is not None and self._k > 0

    @property
    def idle(self) -> bool:
        return all(s is None for s in self._slot)

    @property
    def has_free_slot(self) -> bool:
        return self._free_slot() is not None

    @property
    def active(self) -> int:
        """Number of in-flight requests."""
        return sum(s is not None for s in self._slot)

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self._slot):
            if s is None:
                return i
        return None

    def prefix_fingerprint(self) -> bytes:
        """Compact prefix fingerprint of the radix cache (packed chained
        CRC32 block hashes, prefix_tree.block_hashes); empty when the
        cache is off.  Safe to read from another thread: an immutable
        snapshot the decode thread swaps in after each tree change."""
        tree = self._prefix_tree
        return tree.fingerprint if tree is not None else b""

    # ------------------------------------------------------------ prefill
    @property
    def _int8(self) -> bool:
        return isinstance(self._cache, QuantKVCache)

    def _prefill(self, prompt: np.ndarray, bucket: int, draft: bool = False):
        """Forward the bucket-padded prompt through the target (or the
        draft); returns the last real position's logits [vocab] and the
        prompt's K/V row: (k, v) [L, bucket, KV, D] in the model dtype,
        or (k8, v8, k_scale, v_scale) quantized already when the slot
        cache is int8.  Only the last real position goes through the LM
        head."""
        model, params = self._pair(draft)
        padded = torch.zeros((1, bucket), dtype=torch.int32,
                             device=self.device)
        padded[0, :len(prompt)] = torch.as_tensor(prompt, device=self.device)
        h, kvs, _ = model._forward(params, padded, collect_kv=True)
        last = model.final_logits(params, h[:, len(prompt) - 1])
        k = torch.stack([k[0] for k, _ in kvs])
        v = torch.stack([v[0] for _, v in kvs])
        return last[0], (_kv_quantize(k, v) if self._int8 else (k, v))

    def _pair(self, draft: bool):
        return ((self.draft, self.draft_params) if draft
                else (self.model, self.params))

    def _splice(self, row, slot: int, draft: bool = False) -> None:
        """Write one row's K/V (and scales) into the slot's cache rows (the
        draft's with ``draft``), in place; the row's own width (a
        radix-served row is prefix bucket plus suffix bucket wide)."""
        width = row[0].shape[1]
        cache = self._d_cache if draft else self._cache
        dsts = ((cache.k, cache.v, cache.k_scale, cache.v_scale)
                if self._int8 else (cache.k, cache.v))
        for dst, src in zip(dsts, row):
            dst[:, slot, :width] = src

    def _extend(self, pre_row, suffix: np.ndarray, prefix_len: int,
                sbucket: int, draft: bool = False):
        """Extend a cached prefix row by forwarding only the suffix tokens
        against it: a ``[1, sbucket]`` ragged ``decode_block`` against a
        one-row cache of width prefix bucket + ``sbucket`` seeded with the
        prefix K/V, so the suffix's K/V and logits are what decoding those
        tokens one round at a time would compute.  Pad positions past the
        real suffix write garbage beyond the frontier, masked and later
        overwritten like prefill pad positions.  Returns the last real
        suffix position's logits and the combined row (the draft's with
        ``draft``)."""
        model, params = self._pair(draft)
        layers, pbucket, heads, dim = pre_row[0].shape
        total = pbucket + sbucket
        shape = (layers, 1, total, heads, dim)
        dev = self.device
        if self._int8:
            cache = QuantKVCache(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.ones(shape[:-1], device=dev),
                v_scale=torch.ones(shape[:-1], device=dev), length=0)
            dsts = (cache.k, cache.v, cache.k_scale, cache.v_scale)
        else:
            dtype = model.config.dtype
            cache = KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                            v=torch.zeros(shape, dtype=dtype, device=dev),
                            length=0)
            dsts = (cache.k, cache.v)
        for dst, src in zip(dsts, pre_row):
            dst[:, 0, :pbucket] = src
        padded = torch.zeros((1, sbucket), dtype=torch.int32, device=dev)
        padded[0, :len(suffix)] = torch.as_tensor(suffix, device=dev)
        logits, _ = decode_block(
            model, params, padded, cache,
            lengths=torch.tensor([prefix_len], dtype=torch.int64,
                                 device=dev))
        return logits[0, len(suffix) - 1], tuple(d[:, 0] for d in dsts)

    def _radix_extend(self, prompt: np.ndarray, node, matched: int):
        """Shared-prefix extension from the deepest cached ancestor:
        forward only the suffix past the ``matched``-token tree prefix
        against the covering node's row (:meth:`_extend`).  Returns (last
        logits, combined row, draft row or None), or None (no usable
        prefix, or the combined row would overflow the slot cache: the
        caller prefills in full).  A prompt that is itself a cached path
        (an interior split node, no replayable logits) caps the prefix at
        ``len - 1`` and extends one token.  In speculative mode the draft
        row extends from the same node's draft row; an ancestor admitted
        at k = 0 has none, so the draft side (only) prefills in full."""
        real_len = len(prompt)
        plen = min(matched, real_len - 1)
        if plen <= 0 or node.handle is None:
            return None
        pre_row = node.handle.row
        pbucket = int(pre_row[0].shape[1])
        sbucket = _bucket(real_len - plen)
        if pbucket + sbucket > self.max_len:
            return None
        last, row = self._extend(pre_row, prompt[plen:], plen, sbucket)
        d_row = None
        if self._speculating:
            dpre = node.dhandle.row if node.dhandle is not None else None
            if (dpre is not None
                    and int(dpre[0].shape[1]) + sbucket <= self.max_len):
                _, d_row = self._extend(dpre, prompt[plen:], plen, sbucket,
                                        draft=True)
            else:
                _, d_row = self._prefill(
                    prompt, min(_bucket(real_len), self.max_len), draft=True)
        self._prefix_tree.touch(node)    # the whole ancestor path is hot
        self._prefill_tokens += real_len - plen
        return last, row, d_row

    def _admit_to_tree(self, pkey: tuple, last, row, d_row) -> None:
        """Insert an admitted prompt's rows into the radix tree (an edge
        split shares the descendant's rows: no device copy) and run the
        byte-budget LRU eviction pass."""
        tree = self._prefix_tree
        tree.insert(pkey, last, RowRef(row, _row_nbytes(row)),
                    RowRef(d_row, _row_nbytes(d_row))
                    if d_row is not None else None)
        tree.evict_over_budget()

    # ------------------------------------------------------------- submit
    @torch.inference_mode()
    def submit(self, prompt, max_new_tokens: int = 64, *,
               temperature: float | None = None, stop=()) -> int:
        """Admit a request into a free slot (prefill + cache splice).
        Raises RuntimeError when every slot is busy — callers queue above
        this layer.  Returns the request id.  ``temperature`` overrides
        the server default for this request (0.0 = greedy), except in
        speculative mode, whose accept rule runs at the server's
        temperature; ``stop`` is an iterable of token ids that finish
        this request, checked alongside the server ``eos_id``."""
        if (temperature is not None and self.draft is not None
                and temperature != self._temperature):
            raise ValueError(
                "per-request temperature is not supported in speculative "
                "mode (the accept rule runs at the server temperature); "
                "construct the server with the temperature you need")
        self._maybe_rearm_speculation()
        slot = self._free_slot()
        if slot is None:
            raise RuntimeError("no free slot; drain with step() first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        real_len = int(prompt.shape[0])
        if real_len == 0:
            raise ValueError("empty prompt")
        check_token_ids(self.model, prompt)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        # speculative mode: a verify round may write draft_len + 1 entries
        # past the committed frontier before the host truncates
        slack = self.draft_len + 1 if self.draft is not None else 0
        if real_len + max_new_tokens + slack > self.max_len:
            raise ValueError(
                f"prompt {real_len} + max_new {max_new_tokens} (+ "
                f"speculative slack {slack}) exceeds cache max_len "
                f"{self.max_len}")
        check_position_budget(self.model, real_len, max_new_tokens + slack)
        if self.draft is not None:
            check_position_budget(self.draft, real_len,
                                  max_new_tokens + slack)
        bucket = min(_bucket(real_len), self.max_len)
        tree = self._prefix_tree
        pkey = tuple(int(t) for t in prompt) if tree is not None else None
        hit, anc, matched = None, None, 0
        if tree is not None:
            anc, matched, partial = tree.lookup(pkey)
            if matched == real_len and not partial and anc.last is not None:
                hit = anc   # a whole-prompt node: replayable logits + row
        if hit is not None:
            tree.touch(hit)     # the whole ancestor path, not one entry
            self._prompt_hits += 1
            last, row = hit.last, hit.handle.row
            d_row = hit.dhandle.row if hit.dhandle is not None else None
            if self._speculating and d_row is None:
                # cached while speculation was off (k = 0 skips the draft
                # prefill): backfill the draft row and attach it
                _, d_row = self._prefill(prompt, bucket, draft=True)
                self._admit_to_tree(pkey, last, row, d_row)
        else:
            extended = (self._radix_extend(prompt, anc, matched)
                        if tree is not None else None)
            if extended is not None:
                # only the suffix ran a forward; the combined row splices
                # under its own (wider) width
                last, row, d_row = extended
                self._prefix_hits += 1
                self._obs_prefix.add()
            else:
                last, row = self._prefill(prompt, bucket)
                self._prefill_tokens += real_len
                d_row = None
                if self._speculating:
                    # at k = 0 the draft cache is not read: no prefill
                    _, d_row = self._prefill(prompt, bucket, draft=True)
            if tree is not None:
                self._admit_to_tree(pkey, last, row, d_row)
        self._prompt_tokens += real_len
        req_temp = self._temperature if temperature is None else temperature
        first = int(sample_token(last[None], self._gen, req_temp,
                                 self._top_k, self._top_p)[0])
        self._splice(row, slot)
        if self.draft is not None and d_row is not None:
            self._splice(d_row, slot, draft=True)
            self._d_lengths[slot] = real_len
            self._prev[slot] = int(prompt[-1])
        rid = self._next_id
        self._next_id += 1
        self._n_requests += 1
        entry = _Slot(request_id=rid, tokens=[first],
                      max_new=max_new_tokens, stop=frozenset(stop))
        self._slot[slot] = entry
        self._lengths[slot] = real_len
        self._tokens[slot] = first
        self._temps[slot] = req_temp
        if self._finishes(entry, first):
            self._retire(slot)
        return rid

    # --------------------------------------------------------------- step
    def _decode_round(self, tokens: torch.Tensor, lengths: torch.Tensor,
                      temps: torch.Tensor) -> torch.Tensor:
        """One ragged decode step over all slots + per-row sampling.
        Free/done slots decode garbage lanes that the host discards."""
        logits, _ = decode_block(self.model, self.params, tokens[:, None],
                                 self._cache, lengths=lengths)
        return sample_token_rowwise(logits[:, 0], self._gen, temps,
                                    self._top_k, self._top_p)

    def _device_state(self):
        dev = self.device
        return (torch.as_tensor(self._tokens, device=dev),
                torch.as_tensor(self._lengths, device=dev),
                torch.as_tensor(self._temps, device=dev))

    @torch.inference_mode()
    def step(self) -> list[tuple[int, int]]:
        """One decode step over all slots (a speculative round when a
        draft is configured and k > 0: each slot may advance several
        tokens).  Returns [(request_id, token), ...] for every active
        slot's newly decoded token(s) (already appended to its result)."""
        if self.idle:
            return []
        t0 = time.perf_counter()
        if self._speculating:
            emitted = self._spec_step()
            self._obs_record_round(t0, len(emitted))
            return emitted
        self._plain_rounds += 1
        nxt = self._decode_round(*self._device_state()).cpu().numpy()
        emitted: list[tuple[int, int]] = []
        for i, entry in enumerate(self._slot):
            if entry is None:
                continue
            token = int(nxt[i])
            entry.tokens.append(token)
            emitted.append((entry.request_id, token))
            # the step consumed self._tokens[i] at position lengths[i]
            self._lengths[i] += 1
            self._tokens[i] = token
            if self._finishes(entry, token):
                self._retire(i)
        self._n_steps += 1
        self._n_emitted += len(emitted)
        self._obs_record_round(t0, len(emitted))
        return emitted

    @torch.inference_mode()
    def step_many(self, max_rounds: int = 8) -> list[tuple[int, int]]:
        """Up to ``max_rounds`` decode rounds with no host decision between
        them (a host loop of rounds whose tokens stay on the device).  The
        round count is clamped to the least remaining budget across active
        slots and rounded down to a power of two, as in the reference; a
        row finishing early (eos/stop) decodes garbage into its own lane
        for the rest of the block, which host truncation discards.
        Token-exact against the equivalent step() loop.  In speculative
        mode (k > 0) it runs one speculative round: the depth controller
        decides between rounds."""
        if self.idle:
            return []
        if self._speculating:
            return self.step()
        remaining = [entry.max_new - len(entry.tokens)
                     for entry in self._slot if entry is not None]
        n = max(1, min([max_rounds] + remaining))
        n = 1 << (n.bit_length() - 1)
        if n == 1:
            return self.step()
        t0 = time.perf_counter()
        tokens, lengths, temps = self._device_state()
        outs = []
        for _ in range(n):
            tokens = self._decode_round(tokens, lengths, temps)
            lengths = lengths + 1
            outs.append(tokens)
        outs = torch.stack(outs).cpu().numpy()     # [n, B]
        emitted: list[tuple[int, int]] = []
        for r in range(n):
            for i, entry in enumerate(self._slot):
                if entry is None:
                    continue
                token = int(outs[r, i])
                entry.tokens.append(token)
                emitted.append((entry.request_id, token))
                if self._finishes(entry, token):
                    self._retire(i)
        # mirror what the device wrote: every lane (retired included)
        # advanced n positions and holds its last token
        self._lengths += n
        self._tokens[:] = outs[-1]
        self._n_steps += n
        self._n_emitted += len(emitted)
        self._plain_rounds += n
        self._obs_record_round(t0, len(emitted))
        return emitted

    def _spec_step(self) -> list[tuple[int, int]]:
        """One speculative round (generation.spec_round): commit each
        slot's accepted prefix plus the target's next token, read back to
        the host in one copy.  Free and finished lanes advance their
        frontiers like active ones (the host state mirrors what the
        device wrote; a reused slot's splice resets both)."""
        dev = self.device
        k = self._k
        commit, m, cur_new, y_new = spec_round(
            self.model, self.params, self.draft, self.draft_params,
            torch.as_tensor(self._tokens, device=dev),
            torch.as_tensor(self._prev, device=dev), self._cache,
            self._d_cache, torch.as_tensor(self._lengths, device=dev),
            torch.as_tensor(self._d_lengths, device=dev), k,
            float(self._temperature), self._gen)
        host = torch.cat([commit, (m + 1).to(torch.int32)[:, None],
                          cur_new[:, None], y_new[:, None]],
                         dim=1).cpu().numpy()
        emitted: list[tuple[int, int]] = []
        round_proposed = round_accepted = 0
        for i, entry in enumerate(self._slot):
            n = int(host[i, k + 1])
            if entry is not None:
                # active-slot stats: n - 1 of this round's k accepted
                round_proposed += k
                round_accepted += n - 1
                for t in host[i, :n]:
                    token = int(t)
                    entry.tokens.append(token)
                    emitted.append((entry.request_id, token))
                    if self._finishes(entry, token):
                        # tokens past EOS/limit in this round's commit are
                        # dropped; their cache rows lie past the retired
                        # frontier and splice-reset on reuse
                        self._retire(i)
                        break
            self._lengths[i] += n
            self._d_lengths[i] += n
            self._tokens[i] = int(host[i, k + 2])
            self._prev[i] = int(host[i, k + 3])
        self._spec_proposed += round_proposed
        self._spec_accepted += round_accepted
        self._adapt_depth(round_accepted, round_proposed)
        self._n_steps += 1
        self._n_emitted += len(emitted)
        return emitted

    def _obs_record_round(self, t0: float, n_tokens: int) -> None:
        dt = time.perf_counter() - t0
        self._obs_round.observe(dt)
        self._obs_tokens.add(n_tokens)
        self._obs_active.set(self.active)
        if dt > 0:
            self._obs_rate.set(n_tokens / dt)
        if self._spec_proposed:
            self._obs_accept.set(self._spec_accepted / self._spec_proposed)

    def _finishes(self, entry: _Slot, token: int) -> bool:
        return (len(entry.tokens) >= entry.max_new
                or (self.eos_id is not None and token == self.eos_id)
                or token in entry.stop)

    def cancel(self, request_id: int) -> bool:
        """Free an in-flight request's slot without recording a result
        (the client is gone).  The lane decodes garbage until reused,
        like a retired lane.  False when the id is not in flight."""
        for i, entry in enumerate(self._slot):
            if entry is not None and entry.request_id == request_id:
                self._slot[i] = None
                return True
        return False

    def _retire(self, slot: int) -> None:
        entry = self._slot[slot]
        self._results[entry.request_id] = entry.tokens
        self._slot[slot] = None
        self._n_retired += 1
        # lengths/tokens stay — the lane decodes garbage until reused;
        # the splice on reuse rewrites the cache rows that matter

    @property
    def stats(self) -> dict:
        """Serving counters since construction; with the prompt cache on,
        its hits, extensions and the tree's nodes, bytes and evictions;
        in speculative mode the draft's accept rate, tokens a round and
        the current depth."""
        out = {
            "steps": self._n_steps,
            "tokens_emitted": self._n_emitted,
            "requests_admitted": self._n_requests,
            "requests_completed": self._n_retired,
        }
        if self.prompt_cache_size:
            out["prompt_cache_hits"] = self._prompt_hits
            out["prefix_hits"] = self._prefix_hits
            out["prefix_cache_nodes"] = self._prefix_tree.nodes
            out["prefix_cache_bytes"] = self._prefix_tree.bytes
            out["prefix_evictions"] = self._prefix_tree.evictions
        out["prefill_tokens"] = self._prefill_tokens
        out["prompt_tokens"] = self._prompt_tokens
        if self.draft is not None:
            out["draft_accept_rate"] = (
                self._spec_accepted / self._spec_proposed
                if self._spec_proposed else 0.0)
            out["tokens_per_round"] = (
                self._n_emitted / self._n_steps if self._n_steps else 0.0)
            out["draft_depth"] = self._k   # the current adaptive depth
        return out

    # ------------------------------------------------------------ result
    def peek(self, request_id: int) -> list[int]:
        """Tokens generated so far for an in-flight request."""
        for entry in self._slot:
            if entry is not None and entry.request_id == request_id:
                return list(entry.tokens)
        raise KeyError(f"request {request_id} is not in flight")

    def finished(self) -> list[int]:
        """Request ids whose results are ready to collect."""
        return list(self._results)

    def result(self, request_id: int) -> list[int]:
        """Generated tokens for a finished request (pops it)."""
        return self._results.pop(request_id)

    def run_to_completion(self) -> dict[int, list[int]]:
        """Drain all in-flight requests; returns {request_id: tokens}."""
        while not self.idle:
            self.step()
        out, self._results = self._results, {}
        return out
