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

The reference's compiled prefill/splice/step runners are plain methods
here, and the cache is written in place.  Speculative decoding, a mesh,
the int8 cache and the prompt cache are not ported yet; asking for one
raises and names its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch

from ..device import check_on_device, resolve_device
from ..obs import stats as obs_stats
from .generation import (ROADMAP_INT8_CACHE, check_position_budget,
                         check_token_ids, decode_block, init_cache,
                         sample_token, sample_token_rowwise)
from .transformer import ROADMAP_SPMD, Transformer

ROADMAP_SPECULATIVE = "ROADMAP.md Queue 1, serving: speculative decoding"
ROADMAP_PROMPT_CACHE = "ROADMAP.md Queue 1, serving: the radix prefix cache"


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
    ``submit``."""

    def __init__(self, model: Transformer, params: Mapping[str, torch.Tensor],
                 slots: int = 8, max_len: int = 2048, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_id: int | None = None,
                 cache_dtype: str = "native", seed: int = 0, mesh=None,
                 draft: Transformer | None = None, prompt_cache: int = 0,
                 device=None):
        if draft is not None:
            raise NotImplementedError(f"draft=: {ROADMAP_SPECULATIVE}")
        if mesh is not None:
            raise NotImplementedError(f"mesh=: {ROADMAP_SPMD}")
        if cache_dtype == "int8":
            raise NotImplementedError(
                f"cache_dtype='int8': {ROADMAP_INT8_CACHE}")
        if prompt_cache < 0:
            raise ValueError(f"prompt_cache must be >= 0, "
                             f"got {prompt_cache}")
        if prompt_cache:
            raise NotImplementedError(
                f"prompt_cache > 0: {ROADMAP_PROMPT_CACHE}")
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
        self._prefill_tokens = 0
        self._prompt_tokens = 0
        self._obs_round = obs_stats.histogram("serve.round_s")
        self._obs_tokens = obs_stats.counter("serve.tokens")
        self._obs_active = obs_stats.gauge("serve.active_slots")
        self._obs_rate = obs_stats.gauge("serve.tokens_per_s")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._temperature = temperature
        self._top_k = top_k
        self._top_p = top_p
        # per-slot sampling temperature (submit(..., temperature=)
        # overrides the server default per slot)
        self._temps = np.full((slots,), temperature, np.float32)

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

    # ------------------------------------------------------------ prefill
    def _prefill(self, prompt: np.ndarray, bucket: int):
        """Forward the bucket-padded prompt; returns the last real
        position's logits [vocab] and the prompt's per-layer (k, v)
        [1, bucket, KV, D].  Only that one position goes through the LM
        head."""
        padded = torch.zeros((1, bucket), dtype=torch.int32,
                             device=self.device)
        padded[0, :len(prompt)] = torch.as_tensor(prompt, device=self.device)
        h, kvs, _ = self.model._forward(self.params, padded, collect_kv=True)
        last = self.model.final_logits(self.params, h[:, len(prompt) - 1])
        return last[0], kvs

    def _splice(self, kvs, slot: int) -> None:
        """Write one prefilled row's K/V into the slot's cache rows, in
        place."""
        for i, (k, v) in enumerate(kvs):
            width = k.shape[1]
            self._cache.k[i, slot, :width] = k[0]
            self._cache.v[i, slot, :width] = v[0]

    # ------------------------------------------------------------- submit
    @torch.inference_mode()
    def submit(self, prompt, max_new_tokens: int = 64, *,
               temperature: float | None = None, stop=()) -> int:
        """Admit a request into a free slot (prefill + cache splice).
        Raises RuntimeError when every slot is busy — callers queue above
        this layer.  Returns the request id.  ``temperature`` overrides
        the server default for this request (0.0 = greedy); ``stop`` is
        an iterable of token ids that finish this request, checked
        alongside the server ``eos_id``."""
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
        if real_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {real_len} + max_new {max_new_tokens} exceeds "
                f"cache max_len {self.max_len}")
        check_position_budget(self.model, real_len, max_new_tokens)
        bucket = min(_bucket(real_len), self.max_len)
        last, kvs = self._prefill(prompt, bucket)
        self._prefill_tokens += real_len
        self._prompt_tokens += real_len
        req_temp = self._temperature if temperature is None else temperature
        first = int(sample_token(last[None], self._gen, req_temp,
                                 self._top_k, self._top_p)[0])
        self._splice(kvs, slot)
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
        """One decode step over all slots.  Returns [(request_id, token),
        ...] for every active slot's newly decoded token (already appended
        to its result)."""
        if self.idle:
            return []
        t0 = time.perf_counter()
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
        Token-exact against the equivalent step() loop."""
        if self.idle:
            return []
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
        self._obs_record_round(t0, len(emitted))
        return emitted

    def _obs_record_round(self, t0: float, n_tokens: int) -> None:
        dt = time.perf_counter() - t0
        self._obs_round.observe(dt)
        self._obs_tokens.add(n_tokens)
        self._obs_active.set(self.active)
        if dt > 0:
            self._obs_rate.set(n_tokens / dt)

    def _finishes(self, entry: _Slot, token: int) -> bool:
        return (len(entry.tokens) >= entry.max_new
                or (self.eos_id is not None and token == self.eos_id)
                or token in entry.stop)

    def _retire(self, slot: int) -> None:
        entry = self._slot[slot]
        self._results[entry.request_id] = entry.tokens
        self._slot[slot] = None
        self._n_retired += 1
        # lengths/tokens stay — the lane decodes garbage until reused;
        # the splice on reuse rewrites the cache rows that matter

    @property
    def stats(self) -> dict:
        """Serving counters since construction."""
        return {
            "steps": self._n_steps,
            "tokens_emitted": self._n_emitted,
            "requests_admitted": self._n_requests,
            "requests_completed": self._n_retired,
            "prefill_tokens": self._prefill_tokens,
            "prompt_tokens": self._prompt_tokens,
        }

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
