"""Bounded wire-space delta chain between consecutive store versions: the
port of parameter_server_distributed_tpu/delta/chain.py.

The PS builds it right after each optimizer apply (the core's delta sink,
core/ps_core.py ``set_delta_sink``): the new store is encoded to the
chain's wire dtype (``PSDT_DELTA_DTYPE``, default bf16) and diffed
elementwise, bit for bit, against the retained encoding of the previous
version.  A small optimizer step moves many weights by less than a bf16
ulp, so most of the bytes a full pull would ship are unchanged between
versions.  A receiver holding version ``v``'s decode gets exactly
version ``v+1``'s by scattering the changed elements' wire values into
its cached arrays: an unchanged element has unchanged wire bytes, a
changed one carries the bytes a full pull would.  Chain-applied deltas
are therefore bit for bit a full pull, for every elementwise encoding
(f32, raw f32, bf16).

The chain is bounded (``PSDT_DELTA_DEPTH`` pairs) and value-based: any
version bump it was not told about (a checkpoint restore calls
:meth:`DeltaChain.reset`) leaves a gap, no pair is built across it, and
receivers behind the gap are served in full.

Checksum: per tensor, crc32 over the decoded little-endian f32 bytes of
the whole tensor at ``to_version``; the store checksum is crc32 over the
per-tensor crcs' ``<u4`` concatenation in sorted-name order.

The store may hold card tensors (a per-tensor device close): the chain
reads it through ``core.tensor.to_host``, one packed copy.  A flat-arena
store (core/arena.py ``ArenaStore``) is encoded and diffed slab by slab
over its pinned host slabs; every retained image is an owned copy, since
the next close's readback may reuse those buffers.

Left out: the free-run publication knobs ``PSDT_PUBLISH_MIN_VERSIONS``
and ``PSDT_PUBLISH_MAX_LAG_MS`` (ROADMAP.md Queue 1, item 11) and the
flight events (item 14).  Port-only: :attr:`DeltaChain.published`, the
(version, crc, wall time) of the last versions noted, which the PS's
exit report carries.
"""

from __future__ import annotations

import collections
import logging
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Mapping

import numpy as np

from ..core.stripes import partition_names, run_striped, stripe_count
from ..core.tensor import to_host
from ..obs import stats as obs_stats
from ..rpc.codec import (WIRE_BF16, WIRE_DTYPE_NAMES, WIRE_F32,
                         WIRE_RAW_F32, bf16_to_f32)
from ..rpc.wire import ArrayPayload
from .messages import DEFAULT_DTYPE, ENV_DTYPE, delta_depth

log = logging.getLogger("pst.delta")

# the encodings the chain supports: elementwise, fixed bytes an element
_ELEMENTWISE = {WIRE_F32: 4, WIRE_RAW_F32: 4, WIRE_BF16: 2}

# how many noted versions :attr:`DeltaChain.published` remembers
PUBLISHED_KEPT = 256


def delta_wire_dtype() -> int:
    name = os.environ.get(ENV_DTYPE, DEFAULT_DTYPE)
    dtype = WIRE_DTYPE_NAMES.get(name)
    if dtype is None or dtype not in _ELEMENTWISE:
        raise ValueError(
            f"{ENV_DTYPE}={name!r} is not an elementwise serve encoding; "
            f"options: f32, raw, bf16")
    return dtype


def wire_dtype_compatible(dtype: int, chain_dtype: int) -> bool:
    """A pull's encoding matches the chain when the decoded f32 values
    are the same: f32 and raw f32 are one value space."""
    if dtype == chain_dtype:
        return True
    return {dtype, chain_dtype} <= {WIRE_F32, WIRE_RAW_F32}


def encode_wire(flat: np.ndarray, wire_dtype: int) -> np.ndarray:
    """A tensor's flat wire-space image, the payload a full pull would
    carry, as an owned numpy array (``<u2`` a bf16 element, ``<f4`` an
    f32 one), so versions diff with one vector compare."""
    if wire_dtype == WIRE_BF16:
        raw = ArrayPayload(flat, WIRE_BF16).tobytes()   # the active codec
        return np.frombuffer(raw, dtype="<u2")
    # an owned copy, never a view: the live store changes next apply
    return np.array(flat, dtype="<f4", copy=True).reshape(-1)


def decode_wire_values(raw: bytes, wire_dtype: int) -> np.ndarray:
    """Wire-space element bytes -> f32 values, the codec's decode for a
    (possibly sparse) subset of elements."""
    if wire_dtype == WIRE_BF16:
        return bf16_to_f32(np.frombuffer(raw, dtype="<u2"))
    return np.frombuffer(raw, dtype="<f4").astype(np.float32, copy=False)


def tensor_crc(decoded: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(decoded, "<f4"))


# elements decoded at a time for a wire image's crc: the f32 bytes are
# made a cache-sized piece at a time, never for the whole tensor
_CRC_CHUNK = 1 << 18


def wire_crc(wire: np.ndarray, wire_dtype: int) -> int:
    """:func:`tensor_crc` of a wire image's decode, the same value,
    decoding a piece at a time."""
    if wire_dtype != WIRE_BF16:
        return zlib.crc32(np.ascontiguousarray(wire))
    crc = 0
    for start in range(0, int(wire.size), _CRC_CHUNK):
        crc = zlib.crc32(bf16_to_f32(wire[start:start + _CRC_CHUNK]), crc)
    return crc


def fold_crcs(named_crcs: Mapping[str, int]) -> int:
    """The store checksum: crc32 over the per-tensor crcs' ``<u4``
    concatenation in sorted-name order."""
    return zlib.crc32(b"".join(
        struct.pack("<I", named_crcs[name] & 0xFFFFFFFF)
        for name in sorted(named_crcs)))


def store_crc(store: Mapping[str, np.ndarray]) -> int:
    """Checksum of a receiver's f32 store: what the last frame of a delta
    pair must match once the chain applies."""
    return fold_crcs({name: tensor_crc(np.ascontiguousarray(arr, "<f4"))
                      for name, arr in store.items()})


def _bits(wire: np.ndarray, wire_dtype: int) -> np.ndarray:
    """The integer view a bitwise compare runs on: 0.0 -> -0.0 changes
    the bytes a full pull ships, and NaNs must patch deterministically,
    so a float compare would miss changes."""
    return wire if wire_dtype == WIRE_BF16 else wire.view("<u4")


class DeltaPair:
    """One built ``from_version -> to_version`` transition."""

    __slots__ = ("from_version", "to_version", "entries", "nbytes", "crc",
                 "changed", "total")

    def __init__(self, from_version: int, to_version: int,
                 entries: list, nbytes: int, crc: int,
                 changed: int, total: int):
        self.from_version = from_version
        self.to_version = to_version
        # [(name, idx_bytes | b"", value_bytes, dense)], sorted by name
        self.entries = entries
        self.nbytes = nbytes          # wire payload bytes of the entries
        self.crc = crc                # store checksum at to_version
        self.changed = changed        # changed elements
        self.total = total


class DeltaChain:
    """The bounded pair store and the retained previous wire image.

    ``note_apply`` is the core's post-apply hook: it runs inside the
    barrier close, never raises (a failed build logs, resets the chain,
    and the next serve is full), and does its O(model) encode and diff
    outside ``_lock`` (applies are serialized by the caller, so the
    retained image has one writer; ``_lock`` guards the pair map and the
    subscribers' condition variable)."""

    def __init__(self, depth: int | None = None,
                 wire_dtype: int | None = None,
                 stripes: int | None = None):
        self.depth = delta_depth() if depth is None else int(depth)
        self.wire_dtype = (delta_wire_dtype() if wire_dtype is None
                           else int(wire_dtype))
        if self.wire_dtype not in _ELEMENTWISE:
            raise ValueError(f"unsupported delta wire dtype "
                             f"{self.wire_dtype}")
        self._stripes = stripe_count(stripes)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # keyed by from_version; consecutive keys form servable chains
        self._pairs: "OrderedDict[int, DeltaPair]" = OrderedDict()
        # the previous version's wire image, per name, and for a
        # flat-arena store also as whole per-stripe wire slabs under
        # their packing table, so the next build diffs one vector a
        # stripe; the per-name views alias the slabs, so a store that
        # stops being flat mid-chain still diffs per name
        self._wire_prev: dict[str, np.ndarray] | None = None
        self._prev_slabs: tuple | None = None
        self._prev_version = -1
        self._gen = 0    # bumped by reset(): a build racing it is dropped
        # the version whose build is running (-1: none), so a serve of
        # it waits for its pair rather than answering in full
        self._building = -1
        self.published: "collections.deque[tuple[int, int, float]]" = \
            collections.deque(maxlen=PUBLISHED_KEPT)
        self._obs_build_ms = obs_stats.histogram("ps.serve.delta_build_ms")
        self._obs_pair_bytes = obs_stats.gauge("ps.serve.delta_pair_bytes")
        self._obs_changed = obs_stats.gauge("ps.serve.delta_changed")

    # ------------------------------------------------------------- build
    def note_apply(self, store: Mapping, version: int) -> None:
        """Record that the serialized apply produced ``version`` with
        ``store``'s values: builds the ``prev -> version`` pair when the
        retained image is one version behind, else reseeds.  Never
        raises (the core's hook contract)."""
        try:
            self._note_apply(store, int(version))
        except Exception:  # noqa: BLE001 — a failed build never fails the
            # barrier close; full serves stay correct
            log.exception("delta build failed at version %d; chain reset",
                          version)
            self.reset()

    @staticmethod
    def _diff_entry(name: str, prev_bits, new_bits, wire: np.ndarray,
                    itemsize: int) -> tuple:
        """One tensor's pair entry from a bitwise compare of its images,
        shared by the per-name and slab diffs so their bytes are the
        same: sparse (indices and values) below the break-even share,
        else the whole payload.  A dense tensor's indices are never
        made."""
        changed = prev_bits != new_bits
        n, total = int(np.count_nonzero(changed)), int(wire.size)
        if n * (4 + itemsize) < total * itemsize:
            idx_changed = np.flatnonzero(changed)
            return (name, idx_changed.astype("<u4").tobytes(),
                    wire[idx_changed].tobytes(), False, n)
        return (name, b"", wire.tobytes(), True, n)

    def _note_apply(self, store: Mapping, version: int) -> None:
        t0 = time.perf_counter()
        with self._lock:
            gen = self._gen
            prev = self._wire_prev
            prev_version = self._prev_version
            prev_slabs = self._prev_slabs
            self._building = version
        diffable = (prev is not None and version == prev_version + 1
                    and set(prev) == set(store))
        itemsize = _ELEMENTWISE[self.wire_dtype]
        names = sorted(store)
        layout = getattr(store, "layout", None)
        slabs = getattr(store, "slabs", None)
        new_slabs: tuple | None = None
        if layout is not None and slabs is not None:
            wait = getattr(store, "wait", None)
            if callable(wait):
                wait()   # the readback's event (already reached)
            merged, wire_slabs = self._build_arena(
                store, layout, slabs, diffable, prev, prev_slabs, itemsize)
            new_slabs = (layout, wire_slabs)
        else:
            merged = self._build_per_name(to_host(store), names, diffable,
                                          prev, itemsize)
        wires = {name: merged[name][0] for name in names}
        crc = fold_crcs({name: merged[name][1] for name in names})
        pair = None
        if diffable and all(merged[n][2] is not None for n in names):
            entries = [merged[n][2][:4] for n in names]
            nbytes = sum(len(e[1]) + len(e[2]) for e in entries)
            changed = sum(merged[n][2][4] for n in names)
            total = sum(int(w.size) for w in wires.values())
            pair = DeltaPair(prev_version, version, entries, nbytes, crc,
                             changed, total)
        with self._lock:
            self._building = -1
            self._cv.notify_all()
            if self._gen != gen:
                return   # a reset landed mid-build: this image is stale
            self._wire_prev = wires
            self._prev_slabs = new_slabs
            self._prev_version = version
            self.published.append((version, crc, time.time()))
            if pair is not None:
                self._pairs[pair.from_version] = pair
                while len(self._pairs) > self.depth:
                    self._pairs.popitem(last=False)
                self._obs_pair_bytes.set(pair.nbytes)
                self._obs_changed.set(pair.changed)
            else:
                # a version gap or a shape change: older pairs no longer
                # chain to the current version
                self._pairs.clear()
            self._cv.notify_all()
        self._obs_build_ms.observe(1e3 * (time.perf_counter() - t0))

    def _build_per_name(self, store: Mapping[str, np.ndarray],
                        names: list[str], diffable: bool,
                        prev: dict | None, itemsize: int) -> dict:
        """The per-tensor encode and diff: one wire encode and one bitwise
        compare a tensor, stripe-parallel."""
        groups = (partition_names(names, self._stripes)
                  if len(names) > 1 else [list(names)])
        results: list[dict] = [{} for _ in groups]

        def build_group(idx: int, group: list[str]) -> None:
            out = results[idx]
            for name in group:
                flat = np.asarray(store[name], np.float32).reshape(-1)
                wire = encode_wire(flat, self.wire_dtype)
                crc = wire_crc(wire, self.wire_dtype)
                entry = None
                if diffable and prev[name].size == wire.size:
                    entry = self._diff_entry(
                        name, _bits(prev[name], self.wire_dtype),
                        _bits(wire, self.wire_dtype), wire, itemsize)
                out[name] = (wire, crc, entry)

        run_striped([(lambda i=i, g=g: build_group(i, g))
                     for i, g in enumerate(groups)])
        merged: dict[str, tuple] = {}
        for out in results:
            merged.update(out)
        return merged

    def _build_arena(self, store: Mapping[str, np.ndarray], layout,
                     slabs: Mapping[int, np.ndarray], diffable: bool,
                     prev: dict | None, prev_slabs: tuple | None,
                     itemsize: int) -> tuple[dict, dict]:
        """The slab encode and diff of a flat-arena store: per stripe, one
        wire encode of the host slab and, when the previous image was
        kept under the same packing-table epoch, a bitwise compare of
        each tensor's range of the two slab images (the JAX package
        compares the whole slab once and splits the changed indices by
        offset; counting per range first makes no index array for a
        dense tensor).  Entry bytes, crcs and the sparse/dense choice are
        the per-name path's.  A tensor whose previous image predates the
        arena diffs per name."""
        slab_prev = None
        if (diffable and prev_slabs is not None
                and prev_slabs[0].epoch == layout.epoch):
            slab_prev = prev_slabs[1]
        merged: dict[str, tuple] = {}
        wire_slabs: dict[int, np.ndarray] = {}
        stripes = sorted(slabs)
        results: list[tuple] = [None] * len(stripes)

        def build_stripe(idx: int, stripe: int) -> None:
            wire_slab = encode_wire(
                np.asarray(slabs[stripe], np.float32).reshape(-1),
                self.wire_dtype)
            old = None
            if (slab_prev is not None and stripe in slab_prev
                    and slab_prev[stripe].size == wire_slab.size):
                old = _bits(slab_prev[stripe], self.wire_dtype)
                new = _bits(wire_slab, self.wire_dtype)
            out: dict[str, tuple] = {}
            for name in layout.stripe_names[stripe]:
                e = layout.entries[name]
                span = slice(e.offset, e.offset + e.length)
                wire = wire_slab[span]
                crc = wire_crc(wire, self.wire_dtype)
                entry = None
                if old is not None:
                    entry = self._diff_entry(name, old[span], new[span],
                                             wire, itemsize)
                elif (diffable and prev is not None
                        and prev[name].size == wire.size):
                    entry = self._diff_entry(
                        name, _bits(prev[name], self.wire_dtype),
                        _bits(wire, self.wire_dtype), wire, itemsize)
                out[name] = (wire, crc, entry)
            results[idx] = (wire_slab, out)

        run_striped([(lambda i=i, s=s: build_stripe(i, s))
                     for i, s in enumerate(stripes)])
        for idx, stripe in enumerate(stripes):
            wire_slab, out = results[idx]
            wire_slabs[stripe] = wire_slab
            merged.update(out)
        # an ArenaStore's views cover exactly the table; a straggler is
        # still encoded per name, so the image is whole
        for name in store:
            if name not in merged:
                flat = np.asarray(store[name], np.float32).reshape(-1)
                wire = encode_wire(flat, self.wire_dtype)
                merged[name] = (wire, wire_crc(wire, self.wire_dtype), None)
        return merged, wire_slabs

    def reset(self) -> None:
        """Drop everything (a restore): the retained image no longer
        describes the store, and a stale pair would patch a wrong base."""
        with self._lock:
            self._gen += 1
            self._building = -1
            self._pairs.clear()
            self._wire_prev = None
            self._prev_slabs = None
            self._prev_version = -1
            self._cv.notify_all()

    # ------------------------------------------------------------- serve
    @property
    def version(self) -> int:
        with self._lock:
            return self._prev_version

    def pairs_between(self, held: int, current: int
                      ) -> list[DeltaPair] | None:
        """The consecutive pair chain ``held -> current``, or None when a
        hop is missing (past the depth, across a reset, or a version the
        sink never saw)."""
        if held < 0 or current <= held:
            return None
        with self._lock:
            chain: list[DeltaPair] = []
            v = held
            while v < current:
                pair = self._pairs.get(v)
                if pair is None:
                    return None
                chain.append(pair)
                v = pair.to_version
            return chain

    def wait_built(self, version: int, timeout: float) -> None:
        """While the pair into ``version`` is being built, wait for it
        (at most ``timeout``): the store is published before the close
        notes it, so a serve in between would otherwise answer in
        full."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._building == version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._cv.wait(remaining)

    def wait_for_newer(self, version: int, timeout: float) -> bool:
        """Park until the chain records a version newer than ``version``
        or ``timeout`` passes (a subscription's wakeup; callers re-read
        the core's serve version on every wake)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._prev_version <= version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True
