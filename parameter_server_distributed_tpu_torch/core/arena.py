"""The flat arena: the port of parameter_server_distributed_tpu/core/arena.py.

``PSDT_ARENA=1`` (with the sharded device optimizer) lays the device
close out flat: one contiguous f32 buffer per (stripe, role) -- params,
mean sums and each optimizer slot -- addressed through a process-stable
packing table (name -> offset, length, shape; rebuilt only when the
store's shapes change, under an epoch), so

- each fold chunk lands in its stripe's sums slab as one launch per
  (chunk, stripe, lane) (``fold_segments`` through
  ``core.device_apply.slab_update`` / ``slab_assemble``),
- the contributor-mean scale runs as one launch over every stripe slab
  and the update as one launch per stripe slab, whatever the tensor
  count, and
- the readback is one copy per stripe into pinned host memory, whose
  per-tensor views (:class:`ArenaStore`) the serve encode and the
  checkpoint writer read.

Bit-exactness is the per-tensor path's: flattening changes which buffer
an element lives in, never the operations applied to it.  Two per-tensor
behaviours are kept exactly: the AdamW / Lion decay on matrices only
becomes a decay lane over a prefix of each stripe slab (the table packs
decayed, ndim >= 2, tensors first); Momentum's first-touch copy holds
per table, and a mixed velocity table downgrades the close.

Downgrade matrix (never a failed boot, never a failed close): anything
the flat layout cannot represent exactly -- gradient coverage short of
the table, per-name contributor counts that differ, names popped
mid-iteration, a table epoch moving under an open accumulator, a mixed
momentum seed, a packing failure -- takes the per-tensor device path for
that close, counted in ``ps.apply.arena_fallback``.  A packing exception
also latches the arena off for the core.  ``ps.apply.arena_pad`` gauges
the padding share.

Padding: ``PSDT_ARENA_ALIGN`` (elements, default 1) rounds each tensor's
offset up.  Padding is zero, never folded into, and a fixed point of
every rule at (p, g, slots) = 0, whichever lane it rides.  Every store
size goes flat: the reference's mean-tensor bound
(``PSDT_ARENA_MAX_TENSOR_BYTES``) sized its launches to XLA:CPU's thread
pool, and one launch over a stripe slab fills the card whatever the
tensor sizes.  The reference's flight events and timeline lines are not
ported (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

import os
import threading
from typing import Mapping

import numpy as np
import torch

from ..obs import stats as obs_stats
from . import device_apply
from .stripes import stripe_of

ENV_ARENA = "PSDT_ARENA"
ENV_ALIGN = "PSDT_ARENA_ALIGN"


def enabled() -> bool:
    """The per-process layout knob; default off."""
    return os.environ.get(ENV_ARENA, "") not in ("", "0")


def align_elems() -> int:
    n = int(os.environ.get(ENV_ALIGN, "1") or "1")
    if n < 1:
        raise ValueError(f"{ENV_ALIGN} must be >= 1, got {n}")
    return n


def _shape(v) -> tuple:
    return tuple(int(d) for d in (v.shape if hasattr(v, "shape")
                                  else np.shape(v)))


class TableEntry:
    __slots__ = ("name", "stripe", "offset", "length", "shape", "decayed")

    def __init__(self, name: str, stripe: int, offset: int, length: int,
                 shape: tuple, decayed: bool):
        self.name = name
        self.stripe = stripe
        self.offset = offset      # elements into the stripe slab
        self.length = length      # elements
        self.shape = shape
        self.decayed = decayed    # ndim >= 2: the AdamW / Lion decay lane


def store_signature(store: Mapping) -> tuple:
    """The (name, shape) signature a table is built against."""
    return tuple(sorted((name, _shape(v)) for name, v in store.items()))


class PackingTable:
    """Name -> (stripe, offset, length, shape).  Per stripe, decayed
    (ndim >= 2) names sorted, then the rest sorted: every process and
    checkpoint agrees on the layout of a store signature, and the decay
    lane is a prefix of each stripe slab."""

    __slots__ = ("stripes", "epoch", "signature", "entries", "stripe_names",
                 "stripe_sizes", "payload_elems")

    def __init__(self, store: Mapping, stripes: int, epoch: int):
        self.stripes = int(stripes)
        self.epoch = int(epoch)
        self.signature = store_signature(store)
        self.entries: dict[str, TableEntry] = {}
        self.stripe_names: list[list[str]] = [[] for _ in range(stripes)]
        self.stripe_sizes: list[int] = [0] * stripes
        self.payload_elems = 0
        align = align_elems()
        shapes = {name: _shape(v) for name, v in store.items()}
        by_stripe: dict[int, list[str]] = {}
        for name in store:
            by_stripe.setdefault(stripe_of(name, stripes), []).append(name)
        for stripe in range(stripes):
            names = by_stripe.get(stripe, [])
            ordered = (sorted(n for n in names if len(shapes[n]) >= 2)
                       + sorted(n for n in names if len(shapes[n]) < 2))
            offset = 0
            for name in ordered:
                shape = shapes[name]
                length = int(np.prod(shape)) if shape else 1
                self.entries[name] = TableEntry(name, stripe, offset, length,
                                                shape, len(shape) >= 2)
                self.stripe_names[stripe].append(name)
                offset += -(-length // align) * align
                self.payload_elems += length
            self.stripe_sizes[stripe] = offset

    @property
    def total_elems(self) -> int:
        return sum(self.stripe_sizes)

    @property
    def padding_elems(self) -> int:
        return self.total_elems - self.payload_elems

    def compatible(self, name: str, g) -> bool:
        """True when ``g`` folds exactly into ``name``'s range: the same
        shape, no broadcasting."""
        e = self.entries.get(name)
        return e is not None and _shape(g) == e.shape

    def decay_len(self, stripe: int) -> int:
        """Elements of the stripe slab on the decay lane: the prefix up
        to the end of its last decayed tensor (padding inside it stays
        zero on either lane)."""
        ends = [self.entries[n].offset + self.entries[n].length
                for n in self.stripe_names[stripe] if self.entries[n].decayed]
        return max(ends, default=0)

    def ranges(self, stripe: int) -> tuple:
        return tuple((self.entries[n].offset, self.entries[n].length)
                     for n in self.stripe_names[stripe])

    def views(self, stripe: int, host_slab: np.ndarray) -> dict:
        """Per-tensor views of one stripe's host slab."""
        out = {}
        for name in self.stripe_names[stripe]:
            e = self.entries[name]
            out[name] = host_slab[e.offset:e.offset + e.length].reshape(
                e.shape)
        return out

    def device_views(self, stripe: int, slab: torch.Tensor) -> dict:
        """Per-tensor views of one stripe's device slab."""
        out = {}
        for name in self.stripe_names[stripe]:
            e = self.entries[name]
            out[name] = slab[e.offset:e.offset + e.length].view(e.shape)
        return out


class ArenaStore(dict):
    """A store published by a flat close: ``{name: np.ndarray}`` whose
    values are views into ``slabs``, one pinned host f32 slab per stripe
    read back from the card.  ``readback`` is the copies' event; the
    close waits on it before it publishes the store, and :meth:`wait`
    (which ``core.tensor.to_host`` calls) is then free."""

    __slots__ = ("layout", "slabs", "readback")

    def __init__(self, values: Mapping, layout: PackingTable,
                 slabs: Mapping[int, np.ndarray],
                 readback: "device_apply.Readback | None" = None):
        super().__init__(values)
        self.layout = layout
        self.slabs = dict(slabs)
        self.readback = readback

    def wait(self) -> None:
        if self.readback is not None:
            self.readback.wait()


class _PoppedShim:
    """Stand-in for a popped accumulator entry: callers read only
    ``.nbytes``."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


class ArenaAccum:
    """A streaming iteration's running sums as per-stripe flat slabs on
    ``device``.  A fold chunk lands as one launch per (stripe, lane):
    fresh names on the set lane (the bit-copy seed), repeated names on
    the add lane, host payloads in one upload a lane.  Names the table
    cannot represent exactly (unknown, shape-mismatched) fold per tensor
    into ``overflow``, which forces the per-tensor close.

    Thread-safety is the per-tensor accumulator's: stripes fold under
    their own locks (disjoint slabs), one stripe's folds are serialised
    by its lock, and the close drains in-flight folds first."""

    __slots__ = ("table", "device", "slabs", "covered", "popped", "overflow",
                 "scaled")

    def __init__(self, table: PackingTable, device):
        self.table = table
        self.device = device
        self.slabs: dict[int, torch.Tensor] = {}
        self.covered: dict[int, set[str]] = {}
        self.popped: set[str] = set()
        self.overflow: dict = {}       # name -> per-tensor accumulator
        self.scaled = False

    # ------------------------------------------------------------- fold
    def fold_group(self, stripe: int, items: list, counts: dict) -> int:
        """Fold one chunk's table-compatible tensors of one stripe into
        its slab.  Returns bytes newly resident.  Caller holds the lock
        covering the stripe."""
        table = self.table
        cov = self.covered.setdefault(stripe, set())
        fresh = [(n, g) for n, g in items if n not in cov]
        repeat = [(n, g) for n, g in items if n in cov]
        slab = self.slabs.get(stripe)
        size = table.stripe_sizes[stripe]
        for mode, group in (("set", fresh), ("add", repeat)):
            group.sort(key=lambda kv: table.entries[kv[0]].offset)
            # one lane per residence: device payloads are copied from
            # where they lie, host payloads cross in one upload
            lanes = ([(n, g) for n, g in group
                      if device_apply.is_device_array(g)],
                     [(n, g) for n, g in group
                      if not device_apply.is_device_array(g)])
            for host, lane in enumerate(lanes):
                if not lane:
                    continue
                ranges = tuple((table.entries[n].offset,
                                table.entries[n].length) for n, _ in lane)
                vals = [g for _, g in lane]
                if (slab is None and mode == "set"
                        and device_apply.slab_full_cover(ranges, size)):
                    # a whole-stripe seed: the values are the slab
                    slab = device_apply.slab_assemble(ranges, vals, size,
                                                      self.device)
                    continue
                if slab is None:
                    slab = torch.zeros(size, dtype=torch.float32,
                                       device=self.device)
                if host:
                    vals = [device_apply.flat_upload(vals, self.device)]
                device_apply.slab_update(slab, ranges, mode, vals,
                                         flat=bool(host))
        self.slabs[stripe] = slab
        added = 0
        for name, _ in fresh:
            cov.add(name)
            added += 4 * table.entries[name].length
        for name, _ in items:
            counts[name] = counts.get(name, 0) + 1
        return added

    # ------------------------------------------------------------ close
    def names(self) -> set[str]:
        out: set[str] = set()
        for cov in self.covered.values():
            out |= cov
        out |= set(self.overflow)
        return out - self.popped

    def full_coverage(self) -> bool:
        """True when the sums cover exactly the table: every name folded,
        none popped, nothing in overflow."""
        if self.overflow or self.popped:
            return False
        return (sum(len(c) for c in self.covered.values())
                == len(self.table.entries))

    def scale_uniform(self, count: int) -> None:
        """The contributor-mean scale of every stripe slab in one launch
        (the caller proved the per-name counts uniform)."""
        device_apply.scale_means(self.slabs, dict.fromkeys(self.slabs, count),
                                 sorted(self.slabs))
        self.scaled = True

    def to_tensor_dict(self) -> dict:
        """Per-tensor device views of the sums: the per-tensor fallback
        close's input (and the put-back accumulator of a failed one)."""
        out = dict(self.overflow)
        for stripe, cov in self.covered.items():
            slab = self.slabs.get(stripe)
            if slab is None:
                continue
            for name in cov:
                if name in self.popped:
                    continue
                e = self.table.entries[name]
                out[name] = slab[e.offset:e.offset + e.length].view(e.shape)
        return out

    # ------------------------------------------- mapping-protocol shims
    def __iter__(self):
        return iter(self.names())

    def __len__(self) -> int:
        return len(self.names())

    def __contains__(self, name) -> bool:
        return name in self.names()

    def in_slab(self, name: str) -> bool:
        if name in self.popped:
            return False
        e = self.table.entries.get(name)
        return e is not None and name in self.covered.get(e.stripe, ())

    def evict_to_overflow(self, name: str) -> None:
        """Move a slab-resident sum into ``overflow`` as an owned copy on
        the slab's device, so a later fold the slab cannot take (numpy's
        broadcast-up) keeps accumulating in one place, on the device.
        Caller holds the stripe's lock."""
        if not self.in_slab(name):
            return
        e = self.table.entries[name]
        part = self.slabs[e.stripe][e.offset:e.offset + e.length]
        self.overflow[name] = device_apply.owned_copy(part.view(e.shape),
                                                      self.device)
        self.popped.add(name)

    def pop(self, name, default=None):
        """Vacate ``name`` from the close's coverage (which forces the
        per-tensor close); the shim carries the freed bytes."""
        if name in self.overflow:
            return self.overflow.pop(name)
        e = self.table.entries.get(name)
        if e is None or name in self.popped:
            return default
        if not any(name in cov for cov in self.covered.values()):
            return default
        self.popped.add(name)
        return _PoppedShim(4 * e.length)


class ArenaManager:
    """A core's packing table and device param slabs.  The table is
    rebuilt only when the store's signature changes (epoch bumped);
    param slabs are adopted from the previous close by identity (no
    upload in steady state) and packed from the live store otherwise.
    ``_lock`` serialises builds and packs; the fold path reads the
    published ``table`` reference only."""

    def __init__(self, stripes: int, device):
        self._stripes = int(stripes)
        self.device = device
        self._lock = threading.Lock()
        self.table: PackingTable | None = None
        self._table_ref: object = None
        self._epoch = 0
        self._param_slabs: dict[int, torch.Tensor] | None = None
        self._adopted_ref: object = None
        self._slab_epoch = -1
        self._latched_off = False
        self._obs_closes = obs_stats.counter("ps.apply.arena")
        self._obs_fallbacks = obs_stats.counter("ps.apply.arena_fallback")
        self._obs_pad = obs_stats.gauge("ps.apply.arena_pad")
        self.last_fallback = ""

    @property
    def active(self) -> bool:
        return not self._latched_off

    def note_close(self) -> None:
        self._obs_closes.add()

    def fallback(self, reason: str) -> None:
        """This close takes the per-tensor device path (counted)."""
        self._obs_fallbacks.add()
        self.last_fallback = reason

    def latch_off(self, reason: str) -> None:
        """A packing exception turns the arena off for this core."""
        self._latched_off = True
        self.fallback(f"latched: {reason}")

    # ------------------------------------------------------------ table
    def ensure_table(self, store: Mapping) -> PackingTable | None:
        """The packing table of ``store`` (the live params), rebuilt on a
        shape change; None when latched off or the store is empty.  A
        build failure latches off."""
        if self._latched_off or not store:
            return None
        if self.table is not None and self._table_ref is store:
            return self.table
        try:
            with self._lock:
                if self.table is not None and self._table_ref is store:
                    return self.table
                sig = store_signature(store)
                if self.table is None or self.table.signature != sig:
                    self._epoch += 1
                    self.table = PackingTable(store, self._stripes,
                                              self._epoch)
                    self._param_slabs = None
                    self._adopted_ref = None
                    total = max(1, self.table.total_elems)
                    self._obs_pad.set(round(self.table.padding_elems
                                            / total, 4))
                self._table_ref = store
                return self.table
        except Exception as exc:  # noqa: BLE001 — never fail a fold
            self.latch_off(f"{type(exc).__name__}: {exc}")
            return None

    def new_accum(self, table: PackingTable) -> ArenaAccum:
        return ArenaAccum(table, self.device)

    # ------------------------------------------------------------ slabs
    def ensure_param_slabs(self, store: Mapping,
                           table: PackingTable) -> dict[int, torch.Tensor]:
        """The device param slabs of ``store``: the previous close's
        output adopted by identity, else packed per stripe (host values
        in one upload, device values by one launch).  Raises on failure
        (the caller latches off and closes per tensor)."""
        with self._lock:
            if (self._param_slabs is not None
                    and self._adopted_ref is store
                    and self._slab_epoch == table.epoch):
                return self._param_slabs
            slabs: dict[int, torch.Tensor] = {}
            for stripe in range(table.stripes):
                size = table.stripe_sizes[stripe]
                if not size:
                    continue
                names = table.stripe_names[stripe]
                slabs[stripe] = device_apply.slab_assemble(
                    table.ranges(stripe), [store[n] for n in names], size,
                    self.device)
            self._param_slabs = slabs
            self._adopted_ref = store
            self._slab_epoch = table.epoch
            return slabs

    def adopt(self, store: ArenaStore, slabs: dict[int, torch.Tensor]) -> None:
        """Keep a close's output slabs as the next close's input (the
        close never writes into them)."""
        with self._lock:
            self._param_slabs = dict(slabs)
            self._adopted_ref = store
            self._slab_epoch = store.layout.epoch

    def invalidate(self) -> None:
        """Store-mutation fence (restore, initialise): the adopted slabs
        no longer describe the live store."""
        with self._lock:
            self._param_slabs = None
            self._adopted_ref = None
            self._table_ref = None
