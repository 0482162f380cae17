"""The receiving half of the delta protocol, frame assembly and in-place
apply: the port of parameter_server_distributed_tpu/delta/client.py.

Shared by the worker's data plane (rpc/data_plane.py ``PSClient``) and
the decode fleet's subscriber (delta/subscriber.py): both hold a cached
full pull (:class:`DeltaPullState`) and advance it version by version
by scattering each pair's decoded wire values into the cached arrays.

Order of safety: a pair's entries are buffered until its last frame
arrived, then applied, then the final pair's checksum is checked
against the whole patched store.  A transport error mid-stream leaves
the base untouched; a checksum mismatch after the apply means the base
drifted from what the server believes (a PS restart, a missed reset),
so the caller drops it, pulls in full, and downgrades the connection.
"""

from __future__ import annotations

import numpy as np

from ..rpc import messages as m
from .chain import decode_wire_values, store_crc

TensorStore = dict


class DeltaBaseMismatch(RuntimeError):
    """The cached base no longer matches the server's idea of the held
    version (a checksum or version-bookkeeping failure)."""


class DeltaPullState:
    """The receiver's cached pull: the base store deltas patch, and the
    store version it corresponds to (-1 = none)."""

    __slots__ = ("base", "version")

    def __init__(self):
        self.base: TensorStore | None = None
        self.version = -1

    def note_full(self, store: TensorStore, version: int) -> None:
        self.base = store
        self.version = int(version)

    def invalidate(self) -> None:
        self.base = None
        self.version = -1


class DeltaRoundResult:
    __slots__ = ("push", "store", "update", "served_delta", "to_version",
                 "wire_bytes", "crc")

    def __init__(self):
        self.push: m.PushResponse | None = None
        self.store: TensorStore | None = None
        # ParameterUpdate-shaped metadata for the wire negotiation: only
        # a full serve carries tensors to negotiate from
        self.update: m.ParameterUpdate | None = None
        self.served_delta = False
        self.to_version = -1
        self.wire_bytes = 0
        # the checked store checksum of a delta-served round (port-only)
        self.crc: int | None = None


def _apply_entry(store: TensorStore, entry, wire_dtype: int) -> None:
    arr = store.get(entry.name)
    if arr is None:
        raise DeltaBaseMismatch(f"delta names unknown tensor {entry.name!r}")
    if not (isinstance(arr, np.ndarray) and arr.flags["C_CONTIGUOUS"]
            and arr.flags["WRITEABLE"] and arr.dtype == np.float32):
        arr = np.array(arr, np.float32)
        store[entry.name] = arr
    flat = arr.reshape(-1)
    vals = decode_wire_values(entry.values, wire_dtype)
    if entry.dense:
        if vals.size != flat.size:
            raise DeltaBaseMismatch(
                f"dense delta size {vals.size} != tensor {entry.name!r} "
                f"size {flat.size}")
        flat[:] = vals
        return
    idx = np.frombuffer(entry.indices, dtype="<u4")
    if idx.size != vals.size:
        raise DeltaBaseMismatch(
            f"delta index/value count mismatch on {entry.name!r}")
    if idx.size and int(idx.max()) >= flat.size:
        # the bytes come off the wire: check the largest index, not the
        # last
        raise DeltaBaseMismatch(
            f"delta index out of range on {entry.name!r}")
    flat[idx] = vals


def apply_frames(frames, state: DeltaPullState,
                 on_full_chunk=None) -> DeltaRoundResult:
    """Fold a DeltaFrame stream into the round's result, applying delta
    pairs in place to ``state.base``.  ``on_full_chunk(tensors)`` is the
    plain data plane's per-chunk consumer, for full frames.

    Raises :class:`DeltaBaseMismatch` when the base cannot take the
    served chain (no base, a version gap, a checksum failure); the base
    may then be partly patched and the caller must invalidate it."""
    out = DeltaRoundResult()
    local: TensorStore = {}
    meta: list[m.Tensor] = []
    full_iteration, full_ready, got_full = 0, False, False
    pending: list = []          # the buffered entries of the open pair
    pair_from = pair_to = -1
    applied_any = False
    final_crc: int | None = None
    for frame in frames:
        if frame.push is not None and out.push is None:
            out.push = frame.push
        if frame.params is not None:
            got_full = True
            chunk = frame.params
            full_iteration, full_ready = chunk.iteration, chunk.ready
            if chunk.parameters:
                if on_full_chunk is not None:
                    on_full_chunk(chunk.parameters)
                local.update(
                    {t.name: t.to_array() for t in chunk.parameters})
                meta.extend(m.Tensor(name=t.name,
                                     packed_dtype=t.packed_dtype)
                            for t in chunk.parameters)
            if frame.to_version:
                out.to_version = frame.to_version
        if frame.delta:
            if pair_from < 0:
                pair_from, pair_to = frame.from_version, frame.to_version
            elif (frame.from_version, frame.to_version) != (pair_from,
                                                            pair_to):
                raise DeltaBaseMismatch("interleaved delta pairs")
            pending.extend(frame.entries)
            out.wire_bytes += sum(len(e.indices) + len(e.values)
                                  for e in frame.entries)
            if frame.last:
                # one pair complete: apply it to the base
                if state.base is None or state.version != pair_from:
                    raise DeltaBaseMismatch(
                        f"delta pair {pair_from}->{pair_to} does not "
                        f"chain from held version {state.version}")
                for entry in pending:
                    try:
                        _apply_entry(state.base, entry, frame.wire_dtype)
                    except DeltaBaseMismatch:
                        raise
                    except (ValueError, IndexError, TypeError) as exc:
                        # malformed wire bytes take the drifted base's
                        # path, never a raw numpy error in the caller
                        raise DeltaBaseMismatch(
                            f"malformed delta entry for "
                            f"{entry.name!r}: {exc}") from exc
                applied_any = True
                state.version = pair_to
                out.to_version = pair_to
                final_crc = frame.crc
                pending, pair_from, pair_to = [], -1, -1
    if pending:
        raise DeltaBaseMismatch("delta stream ended mid-pair")
    if applied_any:
        out.served_delta = True
        if final_crc is not None and final_crc != store_crc(state.base):
            raise DeltaBaseMismatch(
                f"post-apply checksum mismatch at version "
                f"{state.version}")
        out.store = state.base
        out.crc = final_crc
        return out
    if got_full and full_ready:
        out.store = local
        out.update = m.ParameterUpdate(iteration=full_iteration,
                                       parameters=meta, ready=True)
        if out.to_version >= 0:
            state.note_full(local, out.to_version)
        else:
            # a server that stamps no version cannot be a delta base
            state.invalidate()
    return out
