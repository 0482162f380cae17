"""The accelerator-resident barrier close: the port of
parameter_server_distributed_tpu/core/device_apply.py.

``PSDT_DEVICE_APPLY=1`` moves the PS close off host numpy.  Push chunks
decode onto the PS's device (:func:`tensor_to_device`: a packed payload
crosses to the card as its wire bytes, and the bf16 upcast, the int8
dequantize and the top-k scatter run there), the accumulator holds
device sums, and the sharded optimizer
(async_sgd/device_optimizer.py ``ShardedDeviceOptimizer``) updates each
stripe on the card.  Default off: every host path is unchanged.

The numpy path is the oracle, bit for bit.  The reference reaches that
by splitting each rule into jit programs around XLA:CPU's FMA
contraction; the port computes each stage with the hand-written kernels
of ``ops/device_apply.py`` (``csrc/device_apply.cu``, built without
contraction, every operation rounded on its own), one kernel a stage:
:func:`fold_add`, :func:`owned_copy`, the bf16 and int8 lanes of
:func:`device_unpack`, :func:`slab_update` and :func:`slab_assemble` are
``fold_segments``; :func:`scale_mean` is ``scale_mean``; the top-k lane
is ``topk_scatter``.  Where the device is the CPU (the caller asked for
it), the same functions run the kernels' plain versions.

Torch tensors are mutable where jax arrays are not, so the port never
writes into a tensor it did not allocate: a fold seeds an owned copy
(:func:`owned_copy`), an update writes fresh params, and host payloads
(views into a gRPC message or a ring frame, freed once the fold returns)
go through :func:`upload`, which copies them into pinned staging before
the asynchronous copy to the card is queued.  Every launch is queued on
the device's current stream, which every thread shares.

The reference's scratch recycling (``_scr``, the runtime-false
``where(pred, scr, expr)``) has no counterpart: torch's caching
allocator reuses blocks, and a one-kernel rule has no intermediates.
Its XLA:CPU tuning (``PSDT_DEVICE_XLA_TUNE``) has none either, nor its
stripe-dispatch bound (``PSDT_DEVICE_STRIPE_DISPATCH_MAX``, which sized
fan-out to XLA:CPU's thread pool): every launch goes to the one stream,
so the PS core issues a device close's launches from the thread that
runs it.
``PSDT_DEVICE_STAGE_CHUNK`` (sub-chunked stage programs, the machinery
of the cross-replica sharded update) is not ported: ROADMAP.md Queue 1,
item 13.
"""

from __future__ import annotations

import os
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..device import same_device
from ..ops import device_apply as ops

ENV_DEVICE_APPLY = "PSDT_DEVICE_APPLY"
ENV_STAGE_CHUNK = "PSDT_DEVICE_STAGE_CHUNK"

ROADMAP_SHARDED_UPDATE = ("ROADMAP.md Queue 1, item 13 (the cross-replica "
                          "sharded update)")

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32}


def enabled() -> bool:
    """The per-process knob; default off."""
    return os.environ.get(ENV_DEVICE_APPLY, "") not in ("", "0")


def available(device=None) -> bool:
    """True when ``device`` (None: the card) exists.  The CPU counts
    only where the caller asked for it by naming it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return torch.cuda.is_available()
    return dev.type == "cpu"


def stage_chunk_elems() -> int:
    """``PSDT_DEVICE_STAGE_CHUNK``: raises when set, as it is not
    ported."""
    raw = os.environ.get(ENV_STAGE_CHUNK, "")
    if raw not in ("", "0"):
        raise NotImplementedError(f"{ENV_STAGE_CHUNK}: "
                                  f"{ROADMAP_SHARDED_UPDATE}")
    return 0


def wants_device_fold(optimizer) -> bool:
    """True when the optimizer is device-resident (the sharded family),
    so folds should accumulate on its device."""
    return bool(getattr(optimizer, "device_resident", False))


# ------------------------------------------------------------ residence
def is_device_array(a) -> bool:
    """True for a tensor: the port's host path holds numpy arrays only,
    so a tensor is the device path's (on the CPU where the caller asked
    for it)."""
    return isinstance(a, torch.Tensor)


def is_device_store(store: Mapping) -> bool:
    return any(is_device_array(v) for v in store.values())


def upload(host: np.ndarray, device) -> torch.Tensor:
    """An owned copy of ``host`` (f32, int8, or 16 / 32-bit words, kept
    as int16 / int32) on ``device``.  On the card the bytes go through
    pinned staging first, so the source may be freed or reused as soon
    as this returns; the caching host allocator keeps the staging block
    until the copy has run."""
    host = np.ascontiguousarray(host)
    if host.dtype == np.uint16:
        host = host.view(np.int16)
    elif host.dtype == np.uint32:
        host = host.view(np.int32)
    elif host.dtype not in _TORCH_DTYPES:
        host = host.astype(np.float32)
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.from_numpy(host.copy())
    staging = torch.empty(host.shape, dtype=_TORCH_DTYPES[host.dtype],
                          pin_memory=True)
    staging.numpy()[...] = host
    return staging.to(dev, non_blocking=True)


def owned_f32(g, device) -> torch.Tensor:
    """An f32 contiguous tensor on ``device`` to read from: a device
    tensor that is one already is adopted (and never written), anything
    else is copied there."""
    if isinstance(g, torch.Tensor):
        dev = torch.device(device)
        if (g.dtype == torch.float32 and g.is_contiguous()
                and same_device(g.device, dev)):
            return g
        return g.to(dev, torch.float32).contiguous()
    return upload(np.asarray(g, np.float32), device)


def owned_copy(g, device) -> torch.Tensor:
    """A freshly allocated f32 copy on ``device``, never an adoption:
    the seed of a running sum or a slot that later launches update in
    place (the numpy path's ``np.array(g)``)."""
    if not isinstance(g, torch.Tensor):
        return upload(np.asarray(g, np.float32), device)
    g = g.contiguous()
    if (not same_device(g.device, torch.device(device))
            or g.dtype not in ops.SRC_KINDS):
        return g.to(device, torch.float32, copy=True).contiguous()
    out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
    ops.fold_segments([ops.Segment(out, 0, g, 0, g.numel())], add=False)
    return out


def fold_add(acc: torch.Tensor, g) -> torch.Tensor:
    """``acc += g`` in place on acc's device (one rounding an element,
    ``np.add(acc, g, out=acc)`` exactly); returns ``acc``.  Raises on a
    shape mismatch before anything is written, with numpy's rule: ``g``
    may broadcast up to acc's shape, but a result shape other than
    acc's raises."""
    g_shape = tuple(np.shape(g)) if not isinstance(g, torch.Tensor) \
        else tuple(g.shape)
    try:
        result = np.broadcast_shapes(tuple(acc.shape), g_shape)
    except ValueError as exc:
        raise ValueError(f"fold shape mismatch: accumulator "
                         f"{tuple(acc.shape)} vs gradient {g_shape}") from exc
    if tuple(result) != tuple(acc.shape):
        raise ValueError(f"fold shape mismatch: gradient {g_shape} does not "
                         f"fold into accumulator {tuple(acc.shape)}")
    g = owned_f32(g, acc.device)
    if g_shape != tuple(acc.shape):
        # numpy's broadcast-up (rare: a worker pushing a smaller shape)
        g = g.expand(acc.shape).contiguous()
    ops.fold_segments([ops.Segment(acc, 0, g, 0, acc.numel())], add=True)
    return acc


def inverse_count(count: int) -> float:
    """The contributor-mean scalar, ``np.float32(1.0 / count)``: the
    divide in f64, rounded once."""
    return float(np.float32(1.0 / count))


def scale_mean(acc: torch.Tensor, count: int) -> torch.Tensor:
    """``acc *= 1/count`` in place (the numpy path's scalar); returns
    ``acc``."""
    ops.scale_mean([(acc.view(-1), inverse_count(count))])
    return acc


def scale_means(sums: Mapping, counts: Mapping, names) -> None:
    """:func:`scale_mean` of several device sums in one launch."""
    ops.scale_mean([(sums[n].view(-1), inverse_count(counts[n]))
                    for n in names])


# ------------------------------------------------------------------ slabs
def _merge_ranges(ranges: tuple) -> list:
    """Merge abutting (offset, length) ranges (sorted by offset) into
    (offset, [input indices], total length) segments: a whole-store push
    over an unpadded stripe collapses to one segment."""
    segments: list[tuple[int, list[int], int]] = []
    for i, (off, ln) in enumerate(ranges):
        if segments and segments[-1][0] + segments[-1][2] == off:
            segments[-1] = (segments[-1][0], segments[-1][1] + [i],
                            segments[-1][2] + ln)
        else:
            segments.append((off, [i], ln))
    return segments


def slab_full_cover(ranges: tuple, size: int) -> bool:
    """True when ``ranges`` tile [0, size) exactly."""
    merged = _merge_ranges(ranges)
    return len(merged) == 1 and merged[0][0] == 0 and merged[0][2] == size


def flat_upload(vals, device) -> torch.Tensor:
    """Host values concatenated (one memcpy each) and uploaded once."""
    parts = [np.asarray(v, np.float32).reshape(-1) for v in vals]
    return upload(parts[0] if len(parts) == 1 else np.concatenate(parts),
                  device)


def slab_update(slab: torch.Tensor, ranges: tuple, mode: str, vals,
                flat: bool) -> torch.Tensor:
    """Fold one chunk's tensors into a stripe slab at ``ranges`` (offset,
    length), in place, in one launch: ``mode='set'`` the bit-copy seed of
    fresh names (zeros plus an add would flip -0.0), ``mode='add'`` the
    f32 accumulate.  ``flat=True``: ``vals`` is one f32 tensor holding the
    values back to back (a host lane's single upload); ``flat=False``:
    one device tensor a range."""
    add = mode == "add"
    rows = []
    if flat:
        src, voff = vals[0], 0
        for dst, _idxs, seglen in _merge_ranges(ranges):
            rows.append(ops.Segment(slab, dst, src, voff, seglen))
            voff += seglen
    else:
        for (off, ln), v in zip(ranges, vals):
            rows.append(ops.Segment(slab, off, owned_f32(v, slab.device)
                                    .view(-1), 0, ln))
    ops.fold_segments(rows, add=add)
    return slab


def slab_assemble(ranges: tuple, vals, size: int, device) -> torch.Tensor:
    """A fresh stripe slab of ``size`` elements holding ``vals`` at
    ``ranges`` and zeros elsewhere (padding, names not given).  Host
    values cross in one upload (which is the slab itself when they cover
    it whole); device values are copied in by one launch."""
    host = [(r, v) for r, v in zip(ranges, vals)
            if not isinstance(v, torch.Tensor)]
    dev = [(r, v) for r, v in zip(ranges, vals)
           if isinstance(v, torch.Tensor)]
    if not dev and slab_full_cover(tuple(r for r, _ in host), size):
        return flat_upload([v for _, v in host], device)
    full = slab_full_cover(tuple(sorted(ranges)), size)
    slab = (torch.empty if full else torch.zeros)(
        size, dtype=torch.float32, device=device)
    rows = []
    if host:
        src, voff = flat_upload([v for _, v in host], device), 0
        for (off, ln), _ in host:
            rows.append(ops.Segment(slab, off, src, voff, ln))
            voff += ln
    for (off, ln), v in dev:
        rows.append(ops.Segment(slab, off, owned_f32(v, device).view(-1), 0,
                                ln))
    ops.fold_segments(rows, add=False)
    return slab


# ------------------------------------------------------------- the wire
def device_unpack(wire_dtype: int, raw, total: int, device) -> torch.Tensor:
    """Wire payload -> f32 tensor on ``device``, dequantised there.
    Bit for bit ``Codec.unpack``: the host parses the header and uploads
    the packed bytes (int8 at a quarter of the f32 volume, bf16 at half,
    top-k at the kept entries); the bf16 upcast and the int8 ``q *
    scale`` are ``fold_segments``' lanes, the top-k scatter
    ``topk_scatter``.  Top-k indices must be strictly ascending and in
    range, as the codec writes them."""
    from ..rpc.codec import (WIRE_BF16, WIRE_INT8, WIRE_RAW_F32, WIRE_TOPK)

    if not isinstance(raw, (bytes, bytearray)):
        raw = bytes(raw)
    if wire_dtype == WIRE_RAW_F32:
        return upload(np.frombuffer(raw, dtype="<f4"), device)
    if wire_dtype in (WIRE_BF16, WIRE_INT8):
        if wire_dtype == WIRE_BF16:
            q = upload(np.frombuffer(raw, dtype="<u2"), device).view(
                torch.bfloat16)
            scale = 1.0
        else:
            scale = float(np.frombuffer(raw, dtype="<f4", count=1)[0])
            q = upload(np.frombuffer(raw, dtype=np.int8, offset=4), device)
        out = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
        ops.fold_segments([ops.Segment(out, 0, q, 0, q.numel(), scale)],
                          add=False)
        return out
    if wire_dtype == WIRE_TOPK:
        kept = int(np.frombuffer(raw, dtype="<u4", count=1)[0])
        if not kept:
            return torch.zeros(total, dtype=torch.float32, device=device)
        idx = np.frombuffer(raw, dtype="<u4", offset=4, count=kept)
        if (int(idx[-1]) >= total or total >= 1 << 31
                or (kept > 1 and not bool(np.all(idx[1:] > idx[:-1])))):
            raise ValueError("top-k payload indices are not strictly "
                             "ascending below the tensor's size")
        vals = np.frombuffer(raw, dtype="<u2", offset=4 + 4 * kept,
                             count=kept)
        return ops.topk_scatter(upload(idx, device),
                                upload(vals, device).view(torch.bfloat16),
                                total)
    raise ValueError(f"not a packed wire dtype: {wire_dtype}")


def tensor_to_device(t, device) -> torch.Tensor:
    """A wire ``Tensor`` -> f32 tensor on ``device`` (the device fold's
    input, rpc/data_plane.decode_gradients).  Packed payloads dequantise
    on the device; the repeated-float encoding decodes on the host first
    (it is full f32 already) and crosses in one upload."""
    from ..rpc.codec import PACKED_WIRE_DTYPES
    from ..rpc.wire import ArrayPayload

    packed = t.packed
    if isinstance(packed, ArrayPayload):
        packed = packed.tobytes()
    if t.packed_dtype in PACKED_WIRE_DTYPES and packed:
        arr = device_unpack(t.packed_dtype, packed, int(np.prod(t.shape)),
                            device)
        return arr.reshape(tuple(t.shape)) if t.shape else arr
    return upload(np.asarray(t.to_array(), np.float32), device)


# ------------------------------------------------------------- readback
class Readback(NamedTuple):
    """Host copies of device slabs, and the CUDA event after their
    copies (None on the CPU).  Read :meth:`arrays` only after
    :meth:`wait`."""
    host: dict
    event: object

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def arrays(self) -> dict:
        return {k: t.numpy() for k, t in self.host.items()}


def readback_async(slabs: Mapping) -> Readback:
    """Start the device-to-host copy of every slab into pinned host
    memory without blocking, one copy a slab and one event after them
    all.  CPU slabs are taken as they are (the close never writes into a
    param slab it returned)."""
    host, event = {}, None
    for key, slab in slabs.items():
        if slab.device.type == "cpu":
            host[key] = slab
            continue
        pinned = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
        pinned.copy_(slab, non_blocking=True)
        host[key] = pinned
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(slab.device))
    return Readback(host, event)
