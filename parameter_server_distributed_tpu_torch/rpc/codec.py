"""The wire payload codec: the port's copy of
parameter_server_distributed_tpu/rpc/codec.py, one interface and two
implementations.

Every packed tensor payload on the wire (the ``Tensor.packed`` extension
field, rpc/messages.py) is produced and consumed here:

- :class:`PythonCodec`, in numpy: the byte-identity oracle and the
  fallback that needs no compiler;
- :class:`NativeCodec`, the C++ fast path (native/psdt_native.cpp): one
  pass over pointers into the caller's arrays and the encoder's message
  buffer, outside the GIL.  An operation the library cannot take falls
  back to numpy per call: never another answer, at worst a slower one.

:func:`active_codec` resolves per call to the native codec whenever
``native.lib()`` is available and enabled (``PSDT_NATIVE=0`` or
``native.set_enabled(False)`` forces numpy), and records the choice in
the ``rpc.codec.native`` gauge (1 = native).

The layouts are the reference's, byte for byte (little-endian):

- ``WIRE_RAW_F32``:  n * f32
- ``WIRE_BF16``:     n * bf16 (round-to-nearest-even)
- ``WIRE_INT8``:     f32 max-abs scale | n * int8
- ``WIRE_TOPK``:     u32 k | k * u32 ascending indices | k * bf16 values

Top-k selection is part of the contract: elements with |v| strictly above
the k-th largest |v|, ties at the threshold filled in ascending index
order, NaNs filling any slots left (:func:`topk_indices`).

The reference's Python codec casts to bf16 through ``ml_dtypes`` (which
ships with jax); the port's rounds in numpy on the bit pattern, with the
same answer for every input: round-to-nearest-even, and a NaN becomes the
quiet NaN of its sign.  The two C++ libraries keep a NaN's top payload
bits instead (``f32_to_bf16``), so on a NaN whose payload reaches them the
Python and native codecs of either package differ; every other input,
infinities and subnormals included, packs to the same bytes.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..obs import stats as obs_stats

# Wire encodings for Tensor payloads.  WIRE_F32 is the reference encoding
# (packed `repeated float`, field 3) and never reaches the codec; the
# packed encodings ride fields 5/6, which reference peers skip.
WIRE_F32 = 0       # repeated float field 3 (reference-compatible, default)
WIRE_RAW_F32 = 1   # raw little-endian float32 bytes in field 5
WIRE_BF16 = 2      # raw bfloat16 bytes in field 5: half the payload
WIRE_INT8 = 3      # f32 max-abs scale + int8 bytes in field 5
WIRE_TOPK = 4      # u32 k | k*u32 indices | k*bf16 values in field 5

WIRE_DTYPE_NAMES = {"f32": WIRE_F32, "raw": WIRE_RAW_F32, "bf16": WIRE_BF16,
                    "int8": WIRE_INT8, "topk": WIRE_TOPK}

# the packed encodings the codec handles (everything but repeated-float)
PACKED_WIRE_DTYPES = (WIRE_RAW_F32, WIRE_BF16, WIRE_INT8, WIRE_TOPK)

TOPK_DEFAULT_DENSITY = 0.01  # fraction of entries a topk tensor keeps

def topk_k(size: int, density: float) -> int:
    """Kept-entry count for a WIRE_TOPK payload of ``size`` elements."""
    if not size:
        return 0
    return min(size, max(1, int(round(size * density))))


def payload_nbytes(wire_dtype: int, size: int, k: int = 0) -> int:
    """Exact payload byte count, known before any encode runs."""
    if wire_dtype == WIRE_RAW_F32:
        return 4 * size
    if wire_dtype == WIRE_BF16:
        return 2 * size
    if wire_dtype == WIRE_INT8:
        return 4 + size
    if wire_dtype == WIRE_TOPK:
        return 4 + 6 * k
    raise ValueError(f"not a packed wire dtype: {wire_dtype}")


def bf16_bits(src: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round-to-nearest-even;
    a NaN becomes 0x7FC0 with its sign bit."""
    u = np.ascontiguousarray(src, np.float32).reshape(-1).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(src.reshape(-1))
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000 | 0x7FC0).astype(np.uint16)
    return out


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def topk_indices(flat: np.ndarray, k: int) -> np.ndarray:
    """Deterministic top-k-|value| selection (ascending u32 indices): the
    threshold is the k-th largest |v| (``np.partition``); everything
    strictly above it is kept, ties at it fill the remaining slots in
    ascending index order, and NaNs (which numpy sorts as the largest)
    fill any slots still left, ascending."""
    n = int(flat.size)
    if k >= n:
        return np.arange(n, dtype="<u4")
    ab = np.abs(flat)
    thr = np.partition(ab, n - k)[n - k]
    above = np.nonzero(ab > thr)[0]
    at = np.nonzero(ab == thr)[0][:k - above.size]
    short = k - above.size - at.size
    if short > 0:  # NaNs in the top-k range (possibly thr itself)
        at = np.concatenate([at, np.nonzero(np.isnan(ab))[0][:short]])
    return np.sort(np.concatenate([above, at])).astype("<u4")


class PythonCodec:
    """Flat f32 array <-> packed payload bytes, in numpy.  ``pack_into``
    writes the exact ``payload_nbytes`` payload of ``src`` (flat
    contiguous float32) into the writable buffer ``dst``; ``unpack``
    inverts it (``total`` is the dense element count, which WIRE_TOPK's
    scatter needs)."""

    name = "python"

    def pack_into(self, wire_dtype: int, src: np.ndarray, dst,
                  k: int = 0) -> None:
        if wire_dtype == WIRE_RAW_F32:
            np.copyto(np.frombuffer(dst, dtype="<f4"), src,
                      casting="unsafe")
        elif wire_dtype == WIRE_BF16:
            np.frombuffer(dst, dtype="<u2")[:] = bf16_bits(src)
        elif wire_dtype == WIRE_INT8:
            out = np.frombuffer(dst, np.uint8)
            max_abs = float(np.max(np.abs(src))) if src.size else 0.0
            scale = max_abs / 127.0 if max_abs > 0 else 1.0
            out[:4] = np.frombuffer(np.float32(scale).tobytes(), np.uint8)
            q = np.clip(np.rint(src / np.float32(scale)),
                        -127, 127).astype(np.int8)
            out[4:] = q.view(np.uint8)
        elif wire_dtype == WIRE_TOPK:
            out = np.frombuffer(dst, np.uint8)
            out[:4] = np.frombuffer(np.uint32(k).tobytes(), np.uint8)
            if k:
                idx = topk_indices(src, k)
                vals = bf16_bits(src[idx.astype(np.int64)])
                out[4:4 + 4 * k] = idx.view(np.uint8)
                out[4 + 4 * k:] = vals.view(np.uint8)
        else:
            raise ValueError(f"not a packed wire dtype: {wire_dtype}")

    def unpack(self, wire_dtype: int, raw, total: int) -> np.ndarray:
        if wire_dtype == WIRE_BF16:
            return bf16_to_f32(np.frombuffer(raw, dtype="<u2"))
        if wire_dtype == WIRE_RAW_F32:
            # zero-copy view; Tensor.to_array copies where it must
            return np.frombuffer(raw, dtype="<f4").astype(np.float32,
                                                          copy=False)
        if wire_dtype == WIRE_INT8:
            scale = np.frombuffer(raw, dtype="<f4", count=1)[0]
            return np.frombuffer(raw, dtype=np.int8,
                                 offset=4).astype(np.float32) * scale
        if wire_dtype == WIRE_TOPK:
            k = int(np.frombuffer(raw, dtype="<u4", count=1)[0])
            arr = np.zeros(total, np.float32)
            if k:
                idx = np.frombuffer(raw, dtype="<u4", offset=4, count=k)
                vals = np.frombuffer(raw, dtype="<u2", offset=4 + 4 * k,
                                     count=k)
                arr[idx.astype(np.int64)] = bf16_to_f32(vals)
            return arr
        raise ValueError(f"not a packed wire dtype: {wire_dtype}")


class NativeCodec(PythonCodec):
    """The C++ fast path (native/psdt_native.cpp).  Each operation tries
    the native function and takes the numpy path when it declines
    (library unavailable, an unsuitable layout, or a malformed payload
    that the Python path rejects loudly).  ``WIRE_RAW_F32`` is a copy
    either way, left to numpy."""

    name = "native"

    def pack_into(self, wire_dtype: int, src: np.ndarray, dst,
                  k: int = 0) -> None:
        if wire_dtype == WIRE_BF16:
            if native.pack_bf16_native(src, dst):
                return
        elif wire_dtype == WIRE_INT8:
            if native.quant_int8_native(src, dst):
                return
        elif wire_dtype == WIRE_TOPK:
            if native.topk_pack_native(src, k, dst):
                return
        super().pack_into(wire_dtype, src, dst, k)

    def unpack(self, wire_dtype: int, raw, total: int) -> np.ndarray:
        if wire_dtype == WIRE_BF16:
            out = np.empty(len(raw) // 2, np.float32)
            if native.unpack_bf16_native(raw, out):
                return out
        elif wire_dtype == WIRE_INT8:
            out = np.empty(max(0, len(raw) - 4), np.float32)
            if native.dequant_int8_native(raw, out):
                return out
        elif wire_dtype == WIRE_TOPK:
            out = np.empty(total, np.float32)
            if native.topk_unpack_native(raw, out):
                return out
        return super().unpack(wire_dtype, raw, total)


_PYTHON = PythonCodec()
_NATIVE = NativeCodec()


def active_codec() -> PythonCodec:
    """The process-wide codec: native when the library is available and
    enabled, numpy otherwise, resolved per call (a flip of
    ``native.set_enabled`` takes effect at once) and recorded in the
    ``rpc.codec.native`` gauge."""
    codec = _NATIVE if native.lib() is not None else _PYTHON
    obs_stats.gauge("rpc.codec.native").set(1.0 if codec is _NATIVE
                                            else 0.0)
    return codec
