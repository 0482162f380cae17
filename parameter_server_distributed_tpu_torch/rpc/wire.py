"""Minimal proto3 wire-format codec: the port's copy of
parameter_server_distributed_tpu/rpc/wire.py.

The reference's services (proto/parameter_server.proto,
proto/coordinator.proto) are spoken without protoc or grpc_tools
gencode: messages are declared in Python (``messages.py``) and encoded
and decoded here, byte for byte as the JAX package does, so either
package's peers read the other's messages.

The proto3 subset the schemas use:

- varint scalar fields: int32, int64, bool, enum (wire type 0)
- fixed32 float fields (wire type 5)
- length-delimited: string, bytes, embedded messages, packed repeated
  scalars (wire type 2)
- repeated messages (one length-delimited record per element)
- packed repeated float / int32, with decoders accepting both packed and
  unpacked encodings of repeated scalars
- proto3 default-value elision on encode; unknown-field skipping on decode

Packed ``repeated float`` payloads (the tensor data plane) move as raw
little-endian buffers through numpy.  Packed encodings (bf16, int8,
top-k) run through the codec (``codec.py``) straight into the outgoing
message buffer.  The encoder writes into a ``bytes`` object allocated
uninitialised through the CPython C API (ctypes.pythonapi), since gRPC's
serializer takes nothing else and a bytearray would cost one more copy
of every message; no library of the project's own is loaded.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Any

import numpy as np

from . import codec as _codec

# Wire types
WT_VARINT = 0
WT_FIXED64 = 1
WT_LEN = 2
WT_FIXED32 = 5

_U64_MASK = (1 << 64) - 1

# bytes fields at or below this size are copied out of the RPC buffer at
# decode time (see the "bytes" branch in _decode_field); larger payloads
# (tensor data) stay zero-copy memoryviews into the caller's buffer.
_BYTES_COPY_THRESHOLD = 4096


def encode_varint(value: int) -> bytes:
    """Encode a non-negative (or two's-complement 64-bit wrapped) varint."""
    value &= _U64_MASK
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    """Decode a varint at ``pos``; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result & _U64_MASK, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed32(value: int) -> int:
    """Interpret a decoded varint as int32 (two's complement, per proto3)."""
    value &= 0xFFFFFFFF
    if value >= 1 << 31:
        value -= 1 << 32
    return value


def _signed64(value: int) -> int:
    value &= _U64_MASK
    if value >= 1 << 63:
        value -= 1 << 64
    return value


def _tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == WT_VARINT:
        _, pos = decode_varint(buf, pos)
    elif wire_type == WT_FIXED64:
        pos += 8
    elif wire_type == WT_LEN:
        length, pos = decode_varint(buf, pos)
        pos += length
    elif wire_type == WT_FIXED32:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    if pos > len(buf):
        raise ValueError("truncated field")
    return pos


class Field:
    """Declarative spec for one proto3 field."""

    __slots__ = ("number", "name", "kind", "message_type", "repeated")

    def __init__(self, number: int, name: str, kind: str,
                 message_type: type | None = None, repeated: bool = False):
        self.number = number
        self.name = name
        self.kind = kind  # int32|int64|bool|enum|string|bytes|float|message
        self.message_type = message_type
        self.repeated = repeated


class Message:
    """Base class for declarative proto3 messages.

    Subclasses define ``FIELDS: tuple[Field, ...]`` and plain attributes.
    """

    FIELDS: tuple[Field, ...] = ()

    def __init__(self, **kwargs: Any):
        for f in self.FIELDS:
            setattr(self, f.name, kwargs.pop(f.name, _default_for(f)))
        if kwargs:
            raise TypeError(f"unknown fields for {type(self).__name__}: {sorted(kwargs)}")

    # -- encoding ---------------------------------------------------------
    def encode(self) -> bytes:
        """Two-pass encode: size everything, preallocate once, write in
        place.  Naive bytearray appending copies each nested tensor body
        ~3x (child buffer -> parent growth -> final bytes); at the scale of
        a large model (hundreds of MB per push) those copies dominate push/pull
        latency, so the encoder is exactly-sized instead."""
        writer = _Writer(self.encoded_size())
        self.encode_into(writer)
        return writer.getvalue()

    def encoded_size(self) -> int:
        return sum(_field_size(f, getattr(self, f.name))
                   for f in self.FIELDS)

    def encode_into(self, writer: "_Writer") -> None:
        for f in self.FIELDS:
            _encode_field(writer, f, getattr(self, f.name))

    # -- decoding ---------------------------------------------------------
    @classmethod
    def decode(cls, buf: bytes | memoryview):
        msg = cls()
        # memoryview input decodes zero-copy; nested messages and bytes
        # fields become views into the caller's buffer (which they keep
        # alive), so a 100MB+ gradient push is never re-sliced wholesale
        if not isinstance(buf, (bytes, memoryview)):
            buf = bytes(buf)
        by_number = cls._fields_by_number()
        pos = 0
        n = len(buf)
        while pos < n:
            key, pos = decode_varint(buf, pos)
            field_number = key >> 3
            wire_type = key & 0x7
            f = by_number.get(field_number)
            if f is None:
                pos = _skip_field(buf, pos, wire_type)
                continue
            pos = _decode_field(msg, buf, pos, f, wire_type)
        return msg

    _BY_NUMBER_CACHE: dict[type, dict[int, Field]] = {}

    @classmethod
    def _fields_by_number(cls) -> dict[int, Field]:
        cached = Message._BY_NUMBER_CACHE.get(cls)
        if cached is None:
            cached = {f.number: f for f in cls.FIELDS}
            Message._BY_NUMBER_CACHE[cls] = cached
        return cached

    # -- misc -------------------------------------------------------------
    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if isinstance(v, np.ndarray):
                v = f"<float32[{v.size}]>"
            parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _default_for(f: Field) -> Any:
    if f.repeated:
        return np.zeros((0,), np.float32) if f.kind == "float" else []
    return {
        "int32": 0, "int64": 0, "enum": 0, "bool": False,
        "string": "", "bytes": b"", "float": 0.0,
    }.get(f.kind) if f.kind != "message" else None


class ArrayPayload:
    """Lazy bytes-field payload: a flat float32 source array plus the
    packed WIRE_* encoding it should be sent as.  The encode — dtype cast,
    int8 quantization, or top-k sparsify+pack — happens directly into the
    outgoing message buffer at encode time (``_Writer.write_array``)
    through the codec: one fused pass instead of separate quantize +
    ``tobytes`` + buffer-write sweeps over GBs of tensor payload.

    Anything that needs the payload outside an encode (same-process
    ``to_array``) materializes via :meth:`tobytes`,
    which reproduces the exact bytes a wire round-trip would carry; the
    materialization is cached so a later encode replays it as a memcpy.
    """

    __slots__ = ("src", "wire_dtype", "k", "nbytes", "_cache")

    def __init__(self, src: np.ndarray, wire_dtype: int, k: int = 0) -> None:
        self.src = np.ascontiguousarray(src, np.float32).reshape(-1)
        self.wire_dtype = int(wire_dtype)
        self.k = int(k)
        self.nbytes = _codec.payload_nbytes(self.wire_dtype, self.src.size,
                                            self.k)
        self._cache: bytes | None = None

    def __len__(self) -> int:
        return self.nbytes

    def __bool__(self) -> bool:
        return self.nbytes > 0

    def pack_into(self, dst) -> None:
        """Write the exact payload bytes into the writable buffer ``dst``
        (length ``nbytes``) via the active codec."""
        if self._cache is not None:
            dst[:] = self._cache
        else:
            _codec.active_codec().pack_into(self.wire_dtype, self.src, dst,
                                            self.k)

    def tobytes(self) -> bytes:
        if self._cache is None:
            buf = bytearray(self.nbytes)
            _codec.active_codec().pack_into(self.wire_dtype, self.src,
                                            memoryview(buf), self.k)
            self._cache = bytes(buf)
        return self._cache


# Uninitialized-bytes allocation via the CPython C API: the encoder writes
# its output directly into the `bytes` object handed to gRPC (whose cython
# layer accepts nothing else), skipping both bytearray's zero-fill sweep
# and the final buffer->bytes copy.  Mutating the object is safe because it
# is unreachable by any other code until encode() returns it.
_pyapi = ctypes.pythonapi
_pyapi.PyBytes_FromStringAndSize.restype = ctypes.py_object
_pyapi.PyBytes_FromStringAndSize.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
_pyapi.PyBytes_AsString.restype = ctypes.c_void_p
_pyapi.PyBytes_AsString.argtypes = [ctypes.py_object]


def _alloc_uninit_bytes(size: int) -> tuple[bytes, np.ndarray]:
    """Return (bytes_of_len_size, writable uint8 view into it)."""
    obj = _pyapi.PyBytes_FromStringAndSize(None, size)
    addr = _pyapi.PyBytes_AsString(obj)
    view = np.frombuffer((ctypes.c_ubyte * size).from_address(addr), np.uint8)
    return obj, view


class _Writer:
    """Exact-size in-place buffer writer (see Message.encode), backed by an
    uninitialized `bytes` object so ``getvalue()`` is zero-copy (gRPC's
    serializer contract requires `bytes`; anything else would force a final
    whole-message copy)."""

    __slots__ = ("_out", "buf", "_view", "pos")

    def __init__(self, size: int):
        if size:
            self._out, self.buf = _alloc_uninit_bytes(size)
        else:
            self._out, self.buf = b"", np.empty(0, np.uint8)
        self._view = memoryview(self.buf)
        self.pos = 0

    def write(self, data) -> None:
        n = len(data)
        self._view[self.pos:self.pos + n] = data
        self.pos += n

    def write_array(self, payload: ArrayPayload) -> None:
        """Fused encode-and-store of an ArrayPayload: the codec (dtype
        cast / quantize / top-k pack) writes straight into the message
        buffer (no intermediate array/bytes)."""
        n = payload.nbytes
        payload.pack_into(self._view[self.pos:self.pos + n])
        self.pos += n

    def getvalue(self) -> bytes:
        assert self.pos == len(self._out), (self.pos, len(self._out))
        return self._out


def _varint_size(value: int) -> int:
    value &= _U64_MASK
    n = 1
    while value >= 0x80:
        value >>= 7
        n += 1
    return n


def _len_delimited_size(field_number: int, body_len: int) -> int:
    return (_varint_size(field_number << 3) + _varint_size(body_len)
            + body_len)


def _field_size(f: Field, value: Any) -> int:
    """Exact encoded byte count of one field, mirroring _encode_field's
    branching (incl. proto3 default elision) case for case — the two are
    kept adjacent and any divergence corrupts the stream (covered by the
    byte-identity tests against the JAX package's codec in
    tests/test_torch_wire.py)."""
    kind = f.kind
    if f.repeated:
        if kind == "message":
            return sum(_len_delimited_size(f.number, item.encoded_size())
                       for item in value)
        if kind == "float":
            arr = np.asarray(value, dtype="<f4")
            if not arr.size:
                return 0
            return _len_delimited_size(f.number, 4 * arr.size)
        if kind in ("int32", "int64", "enum", "bool"):
            if not value:
                return 0
            body = sum(_varint_size(int(item)) for item in value)
            return _len_delimited_size(f.number, body)
        if kind == "string":
            return sum(_len_delimited_size(f.number,
                                           len(item.encode("utf-8")))
                       for item in value)
        raise TypeError(f"unsupported repeated kind {kind}")
    if kind in ("int32", "int64", "enum"):
        if not value:
            return 0
        return _varint_size(f.number << 3) + _varint_size(int(value))
    if kind == "bool":
        return _varint_size(f.number << 3) + 1 if value else 0
    if kind == "string":
        if not value:
            return 0
        return _len_delimited_size(f.number, len(value.encode("utf-8")))
    if kind == "bytes":
        if not value:
            return 0
        return _len_delimited_size(f.number, len(value))
    if kind == "float":
        if not value:
            return 0
        return _varint_size((f.number << 3) | WT_FIXED32) + 4
    if kind == "message":
        if value is None:
            return 0
        return _len_delimited_size(f.number, value.encoded_size())
    raise TypeError(f"unsupported kind {kind}")


def _encode_field(out: "_Writer", f: Field, value: Any) -> None:
    kind = f.kind
    if f.repeated:
        if kind == "message":
            for item in value:
                out.write(_tag(f.number, WT_LEN))
                out.write(encode_varint(item.encoded_size()))
                item.encode_into(out)
        elif kind == "float":
            arr = np.asarray(value, dtype="<f4")
            if arr.size:
                out.write(_tag(f.number, WT_LEN))
                out.write(encode_varint(4 * arr.size))
                out.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
        elif kind in ("int32", "int64", "enum", "bool"):
            if value:
                body = bytearray()
                for item in value:
                    body += encode_varint(int(item))
                out.write(_tag(f.number, WT_LEN))
                out.write(encode_varint(len(body)))
                out.write(body)
        elif kind == "string":
            for item in value:
                data = item.encode("utf-8")
                out.write(_tag(f.number, WT_LEN))
                out.write(encode_varint(len(data)))
                out.write(data)
        else:
            raise TypeError(f"unsupported repeated kind {kind}")
        return

    if kind in ("int32", "int64", "enum"):
        if value:
            out.write(_tag(f.number, WT_VARINT))
            out.write(encode_varint(int(value)))
    elif kind == "bool":
        if value:
            out.write(_tag(f.number, WT_VARINT))
            out.write(b"\x01")
    elif kind == "string":
        if value:
            data = value.encode("utf-8")
            out.write(_tag(f.number, WT_LEN))
            out.write(encode_varint(len(data)))
            out.write(data)
    elif kind == "bytes":
        if value:
            out.write(_tag(f.number, WT_LEN))
            out.write(encode_varint(len(value)))
            if isinstance(value, ArrayPayload):
                out.write_array(value)
            else:
                out.write(value)
    elif kind == "float":
        if value:
            out.write(_tag(f.number, WT_FIXED32))
            out.write(struct.pack("<f", value))
    elif kind == "message":
        if value is not None:
            out.write(_tag(f.number, WT_LEN))
            out.write(encode_varint(value.encoded_size()))
            value.encode_into(out)
    else:
        raise TypeError(f"unsupported kind {kind}")


def _decode_field(msg: Message, buf: bytes, pos: int, f: Field, wire_type: int) -> int:
    kind = f.kind
    if f.repeated:
        if kind == "message":
            if wire_type != WT_LEN:
                raise ValueError(f"field {f.name}: bad wire type {wire_type}")
            length, pos = decode_varint(buf, pos)
            end = pos + length
            getattr(msg, f.name).append(
                f.message_type.decode(memoryview(buf)[pos:end]))
            return end
        if kind == "float":
            if wire_type == WT_LEN:  # packed
                length, pos = decode_varint(buf, pos)
                end = pos + length
                arr = np.frombuffer(buf, dtype="<f4", count=length // 4, offset=pos)
                existing = getattr(msg, f.name)
                setattr(msg, f.name,
                        arr if existing.size == 0 else np.concatenate([existing, arr]))
                return end
            if wire_type == WT_FIXED32:  # unpacked element
                val = struct.unpack_from("<f", buf, pos)[0]
                existing = getattr(msg, f.name)
                setattr(msg, f.name, np.append(existing, np.float32(val)))
                return pos + 4
            raise ValueError(f"field {f.name}: bad wire type {wire_type}")
        if kind in ("int32", "int64", "enum", "bool"):
            sign = _signed32 if kind == "int32" else _signed64
            if wire_type == WT_LEN:  # packed
                length, pos = decode_varint(buf, pos)
                end = pos + length
                lst = getattr(msg, f.name)
                while pos < end:
                    v, pos = decode_varint(buf, pos)
                    lst.append(bool(v) if kind == "bool" else sign(v))
                return end
            if wire_type == WT_VARINT:
                v, pos = decode_varint(buf, pos)
                getattr(msg, f.name).append(bool(v) if kind == "bool" else sign(v))
                return pos
            raise ValueError(f"field {f.name}: bad wire type {wire_type}")
        if kind == "string":
            length, pos = decode_varint(buf, pos)
            end = pos + length
            getattr(msg, f.name).append(str(buf[pos:end], "utf-8"))
            return end
        raise TypeError(f"unsupported repeated kind {kind}")

    if kind in ("int32", "int64", "enum"):
        v, pos = decode_varint(buf, pos)
        setattr(msg, f.name, _signed64(v) if kind == "int64" else _signed32(v))
        return pos
    if kind == "bool":
        v, pos = decode_varint(buf, pos)
        setattr(msg, f.name, bool(v))
        return pos
    if kind == "string":
        length, pos = decode_varint(buf, pos)
        end = pos + length
        setattr(msg, f.name, str(buf[pos:end], "utf-8"))
        return end
    if kind == "bytes":
        length, pos = decode_varint(buf, pos)
        end = pos + length
        # Small bytes fields (ids, names, digests) are copied eagerly:
        # a zero-copy memoryview slice would pin the ENTIRE RPC buffer
        # (possibly 100MB+) alive for as long as the field is retained,
        # and downstream consumers expect hashable `bytes`.  Tensor-sized
        # payloads stay zero-copy — their lifetime IS the buffer's
        # lifetime, and the copy is the cost we built this codec to avoid.
        raw = buf[pos:end]
        setattr(msg, f.name,
                bytes(raw) if length <= _BYTES_COPY_THRESHOLD else raw)
        return end
    if kind == "float":
        setattr(msg, f.name, struct.unpack_from("<f", buf, pos)[0])
        return pos + 4
    if kind == "message":
        length, pos = decode_varint(buf, pos)
        end = pos + length
        setattr(msg, f.name,
                f.message_type.decode(memoryview(buf)[pos:end]))
        return end
    raise TypeError(f"unsupported kind {kind}")
