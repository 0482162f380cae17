"""Checkpoint binary codec: the port's copy of
parameter_server_distributed_tpu/checkpoint/codec.py, byte for byte the
same file format.

The reference writes a custom little-endian binary layout from
`ParameterServerCore::save_checkpoint` (reference: src/parameter_server.cpp:112-144)
and reads it back in `load_checkpoint` (:146-188):

    epoch            int32
    current_iteration int32
    num_tensors      size_t (8 bytes on the reference's x86-64 targets)
    per tensor:
      name_len  size_t | name bytes
      shape_len size_t | shape int32[shape_len]
      dtype     int32
      data_len  size_t | data float32[data_len]

This module reproduces that layout byte-for-byte (a checkpoint written by
the reference loads here and vice versa) and adds integrity-preserving
atomic writes (tmp file + rename — the reference writes in place).  The
bulk float I/O is numpy tobytes/frombuffer, i.e. already memcpy-speed; no
native path is needed.
"""

from __future__ import annotations

import os
import struct
from typing import Mapping

import numpy as np

from ..core.tensor import TensorStore, to_host

_I32 = struct.Struct("<i")
_U64 = struct.Struct("<Q")


def dumps(epoch: int, iteration: int, params: Mapping[str, np.ndarray]) -> bytes:
    # card tensors (a device optimizer's store) come down in one packed
    # copy; the bytes are the f32 values either way
    params = to_host(params)
    out = bytearray()
    out += _I32.pack(int(epoch))
    out += _I32.pack(int(iteration))
    out += _U64.pack(len(params))
    for name, arr in params.items():
        arr = np.asarray(arr, dtype="<f4")
        name_b = name.encode("utf-8")
        out += _U64.pack(len(name_b))
        out += name_b
        shape = arr.shape
        out += _U64.pack(len(shape))
        for dim in shape:
            out += _I32.pack(int(dim))
        out += _I32.pack(0)  # dtype: 0 = float32 (only dtype the format carries)
        flat = arr.reshape(-1)
        out += _U64.pack(flat.size)
        out += flat.tobytes()
    return bytes(out)


def loads(buf: bytes) -> tuple[int, int, TensorStore]:
    """Returns (epoch, iteration, params)."""
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(buf):
            raise ValueError(f"truncated checkpoint at offset {pos} (+{n})")
        chunk = buf[pos:pos + n]
        pos += n
        return chunk

    epoch = _I32.unpack(take(4))[0]
    iteration = _I32.unpack(take(4))[0]
    num_tensors = _U64.unpack(take(8))[0]
    if num_tensors > 1 << 32:
        raise ValueError(f"implausible tensor count {num_tensors}")
    params: TensorStore = {}
    for _ in range(num_tensors):
        name_len = _U64.unpack(take(8))[0]
        name = take(name_len).decode("utf-8")
        shape_len = _U64.unpack(take(8))[0]
        shape = [_I32.unpack(take(4))[0] for _ in range(shape_len)]
        dtype = _I32.unpack(take(4))[0]
        if dtype not in (0, 1):
            raise ValueError(f"unknown dtype {dtype} for tensor {name!r}")
        data_len = _U64.unpack(take(8))[0]
        itemsize = 4 if dtype == 0 else 8
        raw = take(data_len * itemsize)
        arr = np.frombuffer(raw, dtype="<f4" if dtype == 0 else "<f8").astype(np.float32)
        params[name] = arr.reshape(shape) if shape else arr
    return epoch, iteration, params


def save(path: str, epoch: int, iteration: int,
         params: Mapping[str, np.ndarray]) -> None:
    """Atomic save: write to a tmp file in the same directory, fsync, rename.
    (The reference writes in place — a crash mid-write corrupts the file.)"""
    data = dumps(epoch, iteration, params)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str) -> tuple[int, int, TensorStore]:
    with open(path, "rb") as f:
        return loads(f.read())
