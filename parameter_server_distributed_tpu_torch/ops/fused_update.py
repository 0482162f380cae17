"""Fused optimizer updates: the port of
parameter_server_distributed_tpu/ops/pallas/fused_update.py.

``fused_sgd``, ``fused_momentum`` and ``fused_adam`` take dicts of float32
tensors keyed by parameter name and update every param that has a
gradient; the others pass through untouched.  On CUDA tensors each runs
its hand-written Hopper kernel (``csrc/fused_update.cu``) once over the
whole list, not once per tensor, or raises: :func:`plan` cuts the tensors
into chunks that one block each takes and packs them into as few
launches as the kernel's by-value table allows (one for the llama_350m
store).  On CPU tensors each runs the plain PyTorch version beside it
(:func:`sgd_reference`, :func:`momentum_reference`,
:func:`adam_reference`) tensor by tensor.  Params come back as fresh
tensors (on the card, views into one new buffer at 16-byte-aligned
offsets); the slots (velocity, m, v) are updated in place, which is what
the JAX package's buffer donation does.  Adam's bias corrections are
computed in f32 each step and passed as runtime kernel arguments, so
stepping never rebuilds or re-specialises anything.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Mapping, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

# kernel launches on CUDA tensors, by kernel (the CPU path and the plain
# versions never count)
launches = {"fused_sgd": 0, "fused_momentum": 0, "fused_adam": 0}

# The kernel's table (csrc/fused_update.cu Table, its by-value parameter):
# a block takes CHUNK elements of one tensor; one launch holds at most
# MAX_TENSORS tensors and MAX_CHUNKS chunks; operands per tensor: p, g,
# out and two slots.
CHUNK = 1 << 16
MAX_TENSORS = 256
MAX_CHUNKS = 16384
OPERANDS = 5


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sgd_reference(p: Tensor, g: Tensor, lr: float) -> Tensor:
    """p - lr*g."""
    return p - lr * g


def momentum_reference(p: Tensor, g: Tensor, vel: Tensor, lr: float,
                       mu: float) -> Tensor:
    """vel <- mu*vel + g (in place); returns p - lr*vel."""
    vel.copy_(mu * vel + g)
    return p - lr * vel


def adam_reference(p: Tensor, g: Tensor, m: Tensor, v: Tensor, lr: float,
                   b1: float, b2: float, eps: float, bc1: float,
                   bc2: float) -> Tensor:
    """m <- b1*m + (1-b1)*g and v <- b2*v + (1-b2)*g*g (in place); returns
    p - lr*(m/bc1)/(sqrt(v/bc2) + eps)."""
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)


def bias_corrections(step: int, b1: float, b2: float) -> tuple[float, float]:
    """(1 - b1^step, 1 - b2^step) computed in f32, as the JAX kernel's
    SMEM scalars are."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** t),
            float(one - np.float32(b2) ** t))


def plan(sizes: Sequence[int], aligned: Sequence[bool]) -> list[np.ndarray]:
    """The chunk tables of one update over tensors of ``sizes`` elements,
    ``aligned[i]`` saying whether all of tensor i's operands are 16-byte
    aligned.  One table a launch; each row is a chunk that one block takes:
    (tensor index, start, length, float4), in tensor order, every chunk
    CHUNK elements but a tensor's last.  Zero-size tensors get no row.  A
    table holds at most MAX_CHUNKS rows of at most MAX_TENSORS tensors, so
    its by-value form fits the kernel's parameter space; a tensor whose
    chunks do not fit continues in the next table."""
    tables, pieces, used, tensors = [], [], 0, 0
    for i, (n, vec) in enumerate(zip(sizes, aligned)):
        start = 0
        while start < n:
            if used == MAX_CHUNKS or tensors == MAX_TENSORS:
                tables.append(np.concatenate(pieces))
                pieces, used, tensors = [], 0, 0
            take = min(-(-(n - start) // CHUNK), MAX_CHUNKS - used)
            starts = start + CHUNK * np.arange(take, dtype=np.int64)
            pieces.append(np.stack([np.full(take, i), starts,
                                    np.minimum(CHUNK, n - starts),
                                    np.full(take, int(bool(vec)))], axis=1))
            used, tensors, start = used + take, tensors + 1, start + take * CHUNK
    if pieces:
        tables.append(np.concatenate(pieces))
    return tables


def kernel_table(table: np.ndarray, sizes: Sequence[int]) -> tuple:
    """A planned table in the kernel's form: (tensors, n, first, vec,
    block) -- the tensor indices it covers, their lengths, the block of
    each one's chunk 0 (negative when earlier chunks went to an earlier
    table), their float4 flags, and each block's position in
    ``tensors``.  Block b covers elements [(b - first[t]) * CHUNK, +CHUNK)
    of tensor t = block[b], cut at n[t]."""
    tensors, pos, block = np.unique(table[:, 0], return_index=True,
                                    return_inverse=True)
    first = (pos - table[pos, 1] // CHUNK).astype(np.int32)
    return (tensors, np.asarray(sizes, np.int64)[tensors], first,
            table[pos, 3].astype(np.uint8), block.astype(np.uint8))


@functools.lru_cache(maxsize=16)
def _kernel_tables(sizes: tuple[int, ...],
                   aligned: tuple[bool, ...]) -> list[tuple]:
    return [kernel_table(t, sizes) for t in plan(sizes, aligned)]


def launch_args(ops: np.ndarray, sizes: tuple[int, ...]) -> list[tuple]:
    """The kernel's arguments for one update, one tuple a launch: (ops
    [T, 5] operand addresses, n, first, vec, block), from each tensor's
    operand addresses (``ops`` [N, 5]: p, g, out, s0, s1; 0 for a slot the
    rule lacks) and size.  A tensor is taken with float4 accesses only
    where all of its addresses are 16-byte aligned."""
    aligned = tuple((ops % 16 == 0).all(axis=1).tolist())
    return [(np.ascontiguousarray(ops[tensors]), n, first, vec, block)
            for tensors, n, first, vec, block in _kernel_tables(sizes,
                                                                aligned)]


@functools.lru_cache(maxsize=16)
def _layout(shapes: tuple[torch.Size, ...]) -> tuple:
    """The output buffer of an update over params of ``shapes``: (sizes,
    element offsets [N + 1], each param's (shape, stride, offset) view),
    every param at a 16-byte-aligned offset."""
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = np.cumsum((0,) + tuple((n + 3) // 4 * 4 for n in sizes))
    views = []
    for shape, off in zip(shapes, offsets.tolist()):
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * max(shape[i + 1], 1)
        views.append((shape, tuple(stride), off))
    return sizes, offsets, views


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("fused_update")
        limits = (ctypes.c_int * 3)()
        lib.psdt_fused_limits(limits)
        if tuple(limits) != (CHUNK, MAX_TENSORS, MAX_CHUNKS):
            raise RuntimeError(f"csrc/fused_update.cu table limits "
                               f"{tuple(limits)} differ from "
                               f"{(CHUNK, MAX_TENSORS, MAX_CHUNKS)}")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        table = [ptr] * 4 + [i32, ptr, i32]
        lib.psdt_fused_sgd.argtypes = table + [f32, ptr]
        lib.psdt_fused_momentum.argtypes = table + [f32, f32, ptr]
        lib.psdt_fused_adam.argtypes = table + [f32] * 8 + [ptr]
        for fn in (lib.psdt_fused_sgd, lib.psdt_fused_momentum,
                   lib.psdt_fused_adam):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _update(name: str, params: Mapping[str, Tensor],
            grads: Mapping[str, Tensor], slots: tuple[Mapping, ...],
            scalars: tuple[float, ...], reference,
            kernel_extra: tuple[float, ...] = ()) -> dict[str, Tensor]:
    """Every param with a gradient updated, the others passed through: the
    plain version tensor by tensor on the CPU, the kernel once per planned
    table on the card (it takes ``scalars`` then ``kernel_extra``)."""
    names = [k for k in params if k in grads]
    new = dict(params)
    if not names:
        return new
    ps = [params[k] for k in names]
    gs = [grads[k] for k in names]
    cols = [[s[k] for k in names] for s in slots]
    flat = [*ps, *gs, *(x for col in cols for x in col)]
    devices = {x.device for x in flat}
    if devices == {torch.device("cpu")}:
        for k, *row in zip(names, ps, gs, *cols):
            new[k] = reference(*row, *scalars)
        return new
    dev = ps[0].device
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"{name}: operands must lie on one cuda device "
                         f"(or all on the cpu), got "
                         f"{sorted(map(str, devices))}")
    # one pass of checks over the lists, then O(1) launches and
    # allocations
    if {x.dtype for x in flat} != {torch.float32}:
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{sorted(str(x.dtype) for x in set(flat))}")
    sizes, offsets, views = _layout(tuple(p.shape for p in ps))
    if any([x.numel() for x in col] != list(sizes) for col in (gs, *cols)):
        raise ValueError(f"{name}: grads and slots must match their params "
                         f"in size")
    if not all(x.is_contiguous() for col in cols for x in col):
        raise ValueError(f"{name} updates its slots in place: they must be "
                         f"contiguous")
    ps = [p.contiguous() for p in ps]
    gs = [g.contiguous() for g in gs]
    out = torch.empty(int(offsets[-1]), dtype=torch.float32, device=dev)
    ops = np.zeros((len(ps), OPERANDS), np.int64)
    ops[:, 0] = [p.data_ptr() for p in ps]
    ops[:, 1] = [g.data_ptr() for g in gs]
    ops[:, 2] = out.data_ptr() + 4 * offsets[:-1]
    for j, col in enumerate(cols):
        ops[:, 3 + j] = [x.data_ptr() for x in col]
    fn = getattr(_lib(), f"psdt_{name}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t_ops, n, first, vec, block in launch_args(ops, sizes):
            err = fn(t_ops.ctypes.data, n.ctypes.data, first.ctypes.data,
                     vec.ctypes.data, len(n), block.ctypes.data, len(block),
                     *scalars, *kernel_extra, stream)
            if err:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {err}")
            launches[name] += 1
    new.update(zip(names, [out.as_strided(*v) for v in views]))
    return new


def fused_sgd(params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
              lr: float) -> dict[str, Tensor]:
    """param <- param - lr * grad for every param with a gradient; the
    others pass through."""
    return _update("fused_sgd", params, grads, (), (float(lr),),
                   sgd_reference)


def fused_momentum(params: Mapping[str, Tensor],
                   grads: Mapping[str, Tensor],
                   velocity: Mapping[str, Tensor], lr: float,
                   mu: float = 0.9) -> tuple[dict, dict]:
    """Fused momentum SGD: returns (new_params, velocity), the velocity
    tensors updated in place."""
    new_p = _update("fused_momentum", params, grads, (velocity,),
                    (float(lr), float(mu)), momentum_reference)
    return new_p, {name: velocity.get(name) for name in params}


def fused_adam(params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
               m: Mapping[str, Tensor], v: Mapping[str, Tensor], step: int,
               lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> tuple[dict, dict, dict]:
    """Fused Adam: returns (new_params, m, v), the moment tensors updated
    in place.  ``step`` is 1-based; its bias corrections enter each launch
    as runtime scalars."""
    scalars = (float(lr), float(b1), float(b2), float(eps),
               *bias_corrections(step, b1, b2))
    # the kernel also takes 1-b1 and 1-b2, rounded to f32 once as the
    # plain version's scalar products round them
    extra = (1.0 - b1, 1.0 - b2)
    new_p = _update("fused_adam", params, grads, (m, v), scalars,
                    adam_reference, extra)
    return (new_p, {name: m.get(name) for name in params},
            {name: v.get(name) for name in params})
