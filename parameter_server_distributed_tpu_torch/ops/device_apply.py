"""The parameter server's barrier close on the card: the four kernels of
``csrc/device_apply.cu``, each beside its plain PyTorch version.

They replace the jit programs of the JAX package's
``core/device_apply.py`` (XLA programs, not Pallas kernels), which
``core/device_apply.py``, ``core/arena.py`` and
``async_sgd/device_optimizer.py`` ``ShardedDeviceOptimizer`` of the port
call:

- :func:`fold_segments`: rows ``(dst, dst_off, src, src_off, n,
  scale)``; each sets ``dst[dst_off:+n]`` to ``src[src_off:+n]`` (a bit
  copy of an f32 source) or adds it (one rounding), the source f32, bf16
  (exact upcast) or int8 (``q * scale``);
- :func:`scale_mean`: rows ``(x, inv)``, ``x *= inv`` in place;
- :func:`sharded_update`: one rule over rows ``(p, g, out, s0, s1,
  decay, seed)``: fresh params into ``out``, the slots in place, the
  AdamW / Lion decay on elements ``[0, decay)``, Momentum's first-touch
  copy where ``seed``;
- :func:`topk_scatter`: a top-k payload (ascending u32 indices, bf16
  values) into a dense f32 tensor.

Each takes the kernel on CUDA tensors or raises (no quiet switch to the
plain version), and the plain version on CPU tensors.  The plain
versions use one torch op per numpy ufunc in the host optimizers' order
(core/optimizer.py), so on the CPU they equal the numpy path bit for
bit; no ``addcmul``, ``addcdiv``, ``lerp`` or ``add(alpha=)``.  Scalars
enter as 0-dim tensors on the operand's device (a CPU-scalar divisor
makes CUDA's divide multiply by its reciprocal), and the square root
goes through f64 (torch's vectorised f32 sqrt on the CPU is off by an
ulp now and then; f64 sqrt rounded to f32 is the correctly rounded f32
root, which numpy and the card compute).
"""

from __future__ import annotations

import array
import contextlib
import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import fused_update as fu

Tensor = torch.Tensor

# kernel launches on CUDA tensors, by kernel (the CPU path and the plain
# versions never count)
launches = {"fold_segments": 0, "scale_mean": 0, "sharded_update": 0,
            "topk_scatter": 0}

MAX_SEGMENTS = 1024       # rows of one fold or scale launch
SPAN = 8192               # elements of a row one fold / scale block takes
ROW_CHUNK = 4096          # output elements a top-k block takes
MAX_GRID = 4096           # blocks of one top-k launch
SRC_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PLAN_VECTOR = 4           # a vector row's bit in psdt_fold_plan's plan
RULES = ("sgd", "momentum", "adam", "adamw", "lion")
RULE_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2, "lion": 1}
# bytes an update moves per element (p and g read, out written, each slot
# read and written)
UPDATE_BYTES = {"sgd": 12, "momentum": 20, "adam": 28, "adamw": 28,
                "lion": 20}
# the kernel's Scalars, in order
SCALARS = ("lr", "mu", "b1", "omb1", "b2", "omb2", "bc1", "bc2", "eps",
           "wd")


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class Segment(NamedTuple):
    """One fold row: ``dst[dst_off:dst_off+n]`` (f32) from
    ``src[src_off:src_off+n]``; ``scale`` multiplies an int8 source."""
    dst: Tensor
    dst_off: int
    src: Tensor
    src_off: int
    n: int
    scale: float = 1.0


class UpdateRow(NamedTuple):
    """One update row over flat f32 tensors of one length: params ``p``,
    gradient ``g``, fresh output ``out``, slots ``s0`` / ``s1`` (None
    where the rule has fewer), the decay lane's length ``decay`` and
    Momentum's first-touch flag ``seed``."""
    p: Tensor
    g: Tensor
    out: Tensor
    s0: Tensor | None
    s1: Tensor | None
    decay: int = 0
    seed: bool = False


def _scalar(value, like: Tensor) -> Tensor:
    return torch.tensor(float(value), dtype=torch.float32,
                        device=like.device)


def _sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded f32 square root (numpy's np.sqrt)."""
    return torch.sqrt(x.double()).float()


def _source(src: Tensor, scale: float) -> Tensor:
    """A fold row's source as f32: as it is, upcast, or dequantised."""
    if src.dtype == torch.float32:
        return src
    if src.dtype == torch.bfloat16:
        return src.float()
    return torch.mul(src.float(), _scalar(scale, src))


# ---------------------------------------------------------- plain versions
def fold_segments_reference(segments: Sequence[Segment], add: bool) -> None:
    """Each row set (a bit copy, or the source's conversion) or added."""
    for s in segments:
        d = s.dst.view(-1)[s.dst_off:s.dst_off + s.n]
        v = _source(s.src.view(-1)[s.src_off:s.src_off + s.n], s.scale)
        d.copy_(torch.add(d, v) if add else v)


def scale_mean_reference(rows: Sequence[tuple[Tensor, float]]) -> None:
    for x, inv in rows:
        x.copy_(torch.mul(x, _scalar(inv, x)))


def sharded_update_reference(rule: str, row: UpdateRow,
                             scalars: dict) -> None:
    """The rule over one row, one torch op per numpy ufunc of the host
    optimizer (core/optimizer.py), the decay lane on ``[0, decay)``."""
    c = {k: _scalar(v, row.p) for k, v in scalars.items()}
    p, g, d = row.p, row.g, row.decay
    if rule == "sgd":
        row.out.copy_(torch.sub(p, torch.mul(g, c["lr"])))
        return
    if rule == "momentum":
        v = row.s0
        if row.seed:
            v.copy_(g)
        else:
            v.copy_(torch.add(torch.mul(v, c["mu"]), g))
        row.out.copy_(torch.sub(p, torch.mul(v, c["lr"])))
        return
    if rule in ("adam", "adamw"):
        m, v = row.s0, row.s1
        m.copy_(torch.add(torch.mul(m, c["b1"]), torch.mul(g, c["omb1"])))
        v.copy_(torch.add(torch.mul(v, c["b2"]),
                          torch.mul(torch.mul(g, g), c["omb2"])))
        den = torch.add(_sqrt_rn(torch.div(v, c["bc2"])), c["eps"])
        if rule == "adam":
            step = torch.mul(torch.div(m, c["bc1"]), c["lr"])
            row.out.copy_(torch.sub(p, torch.div(step, den)))
            return
        step = torch.div(torch.div(m, c["bc1"]), den)
    else:   # lion
        m = row.s0
        t = torch.add(torch.mul(m, c["b1"]), torch.mul(g, c["omb1"]))
        # numpy's sign: NaN stays NaN (torch.sign gives 0), +-0 -> +0
        step = torch.where(torch.isnan(t), t, torch.sign(t))
        m.copy_(torch.add(torch.mul(m, c["b2"]), torch.mul(g, c["omb2"])))
    if d:
        step[:d] = torch.add(step[:d], torch.mul(p[:d], c["wd"]))
    row.out.copy_(torch.sub(p, torch.mul(step, c["lr"])))


def topk_scatter_reference(idx: Tensor, vals: Tensor, total: int) -> Tensor:
    """Dense f32 zeros, the bf16 values upcast at the indices."""
    out = torch.zeros(total, dtype=torch.float32, device=idx.device)
    out[idx.long()] = vals.float()
    return out


# ---------------------------------------------------------------- kernels
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("device_apply")
        limits = (ctypes.c_int * 6)()
        lib.psdt_device_apply_limits(limits)
        want = (MAX_SEGMENTS, fu.CHUNK, fu.MAX_TENSORS, fu.MAX_CHUNKS,
                ROW_CHUNK, SPAN)
        if tuple(limits) != want:
            raise RuntimeError(f"csrc/device_apply.cu limits "
                               f"{tuple(limits)} differ from {want}")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.psdt_fold_plan.argtypes = [ptr] * 3 + [i32, i32, ptr, ptr]
        lib.psdt_fold_segments.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.psdt_scale_mean.argtypes = [ptr] * 3 + [i32, ptr]
        lib.psdt_sharded_update.argtypes = (
            [i32] + [ptr] * 6 + [i32, ptr, i32, ptr, ptr])
        lib.psdt_topk_scatter.argtypes = [ptr, i64, ptr, ptr, i64, i32, ptr]
        for fn in (lib.psdt_fold_plan, lib.psdt_fold_segments,
                   lib.psdt_scale_mean,
                   lib.psdt_sharded_update, lib.psdt_topk_scatter):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _device_of(tensors: Sequence[Tensor], what: str) -> torch.device | None:
    """None when every tensor lies on the CPU; the one CUDA device
    otherwise; raises for a mix."""
    devices = {t.device for t in tensors}
    dev = next(iter(devices))
    if len(devices) == 1 and dev.type in ("cpu", "cuda"):
        return None if dev.type == "cpu" else dev
    raise ValueError(f"{what}: operands must lie on one cuda device (or "
                     f"all on the cpu), got {sorted(map(str, devices))}")


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _grid(total: int) -> int:
    """Blocks of a top-k launch: one a ROW_CHUNK of the output, at most
    MAX_GRID (each then takes several in turn)."""
    return max(1, min(-(-total // ROW_CHUNK), MAX_GRID))


def _launched(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


_SAME_DEVICE = contextlib.nullcontext()
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _on(dev: torch.device):
    """A context that makes ``dev`` (a tensor's device, so indexed) the
    current device; nothing to enter when it already is."""
    if dev.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev`` as a pointer."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _addr(packed: array.array) -> int:
    """The address of a C array (which must outlive the call)."""
    return packed.buffer_info()[0]


def _fold_rows(part: Sequence[Segment]) -> tuple[array.array, ...]:
    """The C arrays of a fold table: dst and src addresses (int64),
    lengths (int64) and scales (f32)."""
    return (array.array("q", [s.dst.data_ptr() + 4 * s.dst_off
                              for s in part]),
            array.array("q", [s.src.data_ptr()
                              + s.src.element_size() * s.src_off
                              for s in part]),
            array.array("q", [s.n for s in part]),
            array.array("f", [s.scale for s in part]))


def fold_plan(segments: Sequence[Segment]) -> tuple[np.ndarray,
                                                    np.ndarray]:
    """The plan that a fold launch over ``segments`` (at most
    MAX_SEGMENTS card rows) runs, from the library's own planner: each
    row's first span and then the span count (``rows + 1`` int32), and
    each row's head elements (0-3, before dst's first 16-byte boundary)
    with PLAN_VECTOR set on a row that takes the vector path."""
    _check(len(segments) <= MAX_SEGMENTS, "fold_plan",
           f"at most {MAX_SEGMENTS} rows")
    dst, src, n, _ = _fold_rows(segments)
    first = np.zeros(len(segments) + 1, np.int32)
    plan = np.zeros(len(segments), np.uint8)
    err = _lib().psdt_fold_plan(_addr(dst), _addr(src), _addr(n),
                                len(segments),
                                SRC_KINDS[segments[0].src.dtype],
                                first.ctypes.data, plan.ctypes.data)
    if err:
        raise RuntimeError(f"psdt_fold_plan failed: CUDA error {err}")
    return first, plan


def fold_segments(segments: Sequence[Segment], add: bool) -> None:
    """Set (``add`` False) or add each row's source into its destination,
    in place.  Sources of one call share a dtype (f32, bf16 or int8)."""
    segments = [s for s in segments if s.n]
    if not segments:
        return
    dev = _device_of([t for s in segments for t in (s.dst, s.src)],
                     "fold_segments")
    if dev is None:
        fold_segments_reference(segments, add)
        return
    kinds = {s.src.dtype for s in segments}
    if len(kinds) != 1 or next(iter(kinds)) not in SRC_KINDS:
        _check(False, "fold_segments", f"sources of one call share f32, "
               f"bf16 or int8, got {sorted(map(str, kinds))}")
    for s in segments:
        _check(s.dst.dtype == torch.float32 and s.dst.is_contiguous()
               and s.src.is_contiguous(), "fold_segments",
               "destinations are contiguous f32, sources contiguous")
        _check(0 <= s.dst_off and s.dst_off + s.n <= s.dst.numel()
               and 0 <= s.src_off and s.src_off + s.n <= s.src.numel(),
               "fold_segments", "a row runs past its tensor")
    kind = SRC_KINDS[segments[0].src.dtype]
    fn = _lib().psdt_fold_segments
    with _on(dev):
        stream = _stream(dev)
        for lo in range(0, len(segments), MAX_SEGMENTS):
            part = segments[lo:lo + MAX_SEGMENTS]
            dst, src, n, scale = _fold_rows(part)
            err = fn(_addr(dst), _addr(src), _addr(n), _addr(scale),
                     len(part), kind, int(bool(add)), stream)
            _launched(err, "fold_segments")


def scale_mean(rows: Sequence[tuple[Tensor, float]]) -> None:
    """``x *= inv`` in place for each row (``inv`` rounded to f32)."""
    rows = [(x, inv) for x, inv in rows if x.numel()]
    if not rows:
        return
    dev = _device_of([x for x, _ in rows], "scale_mean")
    if dev is None:
        scale_mean_reference(rows)
        return
    for x, _ in rows:
        _check(x.dtype == torch.float32 and x.is_contiguous(), "scale_mean",
               "takes contiguous f32 tensors")
    fn = _lib().psdt_scale_mean
    with _on(dev):
        stream = _stream(dev)
        for lo in range(0, len(rows), MAX_SEGMENTS):
            part = rows[lo:lo + MAX_SEGMENTS]
            ptr = array.array("q", [x.data_ptr() for x, _ in part])
            n = array.array("q", [x.numel() for x, _ in part])
            inv = array.array("f", [inv for _, inv in part])
            err = fn(_addr(ptr), _addr(n), _addr(inv), len(part), stream)
            _launched(err, "scale_mean")


def sharded_update(rule: str, rows: Sequence[UpdateRow],
                   scalars: dict) -> None:
    """One update rule over ``rows``: the plain version row by row on the
    CPU; on the card one launch per planned table (ops/fused_update.py
    ``plan``: one for a stripe of llama_350m).  ``scalars`` maps each of
    :data:`SCALARS` the rule reads to its f32 value."""
    if rule not in RULES:
        raise ValueError(f"unknown update rule {rule!r}; options {RULES}")
    rows = [r for r in rows if r.p.numel()]
    if not rows:
        return
    slots = RULE_SLOTS[rule]
    for r in rows:
        have = tuple(s is not None for s in (r.s0, r.s1))
        _check(have == (slots > 0, slots > 1), "sharded_update",
               f"{rule} takes {slots} slot(s)")
        n = r.p.numel()
        _check(all(t.numel() == n for t in (r.g, r.out, r.s0, r.s1)
                   if t is not None), "sharded_update",
               "a row's operands differ in size")
        _check(0 <= r.decay <= n, "sharded_update", "decay past the row")
    operands = [t for r in rows for t in (r.p, r.g, r.out, r.s0, r.s1)
                if t is not None]
    dev = _device_of(operands, "sharded_update")
    if dev is None:
        for r in rows:
            sharded_update_reference(rule, r, scalars)
        return
    _check(all(t.dtype == torch.float32 and t.is_contiguous()
               for t in operands), "sharded_update",
           "takes contiguous f32 tensors")
    ops = np.zeros((len(rows), fu.OPERANDS), np.int64)
    for i, r in enumerate(rows):
        ops[i] = [0 if t is None else t.data_ptr()
                  for t in (r.p, r.g, r.out, r.s0, r.s1)]
    sizes = tuple(r.p.numel() for r in rows)
    decay = np.array([r.decay for r in rows], np.int64)
    seed = np.array([int(bool(r.seed)) for r in rows], np.uint8)
    scal = np.array([float(scalars.get(k, 0.0)) for k in SCALARS],
                    np.float32)
    # a slot the rule lacks is address 0, which is 16-byte aligned
    aligned = tuple((ops % 16 == 0).all(axis=1).tolist())
    fn = _lib().psdt_sharded_update
    with _on(dev):
        stream = _stream(dev)
        for table in fu.plan(sizes, aligned):
            tensors, n, first, vec, block = fu.kernel_table(table, sizes)
            t_ops = np.ascontiguousarray(ops[tensors])
            t_decay = np.ascontiguousarray(decay[tensors])
            t_seed = np.ascontiguousarray(seed[tensors])
            err = fn(RULES.index(rule), t_ops.ctypes.data, n.ctypes.data,
                     t_decay.ctypes.data, first.ctypes.data,
                     vec.ctypes.data, t_seed.ctypes.data, len(n),
                     block.ctypes.data, len(block), scal.ctypes.data,
                     stream)
            _launched(err, "sharded_update")


def topk_scatter(idx: Tensor, vals: Tensor, total: int) -> Tensor:
    """A fresh dense f32 tensor of ``total`` elements holding ``vals``
    (bf16) at ``idx`` (int32 holding the payload's u32 indices, strictly
    ascending and below ``total``; the caller checks) and +0.0 elsewhere."""
    dev = _device_of([idx, vals], "topk_scatter")
    if dev is None:
        return topk_scatter_reference(idx, vals, total)
    _check(idx.dtype == torch.int32 and vals.dtype == torch.bfloat16
           and idx.numel() == vals.numel() and idx.is_contiguous()
           and vals.is_contiguous(), "topk_scatter",
           "takes contiguous int32 indices and bf16 values, one per index")
    out = torch.empty(total, dtype=torch.float32, device=dev)
    if not total:
        return out
    fn = _lib().psdt_topk_scatter
    with _on(dev):
        err = fn(out.data_ptr(), total, idx.data_ptr(), vals.data_ptr(),
                 idx.numel(), _grid(total), _stream(dev))
    _launched(err, "topk_scatter")
    return out
