"""The host C++ library (``psdt_native.cpp``), built on first use and
bound with ctypes: the port's copy of
parameter_server_distributed_tpu/native/__init__.py.

:func:`lib` returns the bound library, compiling it with g++ on first
use, or None when it is disabled (``PSDT_NATIVE=0``, :func:`set_enabled`)
or cannot be built.  Every caller handles None by taking its numpy path,
which gives the same answer (the codec) or the reference's numpy one (the
optimizers), only slower; ``rpc.codec.native`` (rpc/codec.py) and the
exit reports of the wire round's processes say which one ran.

The build does not write into the package, and never in place: g++
writes ``build/native/libpsdt_native-<hash>.so.<pid>.tmp`` beside the
package, which ``os.replace`` then renames, so a process never loads half
a library, and two processes building at once each leave a whole one.
The hash covers the source, the flags the build used and this host's CPU
(its model and feature flags: ``-march=native`` code built on one machine
must not load on another that shares the checkout).

Callers: core/optimizer.py (SGD, Momentum, Adam, AdamW), core/ps_core.py
(the buffered mean and the fused mean-SGD), rpc/codec.py
(``NativeCodec``) and rpc/shm_transport.py (:func:`copy_fn`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading

import numpy as np

log = logging.getLogger("pst.native")

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "psdt_native.cpp")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "native")
# no -ffast-math, ever: -ffp-contract=off keeps -march=native from
# contracting a multiply and an add into one FMA, so the codec stays
# byte-identical to numpy and the optimizers on numpy's rounding
FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
NATIVE_ARCH = ("-march=native",)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _host_cpu() -> str:
    """This host's CPU model and feature flags (the first processor's)."""
    keep = []
    try:
        with open("/proc/cpuinfo", encoding="utf-8",
                  errors="replace") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features") \
                        and key not in [k for k, _ in keep]:
                    keep.append((key, line.strip()))
    except OSError:
        pass
    return platform.machine() + "\n" + "\n".join(v for _, v in keep)


def library_path(arch: tuple[str, ...] = NATIVE_ARCH) -> str:
    """Where the library built with ``arch`` and :data:`FLAGS` from this
    source on this host lives."""
    digest = hashlib.sha256(" ".join(arch + FLAGS).encode())
    digest.update(_host_cpu().encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpsdt_native-{digest.hexdigest()[:16]}.so")


def _build() -> str | None:
    """The library's path, compiling it if this host has no current
    build; None when the compiler is missing or fails.  ``-march=native``
    lets the codec loops vectorize (the library is built on the machine
    that runs it); where g++ refuses it, the plain flags build under a
    name of their own, and the next process tries ``-march=native``
    again."""
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
    except OSError as exc:
        log.warning("native build failed (%s); using the numpy paths", exc)
        return None
    for arch in (NATIVE_ARCH, ()):
        out = library_path(arch)
        if os.path.exists(out) or _compile(arch, out):
            return out
    return None


def _compile(arch: tuple[str, ...], out: str) -> bool:
    """g++ into a temporary name, then ``os.replace`` onto ``out``
    (atomic: a reader never sees half a library); a failed build leaves
    no file behind."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *arch, *FLAGS, "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        log.warning("native build %s failed (%s)", " ".join(arch) or
                    "without -march", exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
    pp = ctypes.POINTER(_F32P)
    lib.psdt_mean.argtypes = [pp, i32, i64, _F32P]
    lib.psdt_sgd.argtypes = [_F32P, _F32P, i64, f32]
    lib.psdt_momentum.argtypes = [_F32P, _F32P, _F32P, i64, f32, f32]
    lib.psdt_adam.argtypes = [_F32P, _F32P, _F32P, _F32P, i64, f32, f32, f32,
                              f32, f32, f32]
    lib.psdt_adamw.argtypes = [_F32P, _F32P, _F32P, _F32P, i64, f32, f32,
                               f32, f32, f32, f32, f32]
    lib.psdt_mean_sgd.argtypes = [_F32P, pp, i32, i64, f32]
    lib.psdt_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64]
    lib.psdt_pack_bf16.argtypes = [_F32P, i64, _U8P]
    lib.psdt_unpack_bf16.argtypes = [_U8P, i64, _F32P]
    lib.psdt_quant_int8.argtypes = [_F32P, i64, _U8P]
    lib.psdt_dequant_int8.argtypes = [_U8P, i64, _F32P]
    lib.psdt_topk_pack.argtypes = [_F32P, i64, i64, _U8P]
    lib.psdt_topk_unpack.argtypes = [_U8P, i64, _F32P]
    lib.psdt_topk_unpack.restype = ctypes.c_int32
    for name in ("psdt_mean", "psdt_sgd", "psdt_momentum", "psdt_adam",
                 "psdt_adamw", "psdt_mean_sgd", "psdt_copy",
                 "psdt_pack_bf16", "psdt_unpack_bf16", "psdt_quant_int8",
                 "psdt_dequant_int8", "psdt_topk_pack"):
        getattr(lib, name).restype = None
    return lib


_enabled = os.environ.get("PSDT_NATIVE", "1").lower() not in ("0", "false")


def set_enabled(value: bool) -> None:
    """Enable or disable the native path at run time.  Re-enabling also
    clears the build-attempted latch when no library was bound, so a
    failed build is retried."""
    global _enabled, _tried
    _enabled = bool(value)
    if _enabled and _lib is None and _tried:
        with _lock:
            if _lib is None:
                _tried = False


def is_enabled() -> bool:
    """Whether the native path is requested (:func:`lib` says whether it
    is available)."""
    return _enabled


def reset_for_retry() -> None:
    """Drop the bound library and the build-attempted latch, so the next
    :func:`lib` builds and binds anew."""
    global _lib, _tried
    with _lock:
        _lib = None
        _tried = False


def lib() -> ctypes.CDLL | None:
    """The bound library, or None if disabled or unavailable."""
    global _lib, _tried
    if not _enabled:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            path = _build()
            if path is not None:
                try:
                    _lib = _bind(path)
                except OSError as exc:
                    log.warning("native load failed: %s", exc)
    return _lib


def _fptr(arr: np.ndarray) -> _F32P:
    return arr.ctypes.data_as(_F32P)


def mean_over_workers_native(arrays: list[np.ndarray]) -> np.ndarray | None:
    """Mean of equally shaped float32 arrays, or None when the library is
    unavailable or the arrays do not suit it."""
    native = lib()
    if native is None or not arrays:
        return None
    if np.asarray(arrays[0]).dtype != np.float32:
        return None
    contig = [np.ascontiguousarray(a, np.float32) for a in arrays]
    if any(c.shape != contig[0].shape for c in contig):
        return None
    out = np.empty_like(contig[0])
    ptrs = (_F32P * len(contig))(*[_fptr(c) for c in contig])
    native.psdt_mean(ptrs, len(contig), contig[0].size, _fptr(out))
    return out


def sgd_native(param: np.ndarray, grad: np.ndarray, lr: float) -> bool:
    """In place ``param -= lr * grad``; False if the native path cannot
    take it."""
    native = lib()
    if (native is None or param.dtype != np.float32
            or not param.flags.c_contiguous
            or param.shape != np.shape(grad)):
        return False
    grad_c = np.ascontiguousarray(grad, np.float32)
    native.psdt_sgd(_fptr(param), _fptr(grad_c), param.size,
                    ctypes.c_float(lr))
    return True


def mean_sgd_native(param: np.ndarray, grads: list[np.ndarray],
                    lr: float) -> bool:
    """In place ``param -= lr * mean(grads)`` in one pass."""
    native = lib()
    if (native is None or not grads or param.dtype != np.float32
            or not param.flags.c_contiguous):
        return False
    contig = [np.ascontiguousarray(g, np.float32) for g in grads]
    if any(c.shape != param.shape for c in contig):
        return False
    ptrs = (_F32P * len(contig))(*[_fptr(c) for c in contig])
    native.psdt_mean_sgd(_fptr(param), ptrs, len(contig), param.size,
                         ctypes.c_float(lr))
    return True


def momentum_native(param: np.ndarray, grad: np.ndarray,
                    velocity: np.ndarray, lr: float, mu: float) -> bool:
    """In place ``velocity = mu*velocity + grad; param -= lr*velocity``."""
    native = lib()
    if (native is None
            or param.dtype != np.float32 or not param.flags.c_contiguous
            or velocity.dtype != np.float32
            or not velocity.flags.c_contiguous
            or param.shape != np.shape(grad)
            or param.shape != velocity.shape):
        return False
    grad_c = np.ascontiguousarray(grad, np.float32)
    native.psdt_momentum(_fptr(param), _fptr(grad_c), _fptr(velocity),
                         param.size, ctypes.c_float(lr), ctypes.c_float(mu))
    return True


def _adam_ok(native, param, grad, m, v, step) -> bool:
    arrays = (param, m, v)
    return not (native is None or step < 1
                or any(a.dtype != np.float32 or not a.flags.c_contiguous
                       for a in arrays)
                or param.shape != np.shape(grad)
                or any(a.shape != param.shape for a in (m, v)))


def adam_native(param: np.ndarray, grad: np.ndarray, m: np.ndarray,
                v: np.ndarray, lr: float, b1: float, b2: float, eps: float,
                step: int) -> bool:
    """In place fused Adam pass over param, m and v; ``step`` is the
    1-based update count of the bias corrections."""
    native = lib()
    if not _adam_ok(native, param, grad, m, v, step):
        return False
    grad_c = np.ascontiguousarray(grad, np.float32)
    native.psdt_adam(_fptr(param), _fptr(grad_c), _fptr(m), _fptr(v),
                     param.size, ctypes.c_float(lr), ctypes.c_float(b1),
                     ctypes.c_float(b2), ctypes.c_float(eps),
                     ctypes.c_float(1.0 - b1 ** step),
                     ctypes.c_float(1.0 - b2 ** step))
    return True


def adamw_native(param: np.ndarray, grad: np.ndarray, m: np.ndarray,
                 v: np.ndarray, lr: float, b1: float, b2: float, eps: float,
                 step: int, wd: float) -> bool:
    """In place fused AdamW pass (Adam and the decoupled decay in one
    sweep); ``wd=0`` for tensors excluded from decay."""
    native = lib()
    if not _adam_ok(native, param, grad, m, v, step):
        return False
    grad_c = np.ascontiguousarray(grad, np.float32)
    native.psdt_adamw(_fptr(param), _fptr(grad_c), _fptr(m), _fptr(v),
                      param.size, ctypes.c_float(lr), ctypes.c_float(b1),
                      ctypes.c_float(b2), ctypes.c_float(eps),
                      ctypes.c_float(1.0 - b1 ** step),
                      ctypes.c_float(1.0 - b2 ** step),
                      ctypes.c_float(wd))
    return True


# ---------------------------------------------------------------------------
# Wire-codec wrappers (rpc/codec.py NativeCodec).  Sources and
# destinations are pointers into the caller's arrays and the encoder's
# message buffer, no copies.  Each returns False when the native path is
# unavailable or the inputs do not suit it, and the caller takes numpy.


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def _as_u8(buf) -> np.ndarray:
    """A uint8 view of a bytes, memoryview or ndarray buffer."""
    if isinstance(buf, np.ndarray):
        return buf.view(np.uint8) if buf.dtype != np.uint8 else buf
    return np.frombuffer(buf, np.uint8)


def copy_fn():
    """The GIL-free bulk copy ``fn(dst_addr, src_addr, nbytes)`` over raw
    addresses, or None without the library (the shm rings' copies)."""
    native = lib()
    return native.psdt_copy if native is not None else None


def _f32_src_ok(native, src: np.ndarray) -> bool:
    return (native is not None and src.dtype == np.float32
            and src.flags.c_contiguous)


def pack_bf16_native(src: np.ndarray, dst) -> bool:
    """f32 -> bf16 (round to nearest even) straight into ``dst``."""
    native = lib()
    if not _f32_src_ok(native, src):
        return False
    native.psdt_pack_bf16(_fptr(src), src.size, _u8ptr(_as_u8(dst)))
    return True


def unpack_bf16_native(raw, out: np.ndarray) -> bool:
    """bf16 payload -> f32 ``out`` (len(raw) // 2 elements)."""
    native = lib()
    if not _f32_src_ok(native, out):
        return False
    native.psdt_unpack_bf16(_u8ptr(_as_u8(raw)), out.size, _fptr(out))
    return True


def quant_int8_native(src: np.ndarray, dst) -> bool:
    """f32 -> [f32 max-abs scale | int8 * n] into ``dst``."""
    native = lib()
    if not _f32_src_ok(native, src):
        return False
    native.psdt_quant_int8(_fptr(src), src.size, _u8ptr(_as_u8(dst)))
    return True


def dequant_int8_native(raw, out: np.ndarray) -> bool:
    native = lib()
    if not _f32_src_ok(native, out):
        return False
    native.psdt_dequant_int8(_u8ptr(_as_u8(raw)), out.size, _fptr(out))
    return True


def topk_pack_native(src: np.ndarray, k: int, dst) -> bool:
    """f32 -> [u32 k | k*u32 idx | k*bf16 vals] into ``dst`` (threshold
    selection, ties in ascending index order: the codec's contract)."""
    native = lib()
    if not _f32_src_ok(native, src):
        return False
    native.psdt_topk_pack(_fptr(src), src.size, int(k), _u8ptr(_as_u8(dst)))
    return True


def topk_unpack_native(raw, out: np.ndarray) -> bool:
    """top-k payload -> dense f32 ``out``.  False on a malformed payload
    (a truncated header, a k claiming more entries than the payload
    carries, an index out of range), so the Python path raises."""
    native = lib()
    if not _f32_src_ok(native, out):
        return False
    u8 = _as_u8(raw)
    if u8.size < 4:
        return False
    k = int(np.frombuffer(u8[:4].tobytes(), "<u4")[0])
    if u8.size < 4 + 6 * k:   # input from the wire: never trust the header
        return False
    return native.psdt_topk_unpack(_u8ptr(u8), out.size, _fptr(out)) == 0
