"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` beside the
package, as a shared library loaded with ``ctypes``.  The library's file
name carries a hash of its source, of every ``csrc/`` header it includes
(``#include "x.cuh"``, followed through headers) and of its flags
(:func:`flags`: the common ones and the source's own), so an
edited source or header never loads a stale build, and processes that
share a checkout share a build.
Nothing here runs at import: the CPU has no ``nvcc``, and the CPU paths
never call :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PACKAGE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "torch_kernels")
SOURCES = ("flash_fwd", "flash_bwd", "fused_update", "device_apply",
           "int8_serve")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beyond NVCC_FLAGS: the PS close's kernels are held
# to the host numpy optimizers bit for bit, and the KV quantizer to its
# plain version byte for byte, so every operation rounds on its own (no
# contraction into FMAs, IEEE divide and sqrt, denormals kept)
_EXACT = ("--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false")
EXTRA_FLAGS = {"device_apply": _EXACT, "int8_serve": _EXACT}

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's report per built source (registers, shared memory, spills)
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit (set CUDA_HOME)")


def inputs(name: str) -> list[str]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` that it includes,
    directly or through another header, as file names in ``csrc/``."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        fname = todo.pop()
        if fname in found:
            continue
        found.append(fname)
        with open(os.path.join(CSRC, fname), encoding="utf-8") as f:
            todo += [h for h in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(CSRC, h))]
    return found


def flags(name: str) -> tuple[str, ...]:
    """The nvcc flags ``csrc/<name>.cu`` builds with."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(flags(name)).encode())
    for fname in sorted(inputs(name)):
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no current build, one ``nvcc``
    per source, all started together.  Returns the seconds each build
    took (0.0 for one already built); raises with the compiler's output
    if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = nvcc()
    started = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [compiler, *flags(name), "-o", tmp,
             os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _LIBS[name] = ctypes.CDLL(path)
        return lib
