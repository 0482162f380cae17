"""The exit report of a wire-round process: one JSON file written when a
PS, worker or serving process ends (``--report=PATH`` on
cli/ps_main.py, cli/worker_main.py, cli/serve_main.py and
cli/route_main.py), with the kernel launch counts of the process, its
peak card memory and its obs registry (counters, gauges, and each
histogram's summary).  Every report carries ``rpc.shm.fallback`` (0 when
no connection fell back to gRPC) and the ``rpc.codec.native`` gauge of
the codec the process resolves at exit (1 = the C++ codec), so a run
that fell back to the Python codec or to gRPC shows it, and the device
close's counters: ``ps.apply.device`` (closes that published a device
store), ``ps.apply.device_fallback`` and ``ps.apply.arena_fallback``.
The launch counts include ``ops.device_apply``'s four kernels and
``ops.int8_serve``'s three; ``peak_rss_bytes`` is the process's peak
resident host memory, from the source ``peak_rss_source`` names (see
:func:`peak_rss`).  The PS adds its optimizer's class
(``optimizer``), the updates its async mode applied
(``applied_updates``, 0 when synchronous), its delta chain's state
(``delta``: armed or not, the (version, crc, wall time) of the last
versions published) and the names and shapes of its store at exit
(``store``: a shard of a sharded store lists its own), a serving process its stats, streams served and,
following a PS, its follower's state and swaps.
``chip_smoke.py`` reads it to check and report the processes' work."""

from __future__ import annotations

import json
import os
import resource

import torch

from ..obs import stats as obs_stats


def peak_rss() -> tuple[int, str]:
    """This process's peak resident host memory in bytes and its source:
    VmHWM of /proc/self/status, the high-water mark of its own address
    space, where the kernel reports it; else getrusage's ru_maxrss, which
    keeps across exec the resident size the process had when it was
    forked, so a child of a large process reports at least its parent's
    size (a caller that needs a child's own peak samples its VmRSS)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024, "VmHWM"
    except OSError:
        pass
    # Linux reports ru_maxrss in KiB
    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "ru_maxrss")


def write_exit_report(path: str, role: str, **extra) -> None:
    """Write the report of this process, playing ``role``, to ``path``;
    ``extra`` keys join the report as they are."""
    from ..ops import device_apply, flash_attention, fused_update, int8_serve
    from ..rpc.codec import active_codec

    active_codec()                           # sets rpc.codec.native
    # present, 0 if never added
    for name in ("rpc.shm.fallback", "ps.apply.device",
                 "ps.apply.device_fallback", "ps.apply.arena_fallback"):
        obs_stats.counter(name)
    snap = obs_stats.REGISTRY.snapshot()
    rss, rss_source = peak_rss()
    report = {
        "role": role, **extra,
        "launches": {**flash_attention.launches, **fused_update.launches,
                     **device_apply.launches, **int8_serve.launches},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if torch.cuda.is_initialized() else 0),
        "peak_rss_bytes": rss,
        "peak_rss_source": rss_source,
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": {name: obs_stats.REGISTRY.histogram(name).summary()
                       for name in snap["histograms"]},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, default=float)
    os.replace(tmp, path)
