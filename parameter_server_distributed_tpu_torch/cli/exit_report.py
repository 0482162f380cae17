"""The exit report of a wire-round process: one JSON file written when a
PS or worker process ends (``--report=PATH`` on cli/ps_main.py and
cli/worker_main.py), with the kernel launch counts of the process, its
peak card memory and its obs registry (counters, gauges, and each
histogram's summary).  Every report carries ``rpc.shm.fallback`` (0 when
no connection fell back to gRPC) and the ``rpc.codec.native`` gauge of
the codec the process resolves at exit (1 = the C++ codec), so a run
that fell back to the Python codec or to gRPC shows it, and the device
close's counters: ``ps.apply.device`` (closes that published a device
store), ``ps.apply.device_fallback`` and ``ps.apply.arena_fallback``.
The launch counts include ``ops.device_apply``'s four kernels; the PS
adds its optimizer's class (``optimizer``).
``chip_smoke.py`` reads it to check and report the processes' work."""

from __future__ import annotations

import json
import os

import torch

from ..obs import stats as obs_stats


def write_exit_report(path: str, role: str, **extra) -> None:
    """Write the report of this process, playing ``role``, to ``path``;
    ``extra`` keys join the report as they are."""
    from ..ops import device_apply, flash_attention, fused_update
    from ..rpc.codec import active_codec

    active_codec()                           # sets rpc.codec.native
    # present, 0 if never added
    for name in ("rpc.shm.fallback", "ps.apply.device",
                 "ps.apply.device_fallback", "ps.apply.arena_fallback"):
        obs_stats.counter(name)
    snap = obs_stats.REGISTRY.snapshot()
    report = {
        "role": role, **extra,
        "launches": {**flash_attention.launches, **fused_update.launches,
                     **device_apply.launches},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if torch.cuda.is_initialized() else 0),
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
