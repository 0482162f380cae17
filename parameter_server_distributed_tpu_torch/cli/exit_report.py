"""The exit report of a wire-round process: one JSON file written when a
PS or worker process ends (``--report=PATH`` on cli/ps_main.py and
cli/worker_main.py), with the kernel launch counts of the process, its
peak card memory and its obs registry (counters, and each histogram's
summary).  ``chip_smoke.py`` reads it to check and report the
processes' work."""

from __future__ import annotations

import json
import os

import torch

from ..obs import stats as obs_stats


def write_exit_report(path: str, role: str) -> None:
    from ..ops import flash_attention, fused_update

    snap = obs_stats.REGISTRY.snapshot()
    report = {
        "role": role,
        "launches": {**flash_attention.launches, **fused_update.launches},
        "peak_mem_bytes": (torch.cuda.max_memory_allocated()
                           if torch.cuda.is_initialized() else 0),
        "counters": snap["counters"],
        "histograms": {name: obs_stats.REGISTRY.histogram(name).summary()
                       for name in snap["histograms"]},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, default=float)
    os.replace(tmp, path)
