"""How many mlp_1b wire workers one card and its host hold for
chip_smoke.py's config3_wire (BASELINE config 3: four PS shards).

    python3 config3_probe.py [--then=auto|N]

Builds the port's kernels and its host library, then runs config3_wire's
big leg (chip_smoke.config3_big: four cli.ps_main shards, mlp_1b at batch
2048, bf16 on the wire, CONFIG3's rounds) with one worker, and prints one
JSON line: each process's peak card memory (torch's allocator) and peak
host RSS, the card memory in use and the host memory available at their
extremes over the leg (nvidia-smi, /proc/meminfo), and the worker count
that leaves 10 % of the card and 10 % of the host's available memory
free:

- a worker's card share is its allocator peak plus the card memory in use
  beyond every process's allocator peak, split evenly over the processes
  (CUDA contexts, allocator caches); the rest of the card memory in use
  is the shards' and stays;
- a worker's host share is its peak RSS (sampled VmRSS); the host
  memory the leg took beyond it is the shards' and stays.

With ``--then=auto`` (or a count) the leg runs again at that count.
Needs one card; the leg's checks are chip_smoke's own.
"""

from __future__ import annotations

import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def suggest(out: dict) -> dict:
    """The worker count that keeps a 10 % margin of card and host memory,
    from a one-worker leg's printed line."""
    mem = out["memory_sampled"]
    peaks = out["peak_mem_gb"]
    overhead = max(0.0, mem["card_used_gb_max"] - sum(peaks.values())) \
        / len(peaks)
    worker_card = peaks["worker 0"] + overhead
    shards_card = mem["card_used_gb_max"] - worker_card
    by_card = math.floor((0.9 * mem["card_total_gb"] - shards_card)
                         / worker_card)
    # the sampled VmRSS: the exit report's fallback (ru_maxrss) carries
    # the parent's size where the kernel keeps no VmHWM
    worker_host = (out["peak_rss_sampled_gb"].get("worker 0")
                   or out["peak_rss_gb"]["worker 0"])
    taken = mem["host_available_gb_at_start"] - mem["host_available_gb_min"]
    shards_host = max(0.0, taken - worker_host)
    by_host = math.floor((0.9 * mem["host_available_gb_at_start"]
                          - shards_host) / worker_host)
    return {"worker_card_gb": worker_card, "shards_card_gb": shards_card,
            "worker_host_gb": worker_host, "shards_host_gb": shards_host,
            "workers_by_card": by_card, "workers_by_host": by_host,
            "workers": max(1, min(8, by_card, by_host))}


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this probe needs a "
                "CUDA card")
    flags = dict(a[2:].split("=", 1) for a in sys.argv[1:]
                 if a.startswith("--") and "=" in a)
    from parameter_server_distributed_tpu_torch import native
    from parameter_server_distributed_tpu_torch.ops import build

    build.build(build.SOURCES)
    if native.lib() is None:
        cs.fail("the host C++ library did not build")
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    c3 = cs.CONFIG3
    _, one = cs.config3_big(np, 1, c3["batch"], c3["rounds"], "mlp_1b")
    advice = suggest(one)
    cs.emit({"phase": "config3_probe", "card": smi, "one_worker": {
        k: one[k] for k in ("peak_mem_gb", "peak_rss_sampled_gb",
                            "memory_sampled", "per_round_slowest_worker",
                            "phase_s")},
        **advice})
    then = flags.get("then")
    if then:
        n = advice["workers"] if then == "auto" else int(then)
        _, more = cs.config3_big(np, n, c3["batch"], c3["rounds"], "mlp_1b")
        cs.emit({"phase": "config3_probe_then", "workers": n, "card": smi,
                 **{k: more[k] for k in (
                     "peak_mem_gb", "peak_rss_sampled_gb", "memory_sampled",
                     "per_round_slowest_worker", "grad_samples_per_s",
                     "phase_s")}})
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
