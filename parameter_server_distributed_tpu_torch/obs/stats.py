"""Process-wide metric instruments: counters, gauges, log-bucket
histograms — the port's own copy of the Counter/Gauge/Histogram/Registry
part of parameter_server_distributed_tpu/obs/stats.py, which
``DecodeServer``, the RPC layer, the PS service, ``Worker`` and the
decode fleet report into (the coordinator's ``fleet.servers.active``
gauge, a fleet server's ``fleet.streams``, ``fleet.swaps`` and
``fleet.queue_depth``, the router's ``fleet.routed`` and
``fleet.route_rejected``) — and ``MetricsLogger``, the worker's JSONL
record per iteration.

Buckets are geometric with ratio 2**(1/4), so a percentile read off the
bucket midpoints is within ~9% of the true value; snapshots are plain
JSON (bucket maps, not percentiles) and merge losslessly.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any

# value v (>0) lands in bucket ceil(log(v, BASE)); bucket i spans
# (BASE**(i-1), BASE**i]
_BASE = 2.0 ** 0.25
_LOG_BASE = math.log(_BASE)


class Counter:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int | float = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed distribution: O(1) memory in observations, bounded
    relative error on percentiles."""

    __slots__ = ("_lock", "buckets", "count", "total", "zeros",
                 "vmin", "vmax")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.zeros = 0   # observations <= 0 (kept out of the log buckets)
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if v <= 0.0:
                self.zeros += 1
                return
            idx = math.ceil(math.log(v) / _LOG_BASE - 1e-9)
            self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        with self._lock:
            return percentile_from(self._snapshot_locked(), q)

    def summary(self) -> dict[str, float]:
        with self._lock:
            snap = self._snapshot_locked()
        if not snap["count"]:
            return {"count": 0}
        return {"count": snap["count"],
                "mean": snap["sum"] / snap["count"],
                "p50": percentile_from(snap, 50),
                "p95": percentile_from(snap, 95),
                "min": snap["min"], "max": snap["max"]}

    def _snapshot_locked(self) -> dict:
        return {"count": self.count, "sum": self.total, "zeros": self.zeros,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "buckets": dict(self.buckets)}

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot_locked()


def percentile_from(snap: dict, q: float) -> float:
    """q-th percentile from a histogram snapshot: the geometric midpoint
    of the bucket holding the target rank, clamped to [min, max]."""
    count = snap.get("count", 0)
    if not count:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * count))
    seen = snap.get("zeros", 0)
    if rank <= seen:
        return min(0.0, snap["min"])
    items = sorted((int(k), v) for k, v in snap["buckets"].items())
    for idx, n in items:
        seen += n
        if rank <= seen:
            mid = _BASE ** (idx - 0.5)
            return min(max(mid, snap["min"]), snap["max"])
    return snap["max"]


class Registry:
    """Name -> instrument map; the process-wide default is ``REGISTRY``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls()
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(inst).__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()

    def snapshot(self) -> dict:
        """JSON-able view of every instrument (histograms as bucket
        maps)."""
        with self._lock:
            items = list(self._instruments.items())
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.snapshot()
        return out


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


class MetricsLogger:
    """Append-only JSONL metrics stream (path None: in memory only)."""

    def __init__(self, path: str | None = None):
        self._path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, **fields: Any) -> dict:
        record = {"t": time.time(), **fields}
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(record, default=float) + "\n")
        return record
