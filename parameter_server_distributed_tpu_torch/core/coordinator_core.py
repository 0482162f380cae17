"""Coordinator membership registry: the port of ``WorkerRegistryEntry``
and ``CoordinatorCore`` from
parameter_server_distributed_tpu/core/coordinator_core.py.

A lock-guarded map worker id -> registry entry with heartbeat stamps,
stale-worker eviction and the PS address workers discover.  Its
``live_worker_count`` is the elastic barrier width of
``ParameterServerCore``: :meth:`CoordinatorCore.width_provider` hands the
core a provider whose ``generation()`` moves whenever the live set does,
so the barrier narrows at the next width read.

Not ported: the shard map, promotions and live resharding (ROADMAP.md
Queue 1, item 13), the decode fleet registry (item 6), the tier topology
(item 10) and the membership states with their drain (item 11).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


class WorkerStatus:
    """The worker status enum of the coordinator protocol."""
    IDLE = 0
    TRAINING = 1
    CHECKPOINTING = 2
    ERROR = 3


@dataclasses.dataclass
class WorkerRegistryEntry:
    worker_id: int
    address: str
    port: int
    hostname: str
    status: int = WorkerStatus.IDLE
    last_heartbeat: float = 0.0


class CoordinatorCore:
    def __init__(self, ps_address: str, ps_port: int,
                 time_fn: Callable[[], float] = time.monotonic):
        self._ps_address = ps_address
        self._ps_port = int(ps_port)
        self._workers: dict[int, WorkerRegistryEntry] = {}
        self._lock = threading.Lock()   # the registry and the PS address
        self._time = time_fn
        # bumped whenever the live set changes (a new worker, a leave, an
        # eviction): the PS barrier-width cache invalidates on it
        self._registry_generation = 0

    def register_worker(self, worker_id: int, address: str, port: int,
                        hostname: str) -> int:
        """Upsert with a heartbeat stamp; returns the registered count.  A
        worker new to the registry bumps the registry generation."""
        now = self._time()
        with self._lock:
            fresh = worker_id not in self._workers
            self._workers[worker_id] = WorkerRegistryEntry(
                worker_id=worker_id, address=address, port=int(port),
                hostname=hostname, status=WorkerStatus.IDLE,
                last_heartbeat=now)
            if fresh:
                self._registry_generation += 1
            return len(self._workers)

    def update_heartbeat(self, worker_id: int, status: int) -> bool:
        """Refresh the stamp and status; False for an unknown worker."""
        with self._lock:
            entry = self._workers.get(worker_id)
            if entry is None:
                return False
            entry.last_heartbeat = self._time()
            entry.status = status
            return True

    def list_workers(self) -> list[WorkerRegistryEntry]:
        with self._lock:
            return [dataclasses.replace(e) for e in self._workers.values()]

    def live_worker_count(self) -> int:
        with self._lock:
            return len(self._workers)

    def get_parameter_server_address(self) -> tuple[str, int]:
        with self._lock:
            return self._ps_address, self._ps_port

    def set_parameter_server_address(self, address: str, port: int) -> None:
        """Re-point discovery (ephemeral ports, PS failover)."""
        with self._lock:
            self._ps_address = address
            self._ps_port = int(port)

    def registry_generation(self) -> int:
        """Monotone count of live-set changes (register, leave, evict)."""
        with self._lock:
            return self._registry_generation

    def width_provider(self):
        """An in-process ``live_workers_fn`` for ``ParameterServerCore``:
        callable for the live count, with the ``generation`` attribute
        its barrier-width cache invalidates on."""
        core = self

        class _Provider:
            def __call__(self) -> int:
                return core.live_worker_count()

            def generation(self) -> int:
                return core.registry_generation()

        return _Provider()

    def deregister_worker(self, worker_id: int) -> bool:
        """Graceful leave: drop the entry now, so the barrier narrows at
        the next width read instead of a stale-heartbeat reap."""
        with self._lock:
            removed = self._workers.pop(int(worker_id), None) is not None
            if removed:
                self._registry_generation += 1
            return removed

    def remove_stale_workers(self, timeout_s: float = 30.0) -> list[int]:
        """Evict workers silent for more than ``timeout_s``; returns their
        ids."""
        now = self._time()
        with self._lock:
            evicted = [wid for wid, entry in self._workers.items()
                       if now - entry.last_heartbeat > timeout_s]
            for wid in evicted:
                del self._workers[wid]
            if evicted:
                self._registry_generation += 1
            return evicted
