"""Coordinator membership registry: the port of ``WorkerRegistryEntry``
and ``CoordinatorCore`` from
parameter_server_distributed_tpu/core/coordinator_core.py.

A lock-guarded map worker id -> registry entry with heartbeat stamps,
stale-worker eviction and the PS address workers discover.  Its
``live_worker_count`` is the elastic barrier width of
``ParameterServerCore``: :meth:`CoordinatorCore.width_provider` hands the
core a provider whose ``generation()`` moves whenever the live set does,
so the barrier narrows at the next width read.

The PS shard map: one :class:`ShardMapEntry` per PS shard (entry 0
the PS the reference protocol's discovery names, the rest
``CoordinatorConfig.ps_shards``) under a map epoch, read by workers
through ``GetShardMap``.

The decode fleet's registry: a map server id -> :class:`FleetMember`
under a fleet epoch bumped on every state change (JOINING, ACTIVE,
DRAINING, GONE: the elastic membership states), the manual scale
target, and the stale-server reap the coordinator's reaper runs.

Not ported: backups, their promotion, ``set_shard_backups``,
``set_shard_map`` and live resharding (ROADMAP.md Queue 1, item 13), the
tier topology (item 10) and the workers' membership states with their
drain (item 11).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Sequence

from ..elastic import messages as emsg
from ..obs import stats as obs_stats


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


@dataclasses.dataclass
class FleetMember:
    """One decode server of the serving fleet: identity, capacity, the
    load signals the router scores on, and its state (the elastic
    membership constants)."""
    server_id: int
    address: str
    slots: int
    free_slots: int = 0
    queue_depth: int = 0
    weight_version: int = 0
    active_streams: int = 0
    state: int = emsg.MEMBER_JOINING
    epoch: int = 0            # fleet epoch at the last state change
    last_heartbeat: float = 0.0
    # radix prefix-cache fingerprint: packed block hashes the router
    # scores prompt overlap against; empty = no cache
    prefix_fp: bytes = b""


@dataclasses.dataclass
class ShardMapEntry:
    """One PS shard: its serving primary, a backup replica (always
    empty in the port: backups are item 13's) and the map epoch at which
    this entry last changed."""
    primary: str
    backup: str = ""
    epoch: int = 1


class CoordinatorCore:
    def __init__(self, ps_address: str, ps_port: int,
                 ps_shards: Sequence[str] = (),
                 time_fn: Callable[[], float] = time.monotonic):
        self._ps_address = ps_address
        self._ps_port = int(ps_port)
        self._workers: dict[int, WorkerRegistryEntry] = {}
        # the registry, the PS address and the shard map
        self._lock = threading.Lock()
        self._time = time_fn
        # the epoch-numbered shard map: index = shard index, entry 0 the
        # primary PS that the reference protocol sees, then the shards
        # beyond it (CoordinatorConfig.ps_shards)
        self._shard_epoch = 1
        self._shard_map: list[ShardMapEntry] = [
            ShardMapEntry(primary=addr, epoch=1)
            for addr in (f"{ps_address}:{int(ps_port)}", *ps_shards)]
        # bumped whenever the live set changes (a new worker, a leave, an
        # eviction): the PS barrier-width cache invalidates on it
        self._registry_generation = 0
        # the decode fleet: server id -> row, under an epoch bumped on
        # every state change (heartbeats do not bump it: the router polls
        # the table anyway); _fleet_target is the manual scale target,
        # 0 = the autoscaler's watermarks decide
        self._fleet: dict[int, FleetMember] = {}
        self._fleet_epoch = 0
        self._fleet_target = 0
        self._obs_fleet_active = obs_stats.gauge("fleet.servers.active")

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
        """Re-point discovery (ephemeral ports, PS failover); the shard
        map's entry 0 follows."""
        with self._lock:
            self._ps_address = address
            self._ps_port = int(port)
            self._shard_map[0].primary = f"{address}:{int(port)}"
            self._shard_map[0].epoch = self._shard_epoch

    def get_parameter_server_shards(self) -> list[str]:
        """Every PS shard's address (the map's primaries), shard 0
        first; one element means the unsharded topology."""
        with self._lock:
            return [e.primary for e in self._shard_map]

    def set_parameter_server_shards(self, shards: Sequence[str]) -> None:
        """Replace the shards beyond the primary; an entry whose address
        is unchanged keeps its epoch."""
        with self._lock:
            old = {e.primary: e for e in self._shard_map[1:]}
            self._shard_epoch += 1
            self._shard_map[1:] = [
                old.get(addr) or ShardMapEntry(primary=addr,
                                               epoch=self._shard_epoch)
                for addr in shards]

    def get_shard_map(self) -> tuple[int, list[ShardMapEntry]]:
        """(map epoch, entry copies).  The epoch only grows, so a worker
        holding entries at epoch E knows a map of a later epoch replaces
        them."""
        with self._lock:
            return self._shard_epoch, [dataclasses.replace(e)
                                       for e in self._shard_map]

    def promote_shard(self, shard_index: int, observed_primary: str
                      ) -> tuple[int, list[ShardMapEntry]]:
        """A worker reports shard ``shard_index``'s primary failed.  The
        JAX package swaps in the shard's backup; no entry of the port's
        map has one (backups and promotion are item 13's), so the map
        comes back unchanged, and the reporter raises its error."""
        return self.get_shard_map()

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

    # --------------------------------------------------------- decode fleet
    def _fleet_transition_locked(self, member: FleetMember,
                                 state: int) -> bool:
        """Move ``member`` to ``state``, bumping the fleet epoch iff it
        changed (the caller holds _lock)."""
        if member.state == state:
            return False
        member.state = state
        self._fleet_epoch += 1
        member.epoch = self._fleet_epoch
        self._obs_fleet_active.set(sum(
            1 for m in self._fleet.values()
            if m.state == emsg.MEMBER_ACTIVE))
        return True

    def fleet_register(self, server_id: int, address: str,
                       slots: int) -> int:
        """A decode server announces itself (or again after GONE):
        straight to ACTIVE, since serving has no barrier to join.
        Returns the fleet epoch."""
        now = self._time()
        with self._lock:
            sid = int(server_id)
            member = self._fleet.get(sid)
            if member is None or member.state == emsg.MEMBER_GONE:
                member = FleetMember(server_id=sid, address=address,
                                     slots=int(slots),
                                     free_slots=int(slots))
                self._fleet[sid] = member
            member.address = address
            member.slots = int(slots)
            member.last_heartbeat = now
            self._fleet_transition_locked(member, emsg.MEMBER_ACTIVE)
            return self._fleet_epoch

    def fleet_heartbeat(self, server_id: int, free_slots: int,
                        queue_depth: int, weight_version: int,
                        active_streams: int,
                        prefix_fp: bytes = b"") -> int | None:
        """Load refresh; returns the server's own state (its drain
        signal), or None for an unknown or GONE server, which then
        registers again.  The fingerprint rides every beat."""
        now = self._time()
        with self._lock:
            member = self._fleet.get(int(server_id))
            if member is None or member.state == emsg.MEMBER_GONE:
                return None
            member.last_heartbeat = now
            member.free_slots = int(free_slots)
            member.queue_depth = int(queue_depth)
            member.weight_version = int(weight_version)
            member.active_streams = int(active_streams)
            member.prefix_fp = bytes(prefix_fp)
            return member.state

    def fleet_drain(self, server_id: int) -> bool:
        """Mark a decode server DRAINING: it stops admitting, finishes
        its in-flight streams and leaves.  False when unknown or gone."""
        with self._lock:
            member = self._fleet.get(int(server_id))
            if member is None or member.state == emsg.MEMBER_GONE:
                return False
            self._fleet_transition_locked(member, emsg.MEMBER_DRAINING)
            return True

    def fleet_leave(self, server_id: int) -> bool:
        """Graceful leave: the row goes GONE now and stays in the table
        (ids are the operator's; a rejoin reuses the row)."""
        with self._lock:
            member = self._fleet.get(int(server_id))
            if member is None:
                return False
            return self._fleet_transition_locked(member, emsg.MEMBER_GONE)

    def fleet_table(self) -> tuple[int, list[FleetMember], int]:
        """(fleet epoch, row copies sorted by server id, scale target)."""
        with self._lock:
            return (self._fleet_epoch,
                    [dataclasses.replace(self._fleet[sid])
                     for sid in sorted(self._fleet)],
                    self._fleet_target)

    def fleet_state(self, server_id: int) -> int | None:
        with self._lock:
            member = self._fleet.get(int(server_id))
            return None if member is None else member.state

    def set_fleet_target(self, n: int) -> int:
        """The manual scale target (0 hands control back to the
        autoscaler's watermarks).  Returns the fleet epoch."""
        with self._lock:
            self._fleet_target = max(0, int(n))
            self._fleet_epoch += 1
            return self._fleet_epoch

    def remove_stale_fleet(self, timeout_s: float = 30.0) -> list[int]:
        """Mark decode servers silent for more than ``timeout_s`` GONE;
        returns the newly gone ids."""
        now = self._time()
        evicted: list[int] = []
        with self._lock:
            for member in self._fleet.values():
                if (member.state != emsg.MEMBER_GONE
                        and now - member.last_heartbeat > timeout_s
                        and self._fleet_transition_locked(
                            member, emsg.MEMBER_GONE)):
                    evicted.append(member.server_id)
        return evicted
