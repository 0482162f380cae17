"""The decode fleet's controller, autoscaling and rolling updates: the
port of parameter_server_distributed_tpu/fleet/controller.py.

It runs beside a :class:`~..core.coordinator_core.CoordinatorCore` and
holds the core itself (no RPC to itself):

- **Autoscaling.**  :func:`scale_decision` is the policy: one server
  more when fleet-wide slot occupancy (busy slots and queued admissions
  over total slots) is above the high watermark, one fewer below the
  low one, clamped to [min, max]; a manual target (``ctl_main scale
  <n>``) overrides the watermarks until set back to 0.  The loop acts
  through a ``spawner`` (start one decode process; stop a drained
  one).  Scale-in drains before it stops: the victim is marked
  DRAINING, finishes its in-flight streams and leaves, and only a GONE
  server is handed to ``spawner.stop``.
- **Rolling update and rollback.**  :meth:`FleetController.rolling_update`
  walks the ACTIVE servers one at a time and ``Control(SWAP)``s each to
  the version, confirming each swap before the next server (streams
  stay pinned to their server, and the swap lands between rounds);
  :meth:`FleetController.rollback` pins every server back to a held
  version, after which no server serves a newer version until unpinned.

Not ported: flight events (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading

import grpc

from ..rpc.service import RpcClient
from . import messages as fmsg

log = logging.getLogger("pst.fleet.controller")


@dataclasses.dataclass
class ScalePolicy:
    """Watermarks (fractions of total slots occupied) and size bounds."""
    low: float = 0.3
    high: float = 0.8
    min_servers: int = 1
    max_servers: int = 8


def occupancy(entries) -> float:
    """Fleet-wide demand: (busy slots + queued admissions) over the
    total slots of the ACTIVE servers.  Full slots and full queues read
    above 1.0, the scale-out signal."""
    live = [e for e in entries if int(e.state) == fmsg.MEMBER_ACTIVE]
    total = sum(int(e.slots) for e in live)
    if total <= 0:
        return 0.0
    busy = sum(int(e.slots) - int(e.free_slots) for e in live)
    queued = sum(int(e.queue_depth) for e in live)
    return (busy + queued) / total


def scale_decision(entries, policy: ScalePolicy,
                   manual_target: int = 0) -> int:
    """The desired fleet size for the table: the manual target when set,
    else one step in the watermark's direction (never a jump: each new
    server changes the occupancy the next decision sees)."""
    current = sum(1 for e in entries
                  if int(e.state) in (fmsg.MEMBER_ACTIVE,
                                      fmsg.MEMBER_JOINING))
    if manual_target > 0:
        return max(policy.min_servers,
                   min(policy.max_servers, manual_target))
    occ = occupancy(entries)
    if occ > policy.high and current < policy.max_servers:
        return current + 1
    if occ < policy.low and current > policy.min_servers:
        return current - 1
    return max(policy.min_servers, min(policy.max_servers, current))


def expected_servers(streams_per_s: float, tokens_per_stream: float,
                     tokens_per_s_per_slot: float, slots: int) -> int:
    """Little's-law sizing for operators: the fleet size at which the
    offered load occupies about 70 % of the slots."""
    if tokens_per_s_per_slot <= 0 or slots <= 0:
        return 1
    demand_slots = (streams_per_s * tokens_per_stream
                    / tokens_per_s_per_slot)
    return max(1, math.ceil(demand_slots / (0.7 * slots)))


class FleetController:
    """See the module docstring.  ``spawner`` has ``spawn() -> None``
    (start one decode process, which registers itself) and
    ``stop(server_id) -> None`` (reap a GONE one)."""

    def __init__(self, core, *, policy: ScalePolicy | None = None,
                 spawner=None, interval_s: float = 0.5):
        self.core = core
        self.policy = policy or ScalePolicy()
        self.spawner = spawner
        self._interval = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # servers this controller marked DRAINING that still owe a
        # spawner.stop once GONE
        self._stopping: set[int] = set()
        self._clients: dict[str, RpcClient] = {}

    # ------------------------------------------------------------- clients
    def _control(self, address: str, action: int, version: int = -1,
                 timeout: float = 30.0) -> fmsg.DecodeControlResponse:
        client = self._clients.get(address)
        if client is None:
            client = RpcClient(address, fmsg.DECODE_SERVICE,
                               fmsg.DECODE_METHODS)
            self._clients[address] = client
        return client.call(
            "Control",
            fmsg.DecodeControlRequest(action=action, version=version),
            timeout=timeout)

    def close(self) -> None:
        self.stop_autoscaler()
        clients, self._clients = dict(self._clients), {}
        for client in clients.values():
            client.close()

    # ------------------------------------------------------ rolling update
    def _active_servers(self):
        _epoch, entries, _target = self.core.fleet_table()
        return [e for e in entries if e.state == fmsg.MEMBER_ACTIVE]

    def rolling_update(self, version: int = -1,
                       timeout: float = 30.0) -> dict[int, bool]:
        """Swap every ACTIVE server to ``version`` (-1 = each server's
        newest held), one server at a time: a swap confirms before the
        next server is touched, so at most one server is mid-swap and
        every pinned stream keeps flowing.  Returns {server_id: ok}."""
        results: dict[int, bool] = {}
        for member in self._active_servers():
            try:
                resp = self._control(member.address, fmsg.CTRL_SWAP,
                                     version, timeout=timeout)
                results[member.server_id] = bool(resp.success)
                if not resp.success:
                    log.warning("rollout: server %d refused version %d "
                                "(%s)", member.server_id, version,
                                resp.message)
            except grpc.RpcError as exc:
                log.warning("rollout: server %d unreachable (%s)",
                            member.server_id, exc)
                results[member.server_id] = False
        return results

    def rollback(self, version: int,
                 timeout: float = 30.0) -> dict[int, bool]:
        """Pin the whole fleet back to ``version``: each server swaps to
        it and refuses anything newer until unpinned."""
        results: dict[int, bool] = {}
        for member in self._active_servers():
            try:
                resp = self._control(member.address, fmsg.CTRL_ROLLBACK,
                                     version, timeout=timeout)
                results[member.server_id] = bool(resp.success)
            except grpc.RpcError:
                results[member.server_id] = False
        return results

    def unpin(self) -> None:
        for member in self._active_servers():
            try:
                self._control(member.address, fmsg.CTRL_UNPIN)
            except grpc.RpcError:
                pass  # an unreachable server pins nothing new

    # ---------------------------------------------------------- autoscaler
    def scale_step(self) -> int:
        """One autoscale decision and its action; returns the desired
        size.  Scale-out spawns now; scale-in drains the youngest ACTIVE
        server and stops it only once the table shows it GONE."""
        _epoch, entries, manual = self.core.fleet_table()
        # a drained server has left the table (GONE): reap it now
        for entry in entries:
            if (entry.server_id in self._stopping
                    and entry.state == fmsg.MEMBER_GONE):
                self._stopping.discard(entry.server_id)
                if self.spawner is not None:
                    self.spawner.stop(entry.server_id)
        desired = scale_decision(entries, self.policy, manual)
        current = [e for e in entries if e.state == fmsg.MEMBER_ACTIVE]
        draining = sum(1 for e in entries
                       if e.state == fmsg.MEMBER_DRAINING)
        if desired > len(current) + draining and self.spawner is not None:
            log.info("fleet scale-out: %d -> %d", len(current), desired)
            self.spawner.spawn()
        elif desired < len(current) and draining == 0:
            # one drain at a time, the youngest first: the longest-lived
            # server has the warmest caches
            victim = max(current, key=lambda e: e.server_id)
            log.info("fleet scale-in: draining server %d",
                     victim.server_id)
            self.core.fleet_drain(victim.server_id)
            self._stopping.add(victim.server_id)
        return desired

    def start_autoscaler(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._autoscale_loop,
                                        daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop_autoscaler(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def _autoscale_loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scale_step()
            except Exception:  # noqa: BLE001 — the autoscaler keeps
                # ticking through a transient RPC or spawn failure; the
                # next interval retries on a fresh table
                log.exception("autoscale step failed")
