"""Coordinator gRPC service and stale-worker reaper: the port of
parameter_server_distributed_tpu/server/coordinator_service.py.

Wraps the port's ``CoordinatorCore`` in the reference's 4-RPC service
(reference: src/coordinator_service.cpp:26-112,
proto/coordinator.proto:5-10) and runs the cleanup thread (every 10 s,
evict workers silent for more than 30 s — reference:
src/coordinator_service.cpp:102-107).

Beside the reference's four RPCs it serves the decode fleet's
``UpdateFleet`` (fleet/messages.py ``FLEET_COORD_METHODS``: register,
heartbeat, leave, drain, scale target, table query) and the PS shard
map: ``GetParameterServerAddress`` lists every shard in its extension
field 3 when the store is sharded (``--ps-shards``), and
``GetShardMap`` / ``ReportShardFailure`` (replication/messages.py
``REPLICATION_COORD_METHODS``) answer the epoch-numbered map, so either
package's ``Worker`` fans out over the shards as it does on a JAX
coordinator.  Its reaper also marks decode servers silent for the stale
timeout GONE.  The JAX package's other extensions (membership and the
tier topology, ROADMAP.md Queue 1, items 11 and 10) answer
UNIMPLEMENTED, which the JAX package's ``Worker`` latches as
"unsupported" and carries on without; ``GetClusterMetrics`` and its
fleet rollup (item 14, observability) answer UNIMPLEMENTED with that
item named.  A reported shard failure promotes nothing: backups are
item 13's.
"""

from __future__ import annotations

import logging
import threading
import time

import grpc

from ..config import CoordinatorConfig
from ..core.coordinator_core import CoordinatorCore
from ..fleet import messages as fmsg
from ..replication import messages as rmsg
from ..rpc import messages as m
from ..rpc.service import bind_service, make_server
from ..rpc.wire import Message

ROADMAP_OBS = ("GetClusterMetrics is not ported yet: ROADMAP.md Queue 1, "
               "item 14 (observability: obs/export.py and the fleet "
               "rollup)")
# bound only to refuse with the item named (its messages are item 14's)
_UNPORTED_METHODS = {"GetClusterMetrics": (Message, Message)}

log = logging.getLogger("pst.coordinator")


class CoordinatorService:
    def __init__(self, core: CoordinatorCore):
        self.core = core

    # reference: src/coordinator_service.cpp:39-61
    def RegisterWorker(self, request: m.WorkerInfo,
                       context) -> m.RegisterResponse:
        total = self.core.register_worker(request.worker_id, request.address,
                                          request.port, request.hostname)
        ps_addr, ps_port = self.core.get_parameter_server_address()
        log.info("registered worker %d (%s:%d), total=%d",
                 request.worker_id, request.address, request.port, total)
        return m.RegisterResponse(
            success=True, message="registered",
            parameter_server_address=f"{ps_addr}:{ps_port}",
            total_workers=total)

    # reference: src/coordinator_service.cpp:63-72
    def Heartbeat(self, request: m.HeartbeatRequest,
                  context) -> m.HeartbeatResponse:
        ok = self.core.update_heartbeat(request.worker_id, request.status)
        return m.HeartbeatResponse(success=ok,
                                   timestamp=int(time.time() * 1000))

    # reference: src/coordinator_service.cpp:74-88
    def ListWorkers(self, request: m.ListWorkersRequest,
                    context) -> m.ListWorkersResponse:
        entries = self.core.list_workers()
        return m.ListWorkersResponse(
            workers=[m.WorkerInfo(worker_id=e.worker_id, address=e.address,
                                  port=e.port, hostname=e.hostname)
                     for e in entries],
            total_workers=len(entries))

    # reference: src/coordinator_service.cpp:90-99
    def GetParameterServerAddress(self, request: m.GetPSAddressRequest,
                                  context) -> m.GetPSAddressResponse:
        addr, port = self.core.get_parameter_server_address()
        shards = self.core.get_parameter_server_shards()
        # extension field 3 only when sharded: reference peers skip it,
        # the packages' workers fan out per tensor owner
        return m.GetPSAddressResponse(address=addr, port=port,
                                      shards=shards if len(shards) > 1
                                      else [])

    # the epoch-numbered shard map (framework extension, replication/)
    @staticmethod
    def _map_response(epoch, entries) -> rmsg.ShardMapResponse:
        return rmsg.ShardMapResponse(
            epoch=epoch,
            entries=[rmsg.WireShardMapEntry(primary=e.primary,
                                            backup=e.backup, epoch=e.epoch)
                     for e in entries])

    def GetShardMap(self, request: rmsg.ShardMapRequest,
                    context) -> rmsg.ShardMapResponse:
        return self._map_response(*self.core.get_shard_map())

    def ReportShardFailure(self, request: rmsg.ShardFailureReport,
                           context) -> rmsg.ShardMapResponse:
        log.warning("worker %d reports shard %d (%s) dead",
                    request.worker_id, request.shard_index,
                    request.observed_primary)
        epoch, entries = self.core.promote_shard(request.shard_index,
                                                 request.observed_primary)
        return self._map_response(epoch, entries)

    def GetClusterMetrics(self, request, context):
        context.abort(grpc.StatusCode.UNIMPLEMENTED, ROADMAP_OBS)

    # the decode fleet: register, heartbeat, leave, drain, scale target
    # and table query in one method (the JAX package's
    # server/coordinator_service.py:174-222)
    def UpdateFleet(self, request: fmsg.FleetRequest,
                    context) -> fmsg.FleetResponse:
        ok, message = True, "ok"
        sid = int(request.server_id)
        if request.action == fmsg.FLEET_REGISTER:
            self.core.fleet_register(sid, request.address, request.slots)
            log.info("decode server %d registered (%s, %d slots)",
                     sid, request.address, request.slots)
        elif request.action == fmsg.FLEET_HEARTBEAT:
            state = self.core.fleet_heartbeat(
                sid, request.free_slots, request.queue_depth,
                request.weight_version, request.active_streams,
                prefix_fp=bytes(request.prefix_fp))
            if state is None:
                ok, message = False, f"server {sid} unknown (re-register)"
        elif request.action == fmsg.FLEET_LEAVE:
            self.core.fleet_leave(sid)
            log.info("decode server %d left the fleet", sid)
        elif request.action == fmsg.FLEET_DRAIN:
            target = int(request.target_server_id)
            ok = self.core.fleet_drain(target)
            message = (f"server {target} draining" if ok
                       else f"server {target} unknown or already gone")
            log.warning("fleet drain request for server %d: %s",
                        target, message)
        elif request.action == fmsg.FLEET_SCALE:
            self.core.set_fleet_target(int(request.scale_target))
            message = f"scale target {int(request.scale_target)}"
            log.info("fleet %s", message)
        epoch, fleet, target = self.core.fleet_table()
        self_state = self.core.fleet_state(sid)
        return fmsg.FleetResponse(
            epoch=epoch, success=ok, message=message,
            self_state=self_state if self_state is not None else -1,
            scale_target=target,
            entries=[fmsg.FleetEntry(
                server_id=f.server_id, address=f.address, slots=f.slots,
                free_slots=f.free_slots, queue_depth=f.queue_depth,
                weight_version=f.weight_version, state=f.state,
                epoch=f.epoch, active_streams=f.active_streams,
                prefix_fp=f.prefix_fp)
                for f in fleet])


class Coordinator:
    """Process-level assembly (reference: run_coordinator_server at
    src/coordinator_service.cpp:114-126)."""

    def __init__(self, config: CoordinatorConfig):
        self.config = config
        self.core = CoordinatorCore(config.ps_address, config.ps_port,
                                    ps_shards=config.ps_shards)
        self.service = CoordinatorService(self.core)
        self._server: grpc.Server | None = None
        self._stop = threading.Event()
        self._reaper: threading.Thread | None = None

    def start(self) -> int:
        """Start serving; returns the bound port (0 in config = ephemeral)."""
        self._server = make_server()
        bind_service(self._server, m.COORDINATOR_SERVICE,
                     {**m.COORDINATOR_METHODS, **fmsg.FLEET_COORD_METHODS,
                      **rmsg.REPLICATION_COORD_METHODS,
                      **_UNPORTED_METHODS}, self.service)
        addr = f"{self.config.bind_address}:{self.config.port}"
        port = self._server.add_insecure_port(addr)
        if port == 0:
            raise RuntimeError(f"could not bind {addr}")
        self._server.start()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="coordinator-reaper")
        self._reaper.start()
        log.info("coordinator listening on %s (ps=%s:%d, %d shard(s))",
                 addr, self.config.ps_address, self.config.ps_port,
                 1 + len(self.config.ps_shards))
        return port

    def _reap_loop(self) -> None:
        while not self._stop.wait(self.config.reap_period_s):
            for wid in self.core.remove_stale_workers(
                    self.config.stale_timeout_s):
                log.warning("evicted stale worker %d", wid)
            for sid in self.core.remove_stale_fleet(
                    self.config.stale_timeout_s):
                log.warning("evicted stale decode server %d", sid)

    def wait(self) -> None:
        assert self._server is not None
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace).wait()
        if self._reaper is not None:
            self._reaper.join(timeout=5.0)
