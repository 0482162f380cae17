"""The worker's view of the coordinator's shard map: the port of the
read side of ``ShardMapClient`` from
parameter_server_distributed_tpu/replication/failover.py.

``ShardedPSClient`` (worker/ps_shards.py) holds one when the coordinator
serves ``GetShardMap``.  It reads the epoch-numbered map (:meth:`refresh`,
:meth:`primaries`, :meth:`wait_for_epoch_above`) to follow a topology
that changes, and on a shard RPC that dies with a transport error it
reports the primary (:meth:`report_failure`).  The coordinator promotes
a shard's backup only where the map holds one; a map without backups,
the only kind the port's coordinator builds, answers with the same
primary, and the report returns None, so the caller raises the RPC's
error as the JAX client does against such a map.

A coordinator without the method (a reference peer) answers
UNIMPLEMENTED: :meth:`refresh` returns False from then on, and the
worker keeps the static discovery topology.

Not ported: promotion to backups, live resharding (ROADMAP.md Queue 1,
item 13) and the ``failover.report`` flight event (item 14).
"""

from __future__ import annotations

import logging
import threading
import time

import grpc

from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc.service import RpcClient
from ..rpc.service import status_code as _status_code
from . import messages as rmsg

log = logging.getLogger("pst.failover")


class ShardMapClient:
    """The cached (epoch, entries) and the map RPCs.  Thread-safe: the
    sharded client's fan-out threads may report failures and read the
    map at once (a leaf lock: nothing else is taken under it)."""

    def __init__(self, coordinator_address: str, worker_id: int = 0,
                 client: RpcClient | None = None):
        self._client = client or RpcClient(
            coordinator_address, m.COORDINATOR_SERVICE,
            {**m.COORDINATOR_METHODS, **rmsg.REPLICATION_COORD_METHODS})
        self.worker_id = int(worker_id)
        self._lock = threading.Lock()
        self.epoch = 0
        self.entries: list[rmsg.WireShardMapEntry] = []
        self._supported: bool | None = None
        # failover attempts; the coordinator counts actual promotions
        self._obs_failovers = obs_stats.counter("ps.replica.failovers")

    @property
    def supported(self) -> bool:
        """True once the coordinator has answered ``GetShardMap`` (a
        reference coordinator never will: a permanent downgrade)."""
        return self._supported is True

    def close(self) -> None:
        self._client.close()

    def _adopt(self, resp: rmsg.ShardMapResponse) -> None:
        with self._lock:
            if resp.epoch >= self.epoch:
                self.epoch = int(resp.epoch)
                self.entries = list(resp.entries)

    def refresh(self, timeout: float = 5.0) -> bool:
        """Fetch the current map.  False = the coordinator does not speak
        the extension (remembered) or is unreachable."""
        if self._supported is False:
            return False
        try:
            resp = self._client.call("GetShardMap", rmsg.ShardMapRequest(),
                                     timeout=timeout)
        except grpc.RpcError as exc:
            if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                self._supported = False
            return False
        self._supported = True
        self._adopt(resp)
        return True

    def primaries(self) -> list[str]:
        with self._lock:
            return [e.primary for e in self.entries]

    def has_backups(self) -> bool:
        with self._lock:
            return any(e.backup for e in self.entries)

    def report_failure(self, shard_index: int, observed_primary: str,
                       timeout: float = 10.0) -> str | None:
        """Report a failed primary; returns the shard's current primary
        from the map the coordinator answers, or None when it cannot
        help (no extension, unreachable, or no backup promoted: the
        primary is the one reported)."""
        if self._supported is False:
            return None
        self._obs_failovers.add()
        with self._lock:
            epoch = self.epoch
        try:
            resp = self._client.call(
                "ReportShardFailure",
                rmsg.ShardFailureReport(shard_index=shard_index,
                                        observed_primary=observed_primary,
                                        epoch=epoch,
                                        worker_id=self.worker_id),
                timeout=timeout)
        except grpc.RpcError as exc:
            if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                self._supported = False
            log.warning("shard-failure report for %s failed: %s",
                        observed_primary, exc)
            return None
        self._supported = True
        self._adopt(resp)
        with self._lock:
            if shard_index >= len(self.entries):
                return None
            current = self.entries[shard_index].primary
        if current == observed_primary:
            return None   # nothing promoted: the shard really is gone
        return current

    def wait_for_epoch_above(self, epoch: int, timeout: float = 15.0,
                             poll_s: float = 0.1) -> bool:
        """Poll the coordinator until the map's epoch exceeds ``epoch`` or
        ``timeout`` lapses."""
        deadline = time.monotonic() + timeout
        while True:
            if self.refresh() and self.epoch > epoch:
                return True
            if time.monotonic() >= deadline:
                return self.epoch > epoch
            time.sleep(poll_s)
