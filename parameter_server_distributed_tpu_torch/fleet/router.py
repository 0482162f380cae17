"""The decode fleet's front-door stream router: the port of
parameter_server_distributed_tpu/fleet/router.py.

The router speaks the same ``psdt_fleet.Decode`` service it routes to,
so a client cannot tell it from a single decode server.

Admission: each ``SubmitStream`` goes to the best ACTIVE backend of the
coordinator's fleet table (polled over ``UpdateFleet`` at most every
``poll_s``) by :func:`score_backends`: free slots, less the router's
claims the table cannot show yet, plus ``overlap_weight`` for each
leading prompt block in the backend's radix prefix fingerprint; then
the shorter queue, then the server id.  A claim is one routed stream.
It counts until a heartbeat newer than the backend's admission of the
stream is in the table: the backend admitted it when its first chunk
came back, it heartbeats every ``heartbeat_s`` (the decode servers'
period), so a table asked for 1.5 ``heartbeat_s`` after that first
chunk holds it.  A stream that ends takes its claim with it and leaves
a credit, a slot the table may still show taken, until a table asked
for 1.5 ``heartbeat_s`` after its end; a backend's free slots plus its
credits never pass its slots.  A burst thus spreads whether or not a
poll lands inside it, and a burst right after another is placed by the
slots free now, not by the last burst's heartbeats.  (The JAX
package's router clears its claims at every poll, so a poll mid-burst
on a table a heartbeat old stacks the rest of the burst on one
backend.)  The stream is then pinned: every chunk of its life relays
from that backend, so a rolling weight update swaps the version under
it and never re-routes a continuation.  DRAINING backends take no new
streams but keep their pinned ones; a backend lost mid-stream becomes
that stream's error chunk (its decode context is gone, and re-routing
would silently restart the generation).  Not ported: flight events
(ROADMAP.md Queue 1, item 14) and ``checked_lock`` (item 15).
"""

from __future__ import annotations

import logging
import threading
import time

import grpc

from ..models.prefix_tree import block_hashes, overlap_blocks, unpack_fp
from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc.service import RpcClient, bind_service, make_server
from ..rpc.service import status_code as _status_code
from . import messages as fmsg

log = logging.getLogger("pst.fleet.router")


def score_backends(entries, claims: dict[int, int] | None = None,
                   prompt_hashes=None, weight: float = 1.0) -> list:
    """ACTIVE backends best first: free slots less the router's own
    claims, plus ``weight`` for each leading prompt block in the entry's
    ``prefix_fp``; then the shorter queue, then the server id.  Without
    prompt hashes, or against entries without a fingerprint, every
    overlap is zero and the order is the free-slot / queue-depth one."""
    claims = claims or {}
    live = [e for e in entries if int(e.state) == fmsg.MEMBER_ACTIVE]

    def affinity(e) -> float:
        fp = bytes(getattr(e, "prefix_fp", b""))
        if not prompt_hashes or not fp or not weight:
            return 0.0
        return weight * overlap_blocks(prompt_hashes, unpack_fp(fp))

    return sorted(
        live,
        key=lambda e: (-(int(e.free_slots)
                         - claims.get(int(e.server_id), 0)
                         + affinity(e)),
                       int(e.queue_depth), int(e.server_id)))


class FleetRouter:
    """See the module docstring."""

    def __init__(self, coordinator: str, *, port: int = 0,
                 bind_address: str = "127.0.0.1",
                 poll_s: float = 0.5, overlap_weight: float = 1.0,
                 heartbeat_s: float = 0.5):
        self._coordinator = coordinator
        self._bind = f"{bind_address}:{int(port)}"
        self._poll_s = float(poll_s)
        self._heartbeat_s = float(heartbeat_s)
        # free-slot equivalents one reusable prefix block is worth in the
        # score: cache affinity outbids at most weight * blocks free
        # slots, so a backend with a hot prefix and a long queue still
        # loses to an idle one; 0 turns prefix-aware routing off
        self._overlap_weight = float(overlap_weight)
        # guards the table, the claims, the backend clients and the
        # poll-in-flight flag
        self._lock = threading.Lock()
        # one poll at a time is a flag under _lock, not a lock held over
        # the RPC: while one thread polls, every other admission routes
        # on the last table and its claims instead of waiting out a slow
        # coordinator
        self._polling = False
        self._entries: list = []
        self._table_at = 0.0
        # when the poll that brought the table was sent
        self._table_asked = 0.0
        self._epoch = 0
        # the claims: [server id, the time from which a table asked for
        # holds the stream (inf until its first chunk), ended]; an ended
        # one is a credit until a table asked for from its time holds the
        # end
        self._claims: list[list] = []
        self._clients: dict[str, RpcClient] = {}
        self.streams_routed = 0
        self.streams_rejected = 0
        self._obs_routed = obs_stats.counter("fleet.routed")
        self._obs_rejected = obs_stats.counter("fleet.route_rejected")
        self._obs_backends = obs_stats.gauge("fleet.route_backends")
        # the prefix blocks of the last routed prompt already cached on
        # its backend
        self._obs_overlap = obs_stats.gauge("fleet.route_overlap")
        self._coord = RpcClient(coordinator, m.COORDINATOR_SERVICE,
                                fmsg.FLEET_COORD_METHODS)
        self._grpc = None
        self.port = 0

    # ----------------------------------------------------------- lifecycle
    def start(self) -> int:
        self._grpc = make_server(max_workers=32)
        bind_service(self._grpc, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS,
                     self)
        self.port = self._grpc.add_insecure_port(self._bind)
        if self.port == 0:
            raise RuntimeError(f"could not bind {self._bind}")
        self._grpc.start()
        return self.port

    def stop(self, grace: float = 1.0) -> None:
        if self._grpc is not None:
            self._grpc.stop(grace).wait()
        with self._lock:
            clients, self._clients = dict(self._clients), {}
        for client in clients.values():
            client.close()
        self._coord.close()

    def wait(self) -> None:
        assert self._grpc is not None
        self._grpc.wait_for_termination()

    # ------------------------------------------------------------- routing
    def _refresh_table(self, force: bool = False) -> None:
        """Poll the fleet table when it is older than ``poll_s`` (or,
        with ``force``, now), unless a poll is already in flight."""
        with self._lock:
            fresh = time.monotonic() - self._table_at < self._poll_s
            if (fresh and not force) or self._polling:
                return
            self._polling = True
        asked = time.monotonic()
        try:
            resp = self._coord.call(
                "UpdateFleet",
                fmsg.FleetRequest(server_id=-1, action=fmsg.FLEET_QUERY),
                timeout=2.0)
        except grpc.RpcError as exc:
            if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                log.warning("coordinator does not speak UpdateFleet; "
                            "router has no fleet to route to")
            return  # transient: keep the last table
        finally:
            with self._lock:
                self._polling = False
        with self._lock:
            self._entries = list(resp.entries)
            self._epoch = int(resp.epoch)
            self._table_at = time.monotonic()
            self._table_asked = asked
            self._obs_backends.set(sum(
                1 for e in self._entries
                if int(e.state) == fmsg.MEMBER_ACTIVE))

    def _claims_locked(self) -> dict[int, int]:
        """Per backend, the claims the table does not show yet less the
        credits it does not show yet, the credits only up to the slots
        the table shows taken: a credit frees a slot the table holds,
        never cancels a new claim (caller holds _lock).  Claims and
        credits the table shows are dropped."""
        self._claims = [c for c in self._claims
                        if self._table_asked < c[1]]
        claims: dict[int, int] = {}
        credits: dict[int, int] = {}
        for sid, _shown_from, ended in self._claims:
            count = credits if ended else claims
            count[sid] = count.get(sid, 0) + 1
        taken = {int(e.server_id): int(e.slots) - int(e.free_slots)
                 for e in self._entries}
        for sid, n in credits.items():
            claims[sid] = claims.get(sid, 0) - min(n, taken.get(sid, 0))
        return claims

    def _shown_from(self) -> float:
        """When a table asked for from now holds what a backend has now."""
        return time.monotonic() + 1.5 * self._heartbeat_s

    def _admitted(self, claim: list) -> None:
        """The backend admitted the claim's stream (its first chunk)."""
        with self._lock:
            claim[1] = self._shown_from()

    def _release(self, claim: list) -> None:
        """The claim's stream ended: its claim becomes a credit (again in
        the list if the table had shown the stream)."""
        with self._lock:
            claim[1] = self._shown_from()
            claim[2] = True
            if not any(c is claim for c in self._claims):
                self._claims.append(claim)

    def _pick_backend(self, prompt_tokens=None):
        """(The best backend entry, its claim), or (None, None).  The
        claim counts against the backend until the table shows the
        stream or :meth:`_release` takes it.  An empty table is polled
        again for up to 2 s before the stream is rejected: a cold
        router's second admission must not bounce because the first
        one's poll has not landed."""
        hashes = block_hashes(prompt_tokens) if prompt_tokens else None
        self._refresh_table()
        deadline = time.monotonic() + 2.0
        while True:
            with self._lock:
                ranked = score_backends(self._entries, self._claims_locked(),
                                        hashes, self._overlap_weight)
                if ranked:
                    best = ranked[0]
                    claim = [int(best.server_id), float("inf"), False]
                    self._claims.append(claim)
                    if hashes:
                        self._obs_overlap.set(overlap_blocks(
                            hashes, unpack_fp(bytes(best.prefix_fp))))
                    return best, claim
            if time.monotonic() >= deadline:
                return None, None
            time.sleep(0.05)
            self._refresh_table(force=True)

    def _backend_client(self, address: str) -> RpcClient:
        with self._lock:
            client = self._clients.get(address)
            if client is None:
                client = RpcClient(address, fmsg.DECODE_SERVICE,
                                   fmsg.DECODE_METHODS)
                self._clients[address] = client
            return client

    def _reject(self) -> None:
        with self._lock:
            self.streams_rejected += 1
        self._obs_rejected.add()

    # ---------------------------------------------------------------- gRPC
    def SubmitStream(self, request: fmsg.DecodeRequest, context):
        backend, claim = self._pick_backend([int(t) for t in request.tokens])
        if backend is None:
            self._reject()
            yield fmsg.DecodeChunk(error="no decode servers available",
                                   done=True)
            return
        sid = int(backend.server_id)
        with self._lock:
            self.streams_routed += 1
        self._obs_routed.add()
        client = self._backend_client(backend.address)
        try:
            # pinned for the stream's life, swaps under it included
            first = True
            for chunk in client.call("SubmitStream", request,
                                     timeout=None):
                if first:
                    self._admitted(claim)
                    first = False
                yield chunk
                if chunk.done:
                    return
        except grpc.RpcError as exc:
            # the backend died mid-stream: its decode context is gone,
            # so the honest answer is an error, not a silent restart
            self._reject()
            yield fmsg.DecodeChunk(
                error=f"backend {sid} lost mid-stream "
                      f"({_status_code(exc)})", done=True)
        finally:
            self._release(claim)

    def Control(self, request: fmsg.DecodeControlRequest,
                context) -> fmsg.DecodeControlResponse:
        """The router's own status: backends visible, streams routed.
        Management actions go to the servers, not here."""
        if int(request.action) != fmsg.CTRL_STATUS:
            return fmsg.DecodeControlResponse(
                success=False,
                message="router: only STATUS is supported here; address "
                        "Control to a decode server")
        self._refresh_table()
        with self._lock:
            active = [e for e in self._entries
                      if int(e.state) == fmsg.MEMBER_ACTIVE]
            return fmsg.DecodeControlResponse(
                success=True,
                message=f"router: {len(active)} active backends "
                        f"(fleet epoch {self._epoch})",
                server_id=-1,
                slots=sum(int(e.slots) for e in active),
                free_slots=sum(int(e.free_slots) for e in active),
                queue_depth=sum(int(e.queue_depth) for e in active),
                streams_served=self.streams_routed)
