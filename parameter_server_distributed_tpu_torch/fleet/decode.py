"""The fleet face of the port's DecodeServer: the port of
parameter_server_distributed_tpu/fleet/decode.py ``FleetDecodeServer``.

One :class:`FleetDecodeServer` puts one continuous-batching
:class:`~..models.serving.DecodeServer` behind the ``psdt_fleet.Decode``
gRPC service and runs three loops:

- the decode loop, the only thread that touches the DecodeServer: it
  admits queued requests into free slots between rounds, streams each
  decoded token to its request's queue stamped with the weight version
  that decoded it, frees the slots of streams whose client went away,
  and applies weight swaps at round boundaries;
- the membership loop (with a coordinator address): ``UpdateFleet``
  register, then heartbeats with free slots, queue depth, the serving
  version and the radix prefix fingerprint.  The heartbeat's answer is
  the drain signal: a coordinator-side drain is seen on the next beat,
  the server stops admitting, finishes its in-flight streams and
  leaves.  A coordinator that answers UNIMPLEMENTED downgrades the
  server to standalone serving for good;
- the ``Control`` RPC: STATUS, SWAP to a held version, ROLLBACK (swap
  back and pin there: versions newer than the pin are held but never
  served until UNPIN), UNPIN and DRAIN.

Versions come in through :meth:`FleetDecodeServer.publish_version`
into a bounded store that never evicts the rollback pin, or from a live
feed: ``follower=`` takes a delta/subscriber.py ``WeightFollower``,
polled at every round boundary and while idle, each version it delivers
published as if by ``publish_version``.  Every store goes through
``transform`` before it swaps in (cli/serve_main.py binds the move to
the card in the server's dtype, then the int8 quantizer under
``--quant``, so boot weights and every swap quantize alike).  A
standalone server advances to each published version itself; a
fleet-registered one swaps when the controller says so.  Each swap's
transform and swap times land in ``fleet.transform_s`` and
``fleet.swap_s``, and :attr:`FleetDecodeServer.swaps` keeps (version,
wall time) of the last swaps.  Not ported: flight events (ROADMAP.md
Queue 1, item 14) and ``checked_lock`` (item 15).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from collections import OrderedDict
from typing import Callable

import grpc

from ..elastic import messages as emsg
from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc.service import RpcClient, bind_service, make_server
from ..rpc.service import status_code as _status_code
from . import messages as fmsg

log = logging.getLogger("pst.fleet.decode")

# how many swaps FleetDecodeServer.swaps remembers
SWAPS_KEPT = 256

# Serializes the servers' forward passes when several FleetDecodeServers
# share one process (tests, in-process fleets): one server's round runs
# at a time, as the JAX package's dispatch lock orders its programs.
# Uncontended with one server a process, the production shape.
_DISPATCH_LOCK = threading.Lock()


class _Stream:
    """One admitted (or queued) request: its fields and the queue its
    chunks flow out on (None = end of stream).  ``cancelled`` is set by
    the handler when the client is gone: a cancelled stream is never
    admitted, and an in-flight one has its slot freed at the next
    round, so an abandoned request does not decode its budget into a
    queue nobody reads."""

    __slots__ = ("tokens", "max_new", "temperature", "stop", "out",
                 "request_id", "cancelled")

    def __init__(self, tokens, max_new, temperature, stop):
        self.tokens = tokens
        self.max_new = max_new
        self.temperature = temperature
        self.stop = stop
        self.out: "queue.Queue[fmsg.DecodeChunk | None]" = queue.Queue()
        self.request_id = -1
        self.cancelled = False


class _CommandBox:
    """The outcome of one decode-loop command: the Control handler
    waits on ``done`` and reads ``ok`` and ``why``."""

    __slots__ = ("done", "ok", "why")

    def __init__(self):
        self.done = threading.Event()
        self.ok = False
        self.why = ""


def box_ok(box: _CommandBox | None) -> None:
    if box is not None:
        box.ok = True
        box.done.set()


def box_fail(box: _CommandBox | None, why: str) -> None:
    if box is not None:
        box.why = why
        box.done.set()


class FleetDecodeServer:
    """See the module docstring.  ``transform`` maps every published
    store before it swaps in; ``follower`` (an object with ``poll()`` and
    ``stop()``) feeds versions, and is stopped with the server."""

    def __init__(self, server, *, server_id: int = 0, port: int = 0,
                 bind_address: str = "127.0.0.1",
                 coordinator: str | None = None,
                 follower=None, auto_advance: bool | None = None,
                 transform: Callable[[dict], dict] | None = None,
                 versions_kept: int = 4, heartbeat_s: float = 0.5):
        self.server = server
        self._follower = follower
        self.server_id = int(server_id)
        self._bind = f"{bind_address}:{int(port)}"
        self._coordinator = coordinator
        self._transform = transform
        # standalone servers advance to each published version;
        # fleet-registered ones hold versions for the controller
        self.auto_advance = (coordinator is None if auto_advance is None
                             else bool(auto_advance))
        self._versions_kept = max(1, int(versions_kept))
        self._heartbeat_s = float(heartbeat_s)
        # guards the version store and the pin, shared by the gRPC
        # handler threads and the decode loop
        self._lock = threading.Lock()
        self._versions: "OrderedDict[int, dict]" = OrderedDict()
        self._pinned = -1
        self._admit: "queue.Queue[_Stream]" = queue.Queue()
        self._live: dict[int, _Stream] = {}     # request_id -> stream
        self._commands: "queue.Queue[tuple]" = queue.Queue()
        self._wake = threading.Event()
        self._draining = False
        self._stopped = threading.Event()
        self._left = threading.Event()   # deregistered (drain complete)
        self._registered = False
        self.streams_served = 0
        self._obs_streams = obs_stats.counter("fleet.streams")
        self._obs_errors = obs_stats.counter("fleet.stream_errors")
        self._obs_swaps = obs_stats.counter("fleet.swaps")
        self._obs_queue = obs_stats.gauge("fleet.queue_depth")
        self._obs_transform = obs_stats.histogram("fleet.transform_s")
        self._obs_swap_s = obs_stats.histogram("fleet.swap_s")
        self.swaps: "collections.deque[tuple[int, float]]" = \
            collections.deque(maxlen=SWAPS_KEPT)
        self._grpc: grpc.Server | None = None
        self.port = 0
        self.address = ""
        self._decode_thread = threading.Thread(
            target=self._decode_loop, daemon=True,
            name=f"fleet-decode-{server_id}")
        self._member_thread: threading.Thread | None = None
        self._client: RpcClient | None = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> int:
        """Bind the gRPC service, start the decode loop and, with a
        coordinator, register and heartbeat.  Returns the bound port."""
        self._grpc = make_server()
        bind_service(self._grpc, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS,
                     self)
        self.port = self._grpc.add_insecure_port(self._bind)
        if self.port == 0:
            raise RuntimeError(f"could not bind {self._bind}")
        self._grpc.start()
        self.address = f"{self._bind.rsplit(':', 1)[0]}:{self.port}"
        self._decode_thread.start()
        if self._coordinator:
            self._client = RpcClient(self._coordinator,
                                     m.COORDINATOR_SERVICE,
                                     fmsg.FLEET_COORD_METHODS)
            self._member_thread = threading.Thread(
                target=self._membership_loop, daemon=True,
                name=f"fleet-member-{self.server_id}")
            self._member_thread.start()
        return self.port

    def stop(self, grace: float = 1.0) -> None:
        self._stopped.set()
        self._wake.set()
        if self._grpc is not None:
            self._grpc.stop(grace).wait()
        self._decode_thread.join(timeout=5.0)
        if self._follower is not None:
            self._follower.stop()
        if self._member_thread is not None:
            self._member_thread.join(timeout=5.0)
        if self._client is not None:
            self._client.close()
            self._client = None

    def drain(self) -> None:
        """Stop admitting new streams; the in-flight ones finish, then
        the server leaves the fleet (:meth:`wait_drained` returns).  The
        SIGTERM and Control(DRAIN) path."""
        self._draining = True
        self._wake.set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until a drain completed: in-flight streams finished and
        the server left the fleet."""
        return self._left.wait(timeout)

    @property
    def draining(self) -> bool:
        return self._draining

    # ------------------------------------------------------------- helpers
    def queue_depth(self) -> int:
        return self._admit.qsize()

    def free_slots(self) -> int:
        """Slots not claimed by an in-flight or a queued request (a
        queued admission takes its slot at the next round boundary)."""
        return max(0, self.server.slots - self.server.active
                   - self._admit.qsize())

    def weight_version(self) -> int:
        return int(self.server.params_version)

    def prefix_fingerprint(self) -> bytes:
        return self.server.prefix_fingerprint()

    def publish_version(self, store: dict, version: int) -> None:
        """Hold a weight version in the bounded store (the oldest goes
        first, never the rollback pin); an auto-advancing server also
        queues the swap, unless the version is newer than the pin."""
        with self._lock:
            self._versions[int(version)] = store
            while len(self._versions) > self._versions_kept:
                # evicting the pin would strand a later rollback retry
                # at "version not held"
                for held in self._versions:
                    if held != self._pinned:
                        del self._versions[held]
                        break
                else:
                    break
            advance = (self.auto_advance and
                       (self._pinned < 0 or version <= self._pinned))
        if advance:
            self._commands.put(("swap", int(version), None))
            self._wake.set()

    # --------------------------------------------------------- gRPC: submit
    def SubmitStream(self, request: fmsg.DecodeRequest, context):
        """Queue one stream for the decode loop, then relay its chunks.
        A rejection (draining, bad request) is an error chunk, never a
        transport failure: the router relays it as it is."""
        if self._draining or self._stopped.is_set():
            self._obs_errors.add()
            yield fmsg.DecodeChunk(error="server draining", done=True)
            return
        tokens = [int(t) for t in request.tokens]
        if not tokens:
            self._obs_errors.add()
            yield fmsg.DecodeChunk(error="empty prompt", done=True)
            return
        stream = _Stream(
            tokens, int(request.max_new) or 64,
            None if request.temperature < 0 else float(request.temperature),
            [int(t) for t in request.stop])
        self._admit.put(stream)
        self._obs_queue.set(self._admit.qsize())
        self._wake.set()
        try:
            while True:
                try:
                    chunk = stream.out.get(timeout=30.0)
                except queue.Empty:
                    # a wedged decode loop must not hold the client
                    self._obs_errors.add()
                    yield fmsg.DecodeChunk(error="decode stalled",
                                           done=True)
                    return
                if chunk is None:
                    return
                yield chunk
        finally:
            # the handler ends before the stream did (client gone, the
            # stall above): the decode loop drops the stream
            stream.cancelled = True
            self._wake.set()

    # -------------------------------------------------------- gRPC: control
    def Control(self, request: fmsg.DecodeControlRequest,
                context) -> fmsg.DecodeControlResponse:
        action = int(request.action)
        ok, message = True, "ok"
        if action in (fmsg.CTRL_SWAP, fmsg.CTRL_ROLLBACK):
            version = int(request.version)
            with self._lock:
                if version == -1 and self._versions:
                    version = next(reversed(self._versions))
                held = version in self._versions
                newer_than_pin = (self._pinned >= 0
                                  and version > self._pinned)
                if held and action == fmsg.CTRL_ROLLBACK:
                    # pin under the lock hold that found the version, so
                    # no auto-advance interleaves
                    self._pinned = version
                    newer_than_pin = False
            if not held:
                ok, message = False, f"version {version} not held"
            elif newer_than_pin:
                ok = False
                message = (f"version {version} newer than rollback pin "
                           f"{self._pinned} (Control UNPIN first)")
            else:
                ok, why = self._run_command(("swap", version))
                message = (f"serving version {version}" if ok
                           else f"swap to {version} failed: {why}")
        elif action == fmsg.CTRL_UNPIN:
            with self._lock:
                self._pinned = -1
            message = "unpinned"
        elif action == fmsg.CTRL_DRAIN:
            self.drain()
            message = "draining"
        elif action != fmsg.CTRL_STATUS:
            ok, message = False, f"unknown control action {action}"
        with self._lock:
            held = list(self._versions)
            pinned = self._pinned
        state = (emsg.MEMBER_DRAINING if self._draining
                 else emsg.MEMBER_ACTIVE)
        return fmsg.DecodeControlResponse(
            success=ok, message=message, server_id=self.server_id,
            state=state, slots=self.server.slots,
            free_slots=self.free_slots(), queue_depth=self.queue_depth(),
            weight_version=self.weight_version(), pinned_version=pinned,
            versions_held=held, streams_served=self.streams_served,
            prefill_tokens=int(self.server._prefill_tokens),
            prompt_tokens=int(self.server._prompt_tokens))

    def _run_command(self, command: tuple,
                     timeout: float = 30.0) -> tuple[bool, str]:
        """Queue a command for the decode loop (a swap lands at a round
        boundary), wait for it, and return its outcome: a Control that
        reported success for a swap that raised would break the
        rollback guarantee."""
        box = _CommandBox()
        self._commands.put((command[0], command[1], box))
        self._wake.set()
        if not box.done.wait(timeout):
            return False, "decode loop busy"
        return box.ok, box.why

    # ----------------------------------------------------------- decode loop
    def _apply_commands(self) -> None:
        """The round-boundary command point: swaps requested by Control
        or auto-advance apply here, with no round in flight."""
        while True:
            try:
                kind, version, box = self._commands.get_nowait()
            except queue.Empty:
                return
            if kind != "swap":
                box_fail(box, f"unknown command {kind!r}")
                continue
            with self._lock:
                store = self._versions.get(version)
            if store is None:
                # evicted between Control's check and here
                box_fail(box, f"version {version} no longer held")
            elif version == self.weight_version():
                box_ok(box)  # already serving it
            else:
                try:
                    t0 = time.perf_counter()
                    fresh = (self._transform(store) if self._transform
                             else store)
                    t1 = time.perf_counter()
                    with _DISPATCH_LOCK:
                        self.server.swap_params(fresh, version=version)
                    self._obs_transform.observe(t1 - t0)
                    self._obs_swap_s.observe(time.perf_counter() - t1)
                    self.swaps.append((version, time.time()))
                    self._obs_swaps.add()
                    box_ok(box)
                except Exception as exc:  # noqa: BLE001 — serving
                    # boundary: a bad publication keeps the last-good
                    # weights and never stops decoding
                    log.warning("swap to version %d failed (%s); "
                                "keeping last-good", version, exc)
                    box_fail(box, str(exc))

    def _poll_feed(self) -> None:
        """Publish the follower's newest version, if one landed."""
        if self._follower is None:
            return
        fresh = self._follower.poll()
        if fresh is not None:
            self.publish_version(*fresh)

    def _admit_between_rounds(self) -> None:
        """Admit queued streams into free slots between rounds; a
        submit() rejection becomes that stream's error chunk."""
        while self.server.has_free_slot:
            try:
                stream = self._admit.get_nowait()
            except queue.Empty:
                break
            if stream.cancelled:
                continue  # the client is already gone
            try:
                with _DISPATCH_LOCK:
                    rid = self.server.submit(
                        stream.tokens, stream.max_new,
                        temperature=stream.temperature, stop=stream.stop)
            except Exception as exc:  # noqa: BLE001 — per-request error
                # boundary: a malformed request never stops the
                # in-flight streams
                self._obs_errors.add()
                stream.out.put(fmsg.DecodeChunk(error=str(exc), done=True))
                stream.out.put(None)
                continue
            stream.request_id = rid
            version = self.weight_version()
            if rid in self.server.finished():
                # max_new=1 or an instant stop: done inside submit()
                for token in self.server.result(rid):
                    stream.out.put(fmsg.DecodeChunk(
                        request_id=rid, token=int(token),
                        weight_version=version))
                # counted before the done chunk: a client that reads the
                # count on seeing its stream end finds it counted
                self.streams_served += 1
                self._obs_streams.add()
                stream.out.put(fmsg.DecodeChunk(request_id=rid, done=True,
                                                weight_version=version))
                stream.out.put(None)
                continue
            # the prefill produced the first token
            stream.out.put(fmsg.DecodeChunk(
                request_id=rid, token=int(self.server.peek(rid)[0]),
                weight_version=version))
            self._live[rid] = stream
        self._obs_queue.set(self._admit.qsize())

    def _reap_cancelled(self) -> None:
        """Free the slots of in-flight streams whose client vanished."""
        for rid, stream in list(self._live.items()):
            if stream.cancelled:
                del self._live[rid]
                self.server.cancel(rid)

    def _decode_loop(self) -> None:
        while not self._stopped.is_set():
            self._poll_feed()
            self._apply_commands()
            self._reap_cancelled()
            self._admit_between_rounds()
            if self.server.idle:
                if self._draining and self._admit.qsize() == 0:
                    self._finish_drain()
                    return
                self._wake.wait(timeout=self._heartbeat_s)
                self._wake.clear()
                continue
            with _DISPATCH_LOCK:
                emitted = self.server.step()
            version = self.weight_version()
            for rid, token in emitted:
                stream = self._live.get(rid)
                if stream is not None:
                    stream.out.put(fmsg.DecodeChunk(
                        request_id=rid, token=int(token),
                        weight_version=version))
            for rid in set(self.server.finished()) & set(self._live):
                stream = self._live.pop(rid)
                self.server.result(rid)  # tokens already streamed
                self.streams_served += 1
                self._obs_streams.add()
                stream.out.put(fmsg.DecodeChunk(request_id=rid, done=True,
                                                weight_version=version))
                stream.out.put(None)

    def _finish_drain(self) -> None:
        """Every in-flight stream finished: leave the fleet (the table
        narrows now) and release :meth:`wait_drained`."""
        if self._client is not None and self._registered:
            try:
                self._client.call("UpdateFleet", fmsg.FleetRequest(
                    server_id=self.server_id, action=fmsg.FLEET_LEAVE),
                    timeout=5.0)
            except grpc.RpcError:
                pass  # the coordinator is gone: nothing left to tell
            self._registered = False
        log.info("decode server %d drained (%d streams served)",
                 self.server_id, self.streams_served)
        self._left.set()

    # ------------------------------------------------------ membership loop
    def _register(self) -> None:
        self._client.call("UpdateFleet", fmsg.FleetRequest(
            server_id=self.server_id, action=fmsg.FLEET_REGISTER,
            address=self.address, slots=self.server.slots), timeout=5.0)
        self._registered = True

    def _membership_loop(self) -> None:
        try:
            self._register()
        except grpc.RpcError as exc:
            if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                log.info("coordinator does not speak UpdateFleet; "
                         "serving standalone")
                self.auto_advance = True  # no controller will swap us
                return
        while not self._stopped.is_set() and not self._left.is_set():
            try:
                resp = self._client.call("UpdateFleet", fmsg.FleetRequest(
                    server_id=self.server_id, action=fmsg.FLEET_HEARTBEAT,
                    free_slots=self.free_slots(),
                    queue_depth=self.queue_depth(),
                    weight_version=self.weight_version(),
                    active_streams=len(self._live),
                    # an immutable snapshot the decode thread swaps in
                    prefix_fp=self.prefix_fingerprint()), timeout=5.0)
                if not resp.success:
                    # reaped after a stall: the row is the router's only
                    # view of this server, so register again; unless it
                    # is draining, when the answer is its own leave,
                    # landed while this beat was in flight
                    if not (self._draining or self._left.is_set()):
                        self._register()
                elif (int(resp.self_state) == emsg.MEMBER_DRAINING
                        and not self._draining):
                    log.warning("decode server %d: coordinator drain",
                                self.server_id)
                    self.drain()
            except grpc.RpcError:
                pass  # transient: keep serving, the next beat retries
            if self._stopped.wait(self._heartbeat_s):
                return
