"""Shared-memory same-host transport for the fused data plane: the port's
copy of parameter_server_distributed_tpu/rpc/shm_transport.py.

When a worker and its PS share a machine, the fused ``PushPullStream``
round would still cross the loopback TCP stack (HTTP/2 framing, a copy
into the kernel and one out).  This module carries that round over two
single-producer/single-consumer byte rings in ``multiprocessing.
shared_memory`` segments instead: the same wire bytes (encoded
``GradientUpdate`` request frames one way, ``PushPullResponse`` frames
the other), so the codec, the messages and every aggregation semantic
are unchanged; only the transport under them differs.  The protocol is
the JAX package's byte for byte, so a port worker rides the rings of a
JAX PS and a JAX worker those of a port PS.

Negotiation (``NegotiateShm``) is an extension RPC of the PS service.
Its messages live here, not in rpc/messages.py, whose method set is the
reference's: a reference PS answers UNIMPLEMENTED, and the client
downgrades to gRPC for good on that connection (rpc/data_plane.py).  The
handshake succeeds only when both ends report the same ``host_id``
(hostname and kernel boot id) and the server can create the segments;
two containers that share a boot id but not /dev/shm fail at attach and
downgrade the same way.

Ring protocol: each direction is a byte ring with two u64 cursors in its
segment's header (native byte order, read and written whole),
``tail`` (bytes ever written, the producer's) and
``head`` (bytes ever read, the consumer's), and a u32 ``closed`` latch
either side may set.  A frame is a u32 length and its payload, wrapped
modulo the capacity; a frame larger than the ring streams through it,
published in 1 MB blocks so the consumer's copy-out overlaps the
producer's copy-in.  The length 0xFFFFFFFF ends a request or response
(an empty frame is data: a default ``GradientUpdate`` encodes to no
bytes).  The doorbell is a 1-byte nudge on the connection's AF_UNIX
socket (abstract namespace): a mover rings it after each cursor store,
and a waiter parks in ``select`` on it, a real kernel wakeup.  Each
cursor has one writer and its stores are aligned 8-byte stores; the
socket carries wakeups only, and every wait rechecks the cursors, so a
lost ring costs latency, never correctness.  Bulk copies go through the
native library's ``psdt_copy`` outside the GIL when it is built, else
through memoryview assignment.

Environment: ``PSDT_SHM`` (default on; 0 disables both ends) and
``PSDT_SHM_RING_BYTES`` (each direction's capacity, default 32 MB).
Counters: ``rpc.shm.bytes`` (frame bytes this process moved through
rings) and ``rpc.shm.fallback`` (downgrades to gRPC: a refusal,
UNIMPLEMENTED, an attach failure or a transport error mid-round).

Port-only: a segment is created only when /dev/shm has room for it (a
tmpfs filled by the page pretouch raises SIGBUS, not an error), else the
negotiation is refused.  Not ported: the JAX package's flight events and
trace spans (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

import ctypes
import logging
import os
import select
import socket
import struct
import tempfile
import threading
import time
import uuid
from typing import Callable, Iterator

import numpy as np

from .. import native
from ..obs import stats as obs_stats
from .wire import Field, Message

log = logging.getLogger("pst.shm")

ENV_FLAG = "PSDT_SHM"
ENV_RING_BYTES = "PSDT_SHM_RING_BYTES"
# a frame larger than the ring streams through it, so the ring only
# decouples the two sides; every page is touched at negotiation
DEFAULT_RING_BYTES = 32 << 20
# how long a server connection parks for a worker's next round (its
# compute in between); closing the connection ends the park at once
IDLE_PARK_S = 24 * 3600.0
# a request or response that outlasts this fails the round
ROUND_TIMEOUT_S = 3600.0

# segment header (one 64-byte cache line):
#   0  u64 tail   bytes ever written (the producer's cursor)
#   8  u64 head   bytes ever read (the consumer's cursor)
#   16 u32 closed either side latches 1 to tear the connection down
_HEADER = 64
_OFF_TAIL = 0
_OFF_HEAD = 8
_OFF_CLOSED = 16


def enabled() -> bool:
    return os.environ.get(ENV_FLAG, "1") not in ("0", "false", "off")


def ring_bytes() -> int:
    return int(os.environ.get(ENV_RING_BYTES, str(DEFAULT_RING_BYTES)))


def host_id() -> str:
    """Same-host identity: hostname and kernel boot id."""
    try:
        with open("/proc/sys/kernel/random/boot_id",
                  encoding="ascii") as fh:
            boot = fh.read().strip()
    except OSError:
        boot = "no-boot-id"
    return f"{socket.gethostname()}/{boot}"


class ShmTransportError(RuntimeError):
    """Any shared-memory transport failure; the client downgrades the
    connection to gRPC for good (rpc/data_plane.py ``PSClient``)."""


class ShmNegotiateRequest(Message):
    FIELDS = (
        Field(1, "host_id", "string"),
        Field(2, "worker_id", "int32"),
        Field(3, "ring_bytes", "int64"),
    )


class ShmNegotiateResponse(Message):
    """``accepted`` False carries the reason in ``message``.
    ``doorbell`` is the AF_UNIX address of the connection's doorbell
    ("@name" in the abstract namespace)."""
    FIELDS = (
        Field(1, "accepted", "bool"),
        Field(2, "message", "string"),
        Field(3, "c2s_name", "string"),
        Field(4, "s2c_name", "string"),
        Field(5, "ring_bytes", "int64"),
        Field(6, "host_id", "string"),
        Field(7, "doorbell", "string"),
    )


# the extension method, bound beside the reference's and the stream
# methods on the PS service (server/ps_service.py)
SHM_METHODS = {
    "NegotiateShm": (ShmNegotiateRequest, ShmNegotiateResponse),
}

# serializes segment creation with the attach side's suppression of the
# resource tracker, so a concurrent attach never swallows a create's
# registration
_attach_lock = threading.Lock()


class _Doorbell:
    """1-byte wakeups over a connection's AF_UNIX socket.  The cursors are
    the state, so a send is fire-and-forget (a full socket buffer means
    wakeups are pending) and a waiter treats a byte or a timeout alike:
    recheck the cursors."""

    __slots__ = ("_sock",)

    def __init__(self, sock: socket.socket):
        sock.setblocking(False)
        self._sock = sock

    def ring(self) -> None:
        try:
            self._sock.send(b"\x01")
        except OSError:   # buffer full, or torn down
            pass

    def wait(self, timeout: float) -> None:
        try:
            readable, _, _ = select.select([self._sock], [], [], timeout)
            if readable and not self._sock.recv(4096):
                raise ShmTransportError("doorbell socket closed by peer")
        except BlockingIOError:   # drained by a concurrent recheck
            pass
        except (OSError, ValueError) as exc:
            raise ShmTransportError(f"doorbell socket failed: {exc}") \
                from exc

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _doorbell_listener() -> tuple[socket.socket, str]:
    """A listening doorbell socket and its address: "@name" in Linux's
    abstract namespace, a file path elsewhere."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    name = f"psdt-db-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    try:
        sock.bind("\0" + name)
        addr = "@" + name
    except OSError:
        addr = os.path.join(tempfile.gettempdir(), name)
        sock.bind(addr)
    sock.listen(1)
    return sock, addr


def _doorbell_connect(addr: str, timeout: float = 10.0) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect("\0" + addr[1:] if addr.startswith("@") else addr)
    return sock


class ShmRing:
    """One direction of a connection: an SPSC byte ring over a
    shared-memory segment.  One producer calls the ``write*`` methods and
    one consumer the ``read*`` methods; the cursors hand off without any
    lock.  Without a ``doorbell`` (unit tests) waits poll."""

    # copies are published in blocks of this size, so the consumer drains
    # block i while the producer fills block i+1
    _BLOCK = 1 << 20
    # the length slot's end-of-stream marker (0 is a legal length)
    _END = 0xFFFFFFFF

    def __init__(self, shm, capacity: int,
                 doorbell: _Doorbell | None = None):
        self._shm = shm
        self.capacity = capacity
        self._buf = shm.buf
        self.doorbell = doorbell
        # the native GIL-free copy over the mapping's raw address when the
        # library is built; teardown drops it (invalidate) before unmapping
        self._copy = native.copy_fn()
        self._base = 0
        if self._copy is not None:
            carr = (ctypes.c_ubyte * len(shm.buf)).from_buffer(shm.buf)
            self._base = ctypes.addressof(carr)
            del carr   # the export is released; the address outlives it
        # tail and head, each read and written as one aligned 8-byte
        # access (ctypes copies a c_uint64 with one load or store; struct
        # moves a "<Q" a byte at a time, and a peer reading it mid-store
        # saw a cursor tens of MB off).  Native byte order: little-endian
        # on every host this runs on, the JAX package's "<Q" bytes.
        self._cursors = (ctypes.c_uint64 * 2).from_buffer(shm.buf)

    def _cursor_array(self):
        cursors = self._cursors
        if cursors is None:
            raise ShmTransportError("shm segment released")
        return cursors

    def _tail(self) -> int:
        return self._cursor_array()[_OFF_TAIL // 8]

    def _head(self) -> int:
        return self._cursor_array()[_OFF_HEAD // 8]

    def _set_tail(self, v: int) -> None:
        self._cursor_array()[_OFF_TAIL // 8] = v

    def _set_head(self, v: int) -> None:
        self._cursor_array()[_OFF_HEAD // 8] = v

    def _used(self, tail: int, head: int) -> int:
        """Bytes written and not yet read; a peer that broke the protocol
        (cursors that cross, or a gap past the capacity) is an error here,
        never a copy of a negative or oversized length."""
        used = tail - head
        if not 0 <= used <= self.capacity:
            raise ShmTransportError(f"shm ring cursors out of range: tail "
                                    f"{tail}, head {head}")
        return used

    @property
    def closed(self) -> bool:
        try:
            return struct.unpack_from("<I", self._buf, _OFF_CLOSED)[0] != 0
        except (ValueError, TypeError):   # the memoryview was released
            return True

    def close(self) -> None:
        try:
            struct.pack_into("<I", self._buf, _OFF_CLOSED, 1)
        except (ValueError, TypeError):   # already unmapped
            pass

    def invalidate(self) -> None:
        """Drop the raw-address copy and the cursors' view before the
        segment unmaps: a copy racing the unmap then takes the memoryview
        path, whose released buffer raises a clean error instead of
        faulting, and the mapping has no export left to refuse its
        close."""
        self._base = 0
        self._copy = None
        self._cursors = None

    def _wait(self, ready: Callable[[], int], deadline: float,
              what: str) -> int:
        """Park until ``ready()`` (a byte count, never negative) is
        non-zero; raises when the ring is closed or ``deadline``
        (``time.monotonic``) passes."""
        while True:
            n = ready()
            if n:
                return n
            if self.closed:
                raise ShmTransportError(f"shm ring closed while {what}")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ShmTransportError(f"shm ring timeout while {what}")
            if self.doorbell is not None:
                # capped, so a closed latch set without a ring is seen
                self.doorbell.wait(min(remaining, 0.05))
            else:
                time.sleep(min(remaining, 200e-6))

    def _copy_in(self, pos: int, view, src, src_off: int, n: int) -> None:
        # the fast path is read per block: invalidate() may drop it
        base, copy = self._base, self._copy
        if src is not None and copy is not None and base:
            copy(base + _HEADER + pos, src.ctypes.data + src_off, n)
        else:
            self._buf[_HEADER + pos:_HEADER + pos + n] = \
                view[src_off:src_off + n]

    def _write_bytes(self, data, deadline: float) -> None:
        view = memoryview(data).cast("B")
        total = view.nbytes
        # ``src`` keeps the source buffer alive for every raw copy of it
        src = np.frombuffer(view, np.uint8) \
            if self._copy is not None and total else None
        cap = self.capacity
        tail = self._tail()
        sent = 0
        while sent < total:
            free = self._wait(
                lambda: cap - self._used(tail, self._head()), deadline,
                "writing")
            n = min(free, total - sent, self._BLOCK)
            pos = tail % cap
            first = min(n, cap - pos)
            self._copy_in(pos, view, src, sent, first)
            if n > first:
                self._copy_in(0, view, src, sent + first, n - first)
            tail += n
            self._set_tail(tail)
            if self.doorbell is not None:
                self.doorbell.ring()
            sent += n

    def write_frame(self, payload, deadline: float) -> None:
        """One length-prefixed frame; ``payload`` is any C-contiguous
        buffer (bytes, an ndarray such as a view of a pinned host
        tensor), empty included."""
        nbytes = memoryview(payload).nbytes
        if nbytes >= self._END:
            raise ShmTransportError(f"frame of {nbytes} bytes exceeds "
                                    f"the u32 length")
        try:
            self._write_bytes(struct.pack("<I", nbytes), deadline)
            if nbytes:
                self._write_bytes(payload, deadline)
        except ValueError as exc:   # the memoryview was released
            raise ShmTransportError(f"shm segment released: {exc}") from exc
        obs_stats.counter("rpc.shm.bytes").add(4 + nbytes)

    def write_end(self, deadline: float) -> None:
        """The end marker of one request or response."""
        try:
            self._write_bytes(struct.pack("<I", self._END), deadline)
        except ValueError as exc:
            raise ShmTransportError(f"shm segment released: {exc}") from exc
        obs_stats.counter("rpc.shm.bytes").add(4)

    def _copy_out(self, out: bytearray, dst, dst_off: int, pos: int,
                  n: int) -> None:
        base, copy = self._base, self._copy   # see _copy_in
        if dst is not None and copy is not None and base:
            copy(dst.ctypes.data + dst_off, base + _HEADER + pos, n)
        else:
            out[dst_off:dst_off + n] = self._buf[_HEADER + pos:
                                                 _HEADER + pos + n]

    def _read_bytes(self, n: int, deadline: float) -> bytearray:
        out = bytearray(n)
        dst = np.frombuffer(out, np.uint8) \
            if self._copy is not None and n else None
        done = 0
        cap = self.capacity
        head = self._head()
        while done < n:
            avail = self._wait(lambda: self._used(self._tail(), head),
                               deadline, "reading")
            take = min(avail, n - done, self._BLOCK)
            pos = head % cap
            first = min(take, cap - pos)
            self._copy_out(out, dst, done, pos, first)
            if take > first:
                self._copy_out(out, dst, done + first, 0, take - first)
            head += take
            self._set_head(head)
            if self.doorbell is not None:
                self.doorbell.ring()
            done += take
        return out

    def read_frame(self, deadline: float) -> bytes | None:
        """The next frame's payload, or None at an end marker."""
        try:
            (length,) = struct.unpack("<I", self._read_bytes(4, deadline))
            if length == self._END:
                obs_stats.counter("rpc.shm.bytes").add(4)
                return None
            payload = bytes(self._read_bytes(length, deadline)) if length \
                else b""
        except ValueError as exc:   # the memoryview was released
            raise ShmTransportError(f"shm segment released: {exc}") from exc
        obs_stats.counter("rpc.shm.bytes").add(4 + length)
        return payload


def _pretouch(shm) -> None:
    """Fault every page of the mapping in now (one read-modify-write per
    4 KB page): first-touch faults would otherwise slow the first rounds."""
    view = np.frombuffer(shm.buf, np.uint8)
    view[_HEADER::4096] |= 0


def _create_segment(name: str, size: int):
    from multiprocessing import shared_memory

    try:
        st = os.statvfs("/dev/shm")
        free = st.f_bavail * st.f_frsize
    except OSError:
        free = None
    if free is not None and free < size:
        # the pretouch would fill the tmpfs and die of SIGBUS
        raise OSError(f"/dev/shm has {free} bytes free, a ring needs {size}")
    with _attach_lock:
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
    shm.buf[:_HEADER] = bytes(_HEADER)
    _pretouch(shm)
    return shm


def _attach_segment(name: str):
    """Attach to a server's segment without registering it with this
    process's resource tracker: the server owns it and unlinks it, and a
    registration here would unlink it again when this process exits.
    Python 3.13 has ``track=False``; before it, ``register`` is
    suppressed around the attach."""
    from multiprocessing import resource_tracker, shared_memory

    try:
        shm = shared_memory.SharedMemory(name=name, create=False,
                                         track=False)
    except TypeError:   # Python < 3.13: no track keyword
        with _attach_lock:
            orig = resource_tracker.register
            resource_tracker.register = lambda *a, **kw: None
            try:
                shm = shared_memory.SharedMemory(name=name, create=False)
            finally:
                resource_tracker.register = orig
    _pretouch(shm)
    return shm


class ShmClientConnection:
    """The worker's end of one negotiated connection: request frames into
    the c2s ring, response frames out of the s2c ring.  ``_lock``
    serializes whole rounds (the rings are SPSC)."""

    def __init__(self, c2s_name: str, s2c_name: str, capacity: int,
                 doorbell_addr: str = ""):
        self._c2s_shm = _attach_segment(c2s_name)
        self._s2c_shm = None
        self._doorbell = None
        try:
            self._s2c_shm = _attach_segment(s2c_name)
            self._doorbell = (_Doorbell(_doorbell_connect(doorbell_addr))
                              if doorbell_addr else None)
        except BaseException:
            self._unmap()
            raise
        self.c2s = ShmRing(self._c2s_shm, capacity, self._doorbell)
        self.s2c = ShmRing(self._s2c_shm, capacity, self._doorbell)
        self._lock = threading.Lock()

    def round_trip(self, frames: Iterator, timeout: float | None
                   ) -> Iterator[bytes]:
        """One exchange: stream the request frames out, then collect the
        response frames up to the server's end marker.  The response is
        drained under the lock before anything is returned, so a caller
        that stops reading never holds the connection."""
        deadline = time.monotonic() + (timeout or ROUND_TIMEOUT_S)
        with self._lock:
            try:
                for frame in frames:
                    self.c2s.write_frame(frame, deadline)
                self.c2s.write_end(deadline)
                out: list[bytes] = []
                while True:
                    frame = self.s2c.read_frame(deadline)
                    if frame is None:
                        break
                    out.append(frame)
            except ShmTransportError:
                raise
            except BaseException:
                # the frame source raised mid-round: the server is parked
                # mid-request and would fold the next round into this
                # one.  Latch the rings closed so its thread exits and the
                # next round here downgrades to gRPC.
                self.c2s.close()
                self.s2c.close()
                raise
        return iter(out)

    def _unmap(self) -> None:
        if self._doorbell is not None:
            self._doorbell.close()
        for shm in (self._c2s_shm, self._s2c_shm):
            if shm is not None:
                try:
                    shm.close()
                except OSError:
                    pass

    def close(self) -> None:
        # under the round lock: a round in flight ends (or times out)
        # before the segments unmap under its raw-address copies
        with self._lock:
            self.c2s.close()
            self.s2c.close()
            self.c2s.invalidate()
            self.s2c.invalidate()
            self._unmap()


class _ServerConnection:
    """The PS's end of one connection: a thread drains each request's
    frames into the fused handler and streams its response frames back.
    It parks on the barrier as a gRPC handler thread does."""

    def __init__(self, index: int, handler: Callable, capacity: int,
                 on_exit: Callable[["_ServerConnection"], None]
                 | None = None):
        token = uuid.uuid4().hex[:8]
        self.index = index
        self._on_exit = on_exit
        # every unmap goes through release_segments(), which latches: the
        # serve thread's exit reap and the shutdown path can both reach
        # it, and a second unmap under a native copy would fault
        self._release_lock = threading.Lock()
        self._released = False
        self.c2s_name = f"psdt-{os.getpid()}-{index}-{token}-c2s"
        self.s2c_name = f"psdt-{os.getpid()}-{index}-{token}-s2c"
        self._listener, self.doorbell_addr = _doorbell_listener()
        self._c2s_shm = self._s2c_shm = None
        try:
            self._c2s_shm = _create_segment(self.c2s_name,
                                            _HEADER + capacity)
            self._s2c_shm = _create_segment(self.s2c_name,
                                            _HEADER + capacity)
        except BaseException:
            self._listener.close()
            for shm in (self._c2s_shm, self._s2c_shm):
                if shm is not None:
                    shm.close()
                    shm.unlink()
            raise
        self.c2s = ShmRing(self._c2s_shm, capacity)
        self.s2c = ShmRing(self._s2c_shm, capacity)
        self._doorbell: _Doorbell | None = None
        self._handler = handler
        self._thread = threading.Thread(
            target=self._serve_loop, daemon=True, name=f"shm-conn-{index}")
        self._thread.start()

    def _request_frames(self) -> Iterator[bytes]:
        """The frames of one request, up to the client's end marker."""
        while True:
            frame = self.c2s.read_frame(time.monotonic() + ROUND_TIMEOUT_S)
            if frame is None:
                return
            yield frame

    def _serve_loop(self) -> None:
        try:
            self._listener.settimeout(60.0)
            sock, _ = self._listener.accept()
        except OSError:
            # the client never connected its doorbell (it died in the
            # handshake, or teardown closed the listener)
            self.close()
            if self._on_exit is not None:
                self._on_exit(self)
            return
        finally:
            try:
                self._listener.close()
            except OSError:
                pass
        self._doorbell = _Doorbell(sock)
        self.c2s.doorbell = self._doorbell
        self.s2c.doorbell = self._doorbell
        try:
            self._serve_rounds()
        finally:
            if self._on_exit is not None:
                # the client is gone: release the segments now, not at
                # PS shutdown
                self._on_exit(self)

    def _serve_rounds(self) -> None:
        from . import messages as m

        while True:
            try:
                # park for the next round's first frame, then decode the
                # chunks as they arrive, so the fold overlaps the writes
                first = self.c2s.read_frame(time.monotonic() + IDLE_PARK_S)
            except ShmTransportError as exc:
                log.info("shm connection %d ends: %s", self.index, exc)
                return   # closed or torn down
            try:
                if first is None:
                    continue   # a stray end marker
                drained = [False]

                def chunks() -> Iterator:
                    yield m.GradientUpdate.decode(first)
                    for frame in self._request_frames():
                        yield m.GradientUpdate.decode(frame)
                    drained[0] = True

                deadline = time.monotonic() + ROUND_TIMEOUT_S
                for resp in self._handler(chunks(), None):
                    self.s2c.write_frame(resp.encode(), deadline)
                if not drained[0]:
                    # the handler returned without reading every chunk
                    # (the empty-store refusal): consume the rest, so the
                    # next round starts at its first frame
                    for _ in self._request_frames():
                        pass
                self.s2c.write_end(deadline)
            except ShmTransportError as exc:
                log.warning("shm connection %d failed mid-round: %s",
                            self.index, exc)
                return
            except Exception:  # noqa: BLE001 — logged; this connection ends
                log.exception("shm connection handler failed; closing")
                self.close()
                return

    def close(self) -> None:
        self.c2s.close()
        self.s2c.close()
        try:
            # wakes an accept() still waiting for the client's doorbell,
            # which closing alone does not
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:   # not listening any more
            pass
        for sock in (self._doorbell, self._listener):
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def release_segments(self, unmap: bool = True) -> bool:
        """Release the segments exactly once: drop the raw-address copies,
        unmap (unless ``unmap`` is False, for a serve thread that could
        not be joined) and unlink.  False on a repeated call."""
        with self._release_lock:
            if self._released:
                return False
            self._released = True
        self.c2s.invalidate()
        self.s2c.invalidate()
        for shm in (self._c2s_shm, self._s2c_shm):
            if unmap:
                try:
                    shm.close()
                except (OSError, BufferError):   # a view still exports it
                    pass
            try:
                shm.unlink()
            except OSError:   # already gone
                pass
        return True

    def unlink(self, join_s: float = 2.0) -> None:
        self.close()
        self._thread.join(timeout=join_s)
        if self._thread.is_alive():
            # still inside the handler (a barrier wait): unmapping under it
            # could fault a copy, so unlink the names only; the daemon
            # thread's mapping goes with the process
            log.warning("shm connection thread still running at teardown; "
                        "deferring the segment unmap")
            self.release_segments(unmap=False)
            return
        self.release_segments()


class ShmServer:
    """The PS's registry of connections: answers ``NegotiateShm`` and owns
    each connection's segments and thread.  ``handler`` is the fused
    stream handler (request-chunk iterator in, response iterator out)."""

    def __init__(self, handler: Callable, capacity: int | None = None):
        self._handler = handler
        self._capacity = capacity if capacity is not None else ring_bytes()
        self._host_id = host_id()
        self._lock = threading.Lock()   # the registry's list only
        self._conns: list[_ServerConnection] = []
        self._next_index = 0
        self._closed = False

    @property
    def connections(self) -> int:
        with self._lock:
            return len(self._conns)

    def _reap(self, conn: _ServerConnection) -> None:
        """From a connection's thread as it exits (the client closed,
        crashed or never finished the handshake): drop it and release
        its segments; removal under the lock makes reap and shutdown
        exclusive."""
        with self._lock:
            if conn not in self._conns:
                return   # the shutdown path owns it
            self._conns.remove(conn)
        conn.close()
        conn.release_segments()
        log.info("shm connection %d reaped (client disconnected)",
                 conn.index)

    def _refuse(self, why: str) -> ShmNegotiateResponse:
        log.info("shm negotiation refused: %s", why)
        return ShmNegotiateResponse(accepted=False, message=why,
                                    host_id=self._host_id)

    def negotiate(self, request: ShmNegotiateRequest) -> ShmNegotiateResponse:
        if not enabled():
            return self._refuse("shm transport disabled (PSDT_SHM=0)")
        if request.host_id != self._host_id:
            return self._refuse(f"host mismatch: client {request.host_id!r} "
                                f"vs server {self._host_id!r}")
        capacity = self._capacity
        if request.ring_bytes:
            capacity = min(capacity, int(request.ring_bytes))
        with self._lock:
            if self._closed:
                return self._refuse("server shutting down")
            index = self._next_index
            self._next_index += 1
        # segment creation and pretouch run outside the lock: workers
        # negotiating at once must not queue behind each other's faults
        try:
            conn = _ServerConnection(index, self._handler, capacity,
                                     on_exit=self._reap)
        except (OSError, ValueError, ImportError) as exc:
            return self._refuse(f"shared memory unavailable: {exc}")
        with self._lock:
            registered = not self._closed
            if registered:
                self._conns.append(conn)
        if not registered:   # shutdown raced the construction
            conn.unlink()
            return self._refuse("server shutting down")
        log.info("shm connection %d negotiated (worker %d, ring %d MB x2)",
                 index, request.worker_id, capacity >> 20)
        return ShmNegotiateResponse(
            accepted=True, message="ok", c2s_name=conn.c2s_name,
            s2c_name=conn.s2c_name, ring_bytes=capacity,
            host_id=self._host_id, doorbell=conn.doorbell_addr)

    def close(self) -> None:
        """Close every connection: their threads wake from ring and
        doorbell waits; one parked in the handler is left to the process
        exit with its segments unlinked."""
        with self._lock:
            self._closed = True
            conns, self._conns = list(self._conns), []
        for conn in conns:
            conn.unlink()
