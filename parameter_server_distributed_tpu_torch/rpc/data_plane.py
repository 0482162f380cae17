"""Streaming data plane for the parameter-server service: the port's copy
of parameter_server_distributed_tpu/rpc/data_plane.py.

The reference moves every push and pull as ONE unary protobuf message.
The JAX package's extension, which the port speaks too, moves the same
payloads as a STREAM of chunk messages, each carrying a subset of the
tensors:

- ``PushGradientsStream`` (client-streaming): gRPC pulls the request
  iterator from a sender thread, so chunk N+1's encode overlaps chunk N's
  transport, and the server folds each chunk as it arrives.
- ``ServeParametersStream`` (server-streaming): the server ships the
  store chunk by chunk; the client converts each chunk while the next is
  in flight.
- ``PushPullStream`` (bidirectional): the fused synchronous step.  The
  client streams its gradient chunks; the server folds them, parks on
  the aggregation barrier and streams the fresh parameters back on the
  same call.  One RPC round replaces push + barrier polls + pull, and
  because the request side takes a LAZY tensor iterator, the worker's
  bucketed gradient download, encode and transport pipeline per bucket
  (worker/trainer.py ``GradientBuckets``).

Chunks reuse the ``GradientUpdate`` / ``ParameterUpdate`` schemas.
:class:`PSClient` falls back, once and for good per connection, to the
reference's unary RPCs the first time a server answers UNIMPLEMENTED.  A
tensor larger than the chunk budget rides alone in one oversized chunk:
the budget groups, it does not split.

Same host: :class:`PSClient` negotiates the shared-memory transport
(rpc/shm_transport.py) on its first fused round and runs fused rounds
over the rings from then on, the same chunk messages as bytes.  A
refusal, UNIMPLEMENTED (a reference PS), an attach failure or a
transport error mid-round downgrades the connection to gRPC for good,
and each downgrade counts one ``rpc.shm.fallback``; a failed round is
replayed over gRPC.

:func:`decode_gradients` decodes a push chunk for the fold: to host
numpy, or, for a core whose close runs on its device
(``ParameterServerCore.device_fold``), onto that device with the
dequantize there (core/device_apply.py).

Not ported: versioned delta serving (ROADMAP.md Queue 1, item 12).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Iterable, Iterator, Sequence

import grpc

from ..obs import stats as obs_stats
from . import messages as m
from . import shm_transport
from .service import RpcClient
from .service import status_code as _status_code
from .wire import (WT_LEN, WT_VARINT, _len_delimited_size, _tag,
                   _varint_size, _Writer, encode_varint)

log = logging.getLogger("pst.data_plane")

# Default chunk budget for streamed pushes/pulls; PSDT_STREAM_CHUNK_BYTES
# overrides, 0 disables streaming entirely.
DEFAULT_CHUNK_BYTES = 32 << 20


def decode_gradients(tensors: Iterable[m.Tensor], device=None) -> dict:
    """One push chunk's wire Tensors -> fold-ready arrays: host numpy
    (``Tensor.to_array``) when ``device`` is None or False, else f32
    tensors on ``device`` (core/device_apply.tensor_to_device: packed
    payloads cross as their wire bytes and dequantize there)."""
    if device is None or device is False:
        return {t.name: t.to_array() for t in tensors}
    from ..core import device_apply

    return {t.name: device_apply.tensor_to_device(t, device)
            for t in tensors}


def stream_chunk_bytes() -> int:
    return int(os.environ.get("PSDT_STREAM_CHUNK_BYTES",
                              str(DEFAULT_CHUNK_BYTES)))


def bucket_bytes() -> int:
    """Bucket budget for the worker's incremental gradient download
    (worker/trainer.py GradientBuckets).  Defaults to the stream chunk
    budget so download buckets and wire chunks stay aligned;
    PSDT_BUCKET_BYTES overrides independently (0: one whole-store
    bucket)."""
    raw = os.environ.get("PSDT_BUCKET_BYTES")
    if raw is not None:
        return int(raw)
    return stream_chunk_bytes()


def _tensor_nbytes(t: m.Tensor) -> int:
    if t.packed:
        return len(t.packed)
    data = t.data
    return getattr(data, "nbytes", 4 * len(data))


def split_tensors(tensors: Iterable[m.Tensor],
                  chunk_bytes: int) -> Iterator[list[m.Tensor]]:
    """Greedy-pack tensors into order-preserving chunks of roughly
    ``chunk_bytes`` payload each (metadata only: payloads are lazy
    ArrayPayloads or buffer views)."""
    group: list[m.Tensor] = []
    size = 0
    for t in tensors:
        n = _tensor_nbytes(t)
        if group and size + n > chunk_bytes:
            yield group
            group, size = [], 0
        group.append(t)
        size += n
    if group:
        yield group


_PARAMETERS_FIELD = 2  # m.ParameterUpdate.parameters
_ITERATION_FIELD = 1   # m.ParameterUpdate.iteration
_READY_FIELD = 3       # m.ParameterUpdate.ready


def encode_parameter_record_groups(
        groups: Sequence[Sequence[m.Tensor]],
        stripes: int | None = None) -> list[bytes]:
    """Encode several chunk groups' ``ParameterUpdate.parameters`` bodies,
    fanning the groups across the shared stripe executor
    (core/stripes.py) when there is more than one group and more than one
    stripe.  Group order is kept and each group's bytes are exactly the
    serial encode's: only which thread runs a group changes (the numpy
    copies release the GIL)."""
    from ..core.stripes import run_striped, stripe_count

    if len(groups) <= 1 or stripe_count(stripes) <= 1:
        return [encode_parameter_records(group) for group in groups]
    return run_striped([(lambda g=group: encode_parameter_records(g))
                        for group in groups])


def encode_parameter_records(tensors: Iterable[m.Tensor]) -> bytes:
    """Encode a group of wire Tensors ONCE into the exact bytes of
    ``ParameterUpdate.parameters`` (field 2) records: tag, length and
    tensor body per element.  The server's encode-once cache
    (server/ps_service.py) replays them to every puller of the same store
    version through :class:`PreEncodedParameterUpdate`."""
    items = [(t, t.encoded_size()) for t in tensors]
    writer = _Writer(sum(_len_delimited_size(_PARAMETERS_FIELD, size)
                         for _, size in items))
    for tensor, size in items:
        writer.write(_tag(_PARAMETERS_FIELD, WT_LEN))
        writer.write(encode_varint(size))
        tensor.encode_into(writer)
    return writer.getvalue()


class PreEncodedParameterUpdate:
    """A ``ParameterUpdate`` whose ``parameters`` field is pre-encoded wire
    bytes (one or more :func:`encode_parameter_records` blobs).  Encodes
    byte-identically to ``m.ParameterUpdate(...)`` with the same content
    (field order 1, 2, 3, proto3 default elision), and quacks like a
    Message (``encode`` / ``encoded_size`` / ``encode_into``), which is
    all the gRPC serializer and ``PushPullResponse.params`` need."""

    __slots__ = ("iteration", "ready", "bodies")

    def __init__(self, iteration: int, ready: bool,
                 bodies: Sequence[bytes]):
        self.iteration = int(iteration)
        self.ready = bool(ready)
        self.bodies = bodies

    def encoded_size(self) -> int:
        size = sum(len(b) for b in self.bodies)
        if self.iteration:
            size += (_varint_size(_ITERATION_FIELD << 3)
                     + _varint_size(self.iteration))
        if self.ready:
            size += _varint_size(_READY_FIELD << 3) + 1
        return size

    def encode_into(self, writer: "_Writer") -> None:
        if self.iteration:
            writer.write(_tag(_ITERATION_FIELD, WT_VARINT))
            writer.write(encode_varint(self.iteration))
        for body in self.bodies:
            writer.write(memoryview(body))
        if self.ready:
            writer.write(_tag(_READY_FIELD, WT_VARINT))
            writer.write(b"\x01")

    def encode(self) -> bytes:
        writer = _Writer(self.encoded_size())
        self.encode_into(writer)
        return writer.getvalue()


class PSClient(RpcClient):
    """Parameter-server client with the streaming data plane.

    ``push_gradients`` / ``pull_parameters`` / ``push_pull`` use the
    chunk-stream RPCs and fall back (once, remembered per connection) to
    the reference's unary RPCs when the server does not implement them.
    Everything else is plain :meth:`RpcClient.call`."""

    def __init__(self, target: str,
                 service: str = m.PARAMETER_SERVER_SERVICE,
                 methods=None, chunk_bytes: int | None = None):
        methods = dict(methods or m.PARAMETER_SERVER_METHODS)
        methods.update(m.PARAMETER_SERVER_STREAM_METHODS)
        methods.update(shm_transport.SHM_METHODS)
        super().__init__(target, service, methods)
        self.chunk_bytes = (stream_chunk_bytes() if chunk_bytes is None
                            else chunk_bytes)
        # None = untried; False = the server answered UNIMPLEMENTED (a
        # reference PS): unary for good on this connection
        self._stream_ok: bool | None = None
        # the same tri-state for the fused push→barrier→pull method
        self._fused_ok: bool | None = None
        # the same-host rings: None = not negotiated yet; False = gRPC for
        # good (refused, UNIMPLEMENTED, attach failure, transport error)
        self._shm_conn: shm_transport.ShmClientConnection | None = None
        self._shm_ok: bool | None = None

    def _streaming(self) -> bool:
        return self.chunk_bytes > 0 and self._stream_ok is not False

    def _fused(self) -> bool:
        return self.chunk_bytes > 0 and self._fused_ok is not False

    @property
    def shm_active(self) -> bool:
        """True while a shared-memory connection carries the fused
        rounds."""
        return self._shm_conn is not None and self._shm_ok is True

    def close(self) -> None:
        self._drop_shm(permanent=False)
        super().close()

    # ------------------------------------------------------- shm transport
    def _drop_shm(self, permanent: bool = True) -> None:
        conn, self._shm_conn = self._shm_conn, None
        if permanent:
            self._shm_ok = False
        if conn is not None:
            conn.close()

    def _downgrade(self, why: str) -> None:
        """gRPC for good on this connection, counted."""
        log.info("shm transport to %s: %s; using gRPC", self._target, why)
        self._drop_shm()
        obs_stats.counter("rpc.shm.fallback").add()

    def _shm_connection(self, timeout):
        """The negotiated shared-memory connection, negotiating on first
        use; None when the round rides gRPC: for good after a refusal,
        UNIMPLEMENTED or an attach failure, for this round only when the
        negotiation call itself failed otherwise."""
        if not shm_transport.enabled() or self._shm_ok is False:
            return None
        if self._shm_conn is not None:
            return self._shm_conn
        try:
            resp = self.call(
                "NegotiateShm",
                shm_transport.ShmNegotiateRequest(
                    host_id=shm_transport.host_id(),
                    ring_bytes=shm_transport.ring_bytes()),
                timeout=timeout if timeout else 10.0)
        except grpc.RpcError as exc:
            if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                self._downgrade("NegotiateShm is UNIMPLEMENTED")
            return None
        if not resp.accepted:
            self._downgrade(f"refused ({resp.message})")
            return None
        try:
            self._shm_conn = shm_transport.ShmClientConnection(
                resp.c2s_name, resp.s2c_name, int(resp.ring_bytes),
                doorbell_addr=resp.doorbell)
        except (OSError, ValueError, ImportError) as exc:
            # not reachable from this process (another /dev/shm)
            self._downgrade(f"segment attach failed ({exc})")
            return None
        self._shm_ok = True
        log.info("shm transport active to %s (ring %d MB x2)", self._target,
                 int(resp.ring_bytes) >> 20)
        return self._shm_conn

    # ------------------------------------------------------------------ push
    def push_gradients(self, update: m.GradientUpdate,
                       timeout: float | None = None) -> m.PushResponse:
        if not self._streaming():
            return self.call("ReceiveGradients", update, timeout=timeout)

        def chunks() -> Iterator[m.GradientUpdate]:
            # worker_id/iteration ride on every chunk; the server reads
            # them off the first.  An empty push still sends one empty
            # chunk: it is still a barrier contribution.
            sent = False
            for group in split_tensors(update.gradients, self.chunk_bytes):
                sent = True
                yield m.GradientUpdate(worker_id=update.worker_id,
                                       iteration=update.iteration,
                                       gradients=group)
            if not sent:
                yield m.GradientUpdate(worker_id=update.worker_id,
                                       iteration=update.iteration,
                                       gradients=[])

        try:
            resp = self.call("PushGradientsStream", chunks(), timeout=timeout)
            self._stream_ok = True
            return resp
        except grpc.RpcError as exc:
            if _status_code(exc) != grpc.StatusCode.UNIMPLEMENTED:
                raise
            self._stream_ok = False
            return self.call("ReceiveGradients", update, timeout=timeout)

    # ------------------------------------------------------------------ fused
    def push_pull(self, worker_id: int, iteration: int, tensors,
                  pull_wire_dtype: int = 0, timeout: float | None = None,
                  on_chunk=None) -> tuple[m.PushResponse,
                                          m.ParameterUpdate | None]:
        """Fused synchronous step over ``PushPullStream``: stream the
        gradient chunks, let the server barrier-wait, receive the fresh
        parameter chunks — one data-plane round.

        ``tensors``: an iterable of wire Tensors, or a ZERO-ARG CALLABLE
        returning a fresh iterator (required when the tensors materialize
        lazily, as bucketed downloads do: the unary fallback re-reads
        them).  ``on_chunk``: as for :meth:`pull_parameters`.

        Returns ``(push_response, parameter_update | None)``; the second is
        None whenever fresh parameters were NOT delivered — fused method
        unimplemented (a reference PS), push rejected, or a server-side
        barrier timeout — and the caller falls back to its own barrier
        wait and pull."""
        tensors_fn = tensors if callable(tensors) else lambda: iter(tensors)
        if not self._fused():
            return self._push_only(worker_id, iteration, tensors_fn,
                                   timeout), None

        def chunks() -> Iterator[m.GradientUpdate]:
            # pull_wire_dtype rides the first chunk only; an empty push
            # still sends one empty chunk (see push_gradients)
            first = True
            for group in split_tensors(tensors_fn(), self.chunk_bytes):
                yield m.GradientUpdate(
                    worker_id=worker_id, iteration=iteration,
                    gradients=group,
                    pull_wire_dtype=pull_wire_dtype if first else 0)
                first = False
            if first:
                yield m.GradientUpdate(worker_id=worker_id,
                                       iteration=iteration, gradients=[],
                                       pull_wire_dtype=pull_wire_dtype)

        # same host: the same chunk messages, as bytes, through the rings;
        # a transport error downgrades for good and the round is replayed
        # over gRPC below (tensors_fn replays its tensors)
        conn = self._shm_connection(timeout)
        if conn is not None:
            calls, latency = self._instruments["PushPullStream"]
            calls.add()
            t0 = time.perf_counter()
            try:
                frames = conn.round_trip(
                    (chunk.encode() for chunk in chunks()), timeout)
                result = self._assemble_fused(
                    (m.PushPullResponse.decode(memoryview(f))
                     for f in frames), on_chunk)
                self._fused_ok = True
                return result
            except shm_transport.ShmTransportError as exc:
                log.warning("shm fused round failed (%s)", exc)
                self._downgrade("round failed")
            finally:
                latency.observe(time.perf_counter() - t0)

        try:
            result = self._assemble_fused(
                self.call("PushPullStream", chunks(), timeout=timeout),
                on_chunk)
            self._fused_ok = True
            return result
        except grpc.RpcError as exc:
            if _status_code(exc) != grpc.StatusCode.UNIMPLEMENTED:
                raise
            self._fused_ok = False
            return self._push_only(worker_id, iteration, tensors_fn,
                                   timeout), None

    @staticmethod
    def _assemble_fused(frames, on_chunk) -> tuple[m.PushResponse,
                                                   m.ParameterUpdate | None]:
        """Fold a ``PushPullResponse`` frame stream into the
        ``(push, params | None)`` result."""
        push: m.PushResponse | None = None
        merged: list[m.Tensor] = []
        params_iteration, ready, got_params = 0, False, False
        for frame in frames:
            if frame.push is not None and push is None:
                push = frame.push
            if frame.params is not None:
                got_params = True
                chunk = frame.params
                params_iteration, ready = chunk.iteration, chunk.ready
                if on_chunk is not None:
                    on_chunk(chunk.parameters)
                    merged.extend(
                        m.Tensor(name=t.name, packed_dtype=t.packed_dtype)
                        for t in chunk.parameters)
                else:
                    merged.extend(chunk.parameters)
        if push is None:
            return m.PushResponse(success=False,
                                  message="empty fused response"), None
        if not (got_params and ready):
            return push, None
        return push, m.ParameterUpdate(iteration=params_iteration,
                                       parameters=merged, ready=True)

    def _push_only(self, worker_id: int, iteration: int, tensors_fn,
                   timeout) -> m.PushResponse:
        """Degraded fused call: the push leg only (chunk-streamed when the
        server supports it, unary otherwise); the caller supplies the
        barrier wait and the pull."""
        update = m.GradientUpdate(worker_id=worker_id, iteration=iteration,
                                  gradients=list(tensors_fn()))
        return self.push_gradients(update, timeout=timeout)

    # ------------------------------------------------------------------ pull
    def pull_parameters(self, request: m.PullRequest,
                        timeout: float | None = None,
                        on_chunk=None) -> m.ParameterUpdate:
        """One merged ParameterUpdate (chunks concatenated in server order,
        indistinguishable from the unary response).

        ``on_chunk(tensors)``: optional per-chunk consumer called as each
        chunk ARRIVES, so conversion overlaps the transport of later
        chunks.  The consumed tensors appear in the result as metadata
        only (name and packed_dtype); on the unary fallback it is called
        once with the whole list."""
        def unary_pull() -> m.ParameterUpdate:
            resp = self.call("ServeParameters", request, timeout=timeout)
            if on_chunk is not None:
                on_chunk(resp.parameters)
            return resp

        if not self._streaming():
            return unary_pull()
        try:
            chunks = self.call("ServeParametersStream", request,
                               timeout=timeout)
            merged: list[m.Tensor] = []
            iteration, ready = 0, False
            got_any = False
            for chunk in chunks:
                got_any = True
                iteration, ready = chunk.iteration, chunk.ready
                if on_chunk is not None:
                    on_chunk(chunk.parameters)
                    # the consumer took the payloads; holding the wire
                    # copy beside the converted store would double the
                    # pull's peak memory
                    merged.extend(
                        m.Tensor(name=t.name, packed_dtype=t.packed_dtype)
                        for t in chunk.parameters)
                else:
                    merged.extend(chunk.parameters)
            self._stream_ok = True
            if not got_any:  # zero-chunk stream: treat as an empty store
                return unary_pull()
            return m.ParameterUpdate(iteration=iteration, parameters=merged,
                                     ready=ready)
        except grpc.RpcError as exc:
            if _status_code(exc) != grpc.StatusCode.UNIMPLEMENTED:
                raise
            self._stream_ok = False
            return unary_pull()
