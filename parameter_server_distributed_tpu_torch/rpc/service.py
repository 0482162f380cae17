"""gRPC plumbing: the port's copy of
parameter_server_distributed_tpu/rpc/service.py — generic service binding
through gRPC's generic-handler API with the wire codec of ``wire.py``
(no gencode), and a typed client over one persistent channel.  Method
paths are the reference's (``/parameter_server.ParameterServer/<M>``,
``/coordinator.Coordinator/<M>``), so either package's peers call the
other's services.

Both ends of every RPC count calls, latency and request/response bytes
in the port's obs registry (``obs/stats.py``): ``rpc.server.<M>.*`` and
``rpc.client.<M>.*``.  The latency of a ``unary_stream`` client call
covers dispatch only (the response iterator outlives the call); the byte
counters see every chunk because they live in the (de)serializers.  Not
ported: the JAX package's trace spans and flight events (ROADMAP.md
Queue 1, item 14).
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Mapping

import grpc

from ..obs import stats as obs_stats
from .wire import Message

_HANDLERS = {
    "unary": grpc.unary_unary_rpc_method_handler,
    "stream_unary": grpc.stream_unary_rpc_method_handler,
    "unary_stream": grpc.unary_stream_rpc_method_handler,
    "stream_stream": grpc.stream_stream_rpc_method_handler,
}


def _spec(entry) -> tuple[type[Message], type[Message], str]:
    """Normalize a method-table entry: (req, resp) -> unary-unary, or
    (req, resp, style) with style in unary | stream_unary | unary_stream
    | stream_stream."""
    if len(entry) == 2:
        req_cls, resp_cls = entry
        return req_cls, resp_cls, "unary"
    req_cls, resp_cls, style = entry
    return req_cls, resp_cls, style


def _counting_deserializer(decode: Callable, counter) -> Callable:
    def deserialize(buf):
        counter.add(len(buf))
        return decode(buf)
    return deserialize


def _counting_serializer(counter) -> Callable:
    def serialize(msg: Message) -> bytes:
        data = msg.encode()
        counter.add(len(data))
        return data
    return serialize


def _instrument_handler(behavior: Callable, method: str, style: str):
    """Wrap a service method with call and latency accounting; a
    streaming response's latency runs until its last chunk is taken."""
    calls = obs_stats.counter(f"rpc.server.{method}.calls")
    latency = obs_stats.histogram(f"rpc.server.{method}.latency_s")

    if style in ("unary_stream", "stream_stream"):
        def streaming(request, context):
            calls.add()
            t0 = time.perf_counter()

            def stream():
                try:
                    yield from behavior(request, context)
                finally:
                    latency.observe(time.perf_counter() - t0)
            return stream()
        return streaming

    def handler(request, context):
        calls.add()
        t0 = time.perf_counter()
        try:
            return behavior(request, context)
        finally:
            latency.observe(time.perf_counter() - t0)
    return handler


def bind_service(server: grpc.Server, service_name: str,
                 methods: Mapping[str, tuple], impl: Any) -> None:
    """Register ``impl`` on ``server``: for each method M, ``impl.M(request,
    context)`` must exist and return the response message (for
    ``stream_unary`` the first argument is a request iterator; for
    ``unary_stream`` the method returns an iterator of responses).  A
    method not in ``methods`` answers UNIMPLEMENTED."""
    handlers = {}
    for method, entry in methods.items():
        req_cls, _resp_cls, style = _spec(entry)
        handlers[method] = _HANDLERS[style](
            _instrument_handler(getattr(impl, method), method, style),
            request_deserializer=_counting_deserializer(
                req_cls.decode,
                obs_stats.counter(f"rpc.server.{method}.request_bytes")),
            response_serializer=_counting_serializer(
                obs_stats.counter(f"rpc.server.{method}.response_bytes")),
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),))


# Shared channel/server options.  The default 16KB HTTP/2 frame caps
# loopback throughput for tensor-sized messages; the larger write buffer
# keeps the transport fed while the next chunk encodes.  A chunk carries
# whole tensors, so one message holds at least the largest tensor: gRPC's
# largest message (2 GiB - 1), where the JAX package's 1 GiB refuses an
# f32 push of one mlp_1b weight (16384 x 16384, 1 GiB + its header)
MAX_MESSAGE_BYTES = (1 << 31) - 1
CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.http2.max_frame_size", 16 << 20),
    ("grpc.http2.write_buffer_size", 64 << 20),
]


def status_code(exc: grpc.RpcError):
    """Status code of an RpcError, or None for errors that carry none."""
    code = getattr(exc, "code", None)
    return code() if callable(code) else None


def make_server(max_workers: int = 8) -> grpc.Server:
    return grpc.server(
        concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="rpc-handler"),
        options=CHANNEL_OPTIONS)


class RpcClient:
    """Typed client over one persistent insecure channel (the reference
    opens a fresh channel per call on the worker's hot path)."""

    def __init__(self, target: str, service_name: str,
                 methods: Mapping[str, tuple]):
        self._target = target
        self._channel = grpc.insecure_channel(target,
                                              options=CHANNEL_OPTIONS)
        self._calls: dict[str, Callable] = {}
        self._instruments: dict[str, tuple] = {}
        for method, entry in methods.items():
            _req_cls, resp_cls, style = _spec(entry)
            make_call = {
                "unary": self._channel.unary_unary,
                "stream_unary": self._channel.stream_unary,
                "unary_stream": self._channel.unary_stream,
                "stream_stream": self._channel.stream_stream,
            }[style]
            self._calls[method] = make_call(
                f"/{service_name}/{method}",
                request_serializer=_counting_serializer(
                    obs_stats.counter(f"rpc.client.{method}.request_bytes")),
                response_deserializer=_counting_deserializer(
                    resp_cls.decode,
                    obs_stats.counter(
                        f"rpc.client.{method}.response_bytes")),
            )
            self._instruments[method] = (
                obs_stats.counter(f"rpc.client.{method}.calls"),
                obs_stats.histogram(f"rpc.client.{method}.latency_s"))

    def call(self, method: str, request, timeout: float | None = None):
        """One call.  For a ``stream_unary`` or ``stream_stream`` method
        pass an ITERATOR of request messages (gRPC pulls it from a sender
        thread, so per-chunk encode overlaps transport); ``unary_stream``
        and ``stream_stream`` return an iterator of response messages that
        decode as chunks arrive."""
        calls, latency = self._instruments[method]
        calls.add()
        t0 = time.perf_counter()
        try:
            return self._calls[method](request, timeout=timeout)
        finally:
            latency.observe(time.perf_counter() - t0)

    def close(self) -> None:
        self._channel.close()
