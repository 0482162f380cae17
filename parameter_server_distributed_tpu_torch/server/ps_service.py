"""Parameter-server gRPC service: the port of
parameter_server_distributed_tpu/server/ps_service.py.

Wraps the port's ``ParameterServerCore`` in the reference's 5-RPC service
(reference: src/parameter_server_service.cpp,
proto/parameter_server.proto:5-11) plus the JAX package's streaming data
plane (rpc/data_plane.py), and writes the checkpoint of each epoch
(reference daemon: src/parameter_server_service.cpp:150-169) through
``CheckpointManager``, taking its state at the apply that advanced the
epoch (:class:`_EpochSaver`).

- **Per-chunk gradient folding**: the streaming push handlers feed each
  decoded chunk into the core's ``PushSink`` (``begin_push``) as it
  arrives, so decode and accumulate overlap the transport of later
  chunks.
- **Encode-once broadcast cache**: the served store is encoded to wire
  bytes once per (store version, wire dtype, chunk budget) and replayed
  to every puller of that version (:class:`EncodedServeCache`), so the
  post-barrier fan-out to N workers runs one ``to_wire`` encode, not N.
  The core's store version moves on every apply, restore and
  initialisation, which invalidates the cache.  ``to_wire`` reads a
  device optimizer's card tensors through ``core.tensor.to_host``, one
  packed copy.

- **Same-host rings**: ``NegotiateShm`` (rpc/shm_transport.py) gives a
  worker on this host two shared-memory rings and a thread that runs
  each of its fused rounds through the same ``PushPullStream`` handler,
  so bytes and semantics do not depend on the transport.
- **Versioned deltas and live publication** (delta/): a ``DeltaChain``
  diffs consecutive store versions after every apply (the core's delta
  sink, armed on the first request that can take a delta), and
  :class:`EncodedDeltaCache` replays each pair's encoded frames to every
  receiver.  ``PullParametersDelta`` and ``PushPullDeltaStream`` answer
  a receiver that names its held version with the pairs since then, or
  a version-stamped full serve; ``SubscribeWeights`` streams every new
  version to a subscriber (delta/subscriber.py ``WeightFollower``)
  until it cancels.

Registered: ``ReceiveGradients``, ``ServeParameters``, ``CheckSyncStatus``,
``SaveCheckpoint``, ``LoadCheckpoint``, the streams
``PushGradientsStream``, ``ServeParametersStream`` and ``PushPullStream``,
``NegotiateShm``, and, unless ``PSDT_DELTA_DEPTH=0``, the delta RPCs and
``SubscribeWeights``.  Not registered, so answered UNIMPLEMENTED: the
replication and sharded-update RPCs (ROADMAP.md Queue 1, item 13), and
the delta RPCs at ``PSDT_DELTA_DEPTH=0``.  The JAX package's clients
fall back on each of them by themselves.

Timings land in the port's obs registry: ``ps.apply_s`` (fold commit and
apply, net of RPC plumbing), ``ps.serve_s``, ``ps.barrier_wait_s`` (how
long fused handlers park on the barrier), the cache's
``ps.serve.cache_hit`` / ``ps.serve.cache_miss`` and ``ps.serve.encode_s``
(one encode of the store, the part of a serve that is not transfer), the
delta plane's ``ps.serve.delta_hit`` / ``ps.serve.delta_miss`` /
``ps.serve.delta_bytes`` and ``ps.publish.refused`` (subscribers turned
away at ``PSDT_MAX_SUBSCRIBERS``); the chain adds
``ps.serve.delta_build_ms``, and the core ``ps.barrier_close_s``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import OrderedDict

import grpc
import torch

from ..checkpoint.manager import CheckpointManager
from ..config import ParameterServerConfig
from ..core.optimizer import make_optimizer
from ..core.ps_core import ParameterServerCore, PushSink
from ..core.tensor import to_wire
from ..delta import messages as dmsg
from ..delta.chain import DeltaChain, DeltaPair, wire_dtype_compatible
from ..device import resolve_device
from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc import shm_transport
from ..rpc.data_plane import (PreEncodedParameterUpdate, decode_gradients,
                              encode_parameter_record_groups, split_tensors,
                              stream_chunk_bytes)
from ..rpc.service import bind_service, make_server

log = logging.getLogger("pst.ps")


class _ServeCacheEntry:
    __slots__ = ("event", "bodies", "failed", "version")

    def __init__(self):
        self.event = threading.Event()
        self.bodies: list[bytes] | None = None
        self.failed = False
        # the store version the bodies were actually encoded at
        self.version = -1


class EncodedServeCache:
    """Encode-once broadcast cache: encoded parameter-chunk bytes keyed by
    (store version, wire dtype, chunk budget).

    Single-flight per key: the first serve of a version encodes (the
    miss); concurrent serves of the same key wait for that encode and
    replay its bytes.  Entries of older versions are dropped on insert, so
    the cache holds the current version's encodings only."""

    def __init__(self):
        # held only around dict operations, never with a core lock
        self._lock = threading.Lock()
        self._entries: dict[tuple, _ServeCacheEntry] = {}

    def lookup(self, key: tuple) -> tuple[_ServeCacheEntry, bool]:
        """(entry, is_builder).  A builder MUST call :meth:`fill` or
        :meth:`fail`; everyone else waits on ``entry.event``.  Versions
        only grow, so only entries of OLDER versions are pruned."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                return entry, False
            entry = _ServeCacheEntry()
            version = key[0]
            for stale in [k for k in self._entries if k[0] < version]:
                del self._entries[stale]
            self._entries[key] = entry
            return entry, True

    def fill(self, key: tuple, entry: _ServeCacheEntry,
             bodies: list[bytes], version: int) -> None:
        entry.bodies = bodies
        entry.version = version
        if version != key[0]:
            # the store moved between the version probe and the encode's
            # read: re-register under the version actually encoded, unless
            # the cache has already moved past it
            with self._lock:
                if self._entries.get(key) is entry:
                    del self._entries[key]
                if not any(k[0] > version for k in self._entries):
                    for stale in [k for k in self._entries
                                  if k[0] < version]:
                        del self._entries[stale]
                    self._entries[(version,) + key[1:]] = entry
        entry.event.set()

    def fail(self, key: tuple, entry: _ServeCacheEntry) -> None:
        entry.failed = True
        with self._lock:
            if self._entries.get(key) is entry:
                del self._entries[key]
        entry.event.set()


class EncodedDeltaCache:
    """The delta tier of the encode-once cache: DeltaFrame bytes keyed by
    ``(from_version, to_version, chunk budget)``, one encode a pair,
    replayed to every receiver crossing that hop (the post-barrier
    fan-out and every subscriber).  Store versions are never reused in a
    process, so a key is never stale; the bounded LRU ages entries out.
    No single-flight wait: repacking an already diffed pair is cheap
    enough that a racing duplicate beats parking a handler thread."""

    CAPACITY = 32

    def __init__(self):
        self._lock = threading.Lock()
        self._frames: "OrderedDict[tuple, list[bytes]]" = OrderedDict()

    def get(self, pair: DeltaPair, wire_dtype: int,
            budget: int) -> list[bytes]:
        key = (pair.from_version, pair.to_version, budget)
        with self._lock:
            hit = self._frames.get(key)
            if hit is not None:
                self._frames.move_to_end(key)
                return hit
        bodies = [frame.encode()
                  for frame in _pair_frames(pair, wire_dtype, budget)]
        with self._lock:
            self._frames[key] = bodies
            while len(self._frames) > self.CAPACITY:
                self._frames.popitem(last=False)
        return bodies


def _pair_frames(pair: DeltaPair, wire_dtype: int, budget: int):
    """One delta pair -> its DeltaFrames: entries packed greedily to about
    ``budget`` payload bytes a frame, the last frame stamped with the
    pair's store checksum and ``last=True`` (a receiver applies a pair
    only once it has all of it, delta/client.py)."""
    def make(entries, last: bool) -> dmsg.DeltaFrame:
        return dmsg.DeltaFrame(
            from_version=pair.from_version, to_version=pair.to_version,
            delta=True, wire_dtype=wire_dtype, entries=entries,
            crc=pair.crc if last else 0, last=last)

    batch: list[dmsg.DeltaEntry] = []
    size = 0
    for name, idx_bytes, value_bytes, dense in pair.entries:
        nbytes = len(idx_bytes) + len(value_bytes)
        if batch and size + nbytes > budget:
            yield make(batch, last=False)
            batch, size = [], 0
        batch.append(dmsg.DeltaEntry(name=name, indices=idx_bytes,
                                     values=value_bytes, dense=dense))
        size += nbytes
    yield make(batch, last=True)


def _numel(value) -> int:
    return value.numel() if isinstance(value, torch.Tensor) else value.size


class ParameterServerService:
    """RPC handlers (reference: parameter_server_service_impl,
    src/parameter_server_service.cpp:15-175)."""

    def __init__(self, core: ParameterServerCore, ckpt: CheckpointManager):
        self.core = core
        self.ckpt = ckpt
        # the same-host rings; the handler is looked up per round, so an
        # instance-level override governs the shm path too
        self.shm_server = shm_transport.ShmServer(
            lambda chunks, ctx: self.PushPullStream(chunks, ctx))
        self._obs_apply = obs_stats.histogram("ps.apply_s")
        self._obs_serve = obs_stats.histogram("ps.serve_s")
        self._obs_barrier = obs_stats.histogram("ps.barrier_wait_s")
        self._serve_cache = EncodedServeCache()
        self._obs_cache_hit = obs_stats.counter("ps.serve.cache_hit")
        self._obs_cache_miss = obs_stats.counter("ps.serve.cache_miss")
        self._obs_encode = obs_stats.histogram("ps.serve.encode_s")
        # the delta plane: None at PSDT_DELTA_DEPTH=0.  The chain becomes
        # the core's sink lazily, on the first request that can take a
        # delta (_arm_delta): until a receiver exists, the O(model)
        # encode, diff and crc at every close would buy nothing
        self.delta_chain: DeltaChain | None = (
            DeltaChain(stripes=core.stripes) if dmsg.delta_enabled()
            else None)
        self._delta_armed = False
        self._delta_cache = EncodedDeltaCache()
        # live subscriptions, bounded (each parks one handler thread)
        self._active_subscribers = 0
        self._sub_lock = threading.Lock()
        # set when the server stops: parked subscriptions return
        self._closing = threading.Event()
        self._obs_delta_hit = obs_stats.counter("ps.serve.delta_hit")
        self._obs_delta_miss = obs_stats.counter("ps.serve.delta_miss")
        self._obs_delta_bytes = obs_stats.counter("ps.serve.delta_bytes")
        self._obs_sub_refused = obs_stats.counter("ps.publish.refused")

    def _apply(self, worker_id: int, iteration: int, grads):
        t0 = time.perf_counter()
        result = self.core.receive_gradients(worker_id, iteration, grads)
        self._obs_apply.observe(time.perf_counter() - t0)
        return result

    def _commit(self, sink: PushSink):
        """End-of-stream commit of a chunk-folded push (the folds were
        timed inside the stream, overlapping transport)."""
        t0 = time.perf_counter()
        result = sink.commit()
        self._obs_apply.observe(time.perf_counter() - t0)
        return result

    @staticmethod
    def _push_result_response(result) -> m.PushResponse:
        return m.PushResponse(
            success=result.success,
            message=result.message,
            iteration=result.iteration,
            aggregation_complete=result.aggregation_complete,
            workers_received=result.workers_received,
            total_workers=result.total_workers,
        )

    # RPC: push gradients (reference: src/parameter_server_service.cpp:32-59)
    def ReceiveGradients(self, request: m.GradientUpdate,
                         context) -> m.PushResponse:
        grads = decode_gradients(request.gradients, self.core.device_fold())
        result = self._apply(request.worker_id, request.iteration, grads)
        return self._push_result_response(result)

    # RPC: pull parameters (reference: src/parameter_server_service.cpp:62-84),
    # in the encoding the client asked for (PullRequest.wire_dtype, an
    # extension; reference clients leave it 0 = repeated float)
    @staticmethod
    def _serve_wire_dtype(requested: int) -> int:
        """The lossy push encodings (int8, topk) are never applied to
        served parameters: re-compressing them every pull compounds
        error.  Served as bf16 instead."""
        if requested in (m.WIRE_INT8, m.WIRE_TOPK):
            return m.WIRE_BF16
        return requested

    @staticmethod
    def _cache_build_wait_s() -> float:
        """How long a concurrent serve waits for an in-flight cache build
        before encoding on its own; below the worker's 30 s pull
        deadline."""
        return float(os.environ.get("PSDT_SERVE_CACHE_WAIT_S", "20"))

    def _encode_chunk_bodies(self, request_iteration: int, eff_dtype: int,
                             budget: int):
        """One real encode: (chunk bodies, store version).  The per-chunk
        encodes fan out across the stripe executor."""
        t0 = time.perf_counter()
        _, params, _, version = self.core.serve_view(request_iteration)
        tensors = to_wire(params, wire_dtype=eff_dtype)
        bodies = encode_parameter_record_groups(
            list(split_tensors(tensors, budget)),
            stripes=self.core.stripes)
        self._obs_encode.observe(time.perf_counter() - t0)
        return bodies, version

    def _serve_key(self, wire_dtype: int) -> tuple:
        eff = self._serve_wire_dtype(wire_dtype)
        budget = stream_chunk_bytes() or (32 << 20)
        return (self.core.serve_version(), eff, budget)

    def _wait_for_builder(self, entry: _ServeCacheEntry,
                          key: tuple) -> tuple[list[bytes], bool, int]:
        """Non-builder path: (bodies, cached, version).  Replays the
        builder's bytes, or encodes the live store itself if the builder
        failed or stalled."""
        if entry.event.wait(self._cache_build_wait_s()) and not entry.failed:
            self._obs_cache_hit.add()
            return entry.bodies, True, entry.version
        self._obs_cache_miss.add()
        bodies, version = self._encode_chunk_bodies(0, key[1], key[2])
        return bodies, False, version

    def _encoded_parameter_chunks(self, request_iteration: int,
                                  wire_dtype: int) -> list[bytes]:
        return self._encoded_chunks_versioned(request_iteration,
                                              wire_dtype)[0]

    def _encoded_chunks_versioned(self, request_iteration: int,
                                  wire_dtype: int
                                  ) -> tuple[list[bytes], int]:
        """The encoded chunk bodies through the encode-once cache, and the
        store version they were encoded at (the delta protocol stamps it
        as the receiver's base, so it labels the bytes, not the probe).
        A waiter woken from a builder re-probes the version (the store
        may have moved meanwhile), a few times at most."""
        for _ in range(3):
            key = self._serve_key(wire_dtype)
            entry, builder = self._serve_cache.lookup(key)
            if builder:
                self._obs_cache_miss.add()
                try:
                    bodies, version = self._encode_chunk_bodies(
                        request_iteration, key[1], key[2])
                except BaseException:
                    self._serve_cache.fail(key, entry)
                    raise
                self._serve_cache.fill(key, entry, bodies, version)
                return bodies, version
            bodies, cached, version = self._wait_for_builder(entry, key)
            if not cached or self.core.serve_version() == key[0]:
                return bodies, version
        return bodies, version

    def ServeParameters(self, request: m.PullRequest, context):
        t0 = time.perf_counter()
        # the label is read before the bodies: bytes may be newer than
        # their label, never older
        iteration = self.core.current_iteration
        bodies = self._encoded_parameter_chunks(request.iteration,
                                                request.wire_dtype)
        resp = PreEncodedParameterUpdate(iteration, True, bodies)
        self._obs_serve.observe(time.perf_counter() - t0)
        return resp

    # RPC (extension, rpc/data_plane.py): client-streamed push.  Chunks
    # fold into the accumulator as they arrive; the worker becomes a
    # barrier contributor only at the end-of-stream commit.
    def PushGradientsStream(self, request_iterator, context) -> m.PushResponse:
        sink: PushSink | None = None
        for chunk in request_iterator:
            if sink is None:
                sink = self.core.begin_push(chunk.worker_id, chunk.iteration)
            if chunk.gradients:
                sink.fold(decode_gradients(chunk.gradients,
                                           self.core.device_fold()))
        if sink is None:
            return m.PushResponse(success=False, message="empty push stream")
        return self._push_result_response(self._commit(sink))

    def _parameter_chunks(self, request_iteration: int, wire_dtype: int):
        """The current store as a stream of ParameterUpdate chunks, from
        the encode-once cache.  The builder encodes every chunk before
        the first goes out, so no slow first puller paces the cache for
        the rest of the fan-out."""
        iteration = self.core.current_iteration
        bodies = self._encoded_parameter_chunks(request_iteration,
                                                wire_dtype)
        if not bodies:  # an empty store still answers one (empty) chunk
            yield PreEncodedParameterUpdate(iteration, True, ())
            return
        for body in bodies:
            yield PreEncodedParameterUpdate(iteration, True, (body,))

    # RPC (extension): server-streamed pull.
    def ServeParametersStream(self, request: m.PullRequest, context):
        yield from self._parameter_chunks(request.iteration,
                                          request.wire_dtype)

    # The server-side cap on the fused barrier park, below the worker's
    # fused call timeout: a stuck barrier answers a clean ready=False
    # frame (the worker falls back to polling), not a DEADLINE_EXCEEDED.
    @staticmethod
    def _fused_barrier_timeout_s() -> float:
        return float(os.environ.get("PSDT_FUSED_BARRIER_TIMEOUT_S", "60"))

    # RPC (extension, rpc/data_plane.py): the fused synchronous step.
    # Streamed gradient chunks fold as they arrive and commit as ONE push;
    # the handler then parks on the barrier and streams the fresh store
    # back the moment it closes.
    def PushPullStream(self, request_iterator, context):
        # A fused push never seeds an empty store: the bootstrap rule (the
        # first mean BECOMES the params) is for the worker's deliberate
        # init, which rides the plain push.  A fused gradient push can
        # only meet an empty store after a PS restart under a worker
        # holding cached params; refusing makes it re-pull and re-seed.
        empty_store = not self.core.has_parameters
        sink: PushSink | None = None
        pull_wire_dtype = 0
        for chunk in request_iterator:
            if empty_store and chunk.gradients:
                yield m.PushPullResponse(push=m.PushResponse(
                    success=False,
                    message="parameter store empty: fused push refused "
                            "(re-pull and seed init via the push path)",
                    iteration=self.core.current_iteration))
                return
            if sink is None:
                sink = self.core.begin_push(chunk.worker_id, chunk.iteration)
                pull_wire_dtype = chunk.pull_wire_dtype
            if chunk.gradients:
                sink.fold(decode_gradients(chunk.gradients,
                                           self.core.device_fold()))
        if sink is None:
            yield m.PushPullResponse(push=m.PushResponse(
                success=False, message="empty push stream"))
            return
        worker_id, iteration = sink.worker_id, sink.iteration
        result = self._commit(sink)
        # the verdict goes out at once: a stale rejection (async mode)
        # must not wait on any barrier
        yield m.PushPullResponse(push=self._push_result_response(result))
        if not result.success:
            return
        if not result.aggregation_complete:
            t0 = time.perf_counter()
            ready, received, total = self.core.wait_for_aggregation(
                iteration, timeout=self._fused_barrier_timeout_s())
            self._obs_barrier.observe(time.perf_counter() - t0)
            if not ready:
                log.warning(
                    "PushPullStream: barrier timeout at iteration %d "
                    "(%d/%d received); worker %d falls back to polling",
                    iteration, received, total, worker_id)
                yield m.PushPullResponse(params=m.ParameterUpdate(
                    iteration=self.core.current_iteration, ready=False))
                return
        t0 = time.perf_counter()
        for chunk in self._parameter_chunks(iteration, pull_wire_dtype):
            yield m.PushPullResponse(params=chunk)
        self._obs_serve.observe(time.perf_counter() - t0)

    # ------------------------------------------------------------ delta serve
    def _arm_delta(self) -> None:
        """Make the chain the core's delta sink, once, on the first
        request that can take a delta.  Armed without a seed: traffic
        flows by now, and a snapshot outside the apply serialization
        could tear against an apply; the next apply reseeds the chain
        (one more full serve, never a wrong base).  A double arm installs
        the same sink twice, harmlessly."""
        if self._delta_armed or self.delta_chain is None:
            return
        self._delta_armed = True
        self.core.set_delta_sink(self.delta_chain, seed=False)
        log.info("delta chain armed: applies now build version pairs")

    def _delta_serve(self, held_version: int, wire_dtype: int,
                     request_iteration: int) -> tuple[list, int]:
        """The frames answering a receiver that holds ``held_version``,
        and the version they end at: the encoded pairs since then when
        the receiver is within the depth and its encoding matches the
        chain's, else a version-stamped full serve (no base, past the
        depth, across a restore, another encoding)."""
        held = int(held_version)
        eff = self._serve_wire_dtype(wire_dtype)
        budget = stream_chunk_bytes() or (32 << 20)
        chain = self.delta_chain
        current = self.core.serve_version()
        pairs = None
        if (chain is not None
                and wire_dtype_compatible(eff, chain.wire_dtype)):
            self._arm_delta()   # a receiver that can take deltas exists
            if held > 0:
                # the close publishes its store before the chain notes
                # it: a serve in between waits for the pair
                chain.wait_built(current, self._cache_build_wait_s())
                pairs = chain.pairs_between(held, current)
        if pairs is not None:
            frames: list = []
            nbytes = 0
            for pair in pairs:
                for body in self._delta_cache.get(pair, chain.wire_dtype,
                                                  budget):
                    frames.append(dmsg.EncodedDeltaFrame(body))
                    nbytes += len(body)
            self._obs_delta_hit.add()
            self._obs_delta_bytes.add(nbytes)
            return frames, pairs[-1].to_version
        self._obs_delta_miss.add()
        # the label is read before the bodies (see ServeParameters)
        iteration = self.core.current_iteration
        bodies, version = self._encoded_chunks_versioned(request_iteration,
                                                         wire_dtype)
        if not bodies:   # an empty store still answers one (empty) chunk
            return [dmsg.DeltaFrame(
                params=PreEncodedParameterUpdate(iteration, True, ()),
                to_version=version, last=True)], version
        return [dmsg.DeltaFrame(
                    params=PreEncodedParameterUpdate(iteration, True,
                                                     (body,)),
                    to_version=version, last=(i == len(bodies) - 1))
                for i, body in enumerate(bodies)], version

    # RPC (extension, delta/): the version-aware pull
    def PullParametersDelta(self, request: dmsg.DeltaPullRequest, context):
        t0 = time.perf_counter()
        frames, _ = self._delta_serve(request.held_version,
                                      request.wire_dtype, request.iteration)
        self._obs_serve.observe(time.perf_counter() - t0)
        yield from frames

    # RPC (extension, delta/): the version-aware fused round, as
    # PushPullStream, its answer DeltaFrames (a delta chain for a
    # receiver within the depth)
    def PushPullDeltaStream(self, request_iterator, context):
        empty_store = not self.core.has_parameters
        sink: PushSink | None = None
        pull_wire_dtype = 0
        held_version = 0
        for dchunk in request_iterator:
            chunk = dchunk.update
            if chunk is None:
                continue
            if empty_store and chunk.gradients:
                # PushPullStream's bootstrap refusal, as a frame
                yield dmsg.DeltaFrame(push=m.PushResponse(
                    success=False,
                    message="parameter store empty: fused push refused "
                            "(re-pull and seed init via the push path)",
                    iteration=self.core.current_iteration))
                return
            if sink is None:
                sink = self.core.begin_push(chunk.worker_id, chunk.iteration)
                pull_wire_dtype = chunk.pull_wire_dtype
                held_version = int(dchunk.held_version)
            if chunk.gradients:
                sink.fold(decode_gradients(chunk.gradients,
                                           self.core.device_fold()))
        if sink is None:
            yield dmsg.DeltaFrame(push=m.PushResponse(
                success=False, message="empty push stream"))
            return
        worker_id, iteration = sink.worker_id, sink.iteration
        result = self._commit(sink)
        yield dmsg.DeltaFrame(push=self._push_result_response(result))
        if not result.success:
            return
        if not result.aggregation_complete:
            t0 = time.perf_counter()
            ready, received, total = self.core.wait_for_aggregation(
                iteration, timeout=self._fused_barrier_timeout_s())
            self._obs_barrier.observe(time.perf_counter() - t0)
            if not ready:
                log.warning(
                    "PushPullDeltaStream: barrier timeout at iteration %d "
                    "(%d/%d received); worker %d falls back to polling",
                    iteration, received, total, worker_id)
                yield dmsg.DeltaFrame(params=m.ParameterUpdate(
                    iteration=self.core.current_iteration, ready=False))
                return
        t0 = time.perf_counter()
        frames, _ = self._delta_serve(held_version, pull_wire_dtype,
                                      iteration)
        self._obs_serve.observe(time.perf_counter() - t0)
        yield from frames

    # How often a parked subscription re-checks that its client and the
    # server are still there; a new version wakes it at once.
    @staticmethod
    def _subscribe_poll_s() -> float:
        return float(os.environ.get("PSDT_SUBSCRIBE_POLL_S", "0.5"))

    # The live-subscription bound: each parks one handler thread, and the
    # server's pool has room for this many beside the data plane, so a
    # subscriber past it would take the thread of the push that closes a
    # barrier; it is refused RESOURCE_EXHAUSTED and backs off.
    @staticmethod
    def _max_subscribers() -> int:
        return int(os.environ.get("PSDT_MAX_SUBSCRIBERS", "8"))

    def delta_report(self) -> dict:
        """The delta plane's state for an exit report: armed or not, and
        the (version, crc, wall time) of the last versions the chain
        noted."""
        chain = self.delta_chain
        return {"enabled": chain is not None, "armed": self._delta_armed,
                "published": ([list(p) for p in chain.published]
                              if chain is not None else [])}

    def close_subscriptions(self) -> None:
        """Parked subscriptions return at their next wake (server stop)."""
        self._closing.set()

    # RPC (extension, delta/): live weight publication, a frame batch a
    # store version from the subscriber's held version on (full first
    # when it holds nothing or fell behind), until it cancels or the
    # server stops
    def SubscribeWeights(self, request: dmsg.SubscribeRequest, context):
        with self._sub_lock:
            live = self._active_subscribers
            admitted = live < self._max_subscribers()
            if admitted:
                self._active_subscribers += 1
        if not admitted:
            self._obs_sub_refused.add()
            log.warning("SubscribeWeights refused: %d live subscriptions "
                        "at PSDT_MAX_SUBSCRIBERS=%d (subscriber %d backs "
                        "off)", live, self._max_subscribers(),
                        request.subscriber_id)
            if context is not None:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              "subscriber limit reached "
                              f"({self._max_subscribers()}); retry later")
            return
        try:
            held = int(request.held_version)
            chain = self.delta_chain
            if chain is not None and wire_dtype_compatible(
                    self._serve_wire_dtype(request.wire_dtype),
                    chain.wire_dtype):
                # a standing delta receiver: build pairs from now on
                self._arm_delta()
            while ((context is None or context.is_active())
                   and not self._closing.is_set()):
                current = self.core.serve_version()
                if current > held and self.core.has_parameters:
                    frames, end = self._delta_serve(held,
                                                    request.wire_dtype, 0)
                    yield from frames
                    if end > held:
                        held = end
                        continue
                    # a serve labelled at or before the held version
                    # delivered nothing new: park instead of spinning
                if chain is not None:
                    chain.wait_for_newer(held, self._subscribe_poll_s())
                else:
                    time.sleep(self._subscribe_poll_s())
        finally:
            with self._sub_lock:
                self._active_subscribers -= 1

    # RPC (extension, rpc/shm_transport.py): same-host transport
    # negotiation for the fused data plane
    def NegotiateShm(self, request: shm_transport.ShmNegotiateRequest,
                     context) -> shm_transport.ShmNegotiateResponse:
        return self.shm_server.negotiate(request)

    # RPC: barrier poll (reference: src/parameter_server_service.cpp:85-95)
    def CheckSyncStatus(self, request: m.SyncStatusRequest,
                        context) -> m.SyncStatusResponse:
        iteration, ready, received, total = self.core.check_sync_status(
            request.iteration)
        return m.SyncStatusResponse(iteration=iteration, ready=ready,
                                    workers_received=received,
                                    total_workers=total)

    # RPC: on-demand save (reference: src/parameter_server_service.cpp:97-115)
    def SaveCheckpoint(self, request: m.SaveCheckpointRequest,
                       context) -> m.SaveCheckpointResponse:
        try:
            saved = self.ckpt.save(
                epoch=request.epoch if request.epoch else None,
                path=request.path or None)
            return m.SaveCheckpointResponse(success=True,
                                            message="checkpoint saved",
                                            checkpoint_path=saved)
        except Exception as exc:  # noqa: BLE001 — reported over RPC
            log.exception("SaveCheckpoint failed")
            return m.SaveCheckpointResponse(success=False, message=str(exc))

    # The reference ships the loaded params back
    # (src/parameter_server_service.cpp:126-137) though its worker
    # discards them; above this cap the echo is left out, so a large
    # store's load never fails on the 1 GB message limit after it
    # succeeded.
    @staticmethod
    def _echo_max_bytes() -> int:
        return int(os.environ.get("PSDT_CKPT_ECHO_MAX_BYTES",
                                  str(256 << 20)))

    # RPC: load into the PS (reference: src/parameter_server_service.cpp:118-148)
    def LoadCheckpoint(self, request: m.LoadCheckpointRequest,
                       context) -> m.LoadCheckpointResponse:
        try:
            epoch, _iteration = self.ckpt.load(request.path)
            _, params, _ = self.core.serve_parameters()
            nbytes = sum(4 * _numel(v) for v in params.values())
            if nbytes > self._echo_max_bytes():
                return m.LoadCheckpointResponse(
                    success=True,
                    message="checkpoint loaded (parameter echo omitted: "
                            "store exceeds the unary response cap; pull "
                            "via ServeParameters)",
                    epoch=epoch)
            return m.LoadCheckpointResponse(success=True,
                                            message="checkpoint loaded",
                                            epoch=epoch,
                                            parameters=to_wire(params))
        except Exception as exc:  # noqa: BLE001 — reported over RPC
            log.exception("LoadCheckpoint failed")
            return m.LoadCheckpointResponse(success=False, message=str(exc))


class _EpochSaver:
    """The PS's checkpoints: one file per epoch, ``iteration //
    checkpoint_interval``, as the reference's daemon writes, but taken at
    the apply that advanced the epoch, not when a periodic check next
    sees it, so ``checkpoint_epoch_<N>`` holds the store and optimizer
    state of that apply whatever the round does meanwhile.  The core's
    apply hook runs on the applying thread under the core's state lock:
    it takes the state there (``checkpoint_state_locked``: references and
    device copies, no download) and queues it, and this thread downloads
    and writes it while the round goes on.  One state waits at most: an
    apply that finds one still queued blocks until this thread takes it,
    which bounds the memory the copies hold."""

    def __init__(self, core: ParameterServerCore, ckpt: CheckpointManager,
                 interval: int):
        self._core = core
        self._ckpt = ckpt
        self._interval = max(1, int(interval))
        self._queue: "queue.Queue[tuple | None]" = queue.Queue(maxsize=1)
        self._last_epoch = -1
        self._failed = obs_stats.counter("ps.checkpoint.failed")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def hook(self, iteration: int) -> None:
        epoch = iteration // self._interval
        if epoch <= self._last_epoch:
            return
        self._last_epoch = epoch
        self._queue.put((epoch, self._core.checkpoint_state_locked()))

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            epoch, state = item
            try:
                self._ckpt.write(state, epoch)
            except Exception:  # noqa: BLE001 — counted; the round goes on
                self._failed.add()
                log.exception("checkpoint of epoch %d failed", epoch)

    def stop(self) -> None:
        """Finish the queued saves, then end the thread."""
        self._queue.put(None)
        self._thread.join(timeout=120.0)


class ParameterServer:
    """Process-level assembly: core + checkpoint writer + gRPC server
    (reference: run_server at src/parameter_server_service.cpp:177-191).
    The optimizer runs on ``config.device`` (the card unless "cpu");
    without a card and without that request construction raises."""

    def __init__(self, config: ParameterServerConfig):
        self.config = config
        self.device = resolve_device(config.device)
        self.optimizer = make_optimizer(config.optimizer,
                                        config.learning_rate,
                                        config.momentum, config.weight_decay,
                                        device=self.device)
        self.core = ParameterServerCore(
            total_workers=config.total_workers,
            optimizer=self.optimizer,
            staleness_bound=config.staleness_bound,
            gc_iterations=config.gc_iterations,
            aggregation=config.aggregation or None,
        )
        self.ckpt = CheckpointManager(
            self.core,
            directory=config.checkpoint_dir,
            checkpoint_interval=config.checkpoint_interval,
            keep=config.checkpoint_keep,
        )
        self.service = ParameterServerService(self.core, self.ckpt)
        self._saver: _EpochSaver | None = None
        self._server: grpc.Server | None = None

    def start(self) -> int:
        """Start serving; returns the bound port (0 in config = ephemeral)."""
        # the fused data plane parks one handler thread per
        # barrier-waiting worker, so the pool must exceed the barrier
        # width or the push that would close it queues behind them; each
        # admitted subscription parks one more between versions
        delta = self.service.delta_chain is not None
        self._server = make_server(
            max_workers=max(8, 2 * self.config.total_workers + 8
                            + (self.service._max_subscribers() if delta
                               else 0)))
        bind_service(self._server, m.PARAMETER_SERVER_SERVICE,
                     {**m.PARAMETER_SERVER_METHODS,
                      **m.PARAMETER_SERVER_STREAM_METHODS,
                      **shm_transport.SHM_METHODS,
                      **(dmsg.DELTA_PS_METHODS if delta else {})},
                     self.service)
        addr = f"{self.config.bind_address}:{self.config.port}"
        port = self._server.add_insecure_port(addr)
        if port == 0:
            raise RuntimeError(f"could not bind {addr}")
        self._saver = _EpochSaver(self.core, self.ckpt,
                                  self.config.checkpoint_interval)
        self.core.set_apply_hook(self._saver.hook)
        self._server.start()
        log.info("parameter server listening on %s (total_workers=%d, "
                 "checkpoint_interval=%d, optimizer=%s on %s)", addr,
                 self.config.total_workers, self.config.checkpoint_interval,
                 self.config.optimizer, self.device)
        return port

    def wait(self) -> None:
        assert self._server is not None
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        # handlers parked on the barrier return first (not ready), so the
        # shm connection threads can be joined and their segments
        # released, and no gRPC handler holds the exit to the barrier
        # timeout; then the rings close, which wakes threads parked on a
        # ring or a doorbell
        self.core.release_waiters()
        self.service.close_subscriptions()
        self.service.shm_server.close()
        if self._server is not None:
            self._server.stop(grace).wait()
        if self._saver is not None:
            self.core.set_apply_hook(None)
            self._saver.stop()
