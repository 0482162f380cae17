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

Registered: ``ReceiveGradients``, ``ServeParameters``, ``CheckSyncStatus``,
``SaveCheckpoint``, ``LoadCheckpoint``, the streams
``PushGradientsStream``, ``ServeParametersStream`` and ``PushPullStream``,
and ``NegotiateShm``.  Not registered, so answered UNIMPLEMENTED: the
delta RPCs and ``SubscribeWeights`` (ROADMAP.md Queue 1, item 12), and
the replication and sharded-update RPCs (item 13).  The JAX package's
clients fall back on each of them by themselves.

Timings land in the port's obs registry: ``ps.apply_s`` (fold commit and
apply, net of RPC plumbing), ``ps.serve_s``, ``ps.barrier_wait_s`` (how
long fused handlers park on the barrier), the cache's
``ps.serve.cache_hit`` / ``ps.serve.cache_miss`` and ``ps.serve.encode_s``
(one encode of the store, the part of a serve that is not transfer); the
core adds ``ps.barrier_close_s``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time

import grpc
import torch

from ..checkpoint.manager import CheckpointManager
from ..config import ParameterServerConfig
from ..core.optimizer import make_optimizer
from ..core.ps_core import ParameterServerCore, PushSink
from ..core.tensor import from_wire, to_wire
from ..device import resolve_device
from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc import shm_transport
from ..rpc.data_plane import (PreEncodedParameterUpdate,
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
        grads = from_wire(request.gradients)
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
                          key: tuple) -> tuple[list[bytes], bool]:
        """Non-builder path: (bodies, cached).  Replays the builder's
        bytes, or encodes the live store itself if the builder failed or
        stalled."""
        if entry.event.wait(self._cache_build_wait_s()) and not entry.failed:
            self._obs_cache_hit.add()
            return entry.bodies, True
        self._obs_cache_miss.add()
        bodies, _version = self._encode_chunk_bodies(0, key[1], key[2])
        return bodies, False

    def _encoded_parameter_chunks(self, request_iteration: int,
                                  wire_dtype: int) -> list[bytes]:
        """The encoded chunk bodies through the encode-once cache.  A
        waiter woken from a builder re-probes the version (the store may
        have moved meanwhile), a few times at most."""
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
                return bodies
            bodies, cached = self._wait_for_builder(entry, key)
            if not cached or self.core.serve_version() == key[0]:
                return bodies
        return bodies

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
                sink.fold(from_wire(chunk.gradients))
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
                sink.fold(from_wire(chunk.gradients))
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
        optimizer = make_optimizer(config.optimizer, config.learning_rate,
                                   config.momentum, config.weight_decay,
                                   device=self.device)
        self.core = ParameterServerCore(
            total_workers=config.total_workers,
            optimizer=optimizer,
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
        # width or the push that would close it queues behind them
        self._server = make_server(
            max_workers=max(8, 2 * self.config.total_workers + 8))
        bind_service(self._server, m.PARAMETER_SERVER_SERVICE,
                     {**m.PARAMETER_SERVER_METHODS,
                      **m.PARAMETER_SERVER_STREAM_METHODS,
                      **shm_transport.SHM_METHODS}, self.service)
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
        self.service.shm_server.close()
        if self._server is not None:
            self._server.stop(grace).wait()
        if self._saver is not None:
            self.core.set_apply_hook(None)
            self._saver.stop()
