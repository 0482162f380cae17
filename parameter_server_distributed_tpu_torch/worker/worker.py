"""Worker runtime: discovery, registration, heartbeats, the train loop —
the port of ``Worker`` from parameter_server_distributed_tpu/worker/worker.py.

Protocol behaviour, as the reference's (src/worker.cpp, include/worker.h):

- discovery: ask the coordinator for the PS address, then register
  (reference: src/worker.cpp:108-122, 141-186);
- ``query_with_retry``: up to 5 attempts, exponential backoff 100 ms * 2^n
  (reference: src/worker.cpp:129-139);
- a heartbeat thread every 5 s reporting WorkerStatus (reference:
  src/worker.cpp:231-238), re-registering when the coordinator no longer
  knows the worker;
- ``run_iteration``: pull -> compute -> push -> poll the sync status
  every 50 ms up to 200 polls, 3 outer retries (reference:
  src/worker.cpp:331-406).  Against a PS that speaks the streaming data
  plane (the port's or the JAX package's) the communication tail is ONE
  fused ``PushPullStream`` round: the gradients stream out of a
  ``GradientBuckets`` (the trainer's bucketed download), the returned
  parameters are kept for the next iteration's "pull", and the next
  batch prefetches meanwhile.  Against a reference PS every leg falls
  back to the serial unary protocol (rpc/data_plane.py).  Pulls and
  fused rounds are version aware first (delta/): the worker names the
  store version it holds and the PS answers the changed bytes, applied
  in place to its cached pull; the connection falls back to the plain
  protocol by itself;
- a checkpoint restore request at startup (reference:
  src/worker.cpp:289-314).

As in the JAX package, gradients come from a real model step, and a PS
holding no parameters is seeded with the deterministic init
``trainer.init_params(seed=0)`` (each worker pushes the same init; the
PS adopts the first mean).  A torch init is not the JAX package's, so a
fleet that mixes the two packages' workers starts from a store its
caller initialises.  The expected parameter names come from the model's
``param_shapes()``, not from an init, which at llama_350m would build and
download 1.34 GB.

Per iteration the worker times its phases into the obs registry
(``worker.<phase>_s``) and into one ``PSDT_METRICS_FILE`` record (``%d``
in the path becomes the worker id): ``step_time_s``, ``pull_s``,
``data_s``, ``compute_s``, ``fused_s``, ``push_s``, ``barrier_wait_s``,
and for a bucketed step ``dtoh_ms`` (the copies' device time) and
``dtoh_wait_s``.

A PS sharded over several processes (the coordinator's ``--ps-shards``)
is discovered as the JAX worker discovers it: the coordinator's shard map
(``GetShardMap``) when it lists more than one primary, else field 3 of
the discovery answer, builds a ``ShardedPSClient`` (worker/ps_shards.py)
that fans every push and pull out per tensor owner; one address builds
the single-PS ``PSClient``.  A sharded round drains the trainer's
bucketed download once, then pushes each shard its partition; deltas are
the single-PS connection's (the sharded client has none, and the worker
takes the plain rounds).  A partial pull (a shard restarted empty) asks
the shard map again first, then reseeds only the missing names, so a
restarted shard is reseeded alone.

Not ported: the tier client and error feedback of lossy pushes (ROADMAP.md
Queue 1, item 10), membership and drain (item 11), failover, promotion,
backups and resharding (item 13), flight events and the heartbeat's
metric snapshot (item 14), and the free-running loop (item 11).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import socket
import threading
import time
from typing import Callable, Iterator

import grpc
import numpy as np

from ..config import WorkerConfig
from ..core.tensor import TensorStore, from_wire, to_wire
from ..obs import stats as obs_stats
from ..replication.failover import ShardMapClient
from ..rpc import messages as m
from ..rpc.data_plane import PSClient
from ..rpc.service import RpcClient
from .ps_shards import ShardedPSClient

log = logging.getLogger("pst.worker")

ROADMAP_TIERS = "ROADMAP.md Queue 1, item 10 (tiers and error feedback)"

_PHASES = ("step", "data", "pull", "compute", "push", "fused",
           "barrier_wait")


class WorkerError(RuntimeError):
    pass


class Worker:
    def __init__(self, config: WorkerConfig, trainer,
                 batches: Iterator, start_heartbeat: bool = True):
        if config.wire_dtype not in m.WIRE_DTYPE_NAMES:
            raise ValueError(
                f"unknown wire_dtype {config.wire_dtype!r}; "
                f"options: {sorted(m.WIRE_DTYPE_NAMES)}")
        if config.wire_dtype in ("int8", "topk"):
            # the JAX package pairs lossy pushes with error feedback (on
            # by default); a push without it would be another result
            raise NotImplementedError(
                f"wire_dtype {config.wire_dtype!r} pushes need error "
                f"feedback: {ROADMAP_TIERS}")
        self.config = config
        self.trainer = trainer
        self.batches = batches
        self.status = m.WorkerStatus.IDLE
        self.iteration = -1  # last completed iteration
        self.last_loss = float("nan")
        metrics_path = os.environ.get("PSDT_METRICS_FILE") or None
        self.metrics = obs_stats.MetricsLogger(
            metrics_path and metrics_path.replace("%d", str(config.worker_id)))
        self._obs_phase = {name: obs_stats.histogram(f"worker.{name}_s")
                           for name in _PHASES}
        self._times: dict[str, float] = {}   # this iteration's phases
        self._obs_retries = obs_stats.counter("rpc.client.retries")
        self._coordinator = RpcClient(config.coordinator_address,
                                      m.COORDINATOR_SERVICE,
                                      m.COORDINATOR_METHODS)
        self._ps: PSClient | ShardedPSClient | None = None
        self._ps_address: str | None = None
        self._total_workers = 0
        self._requested_wire_dtype = m.WIRE_DTYPE_NAMES[config.wire_dtype]
        self._reset_wire_negotiation()
        self.last_bootstrap = False  # True iff the last iteration seeded
        # the parameters the previous iteration's fused round delivered:
        # what a pull at the next iteration would return
        self._next_params: TensorStore | None = None
        self._expected_names: frozenset[str] | None = None
        # single-slot batch prefetch during communication
        self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"worker-{config.worker_id}-prefetch")
        self._prefetched: concurrent.futures.Future | None = None
        self._stop = threading.Event()
        self._heartbeat_thread: threading.Thread | None = None
        if start_heartbeat:
            self._heartbeat_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name=f"worker-{config.worker_id}-heartbeat")
            self._heartbeat_thread.start()

    # ------------------------------------------------------------ lifecycle
    def initialize(self) -> None:
        """Discover the PS and register (reference: src/worker.cpp:108-122)."""
        self._discover_parameter_server()
        self._register()

    def shutdown(self) -> None:
        if self._stop.is_set():
            return   # idempotent
        self._stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=10.0)
        self._prefetch_pool.shutdown(wait=True, cancel_futures=True)
        self._coordinator.close()
        if self._ps is not None:
            self._ps.close()

    # ------------------------------------------------------------ discovery
    def _discover_parameter_server(self) -> None:
        resp = self.query_with_retry(
            lambda: self._coordinator.call("GetParameterServerAddress",
                                           m.GetPSAddressRequest(),
                                           timeout=5.0))
        self._ps_address = f"{resp.address}:{resp.port}"
        if self._ps is not None:
            self._ps.close()
        # the coordinator's epoch-numbered shard map; a reference
        # coordinator answers UNIMPLEMENTED and the worker keeps the
        # discovery answer's topology
        shard_map = ShardMapClient(self.config.coordinator_address,
                                   worker_id=self.config.worker_id)
        primaries = shard_map.primaries() if shard_map.refresh() else []
        if len(primaries) > 1:
            self._ps = ShardedPSClient(primaries, shard_map=shard_map)
            log.info("worker %d: %d PS shards at %s (map epoch %d)",
                     self.config.worker_id, len(primaries), primaries,
                     shard_map.epoch)
        elif len(resp.shards) > 1:
            # the sharded store of field 3 (a coordinator without a map)
            shard_map.close()
            self._ps = ShardedPSClient(list(resp.shards))
            log.info("worker %d: %d PS shards at %s", self.config.worker_id,
                     len(resp.shards), list(resp.shards))
        else:
            shard_map.close()
            self._ps = PSClient(self._ps_address)
            log.info("worker %d: PS at %s", self.config.worker_id,
                     self._ps_address)
        self._reset_wire_negotiation()  # a new PS must re-prove packed support
        self._next_params = None        # cached params were the old PS's

    def _reset_wire_negotiation(self) -> None:
        """Packed pushes start only after the connected PS proves it honors
        the packed extension (its first non-empty pull served packed): a
        reference PS skips the extension fields, so packed pushes at it
        would aggregate empty gradients."""
        self._wire_dtype = self._requested_wire_dtype
        self._peer_packed_ok = self._wire_dtype == m.WIRE_F32

    def _pull_wire_dtype(self) -> int:
        """Encoding asked for served parameters."""
        return self._wire_dtype

    def _push_wire_dtype(self) -> int:
        return self._wire_dtype if self._peer_packed_ok else m.WIRE_F32

    def _register(self) -> None:
        info = m.WorkerInfo(worker_id=self.config.worker_id,
                            address=self.config.address,
                            port=self.config.port,
                            hostname=socket.gethostname())
        resp = self.query_with_retry(
            lambda: self._coordinator.call("RegisterWorker", info,
                                           timeout=5.0))
        if not resp.success:
            raise WorkerError(f"registration rejected: {resp.message}")
        self._total_workers = resp.total_workers
        log.info("worker %d registered (%d total)", self.config.worker_id,
                 resp.total_workers)

    # -------------------------------------------------------------- retries
    def query_with_retry(self, fn: Callable, attempts: int | None = None):
        """Exponential backoff wrapper (reference: src/worker.cpp:129-139)."""
        attempts = attempts or self.config.retry_max_attempts
        delay = self.config.retry_base_delay_s
        last_exc: Exception | None = None
        for attempt in range(attempts):
            try:
                return fn()
            except grpc.RpcError as exc:
                last_exc = exc
                self._obs_retries.add()
                if attempt < attempts - 1:
                    time.sleep(delay)
                    delay *= 2
        raise WorkerError(f"RPC failed after {attempts} attempts: {last_exc}")

    # ------------------------------------------------------------ heartbeat
    def _heartbeat_loop(self) -> None:
        """reference: src/worker.cpp:231-238, plus re-registration when
        the coordinator no longer knows this worker (evicted after a long
        stall, or a coordinator restart)."""
        while not self._stop.wait(self.config.heartbeat_period_s):
            ok = self.send_heartbeat()
            if ok is False and self._total_workers > 0:
                log.warning("worker %d: heartbeat rejected, re-registering",
                            self.config.worker_id)
                try:
                    self._register()
                except WorkerError as exc:
                    log.warning("worker %d: re-registration failed: %s",
                                self.config.worker_id, exc)

    def send_heartbeat(self) -> bool | None:
        """True = accepted, False = the coordinator does not know this
        worker, None = the coordinator is unreachable."""
        try:
            resp = self._coordinator.call(
                "Heartbeat",
                m.HeartbeatRequest(worker_id=self.config.worker_id,
                                   status=self.status),
                timeout=5.0)
            return resp.success
        except grpc.RpcError:
            return None

    # ------------------------------------------------------------ data plane
    def _time(self, phase: str, t0: float) -> None:
        dt = time.perf_counter() - t0
        self._obs_phase[phase].observe(dt)
        self._times[f"{phase}_s"] = self._times.get(f"{phase}_s", 0.0) + dt

    def pull_parameters(self, iteration: int) -> tuple[int, TensorStore]:
        """reference: src/worker.cpp:240-252."""
        t0 = time.perf_counter()
        try:
            return self._pull_parameters(iteration)
        finally:
            self._time("pull", t0)

    def _pull_parameters(self, iteration: int) -> tuple[int, TensorStore]:
        def attempt():
            # a fresh store per attempt: a failed attempt's chunks never
            # land in a retry's
            local: TensorStore = {}

            def convert_chunk(tensors) -> None:
                # f32 conversion per chunk as it arrives
                local.update(from_wire(tensors))

            # the version-aware pull first: the PS answers the changed
            # bytes; None = the plain protocol must run (a sharded client
            # has no delta pull)
            delta_pull = getattr(self._ps, "delta_pull", None)
            result = delta_pull(
                m.PullRequest(worker_id=self.config.worker_id,
                              iteration=iteration,
                              wire_dtype=self._pull_wire_dtype()),
                timeout=30.0) if delta_pull is not None else None
            if result is not None and result.store is not None:
                return result.update, result.store
            resp = self._ps.pull_parameters(
                m.PullRequest(worker_id=self.config.worker_id,
                              iteration=iteration,
                              wire_dtype=self._pull_wire_dtype()),
                timeout=30.0, on_chunk=convert_chunk)
            return resp, local

        resp, store = self.query_with_retry(attempt)
        if resp is None:
            # a delta-served pull carries no wire tensors: the packed
            # negotiation stands
            return iteration, store
        self._note_pull_tensors(resp.parameters)
        return (resp.iteration if resp.iteration else iteration), store

    def _note_pull_tensors(self, parameters) -> None:
        """Feed one pull response's tensor metadata into the packed-wire
        negotiation (every path that receives served parameters)."""
        if not self._peer_packed_ok and parameters:
            if any(t.packed_dtype != m.WIRE_F32 for t in parameters):
                self._peer_packed_ok = True
            else:
                log.warning(
                    "worker %d: PS does not support wire_dtype=%s, "
                    "falling back to f32", self.config.worker_id,
                    self.config.wire_dtype)
                self._wire_dtype = m.WIRE_F32
                self._peer_packed_ok = True
        elif self._peer_packed_ok and self._wire_dtype != m.WIRE_F32:
            # the proof was made against the previous process at this
            # address: an empty or unpacked pull (a restarted PS) resets it
            if not parameters or all(
                    t.packed_dtype == m.WIRE_F32 for t in parameters):
                log.warning(
                    "worker %d: pull no longer packed (PS restart?), "
                    "re-negotiating wire encoding", self.config.worker_id)
                self._reset_wire_negotiation()

    def push_gradients(self, iteration: int, grads) -> m.PushResponse:
        """reference: src/worker.cpp:254-272.  ``grads`` is a store or a
        :class:`GradientBuckets`; a retry replays the same payload, which
        the PS's per-(worker, tensor) first-push-wins fold counts once."""
        t0 = time.perf_counter()
        try:
            pairs = dict(grads.items() if hasattr(grads, "items") else grads)
            update = m.GradientUpdate(
                worker_id=self.config.worker_id, iteration=iteration,
                gradients=to_wire(pairs, self._push_wire_dtype()))
            return self.query_with_retry(
                lambda: self._ps.push_gradients(update, timeout=30.0))
        finally:
            self._time("push", t0)

    # -------------------------------------------------------- fused data plane
    def _use_fused(self) -> bool:
        return self.config.fused_step and self._ps is not None

    def _wire_tensors(self, grads):
        """Lazy wire-tensor producer for the fused push: ``grads`` is a
        mapping or a lazy ``(name, array)`` iterable (GradientBuckets,
        whose re-iteration replays its host cache); each call of the
        returned function yields the wire tensors one by one as the RPC
        sender consumes them, so download, encode and transport pipeline
        per bucket."""
        push_dtype = self._push_wire_dtype()

        def tensors():
            pairs = grads.items() if hasattr(grads, "items") else grads
            for name, g in pairs:
                yield m.Tensor.from_array(name, np.asarray(g, np.float32),
                                          wire_dtype=push_dtype)

        return tensors

    def _fused_push_pull(self, iteration: int,
                         grads) -> tuple[m.PushResponse, TensorStore | None]:
        """One fused push→barrier→pull round: the push verdict and the
        fresh store, or None for the store when the round did not deliver
        one (a reference PS, a server-side barrier timeout) — the caller
        then polls the barrier and pulls."""
        tensors_fn = self._wire_tensors(grads)

        def attempt():
            # the version-aware fused round first; None = the plain one
            # (deltas off or downgraded, or the rings preferred), and a
            # mid-round downgrade's replay below is exact (the PS's
            # per-(worker, tensor) dedup)
            delta_push_pull = getattr(self._ps, "delta_push_pull", None)
            result = delta_push_pull(
                self.config.worker_id, iteration, tensors_fn,
                pull_wire_dtype=self._pull_wire_dtype(),
                timeout=self.config.fused_timeout_s
            ) if delta_push_pull is not None else None
            if result is not None:
                push = (result.push if result.push is not None
                        else m.PushResponse(success=False,
                                            message="empty fused response"))
                return push, result.update, result.store

            local: TensorStore = {}

            def convert_chunk(chunk_tensors) -> None:
                local.update(from_wire(chunk_tensors))

            push, params = self._ps.push_pull(
                self.config.worker_id, iteration, tensors_fn,
                pull_wire_dtype=self._pull_wire_dtype(),
                timeout=self.config.fused_timeout_s,
                on_chunk=convert_chunk)
            return push, params, (local if params is not None else None)

        t0 = time.perf_counter()
        try:
            push, params, store = self.query_with_retry(attempt)
        finally:
            self._time("fused", t0)
        if store is None:
            return push, None
        if params is not None:
            # a delta-served round carries no wire tensors
            self._note_pull_tensors(params.parameters)
        return push, store

    # ---------------------------------------------------------- batch stream
    def _next_batch(self):
        """The prefetched batch when one is ready, else ``next()``."""
        if self._prefetched is not None:
            fut, self._prefetched = self._prefetched, None
            return fut.result()
        return next(self.batches)

    def _start_batch_prefetch(self) -> None:
        """Kick ``next(self.batches)`` on the prefetch thread, so data
        loading runs under the step's communication."""
        if self._prefetched is None and not self._stop.is_set():
            try:
                self._prefetched = self._prefetch_pool.submit(
                    next, self.batches)
            except RuntimeError:  # pool shut down mid-run
                self._prefetched = None

    def check_sync_ready(self, iteration: int) -> m.SyncStatusResponse:
        """reference: src/worker.cpp:274-287."""
        return self.query_with_retry(
            lambda: self._ps.call("CheckSyncStatus",
                                  m.SyncStatusRequest(iteration=iteration),
                                  timeout=5.0))

    def _refresh_topology_on_partial(self) -> bool:
        """A partial pull may mean the shard map moved tensors to shards
        this client does not know yet, rather than a shard restarted
        empty: ask the map again if the client has one.  True when a
        re-pull is worth trying; False = no map, go reseed."""
        refresh = getattr(self._ps, "refresh_topology", None)
        if refresh is None:
            return False
        try:
            refresh()
        except Exception:  # noqa: BLE001 — fall through to the reseed
            log.warning("worker %d: topology refresh failed",
                        self.config.worker_id, exc_info=True)
            return False
        shard_map = getattr(self._ps, "_shard_map", None)
        return shard_map is not None and shard_map.supported

    def _expected_param_names(self) -> frozenset[str]:
        """The model's full parameter-name set, from its shapes."""
        if self._expected_names is None:
            self._expected_names = frozenset(
                self.trainer.model.param_shapes())
        return self._expected_names

    def _seed_bootstrap(self, iteration: int, missing) -> float:
        """The PS store is empty (or partial): push the deterministic init
        for the missing names; the PS adopts the first mean, which for
        identical inits is the init.  Rides the plain push path: the
        fused round refuses to seed an empty store."""
        init = self.trainer.init_params(seed=0)
        if missing:
            self._reset_wire_negotiation()
            init = {name: init[name] for name in missing}
            log.warning("worker %d: pull missing %d tensors, re-seeding "
                        "the deterministic init", self.config.worker_id,
                        len(missing))
        else:
            log.info("worker %d: PS empty, pushing deterministic init",
                     self.config.worker_id)
        push = self.push_gradients(iteration, init)
        if not push.success:
            raise WorkerError(f"bootstrap push rejected: {push.message}")
        if not push.aggregation_complete:
            self._await_barrier(iteration)
        self.iteration = iteration
        self.last_bootstrap = True
        return float("nan")

    # ------------------------------------------------------------ train loop
    def run_iteration(self, iteration: int) -> float:
        """One synchronous training step (reference: src/worker.cpp:331-406
        is pull -> compute -> push -> 50 ms barrier polls); returns the
        loss.  Against a PS with the streaming data plane the tail is one
        fused round whose response delivers the next iteration's
        parameters; against a reference PS each leg is the serial unary
        protocol."""
        self.status = m.WorkerStatus.TRAINING
        self.last_bootstrap = False
        self._times = {}
        t_step = time.perf_counter()
        try:
            params, self._next_params = self._next_params, None
            if params is None:
                _, params = self.pull_parameters(iteration)
            missing = (self._expected_param_names() - set(params)
                       if params else set())
            for _ in range(3 if missing else 0):
                # the missing tensors may have moved with the shard map
                # rather than been lost: ask the map and pull again (a
                # few times) before concluding a shard restarted empty
                if not self._refresh_topology_on_partial():
                    break
                _, params = self.pull_parameters(iteration)
                missing = (self._expected_param_names() - set(params)
                           if params else set())
                if not missing:
                    break
                time.sleep(0.3)
            if not params or missing:
                return self._seed_bootstrap(iteration, missing)

            effective_it = iteration
            fused = self._use_fused()
            incremental = fused and hasattr(self.trainer,
                                            "compute_gradient_buckets")
            fresh: TensorStore | None = None
            for attempt in range(3):
                t0 = time.perf_counter()
                batch = self._next_batch()
                self._time("data", t0)
                t1 = time.perf_counter()
                if incremental:
                    # the gradients stay on the card; .loss waits for the
                    # step and bucket 0, the rest download inside the
                    # fused round
                    grads = self.trainer.compute_gradient_buckets(params,
                                                                  batch)
                    loss = grads.loss
                else:
                    grads, loss = self.trainer.compute_gradients(params,
                                                                 batch)
                self._time("compute", t1)
                self.last_loss = loss
                self._start_batch_prefetch()

                if fused:
                    push, fresh = self._fused_push_pull(effective_it, grads)
                else:
                    push = self.push_gradients(effective_it, grads)
                if incremental:
                    self._times["dtoh_ms"] = grads.dtoh_ms
                    self._times["dtoh_wait_s"] = grads.wait_s
                if push.success:
                    break
                if "stale" in push.message and attempt < 2:
                    # bounded-staleness rejection (async mode): fast-forward
                    # to the PS's iteration, re-pull, recompute, retry
                    log.info("worker %d: stale at iteration %d, "
                             "fast-forwarding to %d", self.config.worker_id,
                             effective_it, push.iteration)
                    effective_it = max(push.iteration, effective_it + 1)
                    _, params = self.pull_parameters(effective_it)
                    continue
                if fused and "store empty" in push.message:
                    # the PS restarted empty under our cached params and
                    # refused a fused gradient push: re-pull, and seed if
                    # it is still empty
                    log.warning("worker %d: fused push refused (PS store "
                                "empty), re-pulling to re-seed",
                                self.config.worker_id)
                    self._reset_wire_negotiation()
                    _, params = self.pull_parameters(effective_it)
                    missing = (self._expected_param_names() - set(params)
                               if params else set())
                    if not params or missing:
                        return self._seed_bootstrap(effective_it, missing)
                    if attempt < 2:
                        continue
                raise WorkerError(f"push rejected: {push.message}")
            if fresh is not None:
                self._next_params = fresh   # the next iteration's pull
            elif not push.aggregation_complete:
                self._await_barrier(effective_it)
            self.iteration = effective_it
            return loss
        finally:
            self._time("step", t_step)
            self.status = m.WorkerStatus.IDLE
            self.metrics.log(step=self.iteration, loss=self.last_loss,
                             bootstrap=self.last_bootstrap,
                             step_time_s=self._times.pop("step_s"),
                             **self._times)

    def _await_barrier(self, iteration: int) -> None:
        """Poll CheckSyncStatus: 50 ms period, <=200 polls, 3 outer retries
        (reference: src/worker.cpp:372-389)."""
        t0 = time.perf_counter()
        try:
            resp: m.SyncStatusResponse | None = None
            for outer in range(self.config.sync_outer_retries):
                for _ in range(self.config.sync_poll_max):
                    resp = self.check_sync_ready(iteration)
                    if resp.ready:
                        return
                    time.sleep(self.config.sync_poll_period_s)
                log.warning("worker %d: barrier timeout at iteration %d "
                            "(%s), retry %d", self.config.worker_id,
                            iteration, _barrier_progress(resp), outer + 1)
                time.sleep(0.5)
            raise WorkerError(f"barrier never completed for iteration "
                              f"{iteration} ({_barrier_progress(resp)})")
        finally:
            self._time("barrier_wait", t0)

    # ------------------------------------------------------------ checkpoint
    def load_checkpoint_from_server(self, path: str) -> bool:
        """Ask the PS to load a checkpoint into itself (reference:
        src/worker.cpp:289-314; the returned copy is not kept)."""
        self.status = m.WorkerStatus.CHECKPOINTING
        try:
            resp = self.query_with_retry(
                lambda: self._ps.call("LoadCheckpoint",
                                      m.LoadCheckpointRequest(path=path),
                                      timeout=60.0))
            if resp.success:
                self._next_params = None   # cached params predate it
                log.info("worker %d: PS restored checkpoint %s (epoch %d)",
                         self.config.worker_id, path, resp.epoch)
            else:
                log.warning("worker %d: checkpoint restore failed: %s",
                            self.config.worker_id, resp.message)
            return resp.success
        finally:
            self.status = m.WorkerStatus.IDLE


def _barrier_progress(resp: m.SyncStatusResponse | None) -> str:
    if resp is None:
        return "no status polled"
    return f"{resp.workers_received}/{resp.total_workers} received"
