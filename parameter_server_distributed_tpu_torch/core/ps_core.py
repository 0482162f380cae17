"""Parameter-server aggregation state machine: the port of
``ParameterServerCore`` from parameter_server_distributed_tpu/core/ps_core.py.

Pure host-side logic, no I/O and no RPC: the gRPC service of the wire
round calls it, and in-process callers (tests, ``chip_smoke.py``) drive
it directly.  The observable semantics are the reference's:

- synchronous barrier: a push contributes once per (iteration, worker);
  when the distinct contributors reach the barrier width, the
  per-element **mean over actual contributors** is applied.
- late pushes to an already-aggregated iteration succeed without
  contributing; a push for a garbage-collected iteration is late too.
- bootstrap: a core holding no parameters adopts the first aggregated
  mean as its parameters (callers initialise the store first).
- ``serve_parameters`` ignores the requested iteration and serves the
  latest store; ``current_iteration`` is the monotone max seen.
- the barrier width may be elastic (``live_workers_fn``, TTL-cached and
  refreshed early when the provider's ``generation()`` moves); iteration
  states are garbage-collected past ``gc_iterations``.
- bounded-staleness async mode (``staleness_bound > 0``) applies each
  push on arrival, refusing one more than the bound behind.

Aggregation (``aggregation`` / ``PSDT_AGGREGATION``): **streaming** (the
default) folds every push into a per-iteration float32 accumulator on
arrival, first push wins for a duplicate, and runs the scale and the
optimizer apply outside ``_state_lock``; **buffered** keeps each
worker's whole store (last push wins) and takes the mean at the close
(with host SGD and the native library, one fused mean-SGD pass).
Stripes (``stripes`` / ``PSDT_STRIPES``, default the usable cores)
partition the store by tensor name: streaming folds run their numpy adds
under per-stripe locks outside ``_state_lock``, and a host optimizer's
apply runs stripe-parallel; results are bit-for-bit the serial ones.

Device optimizers (``PallasOptimizer``, ``DeviceOptimizer``,
``ShardedDeviceOptimizer``) return torch tensors on their device, and the
core stores and serves those as they are: a worker on the same card
packs them there with no host copy.  Everything that needs numpy
(snapshots, checkpoints, optimizer state) reads the store through
``core.tensor.to_host``.  In async mode the apply records a CUDA event;
while it is pending the previous store is served, and the next apply
waits on it first (one apply in flight at most).

The device close (``PSDT_DEVICE_APPLY=1`` with the sharded optimizer,
core/device_apply.py): streaming sync folds of device-decoded chunks
(:meth:`ParameterServerCore.device_fold`) accumulate on the device, the
scale and the update run there, bit for bit the host numpy close.  With
``PSDT_ARENA=1`` (core/arena.py) the sums, params and slots live as one
flat slab per stripe: a fold is one launch per (chunk, stripe), the
scale and the update one per stripe, and the published store is an
``ArenaStore`` of host views read back once per stripe; what the flat
layout cannot represent takes the per-tensor device close for that
close, counted in ``ps.apply.arena_fallback``.

The delta sink (:meth:`ParameterServerCore.set_delta_sink`, delta/chain.py
``DeltaChain``) is told of every store the core publishes: the
initialisation, each synchronous close (flat, striped, serial, the
buffered fused mean-SGD), the bootstrap and, unlike the JAX package's
core, each async apply; a restore resets it.  Each notification runs
after the store's readback, outside ``_params_lock`` and inside the
caller's serialized apply section.

Not ported, each raising ``NotImplementedError`` that names its ROADMAP
item when asked for: tier contributions and aggregate ids, K-of-N quorum
barriers, free-run mode, and ``PSDT_DEVICE_STAGE_CHUNK``.  Left out: the
barrier relay (item 10), replication and resharding
(``install_tensors``/``retire_tensors``, item 13; each resets the delta
sink when it lands), the sharded updater and the flight recorder
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from ..async_sgd.damping import async_damping
from ..native import lib as native_lib
from ..native import mean_over_workers_native, mean_sgd_native
from ..obs import stats as obs_stats
from . import arena as arena_mod
from . import device_apply
from .optimizer import SGD, HostOptimizer
from .stripes import partition_names, run_striped, stripe_count, stripe_of
from .tensor import TensorStore, store_nbytes, to_host, tree_like

AGGREGATION_MODES = ("streaming", "buffered")

# pusher ids at or above this base are tier aggregates (not ported)
TIER_AGGREGATE_ID_BASE = 1 << 20

# where each unported option is planned
ROADMAP_TIERS = "ROADMAP.md Queue 1, item 10 (hierarchical aggregation)"
ROADMAP_ELASTIC = "ROADMAP.md Queue 1, item 11 (quorum barriers, free-run)"

_TRUTHY = ("1", "true", "yes", "on")


def _refuse_unported(contributions_fn, quorum, freerun) -> None:
    """Raise for an option this port does not carry, whether asked for by
    argument or by the reference's environment knobs."""
    if contributions_fn is not None:
        raise NotImplementedError(f"tier contributions (contributions_fn): "
                                  f"{ROADMAP_TIERS}")
    q = (float(quorum) if quorum is not None and quorum > 0
         else float(os.environ.get("PSDT_QUORUM") or 0.0))
    if 0.0 < q < 1.0:   # 1.0 is all-of-N, the plain barrier
        raise NotImplementedError(f"K-of-N quorum barriers (quorum / "
                                  f"PSDT_QUORUM): {ROADMAP_ELASTIC}")
    if (bool(freerun) if freerun is not None else
            os.environ.get("PSDT_FREERUN", "").lower() in _TRUTHY):
        raise NotImplementedError(f"free-run mode (freerun / PSDT_FREERUN): "
                                  f"{ROADMAP_ELASTIC}")
    device_apply.stage_chunk_elems()   # raises where it is asked for


class IterationState:
    __slots__ = ("worker_gradients", "aggregated", "aggregating", "sealed",
                 "workers_at_aggregation", "accum", "counts", "folded",
                 "folding", "inflight", "contributors", "buffer_bytes")

    def __init__(self):
        # buffered mode: whole per-worker gradient stores
        self.worker_gradients: dict[int, TensorStore] = {}
        # streaming mode: running per-name f32 sums and per-name
        # contributor counts (workers pushing disjoint subsets average
        # correctly, as the buffered mean does)
        self.accum: TensorStore = {}
        self.counts: dict[str, int] = {}
        # streaming dedup: worker -> names already folded, so a replayed
        # push never double-counts
        self.folded: dict[int, set[str]] = {}
        # striped folds: worker -> names reserved under _state_lock whose
        # adds still run outside it, and the count of such folds (the
        # close drains it to zero before taking the accumulator)
        self.folding: dict[int, set[str]] = {}
        self.inflight = 0
        # workers whose push completed: only these count toward the width
        self.contributors: set[int] = set()
        self.aggregated = False
        # a streaming close is running its scale and apply outside the lock
        self.aggregating = False
        # set (never cleared) when a close is first attempted: the
        # contributor set is frozen, so a failed apply's retry cannot mix
        # a straggler into the restored (already scaled) accumulator
        self.sealed = False
        self.workers_at_aggregation = 0
        self.buffer_bytes = 0


class CheckpointState(NamedTuple):
    """What :meth:`ParameterServerCore.checkpoint_state` hands out: the
    published store and the optimizer's ``state_snapshot`` (device
    tensors stay on their device; ``core.tensor.to_host`` and
    ``state_to_host`` download them)."""
    epoch: int
    iteration: int
    params: TensorStore
    optimizer: dict


class PushResult:
    """Result of a gradient push (the PushResponse fields)."""
    __slots__ = ("success", "message", "iteration", "aggregation_complete",
                 "workers_received", "total_workers")

    def __init__(self, success: bool, message: str, iteration: int,
                 aggregation_complete: bool, workers_received: int,
                 total_workers: int):
        self.success = success
        self.message = message
        self.iteration = iteration
        self.aggregation_complete = aggregation_complete
        self.workers_received = workers_received
        self.total_workers = total_workers


class PushSink:
    """One worker's push in progress, possibly in chunks: returned by
    :meth:`ParameterServerCore.begin_push`.  Feed each chunk to
    :meth:`fold` as it arrives and call :meth:`commit` at the end.  In
    streaming sync mode each fold adds straight into the iteration's
    shared accumulator; in buffered or async mode folds stage into a
    private dict and the commit takes the whole-push path."""

    __slots__ = ("_core", "worker_id", "iteration", "_buffer")

    def __init__(self, core: "ParameterServerCore", worker_id: int,
                 iteration: int, streaming: bool):
        self._core = core
        self.worker_id = int(worker_id)
        self.iteration = int(iteration)
        self._buffer: dict | None = None if streaming else {}

    def fold(self, gradients: Mapping[str, np.ndarray]) -> None:
        if self._buffer is not None:
            self._buffer.update(gradients)
        else:
            self._core._fold_chunk(self.worker_id, self.iteration,
                                   gradients)

    def commit(self) -> PushResult:
        if self._buffer is not None:
            return self._core.receive_gradients(self.worker_id,
                                                self.iteration, self._buffer)
        return self._core._commit_push(self.worker_id, self.iteration)


def _fold_one(accum: TensorStore, counts: dict[str, int], name: str,
              g) -> int:
    """Fold one tensor into the running accumulator, by the gradient's
    residence: the first contribution seeds an owned f32 copy (never the
    pushed buffer, which the worker may reuse, or a decoded tensor that
    views a message), numpy's ``np.array`` on the host and
    ``device_apply.owned_copy`` for a device-decoded tensor; later ones
    add in place.  A mixed stream converges on the device: a device
    gradient moves a host accumulator there, and a host gradient is
    uploaded into a device one; nothing is read back.  Returns the bytes
    newly resident.  Raises, mutating nothing, on a shape mismatch."""
    acc = accum.get(name)
    if acc is None:
        if device_apply.is_device_array(g):
            acc = device_apply.owned_copy(g, g.device)
        else:
            acc = np.array(g, dtype=np.float32)
        accum[name] = acc
        counts[name] = 1
        return int(acc.nbytes)
    if isinstance(acc, np.ndarray) and not device_apply.is_device_array(g):
        np.add(acc, g, out=acc)
    elif isinstance(acc, np.ndarray):
        accum[name] = device_apply.fold_add(
            device_apply.owned_copy(acc, g.device), g)
    else:
        accum[name] = device_apply.fold_add(acc, g)
    counts[name] += 1
    return 0


def _apply_event(store: TensorStore):
    """A CUDA event recorded after the work queued so far on the stream
    of the store's first card tensor, or None for a store with none."""
    for value in store.values():
        if isinstance(value, torch.Tensor) and value.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(value.device))
            return event
    return None


class ParameterServerCore:
    def __init__(self,
                 total_workers: int = 2,
                 optimizer: HostOptimizer | None = None,
                 staleness_bound: int = 0,
                 live_workers_fn: Callable[[], int] | None = None,
                 live_workers_ttl_s: float = 0.0,
                 gc_iterations: int = 64,
                 aggregation: str | None = None,
                 stripes: int | None = None,
                 contributions_fn=None,
                 quorum: float | None = None,
                 freerun: bool | None = None):
        _refuse_unported(contributions_fn, quorum, freerun)
        mode = (aggregation or os.environ.get("PSDT_AGGREGATION")
                or "streaming").lower()
        if mode not in AGGREGATION_MODES:
            raise ValueError(f"unknown aggregation mode {mode!r}; "
                             f"options: {AGGREGATION_MODES}")
        self._aggregation = mode
        self._params: TensorStore = {}
        # Lock order: _state_lock before _apply_lock before _params_lock;
        # _apply_lock is never held while acquiring _state_lock.
        self._params_lock = threading.Lock()
        self._state_lock = threading.Lock()
        # serializes streaming barrier applies, which run outside
        # _state_lock so pushes and polls of other iterations proceed
        self._apply_lock = threading.Lock()
        self._stripes = stripe_count(stripes)
        # a stripe lock is only taken with no other lock held, never two
        self._stripe_locks = [threading.Lock() for _ in range(self._stripes)]
        self._obs_stripe_ms = obs_stats.histogram("ps.apply.stripe_ms")
        self._obs_parallelism = obs_stats.gauge("ps.apply.parallelism")
        # barrier closes whose fresh store is a device optimizer's tensors
        self._obs_device_applies = obs_stats.counter("ps.apply.device")
        # barrier-completion broadcast: wait_for_aggregation parks here
        self._barrier_cv = threading.Condition(self._state_lock)
        # set by release_waiters() when the server stops
        self._waiters_released = False
        self._iteration_states: "OrderedDict[int, IterationState]" = \
            OrderedDict()
        self._static_total_workers = int(total_workers)
        self._live_workers_fn = live_workers_fn
        self._live_ttl = float(live_workers_ttl_s)
        self._live_cache: tuple[int, float] = (0, 0.0)   # (value, expiry)
        # a provider exposing generation() (the coordinator's registry
        # generation) refreshes the cache the moment the live set moves
        self._live_gen_fn = getattr(live_workers_fn, "generation", None)
        self._live_gen: int | None = None
        # one refresher per expiry; held across the provider call
        self._live_lock = threading.Lock()
        self._optimizer = optimizer or SGD(learning_rate=1.0)
        self._staleness_bound = int(staleness_bound)
        # async damping, armed only by an explicit PSDT_STALENESS_BETA
        self._async_damping = (async_damping()
                               if self._staleness_bound > 0 else None)
        self._gc_iterations = int(gc_iterations)
        self._current_iteration = 0
        self._epoch = 0
        self._applied_updates = 0   # async mode: count of applied pushes
        # bumped on every parameter mutation (apply, initialize, restore)
        self._params_version = 0
        self._serving_version = 0
        # resident buffered-gradient bytes across live iteration states
        self._grad_buffer_bytes = 0
        self._peak_grad_buffer_bytes = 0
        self._obs_peak_buffer = obs_stats.gauge("ps.peak_grad_buffer_bytes")
        self._obs_barrier_close = obs_stats.histogram("ps.barrier_close_s")
        # the same closes split by whether a delta sink was fed
        self._obs_close_by_sink = {
            False: obs_stats.histogram("ps.barrier_close_nosink_s"),
            True: obs_stats.histogram("ps.barrier_close_sink_s")}
        # highest aggregated iteration: a straggler push for a GC'd
        # iteration is late, not a fresh state
        self._aggregated_watermark = -1
        # async mode: iteration of the bootstrap push, so a racing
        # duplicate init push is dropped
        self._bootstrap_iteration: int | None = None
        # bumped by restore(): a streaming close applying outside
        # _state_lock drops an aggregate that a restore made stale
        self._restore_epoch = 0
        # async mode: the latest store known materialized, served while
        # the apply that produces _params is in flight (its CUDA event,
        # _params_event, not yet reached); None when _params is ready
        self._serving: TensorStore | None = None
        self._params_event = None
        # called with the iteration by the thread that published a store
        # (see set_apply_hook)
        self._apply_hook: Callable[[int], None] | None = None
        # the versioned-delta sink (see set_delta_sink)
        self._delta_sink = None
        self._obs_readback = obs_stats.histogram("ps.apply.readback_s")
        # the flat arena (core/arena.py): streaming sync cores whose
        # optimizer speaks the slab family, on a device that exists
        opt_device = getattr(self._optimizer, "device", None)
        self._arena = (
            arena_mod.ArenaManager(self._stripes, opt_device)
            if (arena_mod.enabled() and self._streaming
                and self._staleness_bound == 0
                and getattr(self._optimizer, "supports_arena", False)
                and device_apply.available(opt_device))
            else None)

    # ------------------------------------------------------------------ props
    @property
    def synchronous(self) -> bool:
        return self._staleness_bound == 0

    @property
    def aggregation_mode(self) -> str:
        return self._aggregation

    @property
    def stripes(self) -> int:
        return self._stripes

    @property
    def _streaming(self) -> bool:
        return self._aggregation == "streaming"

    def device_fold(self):
        """The device push chunks should decode onto
        (rpc/data_plane.decode_gradients), or None: the optimizer's
        device when ``PSDT_DEVICE_APPLY`` is set, the optimizer is the
        sharded device family and its device exists.  Streaming sync mode
        only: buffered and async modes stage and apply on the host."""
        if not (self._streaming and self.synchronous
                and device_apply.enabled()
                and device_apply.wants_device_fold(self._optimizer)):
            return None
        device = getattr(self._optimizer, "device", None)
        return device if device_apply.available(device) else None

    def _note_device_apply(self, store: TensorStore) -> None:
        """Count an apply whose fresh store holds a device optimizer's
        tensors.  A per-tensor store is served as it is (its serve reads
        it through ``to_host``, one packed copy); the flat close reads
        its slabs back itself (:meth:`_apply_arena_sync`)."""
        if device_apply.is_device_store(store):
            self._obs_device_applies.add()

    def _params_ready(self) -> bool:
        """Caller holds _params_lock."""
        return self._params_event is None or self._params_event.query()

    @property
    def current_iteration(self) -> int:
        return self._current_iteration

    @property
    def params_version(self) -> int:
        return self._params_version

    @property
    def grad_buffer_bytes(self) -> int:
        return self._grad_buffer_bytes

    @property
    def peak_grad_buffer_bytes(self) -> int:
        return self._peak_grad_buffer_bytes

    @property
    def epoch(self) -> int:
        return self._epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self._epoch = int(value)

    def barrier_width(self) -> int:
        """The barrier width: the live-worker provider's answer when one
        is installed and positive, else the configured total."""
        if self._live_workers_fn is not None:
            with self._live_lock:
                live, expiry = self._live_cache
                gen = (self._live_gen_fn()
                       if self._live_gen_fn is not None else None)
                if (self._live_ttl <= 0 or time.monotonic() >= expiry
                        or (gen is not None and gen != self._live_gen)):
                    live = int(self._live_workers_fn())
                    self._live_cache = (live,
                                        time.monotonic() + self._live_ttl)
                    self._live_gen = gen
            if live > 0:
                return live
        return self._static_total_workers

    def set_total_workers(self, n: int) -> None:
        self._static_total_workers = int(n)

    def set_apply_hook(self, fn: Callable[[int], None] | None) -> None:
        """Install ``fn(iteration)``, called after each apply that
        publishes a store (a synchronous barrier close, an async apply)
        by the applying thread with the core's state lock held, so no
        other apply runs until it returns.  It may call
        :meth:`checkpoint_state_locked` (the PS service's checkpoints do)
        and must not take the state lock.  None removes it."""
        self._apply_hook = fn

    # ------------------------------------------------------------------ delta
    def set_delta_sink(self, sink, *, seed: bool = True) -> None:
        """Install (or clear, with None) the versioned-delta sink:
        ``sink.note_apply(store, version)`` after every store the core
        publishes, ``sink.reset()`` on restore.  ``note_apply`` runs in
        the serialized apply section and must not raise.

        ``seed=True`` notes the live store now, which needs a quiescent
        core (no apply running: the service owns the core before its
        server starts).  A sink installed while applies may run (the
        service's lazy arming) passes ``seed=False``: the next apply
        reseeds it instead, one extra full serve and never a torn
        base."""
        self._delta_sink = sink
        if sink is None or not seed:
            return
        with self._params_lock:
            store, version = self._params, self._params_version
            ready = self._params_ready()
        if store and ready:
            sink.note_apply(store, version)

    def _notify_delta(self, store: TensorStore, version: int) -> None:
        sink = self._delta_sink
        if sink is not None:
            sink.note_apply(store, version)

    def _reset_delta(self) -> None:
        sink = self._delta_sink
        if sink is not None:
            sink.reset()

    def release_waiters(self) -> None:
        """From now on :meth:`wait_for_aggregation` returns at once, not
        ready, and every call parked in it wakes: a stopping server's
        handler threads return instead of holding the process to the
        barrier timeout (port-only)."""
        with self._barrier_cv:
            self._waiters_released = True
            self._barrier_cv.notify_all()

    # ----------------------------------------------------------------- params
    def initialize_parameters(self, params: Mapping[str, np.ndarray]) -> None:
        store = tree_like(params)
        with self._params_lock:
            self._params = store
            self._params_event = None
            self._params_version += 1
            version = self._params_version
        if self._arena is not None:
            self._arena.invalidate()
        # seeds the chain, so the first apply already serves a delta
        self._notify_delta(store, version)

    def get_parameters(self) -> TensorStore:
        with self._params_lock:
            return dict(self._params)

    @property
    def has_parameters(self) -> bool:
        with self._params_lock:
            return bool(self._params)

    def serve_parameters(self, iteration: int = 0
                         ) -> tuple[int, TensorStore, bool]:
        """(current_iteration, params copy, ready); the iteration argument
        is accepted and ignored, as the reference's is."""
        it, params, ready, _ = self.serve_view(iteration)
        return it, params, ready

    def serve_view(self, iteration: int = 0
                   ) -> tuple[int, TensorStore, bool, int]:
        """(current_iteration, params copy, ready, store version).  Async
        mode never blocks a read on an apply in flight: the previous
        store is served until it lands.  Sync mode always serves
        ``_params`` itself, as the barrier promised."""
        with self._params_lock:
            if self._serving is not None:
                if self._params_ready():
                    self._serving = None   # the apply landed: promote
                else:
                    return (self._current_iteration, dict(self._serving),
                            True, self._serving_version)
            return (self._current_iteration, dict(self._params), True,
                    self._params_version)

    def serve_version(self) -> int:
        """The version :meth:`serve_view` would serve now, without a copy."""
        with self._params_lock:
            if self._serving is not None and not self._params_ready():
                return self._serving_version
            return self._params_version

    # ------------------------------------------------------------------- push
    def begin_push(self, worker_id: int, iteration: int) -> PushSink:
        """Open a (possibly chunk-streamed) push; the whole-store
        :meth:`receive_gradients` is its one-chunk case."""
        self._refuse_aggregate_id(worker_id)
        return PushSink(self, worker_id, iteration,
                        streaming=self._streaming and self.synchronous)

    def receive_gradients(self, worker_id: int, iteration: int,
                          gradients: Mapping[str, np.ndarray]) -> PushResult:
        self._refuse_aggregate_id(worker_id)
        if not self.synchronous:
            return self._receive_async(worker_id, iteration, gradients)
        if self._streaming:
            self._fold_chunk(worker_id, iteration, gradients)
            return self._commit_push(worker_id, iteration)
        return self._receive_sync(worker_id, iteration, gradients)

    @staticmethod
    def _refuse_aggregate_id(worker_id: int) -> None:
        if worker_id >= TIER_AGGREGATE_ID_BASE:
            raise NotImplementedError(
                f"tier aggregate id {worker_id} (ids from "
                f"{TIER_AGGREGATE_ID_BASE} up): {ROADMAP_TIERS}")

    # ------------------------------------------------- streaming aggregation
    def _grad_buffer_note(self, delta: int) -> None:
        """Track resident buffered gradient bytes (caller holds
        _state_lock)."""
        self._grad_buffer_bytes += delta
        if self._grad_buffer_bytes > self._peak_grad_buffer_bytes:
            self._peak_grad_buffer_bytes = self._grad_buffer_bytes
            self._obs_peak_buffer.set(self._peak_grad_buffer_bytes)

    def _sync_state_locked(self, iteration: int) -> IterationState | None:
        """The iteration's state, created on first touch; None when the
        iteration is late (aggregated and GC'd).  Caller holds
        _state_lock."""
        state = self._iteration_states.get(iteration)
        if state is None:
            if iteration <= self._aggregated_watermark:
                return None
            state = IterationState()
            self._iteration_states[iteration] = state
            self._gc_locked()
        return state

    def _fold_chunk(self, worker_id: int, iteration: int,
                    gradients: Mapping[str, np.ndarray]) -> None:
        """Fold one chunk of a worker's push into the iteration's running
        accumulator (streaming sync mode), idempotent per (worker, name).
        Chunks for an aggregated, sealed or already-committed iteration
        are discarded.  Striped: only the reservation runs under
        ``_state_lock``; the adds run outside it under stripe locks."""
        with self._state_lock:
            self._current_iteration = max(self._current_iteration, iteration)
            state = self._sync_state_locked(iteration)
            if (state is None or state.aggregated or state.sealed
                    or worker_id in state.contributors):
                return   # the commit reports the push late or duplicate
            if gradients:
                self._maybe_arena_accum_locked(state)
            folded = state.folded.setdefault(worker_id, set())
            if self._stripes <= 1:
                self._fold_into_locked(state, folded, gradients)
                return
            folding = state.folding.setdefault(worker_id, set())
            todo = [(name, g) for name, g in gradients.items()
                    if name not in folded and name not in folding]
            if not todo:
                return
            # reserve: a concurrent duplicate fold of the same (worker,
            # name) sees the reservation and skips
            folding.update(name for name, _ in todo)
            state.inflight += 1
        self._fold_striped(state, worker_id, iteration, todo)

    def _maybe_arena_accum_locked(self, state: IterationState) -> None:
        """Fix a fresh iteration state's accumulator residence (caller
        holds _state_lock): with the arena armed and a packing table for
        the live store, the sums live as per-stripe slabs
        (``ArenaAccum``) from the first fold on.  A state that already
        accumulated per tensor stays so."""
        if self._arena is None or not self._arena.active:
            return
        if isinstance(state.accum, arena_mod.ArenaAccum):
            return
        if state.accum or state.counts:
            return
        with self._params_lock:
            store = self._params
        table = self._arena.ensure_table(store)
        if table is not None:
            state.accum = self._arena.new_accum(table)

    def _arena_fold(self, state: IterationState, folded: set,
                    gradients: Mapping) -> int:
        """Fold into the arena accumulator, one launch per (stripe, lane)
        of the chunk.  Names the table cannot represent exactly (unknown,
        or numpy's broadcast-up) fold per tensor into the accumulator's
        overflow, a slab-resident partial sum evicted there first so it
        accumulates in one place; their presence sends the close down the
        per-tensor path.  Returns bytes newly resident and marks names
        folded as they land.  Caller holds the lock covering the touched
        stripes."""
        accum: arena_mod.ArenaAccum = state.accum
        table = accum.table
        added = 0
        by_stripe: dict[int, list] = {}
        for name, g in gradients.items():
            if name in folded:
                continue
            if (table.compatible(name, g) and name not in accum.overflow
                    and name not in accum.popped):
                by_stripe.setdefault(table.entries[name].stripe,
                                     []).append((name, g))
            else:
                accum.evict_to_overflow(name)
                added += _fold_one(accum.overflow, state.counts, name, g)
                folded.add(name)
        for stripe in sorted(by_stripe):
            items = by_stripe[stripe]
            added += accum.fold_group(stripe, items, state.counts)
            folded.update(name for name, _ in items)
        return added

    def _fold_into_locked(self, state: IterationState, folded: set,
                          gradients: Mapping[str, np.ndarray]) -> None:
        """The serial fold (caller holds _state_lock), used at stripes 1.
        A name is marked folded only after its add, so a retry of a
        failed fold is not dropped."""
        if isinstance(state.accum, arena_mod.ArenaAccum):
            added = self._arena_fold(state, folded, gradients)
            if added:
                state.buffer_bytes += added
                self._grad_buffer_note(added)
            return
        added = 0
        try:
            for name, g in gradients.items():
                if name in folded:
                    continue
                added += _fold_one(state.accum, state.counts, name, g)
                folded.add(name)
        finally:
            if added:
                state.buffer_bytes += added
                self._grad_buffer_note(added)

    def _fold_striped(self, state: IterationState, worker_id: int,
                      iteration: int, todo: list) -> None:
        """The adds of a striped fold, grouped per stripe under stripe
        locks outside ``_state_lock``, then the publication of what landed
        back under it (the close drains ``state.inflight`` first)."""
        groups: dict[int, list] = {}
        for name, g in todo:
            groups.setdefault(stripe_of(name, self._stripes),
                              []).append((name, g))
        work = sorted(groups.items())
        done_by: list[list[str]] = [[] for _ in work]
        added_by = [0] * len(work)

        def fold_group(idx: int, stripe: int, items: list) -> None:
            with self._stripe_locks[stripe]:
                if isinstance(state.accum, arena_mod.ArenaAccum):
                    # one launch per lane over the stripe's slab (the
                    # reservation filtered duplicates already)
                    local: set[str] = set()
                    added_by[idx] += self._arena_fold(state, local,
                                                      dict(items))
                    done_by[idx].extend(local)
                    return
                for name, g in items:
                    added_by[idx] += _fold_one(state.accum, state.counts,
                                               name, g)
                    done_by[idx].append(name)

        try:
            thunks = [(lambda i=i, s=stripe, it=items: fold_group(i, s, it))
                      for i, (stripe, items) in enumerate(work)]
            if device_apply.is_device_store(dict(todo)):
                # device folds launch from this thread: every launch goes
                # to the device's one stream
                for thunk in thunks:
                    thunk()
            else:
                run_striped(thunks)
        finally:
            with self._state_lock:
                state.inflight -= 1
                folding = state.folding.get(worker_id)
                if folding is not None:
                    folding.difference_update(name for name, _ in todo)
                state.folded.setdefault(worker_id, set()).update(
                    name for names in done_by for name in names)
                added = sum(added_by)
                # a restore() racing this fold orphaned `state`: its bytes
                # die with it
                if added and self._iteration_states.get(iteration) is state:
                    state.buffer_bytes += added
                    self._grad_buffer_note(added)
                self._barrier_cv.notify_all()   # wake a draining closer

    def _push_guard_locked(self, state: IterationState | None,
                           worker_id: int, iteration: int,
                           total: int) -> PushResult | None:
        """Early verdict of a streaming commit (caller holds _state_lock;
        None = contribute): GC'd or aggregated -> late push, succeeds
        without contributing; sealed -> the close is in flight without
        this worker; already a contributor -> duplicate, first push wins."""
        if state is None:
            return PushResult(True, "iteration already aggregated",
                              iteration, True, total, total)
        if state.aggregated:
            return PushResult(True, "iteration already aggregated",
                              iteration, True,
                              state.workers_at_aggregation, total)
        if state.sealed:
            return PushResult(True, "aggregation in progress", iteration,
                              False, len(state.contributors), total)
        if worker_id in state.contributors:
            return PushResult(True, "duplicate push ignored (streaming "
                                    "aggregation is first-push-wins)",
                              iteration, False,
                              len(state.contributors), total)
        return None

    def _commit_push(self, worker_id: int, iteration: int) -> PushResult:
        """End of a streaming push: mark the worker a contributor and close
        the barrier if the width is reached."""
        total = self.barrier_width()
        with self._state_lock:
            self._current_iteration = max(self._current_iteration, iteration)
            state = self._sync_state_locked(iteration)
            early = self._push_guard_locked(state, worker_id, iteration,
                                            total)
            if early is not None:
                return early
            state.contributors.add(worker_id)
            received = self._maybe_aggregate_locked(iteration, state, total)
            if state.aggregated:
                return PushResult(True, "aggregation complete", iteration,
                                  True, received, total)
            return PushResult(True, "gradient received", iteration,
                              False, received, total)

    # -------------------------------------------------- buffered aggregation
    def _receive_sync(self, worker_id: int, iteration: int,
                      gradients: Mapping[str, np.ndarray]) -> PushResult:
        total = self.barrier_width()
        with self._state_lock:
            self._current_iteration = max(self._current_iteration, iteration)
            state = self._sync_state_locked(iteration)
            if state is None:
                return PushResult(True, "iteration already aggregated",
                                  iteration, True, total, total)
            if state.aggregated:
                return PushResult(True, "iteration already aggregated",
                                  iteration, True,
                                  state.workers_at_aggregation, total)
            store = tree_like(gradients)   # owned: last push wins
            prev = state.worker_gradients.get(worker_id)
            delta = store_nbytes(store) - (store_nbytes(prev) if prev else 0)
            state.worker_gradients[worker_id] = store
            state.buffer_bytes += delta
            self._grad_buffer_note(delta)
            received = self._maybe_aggregate_locked(iteration, state, total)
            if state.aggregated:
                return PushResult(True, "aggregation complete", iteration,
                                  True, received, total)
            return PushResult(True, "gradient received", iteration,
                              False, received, total)

    # ---------------------------------------------------------- barrier close
    def _maybe_aggregate_locked(self, iteration: int, state: IterationState,
                                total: int) -> int:
        """Close the barrier if the contributors reached the current width.
        Called from pushes and from sync polls and waits, so an elastic
        shrink releases a fully-pushed iteration.  Caller holds
        _state_lock.  Returns the contributor count."""
        if state.aggregated:
            return state.workers_at_aggregation
        received = (len(state.contributors) if self._streaming
                    else len(state.worker_gradients))
        if state.aggregating or received == 0 or received < total:
            return received
        self._close_barrier_locked(iteration, state, received)
        return (state.workers_at_aggregation if state.aggregated
                else received)

    def _close_barrier_locked(self, iteration: int, state: IterationState,
                              received: int) -> None:
        """Streaming: drain in-flight folds, take the accumulator, release
        _state_lock for the scale and apply (serialized by _apply_lock),
        reacquire to publish.  Buffered: mean and apply under _state_lock.
        A failed apply leaves the barrier retryable.  Caller holds
        _state_lock; it is held again on return."""
        t0 = time.perf_counter()
        state.sealed = True
        # before the drain: the wait releases _state_lock, and a poll
        # re-entering _maybe_aggregate_locked must see the close running
        state.aggregating = True
        try:
            if self._streaming:
                while state.inflight:
                    self._barrier_cv.wait(0.05)
                if not self._close_streaming_locked(state):
                    # a restore landed inside the close: drop the aggregate
                    state.aggregating = False
                    return
            else:
                if not self._apply_fused_mean_sgd(state.worker_gradients):
                    self._apply_update(
                        _mean_over_workers(state.worker_gradients))
                state.worker_gradients.clear()
                self._grad_buffer_note(-state.buffer_bytes)
                state.buffer_bytes = 0
        except BaseException:
            state.aggregating = False
            raise
        state.aggregating = False
        state.aggregated = True
        state.workers_at_aggregation = received
        self._aggregated_watermark = max(self._aggregated_watermark,
                                         iteration)
        close_s = time.perf_counter() - t0
        self._obs_barrier_close.observe(close_s)
        self._obs_close_by_sink[self._delta_sink is not None].observe(
            close_s)
        self._barrier_cv.notify_all()
        if self._apply_hook is not None:
            self._apply_hook(iteration)

    def _close_streaming_locked(self, state: IterationState) -> bool:
        """Take the accumulator, scale it to means and apply outside
        _state_lock.  Returns False when a restore obsoleted the
        aggregate.  On an apply failure the accumulator is put back
        (already scaled sums are means, so their counts reset to 1) and
        the exception propagates: the next push or poll retries.  An
        arena accumulator closes flat unless the downgrade matrix sends
        it per tensor (counted)."""
        gen = self._restore_epoch
        sums, counts = state.accum, state.counts
        state.accum, state.counts = {}, {}
        state.folded.clear()
        freed = state.buffer_bytes
        self._grad_buffer_note(-freed)
        state.buffer_bytes = 0
        scaled = False
        try:
            self._state_lock.release()
            try:
                with self._apply_lock:
                    if self._restore_epoch == gen:
                        if isinstance(sums, arena_mod.ArenaAccum):
                            reason = self._arena_fallback_reason(sums,
                                                                 counts)
                            if reason is not None:
                                self._arena.fallback(reason)
                                sums = sums.to_tensor_dict()
                        if isinstance(sums, arena_mod.ArenaAccum):
                            # one scale launch per stripe (counts proven
                            # uniform), then the flat update
                            sums.scale_uniform(next(iter(counts.values())))
                            scaled = True
                            self._apply_arena_sync(sums)
                        else:
                            self._scale_striped(sums, counts)
                            scaled = True
                            self._apply_update(sums)
            finally:
                self._state_lock.acquire()
        except BaseException:
            if self._restore_epoch == gen:
                state.accum = sums
                state.counts = dict.fromkeys(sums, 1) if scaled else counts
                state.buffer_bytes = freed
                self._grad_buffer_note(freed)
            raise
        return self._restore_epoch == gen

    def _receive_async(self, worker_id: int, iteration: int,
                       gradients: Mapping[str, np.ndarray]) -> PushResult:
        """Bounded-staleness apply on arrival."""
        with self._state_lock:
            with self._params_lock:
                params_empty = not self._params
            if params_empty:
                # bootstrap: the pushed payload becomes the parameters
                self._apply_update(tree_like(gradients))
                self._bootstrap_iteration = iteration
                self._current_iteration = max(self._current_iteration,
                                              iteration)
                if self._apply_hook is not None:
                    self._apply_hook(self._current_iteration)
                return PushResult(True, "bootstrap applied",
                                  self._current_iteration, True, 1,
                                  self.barrier_width())
            if (self._bootstrap_iteration is not None
                    and iteration <= self._bootstrap_iteration):
                # a racing duplicate of the bootstrap init push: applying
                # it as a gradient would compute params - lr*init
                return PushResult(True, "bootstrap duplicate ignored",
                                  self._current_iteration, True, 0,
                                  self.barrier_width())
            staleness = self._current_iteration - iteration
            if staleness > self._staleness_bound:
                return PushResult(
                    False, f"stale push: worker iteration {iteration} is "
                           f"{staleness} behind bound {self._staleness_bound}",
                    self._current_iteration, False, 0, self.barrier_width())
            if self._async_damping is not None and staleness > 0:
                gradients = self._async_damping.damp(gradients, staleness)
            self._apply_update(tree_like(gradients))
            self._applied_updates += 1
            self._current_iteration = max(self._current_iteration, iteration)
            if self._apply_hook is not None:
                self._apply_hook(self._current_iteration)
            return PushResult(True, "update applied", self._current_iteration,
                              True, 1, self.barrier_width())

    @property
    def applied_updates(self) -> int:
        """Async mode: number of updates applied (the PS version)."""
        return self._applied_updates

    def _scale_striped(self, sums: TensorStore,
                       counts: dict[str, int]) -> None:
        """In place sums -> means, per stripe on the shared pool (the
        per-tensor operation is unchanged, so the result is bit-for-bit
        the serial loop's).  Device sums scale with one ``scale_mean``
        launch per stripe, issued from this thread.  Caller holds
        _apply_lock."""
        def scale_group(names: list[str]) -> None:
            on_device = [n for n in names
                         if device_apply.is_device_array(sums[n])]
            if on_device:
                device_apply.scale_means(sums, counts, on_device)
            for name in names:
                if not device_apply.is_device_array(sums[name]):
                    sums[name] *= np.float32(1.0 / counts[name])

        if self._stripes <= 1 or len(sums) <= 1:
            scale_group(list(sums))
            return
        if device_apply.is_device_store(sums):
            for names in partition_names(sums, self._stripes):
                scale_group(names)
            return
        run_striped([(lambda ns=ns: scale_group(ns))
                     for ns in partition_names(sums, self._stripes)])

    # ------------------------------------------------------ the flat close
    def _arena_fallback_reason(self, sums: "arena_mod.ArenaAccum",
                               counts: dict[str, int]) -> str | None:
        """None when the flat close may run; otherwise why this close
        takes the per-tensor path (core/arena.py's downgrade matrix).
        Caller holds _apply_lock."""
        if self._arena is None or not self._arena.active:
            return "disabled"
        with self._params_lock:
            store = self._params
        live = self._arena.ensure_table(store)
        if live is None or live.epoch != sums.table.epoch:
            return "epoch"
        if not sums.full_coverage():
            return "coverage"
        values = iter(counts.values())
        first = next(values, None)
        if first is None or any(c != first for c in values):
            return "counts"
        ready = getattr(self._optimizer, "arena_ready", None)
        if ready is None or not ready(sums.table):
            return "slots"
        return None

    def _apply_arena_sync(self, sums: "arena_mod.ArenaAccum") -> None:
        """The flat close (caller holds _apply_lock; ``sums`` already
        means): one update launch per stripe over the slabs, one readback
        per stripe into pinned host memory, and the published store an
        ``ArenaStore`` of views into it.  The readback is waited on
        before the store is published, so every reader of the store
        finds its bytes there.  A packing failure latches the arena off
        and completes this close per tensor."""
        table = sums.table
        with self._params_lock:
            prev = self._params
        try:
            param_slabs = self._arena.ensure_param_slabs(prev, table)
        except Exception as exc:  # noqa: BLE001 — packing never fails a
            # close: the per-tensor device path is always correct
            self._arena.latch_off(f"{type(exc).__name__}: {exc}")
            self._apply_update(sums.to_tensor_dict())
            return
        opt = self._optimizer
        opt.tick()
        new_slabs = opt.apply_arena(table, param_slabs, sums.slabs)
        t0 = time.perf_counter()
        readback = device_apply.readback_async(new_slabs)
        readback.wait()
        self._obs_readback.observe(time.perf_counter() - t0)
        host_slabs = readback.arrays()
        per_stripe = {s: table.views(s, h) for s, h in host_slabs.items()}
        # the store's key order is kept: checkpoints and serve chunks are
        # laid out as the per-tensor path's
        store = arena_mod.ArenaStore(
            {name: per_stripe[table.entries[name].stripe][name]
             for name in prev}, table, host_slabs, readback)
        with self._params_lock:
            if self._params is not prev:
                return   # initialize_parameters() landed: it wins
            self._params = store
            self._params_version += 1
            version = self._params_version
        self._arena.adopt(store, new_slabs)
        self._arena.note_close()
        self._obs_device_applies.add()
        self._notify_delta(store, version)

    def _apply_striped_sync(self, prev: TensorStore,
                            mean_grads: TensorStore) -> None:
        """Striped synchronous apply: tick once, then ``apply_shard`` per
        stripe, on the shared pool for a host optimizer and from this
        thread for a device-resident one (its launches share the
        device's one stream); the merged store is swapped in under
        _params_lock.  The caller serializes applies."""
        opt = self._optimizer
        opt.tick()
        name_groups = partition_names(prev, self._stripes)
        stripe_s = [0.0] * len(name_groups)

        def apply_group(idx: int, names: list[str]) -> TensorStore:
            t1 = time.perf_counter()
            res = opt.apply_shard(
                {n: prev[n] for n in names},
                {n: mean_grads[n] for n in names if n in mean_grads})
            stripe_s[idx] = time.perf_counter() - t1
            return res

        thunks = [(lambda i=i, ns=ns: apply_group(i, ns))
                  for i, ns in enumerate(name_groups)]
        t0 = time.perf_counter()
        if device_apply.wants_device_fold(opt):
            parts = [thunk() for thunk in thunks]
        else:
            parts = run_striped(thunks)
        wall = time.perf_counter() - t0
        by_name: TensorStore = {}
        for part in parts:
            by_name.update(part)
        new_params = {name: by_name[name] for name in prev}   # stable order
        for dt in stripe_s:
            self._obs_stripe_ms.observe(1e3 * dt)
        if wall > 0:
            self._obs_parallelism.set(round(sum(stripe_s) / wall, 2))
        with self._params_lock:
            if self._params is not prev:
                # initialize_parameters() landed during the compute: the
                # newer store wins
                return
            self._params = new_params
            self._params_version += 1
            version = self._params_version
        self._note_device_apply(new_params)
        self._notify_delta(new_params, version)

    def _apply_fused_mean_sgd(self,
                              worker_gradients: Mapping[int, TensorStore]
                              ) -> bool:
        """The buffered close's one-pass native ``param -= lr *
        mean(grads)`` (``psdt_mean_sgd``), as the reference's.  False,
        asking for the mean-then-optimizer path, for an optimizer other
        than host SGD, an empty store (the bootstrap needs the mean
        itself) or without the native library.  Caller holds
        _state_lock."""
        if type(self._optimizer) is not SGD or native_lib() is None:
            return False
        by_name: dict[str, list[np.ndarray]] = {}
        for grads in worker_gradients.values():
            for name, g in grads.items():
                by_name.setdefault(name, []).append(
                    np.ascontiguousarray(g, np.float32))
        lr = float(self._optimizer.learning_rate)
        with self._params_lock:
            if not self._params:
                return False
            new_params: TensorStore = {}
            for name, p in self._params.items():
                arrays = by_name.get(name)
                if not arrays:
                    new_params[name] = np.asarray(p, np.float32)
                    continue
                p_new = np.array(p, np.float32)   # a fresh contiguous copy
                if not mean_sgd_native(p_new, arrays, lr):
                    acc = arrays[0].copy()
                    for g in arrays[1:]:
                        acc += g
                    p_new = p_new - np.float32(lr / len(arrays)) * acc
                new_params[name] = p_new
            self._params = new_params
            self._params_version += 1
            version = self._params_version
        # still under _state_lock (the buffered close), outside
        # _params_lock
        self._notify_delta(new_params, version)
        return True

    def _apply_update(self, mean_grads: TensorStore) -> None:
        """Applies are serialized by the caller (_state_lock on the async
        and buffered paths, _apply_lock on the streaming close); only
        _params_lock is taken here, briefly in async mode."""
        with self._params_lock:
            if not self._params:
                # the bootstrap quirk: the first mean becomes the params,
                # in name order (striped folds insert in thread order, and
                # the store's order is its checkpoints' layout)
                self._params = {name: mean_grads[name]
                                for name in sorted(mean_grads)}
                self._params_event = None
                self._params_version += 1
                store, version = self._params, self._params_version
                boot = True
            else:
                prev, prev_event = self._params, self._params_event
                boot = False
        if boot:
            self._notify_delta(store, version)
            return
        if not self.synchronous:
            # depth bound: at most one apply in flight; wait for the
            # previous one (outside _params_lock, so serves go on)
            if prev_event is not None and not prev_event.query():
                prev_event.synchronize()
            new_params = self._optimizer.apply(prev, mean_grads)
            event = _apply_event(new_params)
            with self._params_lock:
                self._serving = prev   # materialized: served meanwhile
                self._serving_version = self._params_version
                self._params = new_params
                self._params_event = event
                self._params_version += 1
                version = self._params_version
            self._note_device_apply(new_params)
            # the chain reads the store through to_host, which waits for
            # the apply: only a core with a sink installed pays that
            self._notify_delta(new_params, version)
        elif (self._stripes > 1 and self._optimizer.supports_striping
              and len(mean_grads) > 1):
            self._apply_striped_sync(prev, mean_grads)
        else:
            with self._params_lock:
                self._params = self._optimizer.apply(self._params,
                                                     mean_grads)
                self._params_version += 1
                store, version = self._params, self._params_version
            self._note_device_apply(store)
            self._notify_delta(store, version)

    # ------------------------------------------------------------------- sync
    def check_sync_status(self, iteration: int) -> tuple[int, bool, int, int]:
        """(iteration, ready, workers_received, total_workers)."""
        total = self.barrier_width()
        if not self.synchronous:
            return iteration, True, 1, total
        with self._state_lock:
            state = self._iteration_states.get(iteration)
            if state is None:
                if iteration <= self._aggregated_watermark:
                    return iteration, True, total, total   # GC'd
                return iteration, False, 0, total
            # re-evaluate: an elastic shrink fires a fully-pushed iteration
            received = self._maybe_aggregate_locked(iteration, state, total)
            if state.aggregated:
                return iteration, True, state.workers_at_aggregation, total
            return iteration, False, received, total

    def wait_for_aggregation(self, iteration: int,
                             timeout: float) -> tuple[bool, int, int]:
        """Block until ``iteration``'s aggregation completes, the timeout
        passes or :meth:`release_waiters` is called: (ready,
        workers_received, total_workers).  Woken by the close; re-reads
        the (possibly elastic) width every 250 ms."""
        if not self.synchronous:
            return True, 1, self.barrier_width()
        deadline = time.monotonic() + timeout
        while True:
            total = self.barrier_width()
            with self._barrier_cv:
                state = self._iteration_states.get(iteration)
                if state is None:
                    if iteration <= self._aggregated_watermark:
                        return True, total, total
                    received = 0
                else:
                    received = self._maybe_aggregate_locked(iteration, state,
                                                            total)
                    if state.aggregated:
                        return True, state.workers_at_aggregation, total
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._waiters_released:
                    return False, received, total
                self._barrier_cv.wait(min(remaining, 0.25))

    # --------------------------------------------------------------------- gc
    def _gc_locked(self) -> None:
        excess = len(self._iteration_states) - self._gc_iterations
        if excess <= 0:
            return
        for iteration in list(self._iteration_states):
            if excess <= 0:
                break
            old = self._iteration_states[iteration]
            if old.sealed and not old.aggregated:
                # mid-close: evicting would let a replayed push fire a
                # second aggregation before the watermark publishes
                continue
            del self._iteration_states[iteration]
            excess -= 1
            if old.buffer_bytes:
                self._grad_buffer_note(-old.buffer_bytes)
                old.buffer_bytes = 0

    @property
    def tracked_iterations(self) -> int:
        with self._state_lock:
            return len(self._iteration_states)

    # ------------------------------------------------------------- checkpoint
    def snapshot(self) -> tuple[int, int, TensorStore]:
        """Consistent (epoch, current_iteration, params) with the params
        as host numpy.  The locks (state, apply, params) keep a push from
        tearing the view; the download runs after them, which is safe
        because applies never write into a store they returned."""
        with self._state_lock:
            with self._apply_lock:
                with self._params_lock:
                    epoch, iteration = self._epoch, self._current_iteration
                    params = dict(self._params)
        return epoch, iteration, to_host(params)

    def checkpoint_state(self) -> CheckpointState:
        """(epoch, iteration, params, optimizer state) of one moment, for
        a checkpoint; see :meth:`checkpoint_state_locked`."""
        with self._state_lock:
            return self.checkpoint_state_locked()

    def checkpoint_state_locked(self) -> CheckpointState:
        """:meth:`checkpoint_state` for a caller that holds the state lock
        (the apply hook).  One hold of the apply and params locks takes
        the published store (applies never write into a store they
        returned) and the optimizer's ``state_snapshot`` (slots copied:
        applies update them in place), so no apply falls between the two.
        Nothing is downloaded under the locks; the caller does that."""
        with self._apply_lock:
            with self._params_lock:
                return CheckpointState(self._epoch, self._current_iteration,
                                       dict(self._params),
                                       self._optimizer.state_snapshot())

    def optimizer_state(self) -> dict:
        """The optimizer's slot state as numpy, for checkpointing beside
        :meth:`snapshot` (device optimizers download through to_host)."""
        with self._state_lock:
            with self._apply_lock:
                with self._params_lock:
                    return self._optimizer.state_dict()

    def restore(self, epoch: int, iteration: int,
                params: Mapping[str, np.ndarray],
                optimizer_state: dict | None = None,
                params_version: int | None = None) -> None:
        """Adopt a checkpoint.  ``params_version`` (the save-time counter)
        makes the version resume past it and past anything this process
        served: a served version id never names other values."""
        store = tree_like(params)
        with self._state_lock:
            with self._apply_lock:
                with self._params_lock:
                    self._params = store
                    self._params_event = None
                    self._params_version = max(
                        self._params_version, int(params_version or 0)) + 1
                    if optimizer_state is not None:
                        self._optimizer.load_state_dict(optimizer_state)
                # bumped under _apply_lock: an in-flight streaming close
                # sees it before its apply (skips) or after (drops)
                self._restore_epoch += 1
                if self._arena is not None:
                    self._arena.invalidate()
            self._epoch = int(epoch)
            self._current_iteration = int(iteration)
            self._iteration_states.clear()
            self._grad_buffer_bytes = 0
            self._aggregated_watermark = -1
            self._bootstrap_iteration = None
        # the restored store is a new world: no stale pair may patch a
        # receiver toward it
        self._reset_delta()


def _mean_over_workers(worker_gradients: Mapping[int, TensorStore]
                       ) -> TensorStore:
    """Element-wise mean over the gradients of the workers that actually
    contributed: sum, then scale by 1/contributors (not the configured
    total); the native ``psdt_mean`` when the library is there."""
    by_name: dict[str, list[np.ndarray]] = {}
    for grads in worker_gradients.values():
        for name, g in grads.items():
            by_name.setdefault(name, []).append(np.asarray(g, np.float32))
    out: TensorStore = {}
    for name, arrays in by_name.items():
        mean = mean_over_workers_native(arrays)
        if mean is not None:
            out[name] = mean
            continue
        acc = arrays[0].copy()
        for g in arrays[1:]:
            acc += g
        out[name] = acc * np.float32(1.0 / len(arrays))
    return out
