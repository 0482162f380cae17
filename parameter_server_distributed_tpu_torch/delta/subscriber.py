"""Live weight subscription for the decode fleet: the port of
parameter_server_distributed_tpu/delta/subscriber.py.

``WeightFollower`` opens the ``SubscribeWeights`` RPC against a training
PS (the port's or the JAX package's) and tracks its store version by
version: the server streams a full serve first (the base), then one
delta pair batch per optimizer apply.  Each completed version goes to
the consumer through :meth:`WeightFollower.poll`, which a decode server
calls between rounds to hot-swap it (fleet/decode.py ``follower=``,
cli/serve_main.py ``--follow``).

The decode process never crashes or stalls on the training side:

- UNIMPLEMENTED (a reference PS, or deltas off) degrades for good: the
  follower stops and the server keeps its boot weights;
- a transport error (the PS died, a partition) reconnects, a bounded
  number of times with jittered backoff, then degrades: the server keeps
  the last good weights it swapped in;
- a checksum or base mismatch drops the base and resubscribes from
  scratch (held version 0: a full serve).

The store is host float32 numpy; the consumer gets an owned copy of it,
which the next delta never touches.  Port-only: ``sessions`` counts the
subscriptions opened (1 = no reconnect), ``versions_consumed`` the
versions ``poll`` handed out, and ``history`` holds the (version, crc
or None for a full serve, wall time, delta-served) of the last versions
received.  Left out: flight events (ROADMAP.md Queue 1, item 14) and
``checked_lock`` (item 15).
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time

import grpc
import numpy as np

from ..obs import stats as obs_stats
from ..rpc import messages as m
from ..rpc.service import RpcClient
from ..rpc.service import status_code as _status_code
from .client import DeltaBaseMismatch, DeltaPullState, apply_frames
from .messages import DELTA_PS_METHODS, SubscribeRequest

log = logging.getLogger("pst.delta.follow")

HISTORY_KEPT = 256


class WeightFollower:
    """A subscriber thread and a one-slot mailbox of the newest complete
    weight version.  ``poll()`` returns ``(params copy, version)`` at
    most once a version (None when nothing is new)."""

    def __init__(self, target: str, subscriber_id: int = 0,
                 wire_dtype: int = m.WIRE_BF16,
                 reconnect_attempts: int = 5,
                 reconnect_backoff_s: float = 0.5):
        self.target = target
        self.subscriber_id = int(subscriber_id)
        self.wire_dtype = int(wire_dtype)
        self._attempts = int(reconnect_attempts)
        self._backoff = float(reconnect_backoff_s)
        # decorrelated-jitter backoff: each sleep is uniform in [base,
        # min(cap, 3 * the previous sleep)], cap = 8 * base, seeded by
        # the subscriber id, so a fleet that lost one PS does not retry
        # in the same instant, and one follower is reproducible
        self._backoff_cap = self._backoff * 8.0
        self._prev_backoff = self._backoff
        self._jitter_rng = random.Random(0x9E3779B9 ^ self.subscriber_id)
        self._state = DeltaPullState()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: tuple[dict, int] | None = None
        self.degraded = False
        self.degrade_reason = ""
        self.versions_received = 0
        self.versions_consumed = 0
        self.sessions = 0
        self.history: "collections.deque[tuple]" = collections.deque(
            maxlen=HISTORY_KEPT)
        self._obs_version = obs_stats.gauge("serve.follow.version")
        self._obs_degraded = obs_stats.gauge("serve.follow.degraded")
        self._obs_apply = obs_stats.histogram("serve.follow.apply_s")
        self._stop = threading.Event()
        self._client: RpcClient | None = None
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"weight-follower-{subscriber_id}")

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "WeightFollower":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        client, self._client = self._client, None
        if client is not None:
            # closing the channel ends the blocked response iterator
            client.close()
        if self._thread.ident is not None:   # started
            self._thread.join(timeout=5.0)

    # ------------------------------------------------------------- consume
    def poll(self) -> tuple[dict, int] | None:
        """The newest complete (params, version) not yet consumed, or
        None.  Does not block; versions the consumer was too slow for
        are coalesced away (the last one wins)."""
        with self._lock:
            pending, self._pending = self._pending, None
            if pending is not None:
                self.versions_consumed += 1
            return pending

    def wait_for_update(self, timeout: float | None = None
                        ) -> tuple[dict, int] | None:
        """Block until a version not yet consumed lands, then consume it
        (as :meth:`poll`).  Returns None on timeout, or at once after
        stop() or a degrade."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while (self._pending is None and not self.degraded
                   and not self._stop.is_set()):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self._cv.wait(remaining)
            pending, self._pending = self._pending, None
            if pending is not None:
                self.versions_consumed += 1
            return pending

    @property
    def version(self) -> int:
        """The version of the newest weights received (consumed or
        not)."""
        with self._lock:
            return self._state.version

    def base(self) -> dict | None:
        """The follower's own base store (not a copy), for a caller that
        compares it while no version is in flight."""
        return self._state.base

    def _next_backoff(self) -> float:
        """One jittered draw: uniform in [base, min(cap, 3 * previous
        sleep)], remembered for the next draw."""
        hi = max(self._backoff, min(self._backoff_cap,
                                    self._prev_backoff * 3.0))
        sleep = self._jitter_rng.uniform(self._backoff, hi)
        self._prev_backoff = sleep
        return sleep

    # -------------------------------------------------------------- thread
    def _publish(self, result) -> None:
        store = {name: np.array(arr, np.float32, copy=True)
                 for name, arr in self._state.base.items()}
        with self._cv:
            self._pending = (store, self._state.version)
            self.versions_received += 1
            self.history.append((self._state.version, result.crc,
                                 time.time(), result.served_delta))
            self._cv.notify_all()
        self._obs_version.set(self._state.version)

    def _degrade(self, reason: str) -> None:
        with self._cv:
            self.degraded = True
            self.degrade_reason = reason
            self._cv.notify_all()
        self._obs_degraded.set(1)
        log.warning("weight follower degraded (%s): decode keeps serving "
                    "last-good weights (version %d)", reason,
                    self._state.version)

    def _run(self) -> None:
        failures = 0
        while not self._stop.is_set():
            try:
                client = RpcClient(self.target, m.PARAMETER_SERVER_SERVICE,
                                   DELTA_PS_METHODS)
                self._client = client
                held = self._state.version
                self.sessions += 1
                frames = client.call(
                    "SubscribeWeights",
                    SubscribeRequest(subscriber_id=self.subscriber_id,
                                     held_version=max(held, 0),
                                     wire_dtype=self.wire_dtype),
                    timeout=None)
                for batch in _version_batches(frames):
                    if self._stop.is_set():
                        return
                    t0 = time.perf_counter()
                    result = apply_frames(iter(batch), self._state)
                    if self._state.base is not None:
                        self._publish(result)
                        self._obs_apply.observe(time.perf_counter() - t0)
                        failures = 0
                        self._prev_backoff = self._backoff
                if self._stop.is_set():
                    return
                failures += 1   # the server ended the stream (shutdown)
            except DeltaBaseMismatch as exc:
                # the base is poisoned: resubscribe from scratch (held
                # version 0: a full serve)
                log.warning("weight follower base mismatch (%s); "
                            "resubscribing full", exc)
                self._state.invalidate()
                failures += 1
            except grpc.RpcError as exc:
                if self._stop.is_set():
                    return
                if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
                    self._degrade("SubscribeWeights UNIMPLEMENTED "
                                  "(reference PS / delta disabled)")
                    return
                failures += 1
            except Exception as exc:  # noqa: BLE001 — an unexpected error
                # (malformed bytes, a decode bug) degrades, visibly to
                # waiters and the serving loop, instead of ending the
                # thread with degraded still False
                log.exception("weight follower error")
                self._degrade(f"subscription error: {exc}")
                return
            finally:
                client, self._client = self._client, None
                if client is not None:
                    client.close()
            if failures > self._attempts:
                self._degrade(f"subscription lost after {failures} attempts")
                return
            if self._stop.wait(self._next_backoff()):
                return


def _version_batches(frames):
    """Group a SubscribeWeights frame stream into per-version batches
    (one whole serve, full or one delta pair, each), so the follower
    publishes after every version."""
    batch = []
    for frame in frames:
        batch.append(frame)
        if frame.last:
            yield batch
            batch = []
    if batch:
        yield batch
