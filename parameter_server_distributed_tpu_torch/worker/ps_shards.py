"""The sharded parameter-server client: the port of ``shard_owner`` and
``ShardedPSClient`` from parameter_server_distributed_tpu/worker/ps_shards.py.

BASELINE config 3 ("4 PS shards / 8 workers, sharded push/pull") across
processes: the store is partitioned by tensor name over several ordinary
PS processes.  Each tensor has one owner shard, the CRC32 of its name
modulo the shard count, the same on every worker with no coordination;
pushes and pulls fan out per owner and the responses merge back into
one store.

``ShardedPSClient`` offers the ``call(method, request)`` surface of
``rpc.service.RpcClient`` and the data-plane methods of
``rpc.data_plane.PSClient``, so ``worker.Worker`` uses either; the
coordinator's discovery answer (the shard map, or field 3 of
``GetPSAddressResponse``) decides which it builds.  Over one address it
behaves as the single-PS client.

Each shard keeps the semantics of ``ParameterServerCore``: every worker
pushes to EVERY shard each iteration (a shard that owns nothing of the
push still receives an empty gradient list), so each shard's barrier
counts the same workers and iterations as an unsharded PS.

With a ``ShardMapClient`` (replication/failover.py) the client reads the
coordinator's epoch-numbered map: a push rejected with the
``stale shard map`` marker waits for a newer map, rebuilds the shard
connections and replays the round; a shard RPC that dies with a
transport error is reported, and retried against a promoted backup if
the coordinator names one.  The port's coordinator keeps a static map
without backups, so the report leaves the error standing.  Not ported:
backups, promotion and resharding (ROADMAP.md Queue 1, item 13), the
span propagation into the fan-out threads and the flight events (item
14).
"""

from __future__ import annotations

import logging
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import grpc

from ..replication.failover import ShardMapClient, _status_code
from ..replication.messages import STALE_SHARD_MAP
from ..rpc import messages as m
from ..rpc.data_plane import PSClient

log = logging.getLogger("pst.shards")


def shard_owner(name: str, n_shards: int) -> int:
    """Tensor name -> shard index (CRC32 of the UTF-8 name: the same in
    every process and run, unlike Python's salted ``hash``)."""
    return zlib.crc32(name.encode("utf-8")) % n_shards


def _is_stale_map(response) -> bool:
    message = getattr(response, "message", "") or ""
    return (getattr(response, "success", True) is False
            and STALE_SHARD_MAP in message)


class ShardedPSClient:
    """Fan-out and merge over N parameter-server shards.  Each shard
    connection is a :class:`rpc.data_plane.PSClient`, so each rides the
    chunk streams and the same-host rings on its own, with its own unary
    fallback against a reference PS.  ``shard_map`` (optional) follows
    the coordinator's map; see the module docstring."""

    # a round replays at most this often (a stale-map repartition or a
    # failover retry; two cover one racing the other)
    _MAX_ROUND_REPLAYS = 3

    # the hierarchical-aggregation tier (item 10) does not sit between
    # the partitioner and N shard barriers
    supports_tiers = False

    def __init__(self, addresses: Sequence[str],
                 service: str = m.PARAMETER_SERVER_SERVICE,
                 methods=None,
                 shard_map: ShardMapClient | None = None):
        if not addresses:
            raise ValueError("need at least one PS shard address")
        self._service = service
        self._methods = methods
        self._shard_map = shard_map
        # guards the address, client and pool triple while a failover or
        # a rebuild swaps them (the fan-out threads read them)
        self._topology_lock = threading.Lock()
        self.addresses: list[str] = []
        self._clients: list[PSClient] = []
        self._pool: ThreadPoolExecutor | None = None
        self._build(list(addresses))

    def _build(self, addresses: list[str]) -> None:
        self.addresses = list(addresses)
        self._clients = [PSClient(addr, self._service, self._methods)
                         for addr in addresses]
        # the shards' RPCs are independent: issued at once, a fan-out
        # takes the slowest shard's time, not the sum
        self._pool = (ThreadPoolExecutor(
            max_workers=len(self._clients),
            thread_name_prefix="ps-shard") if len(self._clients) > 1
            else None)

    def _rebuild(self, addresses: list[str]) -> None:
        """Replace the whole shard topology."""
        with self._topology_lock:
            old_clients, old_pool = self._clients, self._pool
            self._build(addresses)
        for client in old_clients:
            client.close()
        if old_pool is not None:
            old_pool.shutdown(wait=False)
        log.info("shard topology rebuilt: %d shards %s",
                 len(addresses), addresses)

    @property
    def num_shards(self) -> int:
        return len(self._clients)

    @property
    def shm_active(self) -> bool:
        """True once any shard connection rides the same-host rings
        (each connection negotiates on its own)."""
        return any(getattr(c, "shm_active", False) for c in self._clients)

    def close(self) -> None:
        for client in self._clients:
            client.close()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self._shard_map is not None:
            self._shard_map.close()

    # ------------------------------------------------ failover / topology
    def _with_failover(self, index: int, fn):
        """``fn(client)`` against shard ``index``.  A transport error
        (anything but UNIMPLEMENTED, which the PSClient's fallbacks own)
        is reported to the coordinator; if it names another primary the
        connection moves there and the same call runs once more, else
        the error stands."""
        with self._topology_lock:
            client = self._clients[index]
            address = self.addresses[index]
        try:
            return fn(client)
        except grpc.RpcError as exc:
            if (self._shard_map is None
                    or _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED):
                raise
            log.warning("shard %d (%s) failed mid-call (%s); reporting it",
                        index, address, _status_code(exc))
            replacement = self._shard_map.report_failure(index, address)
            if not replacement or replacement == address:
                raise   # nothing promoted: the error stands
            with self._topology_lock:
                if self.addresses[index] == address:
                    self._clients[index].close()
                    self._clients[index] = PSClient(
                        replacement, self._service, self._methods)
                    self.addresses[index] = replacement
                client = self._clients[index]
            log.warning("shard %d moved %s -> %s; retrying the round there",
                        index, address, replacement)
            return fn(client)

    def refresh_topology(self, wait_for_epoch_above: int | None = None,
                         timeout: float = 15.0) -> bool:
        """Fetch the shard map again (waiting, if asked, for its epoch to
        pass ``wait_for_epoch_above``) and rebuild the connections if the
        primaries changed.  True when the topology changed."""
        if self._shard_map is None:
            return False
        if wait_for_epoch_above is not None:
            self._shard_map.wait_for_epoch_above(wait_for_epoch_above,
                                                 timeout=timeout)
        elif not self._shard_map.refresh():
            return False
        new = self._shard_map.primaries()
        if new and new != self.addresses:
            self._rebuild(new)
            return True
        return False

    def _repartition_after_stale_map(self) -> bool:
        """A shard refused a push with the stale-map marker: wait for a
        newer map, rebuild, and say whether a replay is worth it."""
        if self._shard_map is None:
            return False
        known = self._shard_map.epoch
        if self.refresh_topology(wait_for_epoch_above=known):
            return True
        # the epoch moved without an address change: one replay still
        return self._shard_map.epoch > known

    # ------------------------------------------------------------------ call
    def call(self, method: str, request, timeout: float | None = None):
        for _ in range(self._MAX_ROUND_REPLAYS):
            if self.num_shards == 1:
                resp = self._with_failover(
                    0, lambda c: c.call(method, request, timeout=timeout))
            else:
                handler = getattr(self, f"_call_{method}", None)
                if handler is None:
                    raise ValueError(f"unsupported sharded method {method!r}")
                resp = handler(request, timeout)
            if not _is_stale_map(resp):
                return resp
            if not self._repartition_after_stale_map():
                return resp
        return resp

    def _submit(self, fn, *fn_args, **fn_kwargs):
        # a plain submit: carrying the caller's span into the fan-out
        # thread is item 14's (obs/trace.py)
        return self._pool.submit(fn, *fn_args, **fn_kwargs)

    def _fan_out(self, method: str, requests, timeout):
        futures = [
            self._submit(self._with_failover, i,
                         lambda c, req=request: c.call(method, req,
                                                       timeout=timeout))
            for i, request in enumerate(requests)]
        return [f.result() for f in futures]

    # ------------------------------------------------------------- push path
    def push_gradients(self, update: m.GradientUpdate,
                       timeout: float | None = None) -> m.PushResponse:
        """The chunk-stream push, fanned out per shard at once; merged and
        retried as the unary path."""
        for _ in range(self._MAX_ROUND_REPLAYS):
            if self.num_shards == 1:
                resp = self._with_failover(
                    0, lambda c: c.push_gradients(update, timeout=timeout))
            else:
                resp = self._push_sharded(update, timeout, stream=True)
            if not _is_stale_map(resp):
                return resp
            if not self._repartition_after_stale_map():
                return resp
        return resp

    def _call_ReceiveGradients(self, request: m.GradientUpdate, timeout):
        return self._push_sharded(request, timeout, stream=False)

    def _partition(self, tensors) -> list[list]:
        """Tensors (an iterable, or a callable returning one) -> one list
        per shard, by owner; a shard that owns none gets an empty list,
        which pushed still counts at its barrier."""
        per_shard: list[list] = [[] for _ in range(self.num_shards)]
        for tensor in (tensors() if callable(tensors) else tensors):
            per_shard[shard_owner(tensor.name, self.num_shards)].append(
                tensor)
        return per_shard

    @staticmethod
    def _merge_pushes(responses) -> m.PushResponse:
        return m.PushResponse(
            success=all(r.success for r in responses),
            message="; ".join(sorted({r.message for r in responses})),
            iteration=max(r.iteration for r in responses),
            aggregation_complete=all(r.aggregation_complete
                                     for r in responses),
            workers_received=min(r.workers_received for r in responses),
            total_workers=max(r.total_workers for r in responses))

    @staticmethod
    def _bounded_stale(response) -> bool:
        """A bounded-staleness (async) refusal, not the stale-map marker
        (the round-replay loop owns that)."""
        return (not response.success and "stale" in response.message
                and STALE_SHARD_MAP not in response.message)

    def _push_sharded(self, request: m.GradientUpdate, timeout,
                      stream: bool) -> m.PushResponse:
        def push(client, update):
            if stream:
                return client.push_gradients(update, timeout=timeout)
            return client.call("ReceiveGradients", update, timeout=timeout)

        per_shard = self._partition(request.gradients)
        updates = [m.GradientUpdate(worker_id=request.worker_id,
                                    iteration=request.iteration,
                                    gradients=tensors)
                   for tensors in per_shard]
        futures = [self._submit(self._with_failover, i,
                                lambda c, u=update: push(c, u))
                   for i, update in enumerate(updates)]
        responses = [f.result() for f in futures]
        # async partial refusal: a shard that accepted applied the push on
        # arrival, so a whole retry would apply its partition twice.
        # Re-push only the refused shards, the same payload at each one's
        # current iteration (bounded staleness allows a later logical
        # time), so every shard applies exactly one update a batch
        for _ in range(3):
            stale = [i for i, r in enumerate(responses)
                     if self._bounded_stale(r)]
            if not stale:
                break
            for i in stale:
                responses[i] = self._with_failover(
                    i, lambda c, i=i: push(c, m.GradientUpdate(
                        worker_id=request.worker_id,
                        iteration=responses[i].iteration,
                        gradients=per_shard[i])))
        return self._merge_pushes(responses)

    # ------------------------------------------------------------ fused path
    def push_pull(self, worker_id: int, iteration: int, tensors,
                  pull_wire_dtype: int = 0, timeout: float | None = None,
                  on_chunk=None) -> tuple[m.PushResponse,
                                          m.ParameterUpdate | None]:
        """The fused push→barrier→pull round fanned out per shard, one
        ``PushPullStream`` round a shard, at once.  Every shard gets a
        push (its partition, or an empty one); a bounded-staleness
        refusal re-pushes only the refused shards (``_push_sharded``).
        The merged parameters are None, and the caller polls the barrier
        and pulls, unless every shard delivered fresh parameters.  A
        stale-map refusal waits for the newer map and replays the whole
        round against the new partition."""
        if self._shard_map is None and self.num_shards == 1:
            # the single-PS round, the lazy producer included
            return self._clients[0].push_pull(
                worker_id, iteration, tensors,
                pull_wire_dtype=pull_wire_dtype, timeout=timeout,
                on_chunk=on_chunk)
        # replays re-read the tensors, so a lazy producer (the trainer's
        # bucketed download) is drained once here: the per-bucket
        # overlap of download and transport is the single-PS path's
        all_tensors = list(tensors() if callable(tensors) else tensors)
        for _ in range(self._MAX_ROUND_REPLAYS):
            result = self._push_pull_once(worker_id, iteration, all_tensors,
                                          pull_wire_dtype, timeout, on_chunk)
            if not _is_stale_map(result[0]):
                return result
            log.warning("worker %d: push refused stale-shard-map at "
                        "iteration %d; refreshing the topology", worker_id,
                        iteration)
            if not self._repartition_after_stale_map():
                return result
        return result

    def _push_pull_once(self, worker_id: int, iteration: int, all_tensors,
                        pull_wire_dtype, timeout, on_chunk):
        if self.num_shards == 1:
            return self._with_failover(0, lambda c: c.push_pull(
                worker_id, iteration, all_tensors,
                pull_wire_dtype=pull_wire_dtype, timeout=timeout,
                on_chunk=on_chunk))
        per_shard = self._partition(all_tensors)

        def fused(client, shard_tensors, it):
            return client.push_pull(worker_id, it, shard_tensors,
                                    pull_wire_dtype=pull_wire_dtype,
                                    timeout=timeout, on_chunk=on_chunk)

        futures = [
            self._submit(self._with_failover, i,
                         lambda c, t=shard_tensors: fused(c, t, iteration))
            for i, shard_tensors in enumerate(per_shard)]
        results = [f.result() for f in futures]
        for _ in range(3):
            stale = [i for i, (push, _) in enumerate(results)
                     if self._bounded_stale(push)]
            if not stale:
                break
            for i in stale:
                results[i] = self._with_failover(
                    i, lambda c, i=i: fused(c, per_shard[i],
                                            results[i][0].iteration))
        merged_push = self._merge_pushes([push for push, _ in results])
        stores = [params for _, params in results]
        if not merged_push.success or any(s is None for s in stores):
            return merged_push, None
        return merged_push, self._merge_pulls(stores)

    # ------------------------------------------------------------- pull path
    def pull_parameters(self, request: m.PullRequest,
                        timeout: float | None = None,
                        on_chunk=None) -> m.ParameterUpdate:
        """The chunk-stream pull fanned out per shard at once, merged as
        the unary path.  ``on_chunk`` runs on the fan-out threads, for
        several shards at once: each call must be safe beside the others
        (the worker's inserts into one dict are: the shards' names are
        disjoint)."""
        if self.num_shards == 1:
            return self._with_failover(0, lambda c: c.pull_parameters(
                request, timeout=timeout, on_chunk=on_chunk))
        futures = [
            self._submit(self._with_failover, i,
                         lambda c: c.pull_parameters(request,
                                                     timeout=timeout,
                                                     on_chunk=on_chunk))
            for i in range(self.num_shards)]
        return self._merge_pulls([f.result() for f in futures])

    def _call_ServeParameters(self, request: m.PullRequest, timeout):
        return self._merge_pulls(
            self._fan_out("ServeParameters",
                          [request] * self.num_shards, timeout))

    @staticmethod
    def _merge_pulls(responses) -> m.ParameterUpdate:
        merged: list = []
        for response in responses:
            merged.extend(response.parameters)
        return m.ParameterUpdate(
            iteration=max(r.iteration for r in responses),
            parameters=merged,
            ready=all(r.ready for r in responses))

    # ------------------------------------------------------------------ sync
    def _call_CheckSyncStatus(self, request: m.SyncStatusRequest, timeout):
        responses = self._fan_out("CheckSyncStatus",
                                  [request] * self.num_shards, timeout)
        return m.SyncStatusResponse(
            iteration=request.iteration,
            ready=all(r.ready for r in responses),
            workers_received=min(r.workers_received for r in responses),
            total_workers=max(r.total_workers for r in responses))

    # ------------------------------------------------------------ checkpoint
    def _shard_path(self, path: str, index: int) -> str:
        """A shard's own checkpoint path: shards may share a file system,
        so an explicit path gets a ``.shard<N>`` suffix (shard 0 keeps the
        bare path, as reference tools expect)."""
        if not path or index == 0:
            return path
        return f"{path}.shard{index}"

    def _call_SaveCheckpoint(self, request: m.SaveCheckpointRequest, timeout):
        responses = self._fan_out(
            "SaveCheckpoint",
            [m.SaveCheckpointRequest(epoch=request.epoch,
                                     path=self._shard_path(request.path, i))
             for i in range(self.num_shards)], timeout)
        return m.SaveCheckpointResponse(
            success=all(r.success for r in responses),
            message="; ".join(sorted({r.message for r in responses})),
            checkpoint_path=responses[0].checkpoint_path)

    def _call_LoadCheckpoint(self, request: m.LoadCheckpointRequest, timeout):
        responses = self._fan_out(
            "LoadCheckpoint",
            [m.LoadCheckpointRequest(path=self._shard_path(request.path, i))
             for i in range(self.num_shards)], timeout)
        merged: list = []
        for response in responses:
            merged.extend(response.parameters)
        return m.LoadCheckpointResponse(
            success=all(r.success for r in responses),
            message="; ".join(sorted({r.message for r in responses})),
            epoch=max(r.epoch for r in responses),
            parameters=merged)
