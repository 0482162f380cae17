"""The port's ``CoordinatorCore`` (core/coordinator_core.py) against the
JAX package's on the same calls and clock, and its width provider
driving the port's ``ParameterServerCore`` barrier."""

import numpy as np
import pytest

from parameter_server_distributed_tpu.core import coordinator_core as ref
from parameter_server_distributed_tpu_torch.core import coordinator_core
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def session(module):
    """The registry calls a coordinator service makes, with the answers
    each gives."""
    clock = Clock()
    coord = module.CoordinatorCore("10.0.0.1", 50051, time_fn=clock)
    provider = coord.width_provider()
    log = [("addr", coord.get_parameter_server_address())]
    for wid in (0, 1, 2):
        log.append(("register", coord.register_worker(
            wid, f"10.0.1.{wid}", 6000 + wid, f"host{wid}")))
    log.append(("register again", coord.register_worker(1, "10.0.1.9", 7000,
                                                        "host9")))
    log.append(("gen", coord.registry_generation(), provider(),
                provider.generation()))
    clock.t += 20.0
    log.append(("beat", coord.update_heartbeat(0, 1),
                coord.update_heartbeat(7, 1)))
    clock.t += 15.0   # workers 1 and 2 silent for 35 s
    log.append(("evict", coord.remove_stale_workers(30.0)))
    log.append(("gen", coord.registry_generation(), provider(),
                provider.generation()))
    log.append(("list", [(e.worker_id, e.address, e.port, e.hostname,
                          e.status, e.last_heartbeat)
                         for e in coord.list_workers()]))
    log.append(("leave", coord.deregister_worker(0),
                coord.deregister_worker(0)))
    log.append(("gen", coord.registry_generation(), coord.live_worker_count()))
    coord.set_parameter_server_address("10.0.0.2", 50061)
    log.append(("addr", coord.get_parameter_server_address()))
    return log


def test_registry_session_matches_reference():
    assert session(coordinator_core) == session(ref)


def test_worker_status_values_match_reference():
    from parameter_server_distributed_tpu.rpc.messages import WorkerStatus

    for name in ("IDLE", "TRAINING", "CHECKPOINTING", "ERROR"):
        assert (getattr(coordinator_core.WorkerStatus, name)
                == getattr(WorkerStatus, name))


def test_list_workers_returns_copies():
    coord = coordinator_core.CoordinatorCore("127.0.0.1", 50051)
    coord.register_worker(0, "a", 1, "h")
    coord.list_workers()[0].status = 3
    assert coord.list_workers()[0].status == coordinator_core.WorkerStatus.IDLE


def test_width_provider_narrows_the_barrier_at_once():
    """A leave moves the registry generation, so the core's TTL-cached
    width refreshes at its next read and the survivor's push closes."""
    coord = coordinator_core.CoordinatorCore("127.0.0.1", 50051)
    for wid in (0, 1):
        coord.register_worker(wid, "127.0.0.1", 6000 + wid, "h")
    ps = ParameterServerCore(total_workers=5,
                             live_workers_fn=coord.width_provider(),
                             live_workers_ttl_s=3600.0)
    ps.initialize_parameters({"w": np.zeros(2, np.float32)})
    r = ps.receive_gradients(0, 1, {"w": np.ones(2, np.float32)})
    assert (r.aggregation_complete, r.total_workers) == (False, 2)
    coord.deregister_worker(1)
    r = ps.receive_gradients(0, 2, {"w": np.ones(2, np.float32)})
    assert (r.aggregation_complete, r.total_workers) == (True, 1)
    assert ps.check_sync_status(1)[1]   # the poll closes iteration 1 too
    np.testing.assert_array_equal(ps.get_parameters()["w"], [-2.0, -2.0])
