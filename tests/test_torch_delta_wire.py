"""The delta protocol across the two packages over loopback gRPC: the
port's PS answering the JAX package's clients and the JAX PS answering
the port's.

- Followers: a port ``WeightFollower`` on a JAX PS and a JAX follower on
  a port PS, both PSs fed the same store and gradients (host SGD, numpy
  paths): at every version the two followers deliver byte-identical
  stores at the same ``store_crc``, the PS's own bf16 full pull, most of
  them as deltas.
- Downgrades: a port PS at ``PSDT_DELTA_DEPTH=0`` answers UNIMPLEMENTED,
  and a follower of either package degrades and stops; a follower whose
  base was poisoned fails the pair's crc and recovers by a full
  re-pull; a worker connection that fails it latches full serves.
- Workers: a JAX client's version-aware pull and fused round from a port
  PS, and a port client's from a JAX PS, each bit for bit a full bf16
  pull of the store, the later rounds as deltas.

Every PS and follower is stopped in a fixture's teardown, every wait has
a deadline, and both packages' C++ host libraries are off."""

import os
import threading

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.delta import chain as ref_chain
from parameter_server_distributed_tpu.delta import \
    subscriber as ref_subscriber
from parameter_server_distributed_tpu.rpc import data_plane as ref_dp
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.delta import chain as tchain
from parameter_server_distributed_tpu_torch.delta.subscriber import \
    WeightFollower
from parameter_server_distributed_tpu_torch.rpc import data_plane
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer

SHAPES = {"emb/w": (40, 16), "l0/w": (16, 48), "l0/b": (48,),
          "odd": (131,)}
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    """numpy paths on both sides, one torch thread, quick subscription
    wakeups."""
    monkeypatch.setenv("PSDT_SUBSCRIBE_POLL_S", "0.05")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    native.set_enabled(False)
    ref_native.set_enabled(False)
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        ref_native.set_enabled(default)
        torch.set_num_threads(threads)


@pytest.fixture
def started(tmp_path):
    """start(side) -> (ps, address); follow(obj) registers a follower or
    client to stop.  Everything is stopped at teardown, followers
    first."""
    servers, others = [], []

    def start(side: str, workers: int = 1):
        cfg = port_config if side == "port" else ref_config
        kw = dict(bind_address="127.0.0.1", port=0, total_workers=workers,
                  checkpoint_dir=str(tmp_path / f"{side}{len(servers)}"),
                  checkpoint_interval=10**6, optimizer="sgd",
                  learning_rate=0.5)
        if side == "port":
            kw["device"] = "cpu"
        else:
            kw["autosave_period_s"] = 600.0
        ps = (ParameterServer if side == "port" else RefParameterServer)(
            cfg.ParameterServerConfig(**kw))
        servers.append(ps)
        return ps, f"127.0.0.1:{ps.start()}"

    def keep(obj):
        others.append(obj)
        return obj

    start.keep = keep
    yield start
    for obj in reversed(others):
        if hasattr(obj, "stop"):
            obj.stop()
        else:
            obj.close()
    for ps in reversed(servers):
        ps.stop()


def init_store(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def grads(rng) -> dict:
    return {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
            for k, s in SHAPES.items()}


def bf16_full_pull(address: str, port_side: bool) -> dict:
    """What a full bf16 pull from the PS at ``address`` decodes to."""
    client = (data_plane.PSClient(address) if port_side
              else ref_dp.PSClient(address))
    try:
        mm = m if port_side else ref_m
        resp = client.pull_parameters(mm.PullRequest(
            wire_dtype=mm.WIRE_BF16), timeout=WAIT_S)
        return {t.name: t.to_array() for t in resp.parameters}
    finally:
        client.close()


def same_bytes(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        np.asarray(a[k], np.float32).tobytes()
        == np.asarray(b[k], np.float32).tobytes() for k in a)


def test_followers_across_packages_reach_the_same_crc(started):
    (port_ps, port_addr), (ref_ps, ref_addr) = (started("port"),
                                                started("jax"))
    for ps in (port_ps, ref_ps):
        ps.core.initialize_parameters(init_store())
    port_follower = started.keep(
        WeightFollower(ref_addr, subscriber_id=1).start())
    ref_follower = started.keep(ref_subscriber.WeightFollower(
        port_addr, subscriber_id=2).start())
    rng = np.random.default_rng(1)
    for step in range(5):
        if step:
            g = grads(rng)
            for ps in (port_ps, ref_ps):
                r = ps.core.receive_gradients(
                    0, step, {k: v.copy() for k, v in g.items()})
                assert r.aggregation_complete
        want = {side: ps.core.serve_version()
                for side, ps in (("port", port_ps), ("jax", ref_ps))}
        got = {}
        for side, follower in (("jax", port_follower),
                               ("port", ref_follower)):
            while True:
                update = follower.wait_for_update(timeout=WAIT_S)
                assert update is not None, (side, step, follower.degraded)
                if update[1] == want[side]:
                    break
            got[side] = update[0]
        assert same_bytes(got["port"], got["jax"]), step
        assert (tchain.store_crc(got["port"])
                == ref_chain.store_crc(got["jax"]))
        assert same_bytes(got["port"], bf16_full_pull(port_addr, True))
        assert same_bytes(got["jax"], bf16_full_pull(ref_addr, False))
    assert not port_follower.degraded and not ref_follower.degraded
    assert port_follower.sessions == 1
    # the first version was full, then the apply after the arm reseeded;
    # the rest came as checked deltas
    served = [h[3] for h in port_follower.history]
    assert served[0] is False and sum(served) >= 2
    assert all(h[1] is not None for h in port_follower.history if h[3])


@pytest.mark.parametrize("follower_side", ["port", "jax"])
def test_follower_degrades_on_unimplemented(started, monkeypatch,
                                            follower_side):
    monkeypatch.setenv("PSDT_DELTA_DEPTH", "0")
    ps, addr = started("port")
    ps.core.initialize_parameters(init_store())
    cls = (WeightFollower if follower_side == "port"
           else ref_subscriber.WeightFollower)
    follower = started.keep(cls(addr, subscriber_id=3))
    follower.start()
    assert follower.wait_for_update(timeout=WAIT_S) is None
    assert follower.degraded and "UNIMPLEMENTED" in follower.degrade_reason


def test_follower_recovers_from_a_crc_mismatch(started):
    ps, addr = started("port")
    ps.core.initialize_parameters(init_store())
    follower = started.keep(WeightFollower(addr, subscriber_id=4))
    follower.start()
    rng = np.random.default_rng(2)
    assert follower.wait_for_update(timeout=WAIT_S) is not None
    for it in (1, 2):
        ps.core.receive_gradients(0, it, grads(rng))
        while follower.wait_for_update(timeout=WAIT_S)[1] \
                != ps.core.serve_version():
            pass
    assert follower.history[-1][3]          # a delta came
    follower._state.base["l0/w"][0, 0] += 1.0   # poison the base
    ps.core.receive_gradients(0, 3, grads(rng))
    while True:
        store, version = follower.wait_for_update(timeout=WAIT_S)
        if version == ps.core.serve_version():
            break
    assert follower.sessions == 2 and not follower.degraded
    assert not follower.history[-1][3]      # recovered by a full serve
    assert same_bytes(store, bf16_full_pull(addr, True))


def _round(client, port_client: bool, wid: int, it: int, g: dict):
    mm = m if port_client else ref_m
    return client.delta_push_pull(
        wid, it, lambda: [mm.Tensor.from_array(k, v) for k, v in g.items()],
        pull_wire_dtype=mm.WIRE_BF16, timeout=WAIT_S)


@pytest.mark.parametrize("client_side", ["jax", "port"])
def test_worker_delta_rounds_across_packages(started, monkeypatch,
                                             client_side):
    """A client of one package against the other's PS: the version-aware
    pull, then fused rounds of two workers, every store bit for bit a
    full bf16 pull, the steady rounds delta-served; then a poisoned base
    latches the connection to full serves."""
    monkeypatch.setenv("PSDT_SHM", "0")     # the rings skip the deltas
    port_client = client_side == "port"
    ps, addr = started("jax" if port_client else "port", workers=2)
    ps.core.initialize_parameters(init_store())
    mm = m if port_client else ref_m
    cls = data_plane.PSClient if port_client else ref_dp.PSClient
    clients = [started.keep(cls(addr)) for _ in range(2)]
    first = clients[0].delta_pull(mm.PullRequest(wire_dtype=mm.WIRE_BF16),
                                  timeout=WAIT_S)
    assert first is not None and not first.served_delta
    assert same_bytes(first.store, bf16_full_pull(addr, not port_client))
    rng = np.random.default_rng(3)
    served = []
    for it in (1, 2, 3):
        g = [grads(rng) for _ in clients]
        results = [None, None]

        def run(wid):
            results[wid] = _round(clients[wid], port_client, wid, it,
                                  g[wid])

        threads = [threading.Thread(target=run, args=(w,)) for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S * 2)
        assert not any(t.is_alive() for t in threads)
        oracle = bf16_full_pull(addr, not port_client)
        for r in results:
            assert r is not None and r.push.success
            assert same_bytes(r.store, oracle)
        served.append([r.served_delta for r in results])
    assert served[-1] == [True, True]
    # a poisoned base fails the pair's crc: None, and full for good
    clients[0]._delta_state.base["odd"][0] += 1.0
    ps.core.receive_gradients(0, 4, grads(rng))
    ps.core.receive_gradients(1, 4, grads(rng))
    assert clients[0].delta_pull(mm.PullRequest(wire_dtype=mm.WIRE_BF16),
                                 timeout=WAIT_S) is None
    assert clients[0]._delta_ok is False
    pulled = clients[0].pull_parameters(
        mm.PullRequest(wire_dtype=mm.WIRE_BF16), timeout=WAIT_S)
    assert same_bytes({t.name: t.to_array() for t in pulled.parameters},
                      bf16_full_pull(addr, not port_client))
