"""The port's same-host transport (rpc/shm_transport.py) and its use by
the data plane (rpc/data_plane.py ``PSClient``, server/ps_service.py).

- ``ShmRing``, with the native copy and without it: frames wrap around
  the ring, a frame many times the ring's size streams through it, an
  empty frame is data and the end marker is not, a closed ring wakes its
  waiter, a wait past its deadline raises, and an ndarray (a pinned
  buffer's view, say) is a frame like bytes.
- A fused round over the rings is bit for bit the same round over gRPC:
  a port client on the port's PS and on the JAX package's PS, and a JAX
  client on the port's PS (each negotiates the other's rings), with
  rings of 64 KB so every frame streams through in pieces.
- Each downgrade to gRPC is permanent and counted in ``rpc.shm.fallback``
  while the round still succeeds: a host mismatch, an attach failure, a
  transport error mid-round, and a PS process started with
  ``PSDT_SHM=0``.  ``PSDT_SHM=0`` at the client asks nothing.
- A client that closes has its segments reaped at once; a PS process
  stopped with a fused handler parked on the barrier exits 0 and leaves
  no segment in /dev/shm.

Every server is stopped, every thread joined and every process waited
on with a timeout; segment names are unique per test and unlinked;
``PSDT_SHM`` and ``PSDT_SHM_RING_BYTES`` are set through monkeypatch
only."""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.rpc import data_plane as ref_plane
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.obs import stats
from parameter_server_distributed_tpu_torch.rpc import data_plane
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc import shm_transport as shm
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"w": (300, 200), "b": (200,), "s": ()}
RING = 1 << 16
JOIN_S = 60.0


def _default() -> bool:
    return os.environ.get("PSDT_NATIVE", "1").lower() not in ("0", "false")


@pytest.fixture(autouse=True)
def switches():
    yield
    native.set_enabled(_default())
    ref_native.set_enabled(_default())


# ------------------------------------------------------------------ rings
@pytest.fixture(params=["native_copy", "memoryview_copy"])
def rings(request):
    """make(capacity, doorbell=False) -> (producer ring, consumer ring)
    over one segment of a unique name, attached as the two ends of a
    connection are; everything made is closed and unlinked at teardown."""
    native.set_enabled(request.param == "native_copy")
    if request.param == "native_copy" and native.lib() is None:
        pytest.skip("the native library cannot be built here (no g++)")
    made = []

    def make(capacity: int, doorbell: bool = False):
        name = f"psdt-test-{uuid.uuid4().hex[:12]}"
        owner = shm._create_segment(name, shm._HEADER + capacity)
        peer = shm._attach_segment(name)
        bells = [None, None]
        if doorbell:
            a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
            bells = [shm._Doorbell(a), shm._Doorbell(b)]
        pair = (shm.ShmRing(owner, capacity, bells[0]),
                shm.ShmRing(peer, capacity, bells[1]))
        made.append((owner, peer, bells, pair))
        return pair

    yield make
    for owner, peer, bells, pair in made:
        for ring in pair:
            ring.invalidate()
        for bell in bells:
            if bell is not None:
                bell.close()
        peer.close()
        owner.close()
        owner.unlink()


def _consume(ring, out: list, errors: list, frames: int) -> threading.Thread:
    def run():
        try:
            for _ in range(frames):
                out.append(ring.read_frame(time.monotonic() + JOIN_S))
        except Exception as exc:  # noqa: BLE001 — asserted by the caller
            errors.append(exc)
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


@pytest.mark.parametrize("doorbell", [False, True])
def test_frames_wrap_and_outgrow_the_ring(rings, doorbell):
    prod, cons = rings(4096, doorbell)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, n, np.uint8).tobytes()
                for n in (1000, 3000, 4093, 1, 2500, 40_000, 999, 123_457)]
    out, errors = [], []
    thread = _consume(cons, out, errors, len(payloads) + 1)
    deadline = time.monotonic() + JOIN_S
    for payload in payloads:
        prod.write_frame(payload, deadline)
    prod.write_end(deadline)
    thread.join(JOIN_S)
    assert not thread.is_alive() and not errors, errors
    assert out == payloads + [None]


def test_empty_frame_is_data_and_an_ndarray_is_a_frame(rings):
    prod, cons = rings(256)
    arr = np.arange(100, dtype=np.float32)   # 400 bytes: past the ring
    out, errors = [], []
    thread = _consume(cons, out, errors, 3)
    deadline = time.monotonic() + JOIN_S
    prod.write_frame(b"", deadline)
    prod.write_frame(arr, deadline)
    prod.write_end(deadline)
    thread.join(JOIN_S)
    assert not thread.is_alive() and not errors, errors
    assert out == [b"", arr.tobytes(), None]


def test_close_wakes_the_waiter_and_a_deadline_raises(rings):
    prod, cons = rings(256, doorbell=True)
    with pytest.raises(shm.ShmTransportError, match="timeout"):
        cons.read_frame(time.monotonic() + 0.05)
    out, errors = [], []
    thread = _consume(cons, out, errors, 1)
    time.sleep(0.05)
    prod.close()
    thread.join(10.0)
    assert not thread.is_alive()
    assert len(errors) == 1 and "closed" in str(errors[0])
    with pytest.raises(shm.ShmTransportError, match="closed"):
        prod.write_frame(b"x" * 1000, time.monotonic() + 5.0)


def test_two_processes_stream_through_a_ring_intact(rings):
    """A producer process streams 96 frames of 1-3 MB through a 4 MB
    ring to this process: every byte arrives, in order.  The cursors
    move by up to 1 MB a store, so a reader that could see half a store
    (a cursor read byte by byte) would read unwritten bytes or copy a
    negative length."""
    name = f"psdt-test-{uuid.uuid4().hex[:12]}"
    cap = 4 << 20
    owner = shm._create_segment(name, shm._HEADER + cap)
    cons = shm.ShmRing(owner, cap)
    script = (
        "import sys, time\n"
        "import numpy as np\n"
        "from parameter_server_distributed_tpu_torch import native\n"
        "from parameter_server_distributed_tpu_torch.rpc import "
        "shm_transport as shm\n"
        f"native.set_enabled({native.copy_fn() is not None})\n"
        f"seg = shm._attach_segment({name!r})\n"
        f"ring = shm.ShmRing(seg, {cap})\n"
        "rng = np.random.default_rng(0)\n"
        "deadline = time.monotonic() + 60\n"
        "for i in range(96):\n"
        "    n = int(rng.integers(1 << 20, 3 << 20))\n"
        "    ring.write_frame(np.full(n, i % 251, np.uint8), deadline)\n"
        "ring.write_end(deadline)\n"
        "ring.invalidate()\n"
        "seg.close()\n")
    proc = subprocess.Popen([sys.executable, "-c", script],
                            env={**os.environ, "PYTHONPATH": REPO},
                            stderr=subprocess.PIPE, text=True)
    try:
        rng = np.random.default_rng(0)
        deadline = time.monotonic() + JOIN_S
        for i in range(96):
            frame = cons.read_frame(deadline)
            n = int(rng.integers(1 << 20, 3 << 20))
            assert frame is not None and len(frame) == n, i
            assert frame.count(i % 251) == n, f"frame {i} corrupted"
        assert cons.read_frame(deadline) is None
        assert proc.wait(timeout=JOIN_S) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        cons.invalidate()
        owner.close()
        owner.unlink()


# ------------------------------------------------------- fused rounds
@pytest.fixture
def servers(tmp_path):
    """start(pkg) -> (ps, port): a one-worker PS of the port ("port") or
    of the JAX package ("jax"), host SGD at lr 0.1, its store set; each
    stopped at teardown."""
    started = []

    def start(pkg: str):
        kw = dict(bind_address="127.0.0.1", port=0, total_workers=1,
                  checkpoint_interval=1000,
                  checkpoint_dir=str(tmp_path / f"ck{len(started)}"),
                  optimizer="sgd", learning_rate=0.1)
        if pkg == "port":
            ps = ParameterServer(port_config.ParameterServerConfig(
                device="cpu", **kw))
        else:
            ps = RefParameterServer(ref_config.ParameterServerConfig(
                autosave_period_s=600.0, **kw))
        started.append(ps)
        port = ps.start()
        ps.core.initialize_parameters(_store(0))
        return ps, port

    yield start
    for ps in reversed(started):
        ps.stop()


def _store(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}


def _rounds(client, msgs, n: int = 2, start: int = 0) -> list[dict]:
    """``n`` fused bf16 rounds of worker 0 from iteration ``start``; the
    parameters each returned, as f32 arrays."""
    got = []
    for it in range(start, start + n):
        grads = _store(10 + it)
        tensors = [msgs.Tensor.from_array(name, g,
                                          wire_dtype=msgs.WIRE_BF16)
                   for name, g in grads.items()]
        push, params = client.push_pull(0, it, tensors,
                                        pull_wire_dtype=msgs.WIRE_BF16,
                                        timeout=JOIN_S)
        assert push.success, push.message
        assert params is not None and params.ready
        got.append({t.name: t.to_array() for t in params.parameters})
    return got


def _fallbacks() -> int:
    return stats.counter("rpc.shm.fallback").value


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_a_round_over_shm_is_the_round_over_grpc(servers, monkeypatch,
                                                 client_pkg, server_pkg):
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    make = (data_plane.PSClient if client_pkg == "port"
            else ref_plane.PSClient)
    msgs = m if client_pkg == "port" else ref_m
    results, stores = {}, {}
    for transport in ("shm", "grpc"):
        monkeypatch.setenv("PSDT_SHM", "1" if transport == "shm" else "0")
        ps, port = servers(server_pkg)
        before = stats.counter("rpc.shm.bytes").value
        client = make(f"127.0.0.1:{port}")
        try:
            results[transport] = _rounds(client, msgs)
            assert client._shm_ok is (True if transport == "shm" else None)
        finally:
            client.close()
        # this process's side of the rings: bf16 pushes and pulls
        moved = stats.counter("rpc.shm.bytes").value - before
        if transport == "shm":
            assert moved > 4 * sum(np.prod(s) for s in SHAPES.values())
        else:
            assert moved == 0
        stores[transport] = {k: np.asarray(v) for k, v in
                             ps.core.get_parameters().items()}
    for it, (a, b) in enumerate(zip(results["shm"], results["grpc"])):
        assert sorted(a) == sorted(b) == sorted(SHAPES)
        for name in a:
            assert a[name].tobytes() == b[name].tobytes(), (it, name)
    for name in SHAPES:
        assert stores["shm"][name].tobytes() == \
            stores["grpc"][name].tobytes()


def test_downgrades_are_permanent_and_counted(servers, monkeypatch):
    monkeypatch.setenv("PSDT_SHM", "1")
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    ps, port = servers("port")

    def downgraded(client) -> None:
        before = _fallbacks()
        _rounds(client, m, n=1)
        assert client._shm_ok is False and not client.shm_active
        assert _fallbacks() == before + 1
        _rounds(client, m, n=1)          # for good: no second attempt
        assert _fallbacks() == before + 1

    # a host mismatch: the server refuses
    monkeypatch.setattr(shm, "host_id", lambda: "another-host/boot")
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    try:
        downgraded(client)
    finally:
        client.close()
    monkeypatch.undo()
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    # an attach failure: the segments are not reachable from the client
    monkeypatch.setattr(shm, "_attach_segment",
                        lambda name: (_ for _ in ()).throw(
                            FileNotFoundError(name)))
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    try:
        downgraded(client)
    finally:
        client.close()
    monkeypatch.undo()
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    # a transport error mid-round: the round is replayed over gRPC
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    try:
        _rounds(client, m, n=1)
        assert client.shm_active
        conn = client._shm_conn

        def broken(frames, timeout):
            raise shm.ShmTransportError("ring torn down")
        monkeypatch.setattr(conn, "round_trip", broken)
        downgraded(client)
    finally:
        client.close()
    # PSDT_SHM=0 at the client: nothing is negotiated
    monkeypatch.setenv("PSDT_SHM", "0")
    calls = stats.counter("rpc.client.NegotiateShm.calls").value
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    try:
        _rounds(client, m, n=1)
        assert client._shm_ok is None
    finally:
        client.close()
    assert stats.counter("rpc.client.NegotiateShm.calls").value == calls


def _wait_gone(names, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not any(os.path.exists(f"/dev/shm/{n}") for n in names):
            return True
        time.sleep(0.05)
    return False


def test_segments_are_reaped_when_the_client_closes(servers, monkeypatch):
    monkeypatch.setenv("PSDT_SHM", "1")
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    ps, port = servers("port")
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    try:
        _rounds(client, m, n=1)
        assert ps.service.shm_server.connections == 1
        conn = ps.service.shm_server._conns[0]
        names = [conn.c2s_name, conn.s2c_name]
        assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
    finally:
        client.close()
    assert _wait_gone(names)
    deadline = time.monotonic() + 10.0
    while ps.service.shm_server.connections and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert ps.service.shm_server.connections == 0


# ------------------------------------------------------ PS processes
def _spawn_ps(tmp_path, env_extra: dict, workers: int):
    env = {**os.environ, "PYTHONPATH": REPO, **env_extra}
    log = tmp_path / f"ps-{uuid.uuid4().hex[:6]}.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "parameter_server_distributed_tpu_torch.cli.ps_main",
             "127.0.0.1:0", str(workers), "1000", "--device=cpu",
             "--optimizer=sgd", "--lr=0.1", f"--ckpt-dir={tmp_path}"],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=tmp_path)
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        found = re.search(r"Parameter server listening on [\d.]+:(\d+)",
                          log.read_text())
        if found:
            return proc, int(found.group(1)), log
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError(f"the PS did not start: {log.read_text()}")


def _stop(proc, timeout: float = 30.0) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        return -1


def _bootstrap(client, workers: int) -> None:
    """Seed the store through plain pushes of the same init."""
    init = [m.Tensor.from_array(n, v) for n, v in _store(0).items()]
    for wid in range(workers):
        resp = client.call("ReceiveGradients", m.GradientUpdate(
            worker_id=wid, iteration=0, gradients=init), timeout=JOIN_S)
        assert resp.success, resp.message


def test_a_ps_started_with_psdt_shm_0_refuses(tmp_path, monkeypatch):
    monkeypatch.setenv("PSDT_SHM", "1")
    proc, port, log = _spawn_ps(tmp_path, {"PSDT_SHM": "0"}, workers=1)
    try:
        client = data_plane.PSClient(f"127.0.0.1:{port}")
        try:
            _bootstrap(client, 1)
            before = _fallbacks()
            _rounds(client, m, n=1, start=1)
            assert client._shm_ok is False
            assert _fallbacks() == before + 1
        finally:
            client.close()
        assert _stop(proc) == 0, log.read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_a_ps_stopped_under_a_parked_handler_exits_clean(tmp_path,
                                                         monkeypatch):
    """Two workers, one pushes over the rings and parks on the barrier;
    SIGTERM: the PS exits 0 and unlinks its segments."""
    monkeypatch.setenv("PSDT_SHM", "1")
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    proc, port, log = _spawn_ps(tmp_path, {}, workers=2)
    client = data_plane.PSClient(f"127.0.0.1:{port}")
    errors = []
    thread = threading.Thread(
        target=lambda: errors.append(_try_round(client)), daemon=True)
    try:
        _bootstrap(client, 2)
        thread.start()
        deadline = time.monotonic() + JOIN_S
        while time.monotonic() < deadline:
            status = client.call("CheckSyncStatus",
                                 m.SyncStatusRequest(iteration=1),
                                 timeout=5.0)
            if status.workers_received == 1:
                break
            time.sleep(0.05)
        assert status.workers_received == 1
        assert client._shm_ok is True
        assert _stop(proc) == 0, log.read_text()
        thread.join(JOIN_S)
        assert not thread.is_alive()
        assert errors and errors[0] is not None   # the round never closed
        assert not [n for n in os.listdir("/dev/shm")
                    if n.startswith(f"psdt-{proc.pid}-")]
    finally:
        client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _try_round(client):
    try:
        _rounds(client, m, n=1, start=1)
    except Exception as exc:  # noqa: BLE001 — the caller asserts on it
        return exc
    return None
