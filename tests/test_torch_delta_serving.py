"""Live weight publication into the port's decode servers, on the CPU:
a ``WeightFollower`` tracking a training PS over loopback gRPC.

- A ``DecodeServer`` hot-swaps five and more followed versions between
  rounds while one stream decodes: the tokens before each swap stand and
  the stream retires at full length (the port of the JAX package's
  acceptance, tests/test_delta.py).
- A ``FleetDecodeServer(follower=...)`` polls the feed itself and swaps
  each version through ``transform`` (models/convert.py
  ``StoreUploader``); after the same followed version, its greedy stream
  is token-exact against the JAX package's ``DecodeServer`` swapped to
  the same store, in float32, and a stream spanning swaps carries
  version stamps that never fall.
- ``cli.serve_main --follow`` as a process (fleet mode on port 0): it
  follows the PS to its last version, streams, drains on SIGTERM and
  reports its follower and swaps.
- A concurrent subscribe / apply / pull / reset hammer against one
  service: every served store is a whole version, nothing wedges.
- The follower's jittered backoff stays in its bounds, and a waiter
  wakes on stop.

A tiny float32 model on one torch thread; every server, follower and
process is stopped in teardown, each wait with a deadline."""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.models import serving as js
from parameter_server_distributed_tpu.models import transformer as jt
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.checkpoint.manager import \
    CheckpointManager
from parameter_server_distributed_tpu_torch.core.optimizer import SGD
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.delta import messages as dmsg
from parameter_server_distributed_tpu_torch.delta.chain import store_crc
from parameter_server_distributed_tpu_torch.delta.client import (
    DeltaBaseMismatch, DeltaPullState, apply_frames)
from parameter_server_distributed_tpu_torch.delta.subscriber import \
    WeightFollower
from parameter_server_distributed_tpu_torch.fleet import messages as fmsg
from parameter_server_distributed_tpu_torch.fleet.decode import \
    FleetDecodeServer
from parameter_server_distributed_tpu_torch.models import transformer as tt
from parameter_server_distributed_tpu_torch.models.convert import (
    StoreUploader, params_from_numpy)
from parameter_server_distributed_tpu_torch.models.registry import get_model
from parameter_server_distributed_tpu_torch.models.serving import DecodeServer
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.service import RpcClient
from parameter_server_distributed_tpu_torch.server.ps_service import (
    ParameterServer, ParameterServerService)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 96
WAIT_S = 20.0


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
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


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, init store as numpy): one store."""
    jm = jt.Transformer(jt.TransformerConfig(
        vocab=VOCAB, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=96, max_seq=128, dtype=jnp.float32))
    fields = {f.name: getattr(jm.config, f.name)
              for f in dataclasses.fields(jm.config)}
    pm = tt.Transformer(tt.TransformerConfig(
        **{**fields, "dtype": torch.float32}))
    store = {k: np.asarray(v, np.float32)
             for k, v in jm.init_params(0).items()}
    return jm, pm, store


@pytest.fixture
def started(tmp_path):
    """start(store) -> (ps, address); keep(obj) stops obj at teardown,
    before the PSs."""
    servers, others = [], []

    def start(store):
        ps = ParameterServer(port_config.ParameterServerConfig(
            bind_address="127.0.0.1", port=0, total_workers=1,
            checkpoint_interval=10**6, optimizer="sgd", learning_rate=0.01,
            checkpoint_dir=str(tmp_path / f"ps{len(servers)}"),
            device="cpu"))
        servers.append(ps)
        address = f"127.0.0.1:{ps.start()}"
        ps.core.initialize_parameters(store)
        return ps, address

    def keep(obj):
        others.append(obj)
        return obj

    start.keep = keep
    yield start
    for obj in reversed(others):
        obj.stop()
    for ps in reversed(servers):
        ps.stop()


def step_ps(ps, it: int, rng) -> int:
    """One gradient apply on the PS; returns the version it serves."""
    _, params, _ = ps.core.serve_parameters()
    r = ps.core.receive_gradients(0, it, {
        k: (rng.standard_normal(np.shape(v)) * 1e-2).astype(np.float32)
        for k, v in params.items()})
    assert r.aggregation_complete
    return ps.core.serve_version()


def wait_version(follower, version: int):
    """The follower's update at ``version`` (earlier ones skipped)."""
    while True:
        update = follower.wait_for_update(timeout=WAIT_S)
        assert update is not None, follower.degrade_reason
        if update[1] >= version:
            return update


def test_decode_server_hot_swaps_across_live_training(models, started):
    jm, pm, store = models
    ps, address = started(store)
    follower = started.keep(WeightFollower(address, subscriber_id=9).start())
    upload = StoreUploader(pm.config, "cpu")
    srv = DecodeServer(pm, params_from_numpy(store, pm.config, "cpu"),
                       slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(31)
    rid = srv.submit([int(t) for t in rng.integers(0, VOCAB, 5)],
                     max_new_tokens=24)
    swaps, before = 0, []
    while srv.active and swaps < 5:
        fresh = wait_version(follower, step_ps(ps, swaps + 1, rng))
        srv.step()                       # a round between publications
        prefix = list(srv.peek(rid))
        srv.swap_params(upload(fresh[0]), version=fresh[1])
        swaps += 1
        srv.step()
        after = list(srv.peek(rid))
        assert after[:len(prefix)] == prefix   # tokens before a swap stand
        before = after
    assert swaps >= 5
    while srv.active:
        srv.step()
    out = srv.result(rid)
    assert len(out) == 24 and out[:len(before)] == before
    assert srv.stats["weight_swaps"] >= 5
    assert srv.params_version == ps.core.serve_version()


def _stream(address: str, tokens, max_new: int) -> list:
    client = RpcClient(address, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS)
    try:
        return list(client.call("SubmitStream", fmsg.DecodeRequest(
            tokens=tokens, max_new=max_new), timeout=WAIT_S * 3))
    finally:
        client.close()


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} never held"
        time.sleep(0.02)


def test_fleet_server_follows_token_exact_against_jax(models, started):
    jm, pm, store = models
    ps, address = started(store)
    follower = WeightFollower(address, subscriber_id=5).start()
    fds = started.keep(FleetDecodeServer(
        DecodeServer(pm, params_from_numpy(store, pm.config, "cpu"),
                     slots=2, max_len=96, device="cpu"),
        follower=follower, transform=StoreUploader(pm.config, "cpu"),
        heartbeat_s=0.02))
    fds.start()
    rng = np.random.default_rng(7)
    for it in (1, 2):
        version = step_ps(ps, it, rng)
    _wait(lambda: fds.weight_version() == version, "the followed swap")
    prompt = [int(t) for t in rng.integers(1, VOCAB, 9)]
    chunks = _stream(fds.address, prompt, 10)
    assert chunks[-1].done and not chunks[-1].error
    assert {c.weight_version for c in chunks} == {version}
    # the JAX server swapped to the store the follower delivered
    delivered = follower.base()
    ref = js.DecodeServer(jm, jm.init_params(0), slots=1, max_len=96)
    ref.swap_params({k: jnp.asarray(v) for k, v in delivered.items()})
    rid = ref.submit(prompt, max_new_tokens=10)
    assert [c.token for c in chunks if not c.done] == [
        int(t) for t in ref.run_to_completion()[rid]]
    # a stream that spans swaps: its stamps never fall, and it ends whole
    out: list = []
    reader = threading.Thread(target=lambda: out.extend(
        _stream(fds.address, prompt, 60)))
    reader.start()
    for it in (3, 4, 5):
        step_ps(ps, it, rng)
        time.sleep(0.05)
    reader.join(timeout=WAIT_S * 3)
    assert not reader.is_alive()
    stamps = [c.weight_version for c in out]
    assert stamps == sorted(stamps) and out[-1].done
    assert len([c for c in out if not c.done]) == 60
    assert len(fds.swaps) >= 3 and not follower.degraded


def test_serve_main_follow_as_a_process(started, tmp_path):
    """cli.serve_main --follow in fleet mode: follows the PS to its last
    version, streams under it, drains on SIGTERM, exits 0 and reports
    the follower (one session, no degrade) and its swaps."""
    model = get_model("tiny_lm")
    store = {k: v.numpy() for k, v in model.init_params(
        0, device="cpu").items()}
    ps, address = started(store)
    rng = np.random.default_rng(3)
    report = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=REPO, PSDT_SUBSCRIBE_POLL_S="0.05")
    log = open(tmp_path / "serve.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "parameter_server_distributed_tpu_torch.cli.serve_main",
         "--model=tiny_lm", "--device=cpu", "--slots=2", "--max-len=64",
         "--serve-port=0", f"--follow={address}", "--subscriber-id=7",
         f"--report={report}"], stdout=log, stderr=subprocess.STDOUT,
        env=env, cwd=REPO)
    try:
        def port():
            log.seek(0)
            found = re.search(r"decode fleet server 0 on port (\d+)",
                              log.read())
            assert proc.poll() is None, log.read()[-2000:]
            return found and found.group(1)

        deadline = time.monotonic() + 120
        while not port():
            assert time.monotonic() < deadline, "serve_main never started"
            time.sleep(0.1)
        serve = f"127.0.0.1:{port()}"
        version = step_ps(ps, 1, rng)
        client = RpcClient(serve, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS)
        try:
            _wait(lambda: client.call("Control", fmsg.DecodeControlRequest(
                action=fmsg.CTRL_STATUS), timeout=5).weight_version
                == version, "the followed version")
        finally:
            client.close()
        chunks = _stream(serve, [1, 2, 3], 4)
        assert chunks[-1].done and {c.weight_version for c in chunks} == {
            version}
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    with open(report) as f:
        rep = json.load(f)
    fol = rep["follower"]
    assert fol["version"] == version and fol["sessions"] == 1
    assert not fol["degraded"] and fol["versions_consumed"] >= 1
    assert [s[0] for s in rep["swaps"]][-1] == version
    assert rep["stats"]["weight_swaps"] == len(rep["swaps"])


def test_subscribe_apply_pull_reset_hammer(tmp_path):
    """Applies, delta pulls, subscriptions opening and closing and chain
    resets on one service for 1.5 s: every served store matches its
    crc when a pair carried one, the pullers are served, and every
    thread ends in time."""
    rng = np.random.default_rng(41)
    core = ParameterServerCore(total_workers=1, optimizer=SGD(0.01))
    service = ParameterServerService(core, CheckpointManager(
        core, directory=str(tmp_path), checkpoint_interval=10**9,
        check_period_s=3600.0))
    core.initialize_parameters({
        "w": rng.standard_normal(256).astype(np.float32),
        "b": rng.standard_normal(17).astype(np.float32)})
    stop = threading.Event()
    errors: list = []
    served = [0]      # rounds the pullers completed, full or delta

    def guard(fn):
        def run():
            try:
                fn()
            except BaseException as exc:  # noqa: BLE001 — collected
                errors.append(exc)
        return run

    def applier():
        g = np.random.default_rng(1)
        it = 0
        while not stop.is_set():
            it += 1
            core.receive_gradients(0, it, {
                "w": g.standard_normal(256).astype(np.float32) * 1e-2,
                "b": g.standard_normal(17).astype(np.float32) * 1e-2})

    def puller():
        state = DeltaPullState()
        while not stop.is_set():
            req = dmsg.DeltaPullRequest(wire_dtype=m.WIRE_BF16,
                                        held_version=max(state.version, 0))
            frames = [dmsg.DeltaFrame.decode(f.encode())
                      for f in service.PullParametersDelta(req, None)]
            try:
                result = apply_frames(iter(frames), state)
            except DeltaBaseMismatch:
                state = DeltaPullState()    # re-base, as a client does
                continue
            if result.crc is not None:
                assert result.crc == store_crc(result.store)
            served[0] += result.store is not None

    class Context:
        def __init__(self):
            self.active = True

        def is_active(self):
            return self.active and not stop.is_set()

    def subscriber():
        while not stop.is_set():
            ctx = Context()
            state, batch, seen = DeltaPullState(), [], 0
            try:
                for frame in service.SubscribeWeights(dmsg.SubscribeRequest(
                        subscriber_id=2, wire_dtype=m.WIRE_BF16), ctx):
                    batch.append(dmsg.DeltaFrame.decode(frame.encode()))
                    if batch[-1].last:
                        try:
                            apply_frames(iter(batch), state)
                        except DeltaBaseMismatch:
                            state = DeltaPullState()
                        batch, seen = [], seen + 1
                        if seen >= 3:
                            break
            finally:
                ctx.active = False

    def resetter():
        while not stop.wait(0.02):
            service.delta_chain.reset()

    threads = [threading.Thread(target=guard(fn), daemon=True,
                                name=f"hammer-{fn.__name__}-{i}")
               for i, fn in enumerate((applier, puller, puller, subscriber,
                                       resetter))]
    for t in threads:
        t.start()
    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=15)
        assert not t.is_alive(), f"{t.name} wedged"
    assert not errors, errors
    assert served[0] > 0


def test_follower_backoff_bounds_and_stop_wakes_a_waiter():
    follower = WeightFollower("127.0.0.1:1", subscriber_id=11,
                              reconnect_backoff_s=0.5)
    draws = [follower._next_backoff() for _ in range(200)]
    assert min(draws) >= 0.5 and max(draws) <= 4.0
    again = WeightFollower("127.0.0.1:1", subscriber_id=11,
                           reconnect_backoff_s=0.5)
    assert [again._next_backoff() for _ in range(200)] == draws
    t0 = time.monotonic()
    waiter = threading.Thread(target=follower.wait_for_update,
                              kwargs={"timeout": 30.0})
    waiter.start()
    time.sleep(0.05)
    follower.stop()            # never started: stop still wakes the wait
    waiter.join(timeout=5)
    assert not waiter.is_alive() and time.monotonic() - t0 < 5
