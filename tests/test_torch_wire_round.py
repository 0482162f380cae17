"""The wire round of the port — its coordinator and PS services
(server/), ``Worker`` (worker/worker.py) and the three CLIs — against the
JAX package's, on ``small_lm`` over real localhost gRPC (the pattern of
tests/test_e2e_training.py: servers in process on port 0, workers in
threads).

- Mixed fleets, both directions: one port worker (id 0) and one JAX
  worker (id 1) against the JAX package's coordinator and PS, then
  against the port's.  The PS store is initialised with the JAX init as
  numpy before any push, so no bootstrap mixes the two packages' inits,
  and the PS runs SGD.  Each fleet's losses per iteration are held
  within rtol 1e-4 of a fleet of JAX workers only, on the JAX services,
  the same store and seeds; its store after the last iteration within
  rtol 5e-4, atol 1e-5 (the gradient tolerance of
  tests/test_pallas_ops.py:40).  Against the port's PS the JAX worker
  negotiates the shared-memory rings, and its version-aware pull is
  answered (in full: it pulls f32, the PS's delta chain is bf16).
- The PS's default optimizer (``pallas_sgd``, its plain version with
  ``device="cpu"``) applies bit for bit what the JAX PS's default host
  ``sgd`` applies.
- A fleet of port workers through the port's services bootstraps the PS
  from its own init, and its loss falls, as tests/test_e2e_training.py
  asserts for the JAX fleet.
- The three port CLIs run as processes with ``--device=cpu``.

The JAX package's C++ host library is switched off (its numpy SGD is the
port's bit for bit), torch runs on at most two intra-op threads here, and
every server, thread and process is stopped in teardown, each wait with a
timeout."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.server.coordinator_service import \
    Coordinator as RefCoordinator
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as RefTrainer
from parameter_server_distributed_tpu.worker.worker import Worker as RefWorker
from parameter_server_distributed_tpu_torch import native as port_native
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch.checkpoint import \
    codec as ckpt_codec
from parameter_server_distributed_tpu_torch.checkpoint.manager import \
    CheckpointManager
from parameter_server_distributed_tpu_torch.cli import (coordinator_main,
                                                       ps_main, worker_main)
from parameter_server_distributed_tpu_torch.core.optimizer import \
    make_optimizer
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import to_host
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL, BATCH, LR = "small_lm", 2, 0.5
LOSS_RTOL = 1e-4
STORE_TOL = dict(rtol=5e-4, atol=1e-5)
JOIN_S = 120.0


@pytest.fixture(autouse=True)
def hygiene():
    """The JAX package's numpy host path and at most two torch intra-op
    threads, both restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    native.set_enabled(False)
    port_native.set_enabled(False)
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        port_native.set_enabled(default)
        torch.set_num_threads(threads)


@pytest.fixture
def servers():
    """start(port_side, **ps_kwargs) -> (ps, coordinator, coordinator
    port); everything started is stopped at teardown."""
    started = []

    def start(port_side: bool, tmp, **ps_kwargs):
        cfg = port_config if port_side else ref_config
        ps_kw = dict(bind_address="127.0.0.1", port=0, total_workers=2,
                     checkpoint_dir=str(tmp), **ps_kwargs)
        if port_side:
            ps_kw["device"] = "cpu"
        else:
            ps_kw["autosave_period_s"] = 600.0
        ps = (ParameterServer if port_side else RefParameterServer)(
            cfg.ParameterServerConfig(**ps_kw))
        started.append(ps)
        ps_port = ps.start()
        coordinator = (Coordinator if port_side else RefCoordinator)(
            cfg.CoordinatorConfig(bind_address="127.0.0.1", port=0,
                                  ps_address="127.0.0.1", ps_port=ps_port,
                                  reap_period_s=600.0))
        started.append(coordinator)
        return ps, coordinator, coordinator.start()

    yield start
    for server in reversed(started):
        server.stop()


def port_worker(coord_port: int, wid: int) -> Worker:
    config = port_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model=MODEL, heartbeat_period_s=1.0, device="cpu")
    model, batches = registry.get_model_and_batches(MODEL, BATCH, seed=wid,
                                                    device="cpu")
    return Worker(config, Trainer(model, device="cpu"), batches)


# one JAX Trainer a worker id, compiled once and reused by the fleets
# that run one after the other (never two workers on one trainer)
_REF_TRAINERS: dict = {}


def ref_trainer(wid: int) -> RefTrainer:
    if wid not in _REF_TRAINERS:
        _REF_TRAINERS[wid] = RefTrainer(ref_registry.get_model_and_batches(MODEL, BATCH)[0],
                                        local_devices=jax.devices()[:1])
    return _REF_TRAINERS[wid]


def ref_worker(coord_port: int, wid: int) -> RefWorker:
    config = ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model=MODEL, heartbeat_period_s=1.0)
    _, batches = ref_registry.get_model_and_batches(MODEL, BATCH,
                                                    seed=wid)
    return RefWorker(config, ref_trainer(wid), batches)


def run_fleet(workers, iterations: int) -> dict[int, list[float]]:
    """Drive the workers in lockstep threads (the barrier synchronizes
    them); every thread is joined with a timeout."""
    losses = {w.config.worker_id: [] for w in workers}
    errors = []

    def loop(worker):
        try:
            for it in range(iterations):
                losses[worker.config.worker_id].append(
                    worker.run_iteration(it))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append((worker.config.worker_id, exc))

    threads = [threading.Thread(target=loop, args=(w,), daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, f"worker failures: {errors}"
    return losses


def fleet(start, port_side, makers, init, tmp, iterations=3):
    """One fleet on fresh servers: (losses by worker id, PS store as
    numpy, the workers — shut down)."""
    ps, _coord, coord_port = start(port_side, tmp, optimizer="sgd",
                                   learning_rate=LR)
    ps.core.initialize_parameters(init)
    workers = [make(coord_port, wid) for wid, make in enumerate(makers)]
    try:
        for w in workers:
            w.initialize()
        losses = run_fleet(workers, iterations)
    finally:
        for w in workers:
            w.shutdown()
    store = {k: np.array(v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in ps.core.get_parameters().items()}
    return losses, store, workers


@pytest.fixture(scope="module")
def jax_init():
    model, _ = ref_registry.get_model_and_batches(MODEL, BATCH)
    return {k: np.array(v, np.float32)
            for k, v in model.init_params(0).items()}


# the JAX-only fleet's (losses, store), run once for both sides
_JAX_FLEET: dict = {}


@pytest.mark.parametrize("side", ["jax_services", "port_services"])
def test_mixed_fleet_tracks_jax_fleet(servers, jax_init, tmp_path,
                                      monkeypatch, side):
    monkeypatch.setenv("PSDT_SHM", "1")   # the JAX worker negotiates shm
    if "run" not in _JAX_FLEET:
        _JAX_FLEET["run"] = fleet(servers, False, [ref_worker, ref_worker],
                                  jax_init, tmp_path / "base")[:2]
    base_losses, base_store = _JAX_FLEET["run"]
    losses, store, workers = fleet(servers, side == "port_services",
                                   [port_worker, ref_worker], jax_init,
                                   tmp_path / side)
    for wid in (0, 1):
        assert len(losses[wid]) == 3
        np.testing.assert_allclose(losses[wid], base_losses[wid],
                                   rtol=LOSS_RTOL, err_msg=f"worker {wid}")
    assert sorted(store) == sorted(base_store)
    for name in base_store:
        np.testing.assert_allclose(store[name], base_store[name],
                                   **STORE_TOL, err_msg=name)
    # the fleet learned something: the store moved off the init
    assert any(not np.array_equal(store[n], jax_init[n]) for n in jax_init)
    if side == "port_services":
        jax_client = workers[1]._ps
        assert jax_client._shm_ok is True       # the port PS's rings
        assert jax_client._delta_ok is True     # the delta RPCs answer
        assert jax_client._fused_ok is True


def test_default_ps_optimizer_applies_the_jax_default(tmp_path):
    """Three synchronous rounds of two workers on one store through the
    port's PS at its default optimizer and the JAX PS at its default,
    each with lr 0.05: every store after an apply is bit-identical."""
    port_ps = ParameterServer(port_config.ParameterServerConfig(
        total_workers=2, learning_rate=0.05, checkpoint_dir=str(tmp_path),
        device="cpu"))
    ref_ps = RefParameterServer(ref_config.ParameterServerConfig(
        total_workers=2, learning_rate=0.05, checkpoint_dir=str(tmp_path),
        autosave_period_s=600.0))
    assert port_ps.config.optimizer == "pallas_sgd"
    assert ref_ps.config.optimizer == "sgd"
    rng = np.random.default_rng(4)
    shapes = {"w": (33, 17), "b": (17,), "s": ()}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    for ps in (port_ps, ref_ps):
        ps.core.initialize_parameters(init)
    for it in range(3):
        for wid in (0, 1):
            grads = {n: rng.standard_normal(s).astype(np.float32)
                     for n, s in shapes.items()}
            for ps in (port_ps, ref_ps):
                assert ps.core.receive_gradients(wid, it, grads).success
        got = to_host(port_ps.core.get_parameters())
        want = ref_ps.core.get_parameters()
        for n in shapes:
            assert np.asarray(got[n]).tobytes() == \
                np.asarray(want[n], np.float32).tobytes(), (it, n)


def test_port_fleet_bootstraps_and_learns(servers, tmp_path):
    ps, coordinator, coord_port = servers(True, tmp_path, optimizer="sgd",
                                          learning_rate=LR)
    workers = [port_worker(coord_port, 0), port_worker(coord_port, 1)]
    try:
        for w in workers:
            w.initialize()
        assert coordinator.core.live_worker_count() == 2
        losses = run_fleet(workers, 8)
        bootstraps = [w.last_bootstrap for w in workers]
    finally:
        for w in workers:
            w.shutdown()
    # iteration 0 is the bootstrap (nan); real losses from iteration 1 on
    for wid, history in losses.items():
        assert len(history) == 8 and np.isnan(history[0])
        real = history[1:]
        assert not np.isnan(real).any()
        assert np.mean(real[-3:]) < real[0], f"worker {wid}: {real}"
    assert bootstraps == [False, False]
    assert ps.core.current_iteration == 7
    # the two workers' serves of each store shared one encode
    assert ps.service._obs_cache_hit.value > 0


def test_unported_options_name_their_items(monkeypatch):
    for flag, item in (("--elastic", "item 11"), ("--coordinator=a:1",
                                                  "item 10"),
                       ("--quorum=0.5", "item 11"), ("--backup=a:1",
                                                     "item 13"),
                       ("--replication=1", "item 13"),
                       ("--standby", "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            ps_main.build_config(["127.0.0.1:0", flag])
    for flag, item in (("--mesh=data:2", "item 8"), ("--freerun", "item 11"),
                       ("--tiers", "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            worker_main.build_config(["127.0.0.1:1", "0", "1", flag])
    # file-backed data and the image rows are ported
    for model in ("resnet18_cifar", "resnet50_imagenet", "vit_tiny_cifar",
                  "vit_s16_imagenet"):
        config, _ = worker_main.build_config(
            ["127.0.0.1:1", "0", "1", f"--model={model}", "--data=d.npz"])
        assert (config.model, config.data_path) == (model, "d.npz")
    with pytest.raises(NotImplementedError, match="item 10"):
        Worker(port_config.WorkerConfig(wire_dtype="int8", device="cpu"),
               None, iter(()), start_heartbeat=False)
    # a static sharded store is ported; backups stay item 13's
    with pytest.raises(NotImplementedError, match="item 13"):
        coordinator_main.build_config(["127.0.0.1:0", "127.0.0.1:1",
                                       "--ps-backups=127.0.0.1:2"])
    config = coordinator_main.build_config(
        ["127.0.0.1:0", "127.0.0.1:1", "--ps-shards=h:2,h:3"])
    assert (config.ps_address, config.ps_port, config.ps_shards) == (
        "127.0.0.1", 1, ("h:2", "h:3"))
    assert coordinator_main.build_config(["127.0.0.1:0"]).ps_shards == ()
    with pytest.raises(SystemExit, match="--ps-shards"):
        coordinator_main.build_config(["127.0.0.1:0", "--ps-shards"])


def test_entry_points_refuse_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParameterServer(port_config.ParameterServerConfig(port=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_main.build_worker(port_config.WorkerConfig(model="tiny_lm"))


# ------------------------------------------------------------------ the CLIs
def _wait_for(path, pattern: str, proc, deadline: float) -> re.Match:
    while time.monotonic() < deadline:
        with open(path) as f:
            found = re.search(pattern, f.read())
        if found:
            return found
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    with open(path) as f:
        raise AssertionError(f"no {pattern!r} from {proc.args}: {f.read()}")


# runs a module as __main__ with jax and the JAX package blocked from import
BLOCKED_MAIN = """
import runpy, sys
BLOCKED = ("jax", "jaxlib", "parameter_server_distributed_tpu")
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def test_clis_run_a_round_as_processes(tmp_path):
    """Coordinator, PS (pallas_adam's plain version on the CPU, a
    checkpoint each iteration) and one worker (tiny_lm, 2
    iterations: the bootstrap and one gradient round) as processes, each
    with jax and the JAX package blocked from import."""
    env = {**os.environ, "PYTHONPATH": REPO,
           "PSDT_METRICS_FILE": str(tmp_path / "metrics-%d.jsonl")}
    mod = "parameter_server_distributed_tpu_torch.cli."
    procs = []

    def spawn(name, *args):
        log = tmp_path / f"{name}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-c", BLOCKED_MAIN, mod + name, *args],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=tmp_path)
        procs.append(proc)
        return proc, log

    deadline = time.monotonic() + 90.0
    try:
        ps, ps_log = spawn("ps_main", "127.0.0.1:0", "1", "1",
                           "--optimizer=pallas_adam", "--lr=0.001",
                           "--device=cpu",
                           f"--ckpt-dir={tmp_path / 'ck'}",
                           f"--report={tmp_path / 'ps.json'}")
        ps_port = _wait_for(ps_log, r"Parameter server listening on "
                            r"[\d.]+:(\d+)", ps, deadline).group(1)
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0",
                                 f"127.0.0.1:{ps_port}")
        coord_port = _wait_for(coord_log, r"Coordinator server listening on "
                               r"[\d.]+:(\d+)", coord, deadline).group(1)
        worker, worker_log = spawn("worker_main", f"127.0.0.1:{coord_port}",
                                   "0", "2", "--model=tiny_lm", "--batch=2",
                                   "--device=cpu",
                                   f"--report={tmp_path / 'w0.json'}")
        assert worker.wait(timeout=max(1.0, deadline - time.monotonic())) \
            == 0, worker_log.read_text()
        for proc in (ps, coord):
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30.0) == 0, proc.args
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30.0)
    text = worker_log.read_text()
    assert "completed iteration 0 (bootstrap" in text
    assert re.search(r"completed iteration 1 \(loss \d", text), text
    records = [json.loads(line) for line in
               (tmp_path / "metrics-0.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert records[0]["bootstrap"] and np.isfinite(records[1]["loss"])
    assert records[1]["fused_s"] > 0 and records[1]["compute_s"] > 0
    ps_report = json.loads((tmp_path / "ps.json").read_text())
    assert ps_report["histograms"]["ps.barrier_close_s"]["count"] == 2
    assert json.loads((tmp_path / "w0.json").read_text())["role"] == "worker 0"
    # the epoch-1 checkpoint is the store after the one Adam apply
    core = ParameterServerCore(total_workers=1)
    epoch, iteration = CheckpointManager(core, str(tmp_path / "ck")).load(
        str(tmp_path / "ck" / "checkpoint_epoch_1.ckpt"))
    assert (epoch, iteration) == (1, 1)
    assert sorted(os.listdir(tmp_path / "ck")) == sorted(
        [f"checkpoint_epoch_{e}.ckpt{s}" for e in (0, 1)
         for s in ("", ".meta.json")] + ["checkpoint_epoch_1.ckpt.opt.npz"])


def _assert_state_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(value), err_msg=key)


@pytest.mark.parametrize("staleness", [0, 2])
def test_checkpoint_holds_its_epochs_state_under_a_slow_writer(
        tmp_path, monkeypatch, staleness):
    """The PS writes each epoch's checkpoint from the state of the apply
    that advanced it, even when its writer falls behind the applies:
    every file holds that iteration's store and Adam state exactly
    (checkpoint interval 1, one worker; synchronous and async)."""
    real_save = ckpt_codec.save

    def slow_save(*args, **kwargs):
        time.sleep(0.2)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(ckpt_codec, "save", slow_save)
    ps = ParameterServer(port_config.ParameterServerConfig(
        bind_address="127.0.0.1", port=0, total_workers=1,
        checkpoint_interval=1, checkpoint_dir=str(tmp_path),
        optimizer="pallas_adam", learning_rate=1e-2,
        staleness_bound=staleness, device="cpu"))
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,)}
    stores, states = [], []
    ps.start()
    try:
        for iteration in range(5):
            result = ps.core.receive_gradients(0, iteration, {
                name: rng.standard_normal(shape).astype(np.float32)
                for name, shape in shapes.items()})
            assert result.success, result.message
            stores.append(to_host(ps.core.get_parameters()))
            states.append(ps.core.optimizer_state())
    finally:
        ps.stop()
    for epoch, (store, state) in enumerate(zip(stores, states)):
        core = ParameterServerCore(
            total_workers=1,
            optimizer=make_optimizer("pallas_adam", 1e-2, device="cpu"))
        assert CheckpointManager(core, str(tmp_path)).load(
            str(tmp_path / f"checkpoint_epoch_{epoch}.ckpt")) \
            == (epoch, epoch)
        _assert_state_equal(to_host(core.get_parameters()), store)
        _assert_state_equal(core.optimizer_state(), state)
    assert states[-1]["step"][0] == 4
