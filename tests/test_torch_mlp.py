"""The port's MLP worker (models/mlp.py, the MLP rows of
models/registry.py, data/synthetic.py's class-cluster data, and
``Trainer`` on ``(x, y)`` batches) against the JAX package's.

- Loss and gradients of ``mnist_mlp`` through the port's ``Trainer`` and
  the JAX ``Trainer`` on one numpy store (the JAX init) and batch: f32
  within rtol 1e-5, atol 1e-6; bf16 ``billion_param_mlp(hidden=64,
  layers=2)`` within 2^-5 of each gradient's largest entry (the bf16
  tolerance of tests/test_torch_trainer.py), the loss within 1e-2.
- Both registries draw the same ``(x, y)`` batches from one seed;
  ``params_from_numpy`` carries an MLP store across; ``accuracy`` is the
  JAX model's.
- BASELINE config 1 as a mixed fleet: one port worker and one JAX worker
  on mnist_mlp, bf16 on the wire, over the shared-memory rings (each
  worker negotiates the other package's PS), on the JAX services and on
  the port's (whose PS runs its default, ``pallas_sgd``'s plain version
  here); each worker's losses track a JAX-only fleet's within rtol 1e-4
  and the loss falls.

torch runs on at most two intra-op threads; every server is stopped and
every thread joined with a timeout."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu.models import mlp as ref_mlp
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.server.coordinator_service import \
    Coordinator as RefCoordinator
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as RefTrainer
from parameter_server_distributed_tpu.worker.worker import Worker as RefWorker
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch.models import mlp, registry
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

BATCH, LR, ITERATIONS = 32, 0.05, 4
JOIN_S = 120.0


@pytest.fixture(autouse=True)
def hygiene():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def jax_store(model, seed=0) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in model.init_params(seed).items()}


def jax_grads(model, store, batch):
    grads, loss = RefTrainer(model, local_devices=jax.devices()[:1]) \
        .compute_gradients(store, batch)
    return {k: np.asarray(v) for k, v in grads.items()}, loss


def test_mnist_loss_and_gradients_match_jax():
    store = jax_store(ref_mlp.mnist_mlp(), seed=3)
    batch = next(ref_registry.get_model_and_batches("mnist_mlp", BATCH,
                                                    seed=5)[1])
    ref_g, ref_loss = jax_grads(ref_mlp.mnist_mlp(), store, batch)
    grads, loss = Trainer(mlp.mnist_mlp(), device="cpu") \
        .compute_gradients(store, batch)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert sorted(grads) == sorted(ref_g)
    for k, ref in ref_g.items():
        np.testing.assert_allclose(grads[k], ref, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_bf16_billion_param_mlp_gradients_within_rounding():
    ref_model = ref_mlp.billion_param_mlp(hidden=64, layers=2)
    store = jax_store(ref_model, seed=4)
    rng = np.random.default_rng(6)
    batch = (rng.standard_normal((16, 64)).astype(np.float32),
             rng.integers(0, 64, 16).astype(np.int32))
    ref_g, ref_loss = jax_grads(ref_model, store, batch)
    model = mlp.billion_param_mlp(hidden=64, layers=2)
    assert model.dtype == torch.bfloat16
    assert model.param_shapes() == ref_model.param_shapes()
    grads, loss = Trainer(model, device="cpu").compute_gradients(store,
                                                                 batch)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for k, ref in ref_g.items():
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=2.0 ** -5 * np.abs(ref).max(),
                                   err_msg=k)


def test_registry_rows_and_store_conversion():
    for name in ("mnist_mlp", "mlp_1b"):
        model, batches = registry.get_model_and_batches(name, 4, seed=2,
                                                        device="cpu")
        ref_model, ref_batches = ref_registry.get_model_and_batches(
            name, 4, seed=2)
        assert model.param_shapes() == ref_model.param_shapes()
        for _ in range(2):
            (x, y), (rx, ry) = next(batches), next(ref_batches)
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), rx)
            np.testing.assert_array_equal(y.numpy(), ry)
    assert registry.get_model("mlp_1b").num_params() == 1_342_259_200
    with pytest.raises(ValueError, match="remat"):
        registry.get_model("mnist_mlp", remat=True)
    # a JAX store carried across: the same accuracy on the same batch
    ref_model = ref_mlp.mnist_mlp()
    store = jax_store(ref_model, seed=1)
    params = params_from_numpy(store, mlp.mnist_mlp().config, device="cpu")
    x, y = next(ref_registry.get_model_and_batches("mnist_mlp", 64)[1])
    acc = mlp.mnist_mlp().accuracy(params, (torch.from_numpy(x),
                                            torch.from_numpy(y)))
    ref_acc = ref_model.accuracy({k: jnp.asarray(v)
                                  for k, v in store.items()}, (x, y))
    assert float(acc) == float(ref_acc)
    with pytest.raises(ValueError, match="drift"):
        params_from_numpy({"layer0/w": store["layer0/w"]},
                          mlp.mnist_mlp().config, device="cpu")


# ------------------------------------------------------------- the fleets
@pytest.fixture
def servers(tmp_path):
    started = []

    def start(port_side: bool):
        cfg = port_config if port_side else ref_config
        kw = dict(bind_address="127.0.0.1", port=0, total_workers=2,
                  checkpoint_dir=str(tmp_path / f"ck{len(started)}"),
                  learning_rate=LR)
        if port_side:
            kw["device"] = "cpu"   # the default optimizer: pallas_sgd
        else:
            kw.update(autosave_period_s=600.0, optimizer="sgd")
        ps = (ParameterServer if port_side else RefParameterServer)(
            cfg.ParameterServerConfig(**kw))
        started.append(ps)
        ps_port = ps.start()
        coord = (Coordinator if port_side else RefCoordinator)(
            cfg.CoordinatorConfig(bind_address="127.0.0.1", port=0,
                                  ps_address="127.0.0.1", ps_port=ps_port,
                                  reap_period_s=600.0))
        started.append(coord)
        return ps, coord.start()

    yield start
    for server in reversed(started):
        server.stop()


def port_worker(coord_port: int, wid: int) -> Worker:
    config = port_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model="mnist_mlp", wire_dtype="bf16",
        heartbeat_period_s=1.0, device="cpu")
    model, batches = registry.get_model_and_batches("mnist_mlp", BATCH,
                                                    seed=wid, device="cpu")
    return Worker(config, Trainer(model, device="cpu"), batches)


# one JAX Trainer a worker id, compiled once and reused by the fleets
# that run one after the other (never two workers on one trainer)
_REF_TRAINERS: dict = {}


def ref_trainer(wid: int) -> RefTrainer:
    if wid not in _REF_TRAINERS:
        _REF_TRAINERS[wid] = RefTrainer(ref_mlp.mnist_mlp(),
                                        local_devices=jax.devices()[:1])
    return _REF_TRAINERS[wid]


def ref_worker(coord_port: int, wid: int) -> RefWorker:
    config = ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model="mnist_mlp", wire_dtype="bf16",
        heartbeat_period_s=1.0)
    _, batches = ref_registry.get_model_and_batches("mnist_mlp", BATCH,
                                                    seed=wid)
    return RefWorker(config, ref_trainer(wid), batches)


def fleet(start, port_side: bool, makers, init):
    """Losses by worker id, and whether each worker's connection rode
    the rings."""
    ps, coord_port = start(port_side)
    ps.core.initialize_parameters(init)
    workers = [make(coord_port, wid) for wid, make in enumerate(makers)]
    losses = {wid: [] for wid in range(len(workers))}
    errors = []

    def loop(worker):
        try:
            for it in range(ITERATIONS):
                losses[worker.config.worker_id].append(
                    worker.run_iteration(it))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    try:
        for w in workers:
            w.initialize()
        threads = [threading.Thread(target=loop, args=(w,), daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads), "a worker hung"
        assert not errors, errors
        shm_ok = [w._ps._shm_ok for w in workers]
    finally:
        for w in workers:
            w.shutdown()
    return losses, shm_ok


# the JAX-only fleet's (losses, shm flags), run once for both sides
_JAX_FLEET: dict = {}


@pytest.mark.parametrize("side", ["jax_services", "port_services"])
def test_mixed_mnist_fleet_over_shm_tracks_jax_fleet(servers, monkeypatch,
                                                     side):
    monkeypatch.setenv("PSDT_SHM", "1")
    init = jax_store(ref_mlp.mnist_mlp())
    if "run" not in _JAX_FLEET:
        _JAX_FLEET["run"] = fleet(servers, False, [ref_worker, ref_worker],
                                  init)
    base, base_shm = _JAX_FLEET["run"]
    losses, shm_ok = fleet(servers, side == "port_services",
                           [port_worker, ref_worker], init)
    assert base_shm == [True, True] and shm_ok == [True, True]
    for wid in (0, 1):
        assert len(losses[wid]) == ITERATIONS
        np.testing.assert_allclose(losses[wid], base[wid], rtol=1e-4,
                                   err_msg=f"worker {wid}")
        assert losses[wid][-1] < losses[wid][0]
