"""The port's ResNet (models/resnet.py, the image rows of
models/registry.py) against the JAX package's.

- Loss and gradients of small ResNets (``stages=(1, 1)``, width 8, 8-16
  px; basic and bottleneck blocks; the CIFAR stem and the 7x7/s2 stem
  with its max pool) through the port's ``Trainer`` and the JAX model's
  ``value_and_grad`` on one numpy store and batch: f32 within the
  reference's gradient tolerance, rtol 5e-4, atol 1e-5; bf16 within
  2^-5 of each gradient's largest entry.  The JAX step is compiled with
  ``xla_allow_excess_precision`` off, so that XLA rounds at every cast
  as the model's ops (and the port) do: left on, XLA:CPU keeps the f32
  values that a bf16 conv's input and output casts would round, and a
  bf16 ResNet's batch-statistics norms amplify that difference (the
  default-compiled and the op-by-op JAX gradients of these models
  differ by 10-45 % of the largest entry).
- ``_conv`` against ``jax.lax.conv_general_dilated`` with SAME padding
  at strides 1 and 2 on even and odd sizes (torch's symmetric padding
  gives other values at stride 2 on an even size), and the max pool
  against ``reduce_window``.
- ``param_shapes`` of ``resnet18()`` and ``resnet50()``, the registry
  rows and their dtype plumbing, the CIFAR stream, and a JAX store
  (f32 and bf16) carried across by ``params_from_numpy``.
- A mixed fleet of one port worker and one JAX worker on a tiny
  ResNet, synchronous, on the JAX services and on the port's: each
  worker's losses track a JAX-only fleet's within rtol 1e-4.  Two port
  workers on the port's PS at staleness 4: every push is applied or
  refused as stale.  In both the loss falls: on 64 images no worker
  drew, the PS's last store scores below the init (a worker's own loss
  moves more with its batch than with 4 updates).

torch runs on at most two intra-op threads; every server is stopped and
every thread joined with a timeout."""

import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu.data import synthetic as ref_synthetic
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.models import resnet as ref_resnet
from parameter_server_distributed_tpu.server.coordinator_service import \
    Coordinator as RefCoordinator
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as RefTrainer
from parameter_server_distributed_tpu.worker.worker import Worker as RefWorker
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch.data import synthetic
from parameter_server_distributed_tpu_torch.models import registry, resnet
from parameter_server_distributed_tpu_torch.models.convert import \
    params_from_numpy
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

JOIN_S = 120.0
TINY = dict(stages=(1, 1), width=8, num_classes=10)


@pytest.fixture(autouse=True)
def hygiene():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def numpy_store(model, seed=0, spread=0.1) -> dict:
    """A numpy f32 store of ``model``'s shapes from ``seed``: He normal
    weights, norm scales and biases ``spread`` about 1 and 0 (at 0 the
    reference's init scheme)."""
    rng = np.random.default_rng(seed)
    store = {}
    for name, shape in model.param_shapes().items():
        noise = rng.standard_normal(shape)
        if name.endswith("/scale"):
            value = 1.0 + spread * noise
        elif name.endswith(("/bias", "/b")):
            value = spread * noise
        else:
            value = noise * np.sqrt(2.0 / np.prod(shape[:-1]))
        store[name] = value.astype(np.float32)
    return store


def jax_loss_and_grads(model, store: dict, batch) -> tuple[float, dict]:
    """The JAX model's loss and f32 gradients on ``store`` cast to its
    dtype, from ``value_and_grad`` compiled with
    ``xla_allow_excess_precision`` off (see the module docstring)."""
    params = {k: jnp.asarray(v, model.dtype) for k, v in store.items()}
    step = jax.jit(jax.value_and_grad(model.loss)).lower(
        params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})
    loss, grads = step(params, batch)
    return float(loss), {k: np.asarray(g, np.float32)
                         for k, g in grads.items()}


def image_batch(rng, batch, size, classes=10):
    return (rng.standard_normal((batch, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, batch).astype(np.int32))


# ------------------------------------------------------- loss and gradients
@pytest.mark.parametrize("bottleneck,small_inputs,size", [
    (False, True, 8), (False, False, 16), (True, True, 9), (True, False, 16)],
    ids=["basic-cifar_stem-8", "basic-imagenet_stem-16",
         "bottleneck-cifar_stem-9", "bottleneck-imagenet_stem-16"])
def test_f32_loss_and_gradients_match_jax(bottleneck, small_inputs, size):
    kw = dict(TINY, bottleneck=bottleneck, small_inputs=small_inputs)
    ref_model = ref_resnet.ResNet(**kw)
    store = numpy_store(ref_model, seed=1)
    batch = image_batch(np.random.default_rng(size), 4, size)
    ref_loss, ref_g = jax_loss_and_grads(ref_model, store, batch)
    grads, loss = Trainer(resnet.ResNet(**kw), device="cpu") \
        .compute_gradients(store, batch)
    assert abs(loss - ref_loss) <= 5e-4 * abs(ref_loss)
    assert sorted(grads) == sorted(ref_g)
    for k, ref in ref_g.items():
        np.testing.assert_allclose(grads[k], ref, rtol=5e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("bottleneck,small_inputs,size", [
    (False, True, 8), (True, False, 16)],
    ids=["basic-cifar_stem-8", "bottleneck-imagenet_stem-16"])
def test_bf16_gradients_match_jax_within_rounding(bottleneck,
                                                      small_inputs, size):
    kw = dict(TINY, bottleneck=bottleneck, small_inputs=small_inputs)
    store = numpy_store(ref_resnet.ResNet(**kw), seed=1)
    x, y = image_batch(np.random.default_rng(size), 4, size)
    ref_loss, ref_g = jax_loss_and_grads(
        ref_resnet.ResNet(**kw, dtype=jnp.bfloat16), store, (x, y))
    model = resnet.ResNet(**kw, dtype=torch.bfloat16)
    assert model.dtype == torch.bfloat16
    grads, loss = Trainer(model, device="cpu").compute_gradients(store,
                                                                 (x, y))
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for k, ref in ref_g.items():
        assert grads[k].dtype == np.float32
        np.testing.assert_allclose(grads[k], ref, rtol=0,
                                   atol=2.0 ** -5 * np.abs(ref).max(),
                                   err_msg=k)


# ------------------------------------------------------- padding and pooling
@pytest.mark.parametrize("kernel,stride,size", [
    (3, 2, 8), (3, 2, 9), (3, 1, 8), (1, 2, 8), (1, 2, 9), (7, 2, 16),
    (7, 2, 15)])
def test_conv_matches_lax_same_padding(kernel, stride, size):
    rng = np.random.default_rng(kernel * 100 + size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 4, 6)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = resnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if kernel == 3 and stride == 2 and size % 2 == 0:
        # torch's symmetric padding: the same shape, other values
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                       padding=1).permute(0, 2, 3, 1)
        assert tuple(sym.shape) == ref.shape
        assert not np.allclose(sym.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("size", [8, 9, 112])
def test_max_pool_matches_reduce_window(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    got = resnet._max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert resnet.same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0
                                            else (1, 1))
    assert resnet.same_pads(224, 7, 2) == (2, 3)


# --------------------------------------------------- shapes, rows and stores
def test_param_shapes_match_jax():
    for port_fn, ref_fn, tensors, params in (
            (resnet.resnet18, ref_resnet.resnet18, 62, 11_173_962),
            (resnet.resnet50, ref_resnet.resnet50, 161, 25_557_032)):
        model, ref = port_fn(), ref_fn()
        assert model.param_shapes() == ref.param_shapes()
        assert len(model.param_shapes()) == tensors
        assert model.num_params() == ref.num_params() == params
    assert resnet.resnet50().dtype == torch.bfloat16
    assert resnet.resnet50().config.small_inputs is False


def test_registry_rows_streams_and_dtype_plumbing():
    for name in ("resnet18_cifar", "resnet50_imagenet"):
        model = registry.get_model(name)
        ref_model, _ = ref_registry.get_model_and_batches(name, 4)
        assert model.param_shapes() == ref_model.param_shapes()
    model, batches = registry.get_model_and_batches("resnet18_cifar", 4,
                                                    seed=3, device="cpu")
    _, ref_batches = ref_registry.get_model_and_batches("resnet18_cifar", 4,
                                                        seed=3)
    for _ in range(2):
        (x, y), (rx, ry) = next(batches), next(ref_batches)
        assert x.shape == (4, 32, 32, 3) and x.dtype == torch.float32
        assert y.dtype == torch.int32
        np.testing.assert_array_equal(x.numpy(), rx)
        np.testing.assert_array_equal(y.numpy(), ry)
    assert model.dtype == torch.float32
    model = registry.get_model("resnet18_cifar", dtype="bf16")
    assert model.dtype == model.config.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="remat"):
        registry.get_model("resnet18_cifar", remat=True)
    # the CIFAR stand-in and the image stream at a small size
    a = synthetic.synthetic_cifar10(num_examples=32, seed=2)
    b = ref_synthetic.synthetic_cifar10(num_examples=32, seed=2)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    for batch in (4, 64):
        ours = synthetic.synthetic_image_batches(batch, image_size=8,
                                                 num_classes=5, seed=1,
                                                 dataset_seed=2)
        theirs = ref_synthetic.synthetic_image_batches(
            batch, image_size=8, num_classes=5, seed=1, dataset_seed=2)
        for _ in range(3):
            (x, y), (rx, ry) = next(ours), next(theirs)
            assert x.tobytes() == rx.tobytes() and y.tobytes() == ry.tobytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_store_carried_across(dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    kw = dict(TINY, bottleneck=True)
    # a JAX store as numpy holds it: bf16 leaves are ml_dtypes arrays
    store = {k: np.asarray(v).astype(jdt) for k, v in
             numpy_store(ref_resnet.ResNet(**kw), seed=4).items()}
    model = resnet.ResNet(**kw, dtype=tdt)
    params = params_from_numpy(store, model.config, device="cpu")
    for k, v in store.items():
        assert params[k].dtype == tdt
        np.testing.assert_array_equal(params[k].float().numpy(),
                                      np.asarray(v, np.float32))
    if dtype == "f32":
        x, _ = image_batch(np.random.default_rng(0), 8, 8)
        ref = jax.jit(ref_resnet.ResNet(**kw).apply)(store, x)
        np.testing.assert_allclose(
            model.apply(params, torch.from_numpy(x)).numpy(),
            np.asarray(ref), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="drift"):
        params_from_numpy({"head/w": store["head/w"]}, model.config,
                          device="cpu")


# ------------------------------------------------------------- the fleets
BATCH, LR, ITERATIONS, SIZE = 8, 0.05, 4, 8


def _starter(root):
    """(start, stop): start(port_side, staleness) starts a PS and a
    coordinator of either package; stop() stops every one started."""
    started = []

    def start(port_side: bool, staleness: int = 0):
        cfg = port_config if port_side else ref_config
        kw = dict(bind_address="127.0.0.1", port=0, total_workers=2,
                  checkpoint_dir=str(root / f"ck{len(started)}"),
                  learning_rate=LR, staleness_bound=staleness)
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

    def stop():
        for server in reversed(started):
            server.stop()

    return start, stop


@pytest.fixture
def servers(tmp_path):
    start, stop = _starter(tmp_path)
    yield start
    stop()


def port_worker(coord_port: int, wid: int) -> Worker:
    config = port_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model="resnet18_cifar", heartbeat_period_s=1.0,
        device="cpu")
    batches = synthetic.synthetic_image_batches(BATCH, image_size=SIZE,
                                                seed=wid)
    return Worker(config, Trainer(resnet.ResNet(**TINY), device="cpu"),
                  batches)


# one JAX Trainer a worker id, compiled once and reused by the fleets
# that run one after the other (never two workers on one trainer)
_REF_TRAINERS: dict = {}


def ref_trainer(wid: int) -> RefTrainer:
    if wid not in _REF_TRAINERS:
        _REF_TRAINERS[wid] = RefTrainer(ref_resnet.ResNet(**TINY),
                                        local_devices=jax.devices()[:1])
    return _REF_TRAINERS[wid]


def ref_worker(coord_port: int, wid: int) -> RefWorker:
    config = ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model="resnet18_cifar", heartbeat_period_s=1.0)
    batches = ref_synthetic.synthetic_image_batches(BATCH, image_size=SIZE,
                                                    seed=wid)
    return RefWorker(config, ref_trainer(wid), batches)


def fleet(start, port_side: bool, makers, init, staleness: int = 0):
    """(losses by worker id, the PS)."""
    ps, coord_port = start(port_side, staleness)
    ps.core.initialize_parameters(init)
    workers = [make(coord_port, wid) for wid, make in enumerate(makers)]
    losses = {wid: [] for wid in range(len(workers))}
    errors = []

    def loop(worker):
        try:
            for it in range(ITERATIONS):
                losses[worker.config.worker_id].append(
                    worker.run_iteration(max(it, worker.iteration + 1)))
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
    finally:
        for w in workers:
            w.shutdown()
    return losses, ps


def held_out_loss(store) -> float:
    """The port model's loss at ``store`` (a dict, or either package's
    PS for its store) on 64 images of the task that no worker drew."""
    if not isinstance(store, dict):
        store = {k: v.numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v)
                 for k, v in store.core.get_parameters().items()}
    x, y = next(synthetic.synthetic_image_batches(64, image_size=SIZE,
                                                  seed=99))
    return Trainer(resnet.ResNet(**TINY), device="cpu").compute_gradients(
        store, (x, y))[1]


@pytest.fixture(scope="module")
def jax_fleet_losses(tmp_path_factory):
    """A JAX-only fleet's losses by worker id, on the JAX services."""
    start, stop = _starter(tmp_path_factory.mktemp("jax_fleet"))
    try:
        return fleet(start, False, [ref_worker, ref_worker],
                     numpy_store(ref_resnet.ResNet(**TINY), spread=0))[0]
    finally:
        stop()


@pytest.mark.parametrize("side", ["jax_services", "port_services"])
def test_mixed_resnet_fleet_tracks_jax_fleet(servers, jax_fleet_losses,
                                             side):
    base = jax_fleet_losses
    init = numpy_store(ref_resnet.ResNet(**TINY), spread=0)
    losses, ps = fleet(servers, side == "port_services",
                       [port_worker, ref_worker], init)
    for wid in (0, 1):
        assert len(losses[wid]) == ITERATIONS
        np.testing.assert_allclose(losses[wid], base[wid], rtol=1e-4,
                                   err_msg=f"worker {wid}")
    assert held_out_loss(ps) < held_out_loss(init)


def test_async_resnet_fleet_applies_or_refuses_every_push(servers,
                                                          monkeypatch,
                                                          caplog):
    caplog.set_level(logging.INFO)
    init = numpy_store(ref_resnet.ResNet(**TINY), spread=0)
    results = []
    real = {}

    def start(port_side, staleness=0):
        ps, coord_port = servers(port_side, staleness)
        core = ps.core
        real["receive"] = core.receive_gradients

        def receive(worker_id, iteration, gradients):
            result = real["receive"](worker_id, iteration, gradients)
            results.append(result)
            return result

        monkeypatch.setattr(core, "receive_gradients", receive)
        return ps, coord_port

    losses, ps = fleet(start, True, [port_worker, port_worker], init,
                       staleness=4)
    applied = [r for r in results if r.success]
    stale = [r for r in results if not r.success]
    assert all("stale push" in r.message for r in stale)
    assert len(applied) == ps.core.applied_updates == 2 * ITERATIONS
    logged = [r for r in caplog.records if "fast-forwarding" in r.message]
    assert len(logged) == len(stale)
    assert [len(losses[wid]) for wid in (0, 1)] == [ITERATIONS] * 2
    assert held_out_loss(ps) < held_out_loss(init)
