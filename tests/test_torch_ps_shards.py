"""Static PS sharding in the port — ``shard_owner`` and
``ShardedPSClient`` (worker/ps_shards.py), the shard-map messages and
``ShardMapClient`` (replication/), the coordinator's shard map and
``--ps-shards``, and ``Worker``'s sharded discovery — against the JAX
package's (the cases of tests/test_ps_sharding.py, on the port).

- ``shard_owner`` equals the JAX package's for every parameter name of
  every port registry row at 1–8 shards; ``_partition``,
  ``_merge_pushes`` and ``_merge_pulls`` give the JAX package's bytes on
  the same messages; the shard-map messages, ``GetParameterServerAddress``
  and ``GetShardMap`` are byte for byte a JAX coordinator's on the same
  ``--ps-shards`` (field 3 absent when unsharded).
- Fleets over port shards, ``mnist_mlp``, bf16 on the wire over the
  same-host rings: two port workers over two shards (each shard holds
  its owner's names, the loss falls); a mixed fleet, one port and one
  JAX worker, within rtol 1e-4 of a JAX-only fleet on JAX shards from
  the same numpy store; one JAX worker over four shards, shards 0 and 3
  owning nothing, byte-identical to it over four JAX shards; one port
  worker over four shards byte-identical to it on one PS.
- Checkpoints saved through the port's client load through the JAX
  client's ``.shard<N>`` paths; a restarted shard is reseeded alone; an
  async partial stale push re-pushes only the refused shard; the fused
  round degrades to unary per shard with identical stores.

Both packages' C++ host libraries are off (their numpy SGD folds are bit
for bit the same), torch runs on at most two intra-op threads, rings are
64 KB, and every server, worker and thread is stopped in teardown."""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.models import mlp as ref_mlp
from parameter_server_distributed_tpu.models import registry as ref_registry
from parameter_server_distributed_tpu.replication import messages as ref_rmsg
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu.server.coordinator_service import \
    Coordinator as RefCoordinator
from parameter_server_distributed_tpu.server.ps_service import \
    ParameterServer as RefParameterServer
from parameter_server_distributed_tpu.worker import ps_shards as ref_shards
from parameter_server_distributed_tpu.worker.trainer import \
    Trainer as RefTrainer
from parameter_server_distributed_tpu.worker.worker import Worker as RefWorker
from parameter_server_distributed_tpu_torch import config as port_config
from parameter_server_distributed_tpu_torch import native as port_native
from parameter_server_distributed_tpu_torch.checkpoint.manager import \
    CheckpointManager
from parameter_server_distributed_tpu_torch.cli import coordinator_main
from parameter_server_distributed_tpu_torch.core.optimizer import \
    make_optimizer
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import (to_host,
                                                                 to_wire)
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.replication import \
    messages as rmsg
from parameter_server_distributed_tpu_torch.replication.failover import \
    ShardMapClient
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.service import (
    RpcClient, bind_service, make_server)
from parameter_server_distributed_tpu_torch.core.coordinator_core import \
    CoordinatorCore
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator, CoordinatorService
from parameter_server_distributed_tpu_torch.server.ps_service import (
    ParameterServer, ParameterServerService)
from parameter_server_distributed_tpu_torch.worker.ps_shards import (
    ShardedPSClient, shard_owner)
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

MODEL, BATCH, LR = "mnist_mlp", 32, 0.05
JOIN_S = 120.0
RING = 1 << 16


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    """Both packages' numpy host paths, at most two torch intra-op
    threads, the rings on at 64 KB; all restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    native.set_enabled(False)
    port_native.set_enabled(False)
    monkeypatch.setenv("PSDT_SHM", "1")
    monkeypatch.setenv("PSDT_SHM_RING_BYTES", str(RING))
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        port_native.set_enabled(default)
        torch.set_num_threads(threads)


@pytest.fixture
def cluster(tmp_path):
    """start(port_side, n_shards, total_workers=..., **ps_kwargs) ->
    (shards, their ports, coordinator port); ``closing`` takes anything
    else with a shutdown, close or stop to end at teardown."""
    started: list = []

    def start(port_side: bool, n_shards: int, total_workers: int = 2,
              **ps_kwargs):
        cfg = port_config if port_side else ref_config
        shards = []
        for i in range(n_shards):
            kw = dict(bind_address="127.0.0.1", port=0,
                      total_workers=total_workers, learning_rate=LR,
                      checkpoint_dir=str(tmp_path / f"ck{len(started)}"),
                      **ps_kwargs)
            if port_side:
                kw["device"] = "cpu"   # pallas_sgd's plain version
            else:
                kw.update(autosave_period_s=600.0, optimizer="sgd")
            ps = (ParameterServer if port_side else RefParameterServer)(
                cfg.ParameterServerConfig(**kw))
            started.append(ps)
            shards.append((ps, ps.start()))
        coord = (Coordinator if port_side else RefCoordinator)(
            cfg.CoordinatorConfig(
                bind_address="127.0.0.1", port=0, ps_address="127.0.0.1",
                ps_port=shards[0][1],
                ps_shards=tuple(f"127.0.0.1:{p}" for _, p in shards[1:]),
                reap_period_s=600.0))
        started.append(coord)
        return [ps for ps, _ in shards], [p for _, p in shards], \
            coord.start()

    def closing(obj):
        started.append(obj)
        return obj

    start.closing = closing
    yield start
    for obj in reversed(started):
        for name in ("shutdown", "close", "stop"):
            if hasattr(obj, name):
                getattr(obj, name)()
                break


def port_worker(coord_port: int, wid: int, batch: int = BATCH) -> Worker:
    config = port_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=batch, model=MODEL, wire_dtype="bf16",
        heartbeat_period_s=600.0, device="cpu")
    model, batches = registry.get_model_and_batches(MODEL, batch, seed=wid,
                                                    device="cpu")
    return Worker(config, Trainer(model, device="cpu"), batches,
                  start_heartbeat=False)


_REF_TRAINERS: dict = {}


def ref_worker(coord_port: int, wid: int, batch: int = BATCH) -> RefWorker:
    # one JAX Trainer a worker id, compiled once (never two live workers
    # on one trainer: the fleets run one after the other)
    if wid not in _REF_TRAINERS:
        _REF_TRAINERS[wid] = RefTrainer(ref_mlp.mnist_mlp(),
                                        local_devices=jax.devices()[:1])
    config = ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=batch, model=MODEL, wire_dtype="bf16",
        heartbeat_period_s=600.0)
    _, batches = ref_registry.get_model_and_batches(MODEL, batch, seed=wid)
    return RefWorker(config, _REF_TRAINERS[wid], batches)


def run_fleet(workers, iterations: int) -> dict:
    """Each worker runs ``iterations`` in its own thread; losses by
    worker id.  Notes on each worker whether its connections rode the
    rings (``rode_rings``), then shuts it down."""
    losses = {w.config.worker_id: [] for w in workers}
    errors = []

    def loop(worker):
        try:
            for it in range(iterations):
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
        for w in workers:   # read before shutdown closes the rings
            w.rode_rings = bool(w._ps.shm_active)
    finally:
        for w in workers:
            w.shutdown()
    return losses


def host_store(ps) -> dict:
    return to_host(ps.core.get_parameters())


def numpy_init(seed: int = 0) -> dict:
    return {k: np.asarray(v, np.float32)
            for k, v in ref_mlp.mnist_mlp().init_params(seed).items()}


def partition(store: dict, n: int) -> list[dict]:
    return [{k: v for k, v in store.items() if shard_owner(k, n) == i}
            for i in range(n)]


# -------------------------------------------------------------- placement
@pytest.mark.parametrize("n_shards", range(1, 9))
def test_shard_owner_equals_jax_for_every_registry_name(n_shards):
    names = {"", "w", "layer0/w", "é/ü", "x" * 300}
    for row in sorted(registry.REGISTRY) + sorted(registry.XY_REGISTRY):
        names |= set(registry.get_model(row).param_shapes())
    assert len(names) > 300
    got = {n: shard_owner(n, n_shards) for n in names}
    assert got == {n: ref_shards.shard_owner(n, n_shards) for n in names}
    assert set(got.values()) <= set(range(n_shards))


def test_placement_of_the_config_rows():
    """mnist_mlp over 4 shards leaves shards 0 and 3 empty; mlp_1b puts
    twice the others' elements on shard 1."""
    mnist = registry.get_model("mnist_mlp").param_shapes()
    assert sorted({shard_owner(n, 4) for n in mnist}) == [1, 2]
    big = registry.get_model("mlp_1b").param_shapes()
    sizes = [0] * 4
    for name, shape in big.items():
        sizes[shard_owner(name, 4)] += int(np.prod(shape))
    assert sizes[1] == 536_887_296 and sum(sizes) == 1_342_259_200
    assert {n for n in big if shard_owner(n, 4) == 0} == {"layer2/b",
                                                          "layer3/w"}


def test_message_cap_holds_every_registry_tensor_in_f32():
    """A push chunk holds whole tensors, so the bootstrap's f32 push of
    mlp_1b's 16384 x 16384 weights is one message of 1 GiB and a header:
    over the JAX package's 1 GiB cap, under the port's (gRPC's largest)."""
    from parameter_server_distributed_tpu.rpc import service as ref_service
    from parameter_server_distributed_tpu_torch.rpc import service

    def cap(options) -> int:
        return dict(options)["grpc.max_send_message_length"]

    largest = max(int(np.prod(shape)) for row in
                  sorted(registry.REGISTRY) + sorted(registry.XY_REGISTRY)
                  for shape in registry.get_model(row).param_shapes().values())
    assert largest == 16384 * 16384
    header = len(m.Tensor.from_array(
        "layer0/w", np.zeros(4, np.float32)).encode()) - 16
    message = 4 * largest + header + 64   # the chunk's own fields
    assert cap(service.CHANNEL_OPTIONS) == dict(service.CHANNEL_OPTIONS)[
        "grpc.max_receive_message_length"] == (1 << 31) - 1 > message
    assert cap(ref_service.CHANNEL_OPTIONS) == 1 << 30 < message


def test_partition_and_merges_equal_jax():
    rng = np.random.default_rng(0)
    store = {f"layer{i}/{k}": rng.standard_normal(5).astype(np.float32)
             for i in range(6) for k in ("w", "b")}
    addrs = [f"127.0.0.1:{9 + i}" for i in range(3)]   # never dialled
    port, ref = ShardedPSClient(addrs), ref_shards.ShardedPSClient(addrs)
    try:
        got = port._partition(to_wire(store, m.WIRE_BF16))
        want = ref._partition([ref_m.Tensor.from_array(
            k, v, wire_dtype=ref_m.WIRE_BF16) for k, v in store.items()])
        assert [[t.encode() for t in s] for s in got] == \
            [[t.encode() for t in s] for s in want]
        assert port._partition(lambda: iter(())) == [[], [], []]
        fields = [dict(success=i != 1, message=f"m{i % 2}", iteration=3 + i,
                       aggregation_complete=i != 2, workers_received=2 - i,
                       total_workers=2 + i) for i in range(3)]
        assert port._merge_pushes([m.PushResponse(**f) for f in fields]
                                  ).encode() == ref._merge_pushes(
            [ref_m.PushResponse(**f) for f in fields]).encode()
        pulls = [(i + 1, s, i != 1) for i, s in enumerate(got)]
        assert port._merge_pulls([m.ParameterUpdate(
            iteration=it, parameters=s, ready=r) for it, s, r in pulls]
        ).encode() == ref._merge_pulls([ref_m.ParameterUpdate(
            iteration=it, parameters=s, ready=r) for it, s, r in pulls]
        ).encode()
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------- the shard map
def test_shard_map_messages_byte_equal_jax():
    entries = [dict(primary=f"10.0.0.{i}:5005{i}", backup="", epoch=i + 1)
               for i in range(3)]
    pairs = [
        (rmsg.ShardMapResponse(epoch=4, entries=[
            rmsg.WireShardMapEntry(**e) for e in entries]),
         ref_rmsg.ShardMapResponse(epoch=4, entries=[
             ref_rmsg.WireShardMapEntry(**e) for e in entries])),
        (rmsg.ShardMapRequest(), ref_rmsg.ShardMapRequest()),
        (rmsg.ShardFailureReport(shard_index=2, observed_primary="h:1",
                                 epoch=3, worker_id=7),
         ref_rmsg.ShardFailureReport(shard_index=2, observed_primary="h:1",
                                     epoch=3, worker_id=7)),
    ]
    for ours, theirs in pairs:
        assert ours.encode() == theirs.encode()
        assert type(ours).decode(theirs.encode()).encode() == ours.encode()
    assert rmsg.STALE_SHARD_MAP == ref_rmsg.STALE_SHARD_MAP
    assert set(rmsg.REPLICATION_COORD_METHODS) == set(
        ref_rmsg.REPLICATION_COORD_METHODS)


@pytest.mark.parametrize("sharded", [True, False])
def test_discovery_and_shard_map_byte_equal_jax(sharded):
    argv = ["127.0.0.1:0", "10.0.0.1:50051"] + (
        ["--ps-shards=10.0.0.2:50051,10.0.0.3:50052"] if sharded else [])
    config = coordinator_main.build_config(argv)
    ref = RefCoordinator(ref_config.CoordinatorConfig(
        bind_address="127.0.0.1", port=0, ps_address=config.ps_address,
        ps_port=config.ps_port, ps_shards=config.ps_shards,
        reap_period_s=600.0))
    ours = Coordinator(config)
    clients = []
    try:
        for coord in (ours, ref):
            clients.append(RpcClient(
                f"127.0.0.1:{coord.start()}", m.COORDINATOR_SERVICE,
                {**m.COORDINATOR_METHODS,
                 **rmsg.REPLICATION_COORD_METHODS}))
        got = [[c.call("GetParameterServerAddress", m.GetPSAddressRequest(),
                       timeout=5.0).encode(),
                c.call("GetShardMap", rmsg.ShardMapRequest(),
                       timeout=5.0).encode(),
                c.call("ReportShardFailure", rmsg.ShardFailureReport(
                    shard_index=1 if sharded else 0,
                    observed_primary="10.0.0.1:50051", epoch=1),
                    timeout=5.0).encode()] for c in clients]
        assert got[0] == got[1]
        discovery = m.GetPSAddressResponse.decode(got[0][0])
        assert list(discovery.shards) == (
            ["10.0.0.1:50051", "10.0.0.2:50051", "10.0.0.3:50052"]
            if sharded else [])
        # field 3 (tag 0x1a) rides the answer only when sharded
        assert (b"\x1a" in got[0][0]) == sharded
        shard_map = rmsg.ShardMapResponse.decode(got[0][1])
        assert shard_map.epoch == 1 and len(shard_map.entries) == (
            3 if sharded else 1)
        # a reported failure promotes nothing: the map comes back as it was
        assert got[0][2] == got[0][1]
        # the worker's map client reads it; a report leaves the error
        smc = ShardMapClient("", client=clients[0])
        assert smc.refresh() and smc.supported and not smc.has_backups()
        assert smc.primaries() == [e.primary for e in shard_map.entries]
        assert smc.report_failure(0, "10.0.0.1:50051") is None
        assert smc.wait_for_epoch_above(0, timeout=1.0)
        assert not smc.wait_for_epoch_above(1, timeout=0.2, poll_s=0.05)
    finally:
        for c in clients:
            c.close()
        ours.stop()
        ref.stop()


def test_coordinator_core_shard_map_equals_jax():
    """The same calls on both packages' CoordinatorCore leave the same
    map: entry 0 follows the re-pointed PS address, replacing the other
    shards bumps the epoch and keeps an unchanged entry's, and a reported
    failure without a backup changes nothing."""
    from parameter_server_distributed_tpu.core import coordinator_core as ref

    cores = [CoordinatorCore("10.0.0.1", 1, ps_shards=("h:2", "h:3")),
             ref.CoordinatorCore("10.0.0.1", 1, ps_shards=("h:2", "h:3"))]
    maps = []
    for core in cores:
        core.set_parameter_server_address("10.0.0.9", 7)
        core.set_parameter_server_shards(("h:3", "h:4"))
        core.promote_shard(1, "h:3")
        epoch, entries = core.get_shard_map()
        maps.append((epoch, [(e.primary, e.backup, e.epoch)
                             for e in entries],
                     core.get_parameter_server_shards(),
                     core.get_parameter_server_address()))
    assert maps[0] == maps[1]
    assert maps[0][2] == ["10.0.0.9:7", "h:3", "h:4"] and maps[0][0] == 2


def test_coordinator_without_the_map_is_a_permanent_downgrade():
    """A coordinator that answers GetShardMap UNIMPLEMENTED (a reference
    peer) latches the map client off for good."""
    server = make_server()
    bind_service(server, m.COORDINATOR_SERVICE, m.COORDINATOR_METHODS,
                 CoordinatorService(CoordinatorCore("127.0.0.1", 1)))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    smc = ShardMapClient(f"127.0.0.1:{port}")
    try:
        assert not smc.refresh() and not smc.supported
        assert smc._supported is False and not smc.refresh()
        assert smc.report_failure(0, "x:1") is None
    finally:
        smc.close()
        server.stop(0).wait()


# ------------------------------------------------------------ the fleets
def test_two_port_workers_train_over_two_port_shards(cluster):
    shards, _, coord_port = cluster(True, 2)
    workers = [port_worker(coord_port, i) for i in range(2)]
    for w in workers:
        cluster.closing(w)
    losses = run_fleet(workers, 4)
    assert all(isinstance(w._ps, ShardedPSClient) and w._ps.num_shards == 2
               and w._ps._shard_map.supported for w in workers)
    names = [set(ps.core.get_parameters()) for ps in shards]
    assert names[0] and names[1] and not names[0] & names[1]
    assert names[0] | names[1] == set(
        registry.get_model(MODEL).param_shapes())
    for i, owned in enumerate(names):
        assert all(shard_owner(n, 2) == i for n in owned)
    for wid in (0, 1):   # iteration 0 is the bootstrap
        assert np.isnan(losses[wid][0]) and losses[wid][-1] < losses[wid][1]


def _fleet_on(cluster, port_side: bool, makers, n_shards: int, init,
              iterations: int = 4, batch: int = BATCH):
    shards, _, coord_port = cluster(port_side, n_shards,
                                    total_workers=len(makers))
    if init is not None:
        for ps, part in zip(shards, partition(init, n_shards)):
            ps.core.initialize_parameters(part)
    workers = [make(coord_port, wid, batch) for wid, make in
               enumerate(makers)]
    for w in workers:
        cluster.closing(w)
    losses = run_fleet(workers, iterations)
    return losses, shards, workers


def test_mixed_fleet_on_port_shards_tracks_jax_fleet(cluster):
    """One port worker and one JAX worker on two port shards (a port
    coordinator) against two JAX workers on two JAX shards, the same
    numpy store: losses within rtol 1e-4, stores within the gradient
    tolerance; the JAX worker took the shard-map branch."""
    init = numpy_init()
    base, base_shards, _ = _fleet_on(cluster, False,
                                     [ref_worker, ref_worker], 2, init)
    mixed, shards, workers = _fleet_on(cluster, True,
                                       [port_worker, ref_worker], 2, init)
    jax_client = workers[1]._ps
    assert isinstance(jax_client, ref_shards.ShardedPSClient)
    assert jax_client._shard_map is not None and \
        jax_client._shard_map.supported
    assert all(w.rode_rings for w in workers)
    for wid in (0, 1):
        np.testing.assert_allclose(mixed[wid], base[wid], rtol=1e-4,
                                   err_msg=f"worker {wid}")
        assert mixed[wid][-1] < mixed[wid][0]
    for ps, ref_ps in zip(shards, base_shards):
        got, want = host_store(ps), ref_ps.core.get_parameters()
        assert sorted(got) == sorted(want) and got
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=5e-4,
                                       atol=1e-5, err_msg=n)


def test_jax_worker_over_four_port_shards_equals_jax_shards(cluster):
    """mnist_mlp over four shards: shards 0 and 3 own nothing, and their
    barriers still close on each worker's empty pushes.  A JAX worker
    bootstrapping four port shards leaves every shard byte for byte what
    it leaves on four JAX shards, round after round."""
    stores = []
    for port_side in (False, True):
        _, shards, _ = _fleet_on(cluster, port_side, [ref_worker], 4, None,
                                 iterations=5)
        stores.append([to_host(ps.core.get_parameters()) for ps in shards])
    ref_stores, port_stores = stores
    assert [sorted(s) for s in port_stores] == [sorted(s) for s in
                                                ref_stores]
    assert not port_stores[0] and not port_stores[3]
    for got, want in zip(port_stores, ref_stores):
        for n in want:
            assert got[n].tobytes() == want[n].tobytes(), n


def test_port_worker_over_four_shards_equals_one_ps(cluster, monkeypatch):
    """The card's exact leg here: one port worker at config 1's settings
    (batch 256, bf16 on the wire, pallas_sgd at lr 0.05, 5 rounds) over
    four port shards leaves, merged, the store it leaves on one PS,
    byte for byte; every round after the bootstrap is a fused round that
    delivered the next store (no poll, no pull)."""
    pulls = []
    plain_pull = Worker.pull_parameters
    monkeypatch.setattr(Worker, "pull_parameters", lambda self, it: (
        pulls.append(it), plain_pull(self, it))[1])
    one, (ps,), (w,) = _fleet_on(cluster, True, [port_worker], 1, None,
                                 iterations=6, batch=256)
    four, shards, (w4,) = _fleet_on(cluster, True, [port_worker], 4, None,
                                    iterations=6, batch=256)
    # iteration 0 finds the store empty and seeds it over the plain push,
    # iteration 1 pulls the seeded store; the rounds deliver the rest
    assert pulls == [0, 1, 0, 1]
    np.testing.assert_array_equal(four[0][1:], one[0][1:])
    assert four[0][-1] < four[0][1]
    want = host_store(ps)
    merged = {}
    for shard in shards:
        merged.update(host_store(shard))
    assert not host_store(shards[0]) and not host_store(shards[3])
    assert sorted(merged) == sorted(want)
    for n in want:
        assert merged[n].tobytes() == want[n].tobytes(), n
    assert w4.rode_rings


def test_sharded_checkpoint_loads_through_the_jax_client(cluster, tmp_path):
    _, ports, _ = cluster(True, 2)
    rng = np.random.default_rng(0)
    store = {f"t{i}": rng.standard_normal(8).astype(np.float32)
             for i in range(6)}
    addrs = [f"127.0.0.1:{p}" for p in ports]
    client = cluster.closing(ShardedPSClient(addrs))
    for wid in (0, 1):   # both barrier slots: the first mean seeds
        push = client.call("ReceiveGradients", m.GradientUpdate(
            worker_id=wid, iteration=0, gradients=to_wire(store)))
        assert push.success
    assert push.aggregation_complete
    path = str(tmp_path / "manual.ckpt")
    save = client.call("SaveCheckpoint",
                       m.SaveCheckpointRequest(epoch=1, path=path))
    assert save.success and os.path.exists(path)
    assert os.path.exists(path + ".shard1")
    ref_client = cluster.closing(ref_shards.ShardedPSClient(addrs))
    load = ref_client.call("LoadCheckpoint",
                           ref_m.LoadCheckpointRequest(path=path))
    assert load.success
    loaded = {t.name: t.to_array() for t in load.parameters}
    assert sorted(loaded) == sorted(store)
    for name, value in store.items():
        assert loaded[name].tobytes() == value.tobytes(), name
    # each file is one shard's partition, in the port's own reader too
    for i, p in enumerate((path, path + ".shard1")):
        core = ParameterServerCore(total_workers=1)
        CheckpointManager(core, str(tmp_path)).load(p)
        assert set(core.get_parameters()) == {
            n for n in store if shard_owner(n, 2) == i}


def test_restarted_shard_is_reseeded_alone(cluster, tmp_path):
    """A shard that restarts empty refuses the next fused push (its store
    is empty) and then shows up as a partial merged pull: the worker
    reseeds the missing names, and only on that shard; the other shard
    keeps its trained partition and trains on."""
    shards, ports, coord_port = cluster(True, 2, total_workers=1)
    w = cluster.closing(port_worker(coord_port, 0))
    w.initialize()
    for it in range(2):
        w.run_iteration(it)
    owned = set(shards[1].core.get_parameters())
    assert owned
    port1 = ports[1]
    shards[1].stop()
    restarted = cluster.closing(ParameterServer(
        port_config.ParameterServerConfig(
            bind_address="127.0.0.1", port=port1, total_workers=1,
            learning_rate=LR, checkpoint_dir=str(tmp_path / "restart"),
            device="cpu")))
    restarted.start()
    w.run_iteration(2)
    assert w.last_bootstrap
    init = {n: np.asarray(v, np.float32)
            for n, v in w.trainer.init_params(seed=0).items()}
    got = host_store(restarted)
    assert set(got) == owned
    assert all(got[n].tobytes() == init[n].tobytes() for n in owned)
    kept = host_store(shards[0])
    assert set(kept) == set(init) - owned
    assert not any(np.array_equal(kept[n], init[n]) for n in kept)
    assert np.isfinite(w.run_iteration(3))
    moved = host_store(shards[0])
    assert not any(np.array_equal(moved[n], kept[n]) for n in kept)


def test_async_partial_stale_repushes_only_the_refused_shard(cluster):
    shards, ports, _ = cluster(True, 2, total_workers=1,
                              staleness_bound=2)
    client = cluster.closing(ShardedPSClient(
        [f"127.0.0.1:{p}" for p in ports]))
    direct1 = cluster.closing(RpcClient(
        f"127.0.0.1:{ports[1]}", m.PARAMETER_SERVER_SERVICE,
        m.PARAMETER_SERVER_METHODS))
    rng = np.random.default_rng(0)
    store = {f"t{i}": rng.standard_normal(8).astype(np.float32)
             for i in range(6)}
    owned1 = [n for n in store if shard_owner(n, 2) == 1]
    assert owned1
    for ps, part in zip(shards, partition(store, 2)):
        ps.core.initialize_parameters(part)
    # shard 1 only, far ahead: a low-iteration push is stale there only
    direct1.call("ReceiveGradients", m.GradientUpdate(
        worker_id=9, iteration=10,
        gradients=to_wire({owned1[0]: np.zeros(8, np.float32)})))
    applied = [ps.core.applied_updates for ps in shards]
    push = client.call("ReceiveGradients", m.GradientUpdate(
        worker_id=0, iteration=1, gradients=to_wire(store)))
    assert push.success, push.message
    assert [ps.core.applied_updates for ps in shards] == [
        applied[0] + 1, applied[1] + 1]


def _unary_only_shard(tmp_path, name: str, cluster):
    """A reference-shaped port PS: the five unary RPCs only."""
    core = ParameterServerCore(total_workers=2, optimizer=make_optimizer(
        "pallas_sgd", LR, device="cpu"))
    service = ParameterServerService(
        core, CheckpointManager(core, str(tmp_path / name)))
    server = make_server()
    bind_service(server, m.PARAMETER_SERVER_SERVICE,
                 m.PARAMETER_SERVER_METHODS, service)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()

    class Stop:
        def stop(self):
            core.release_waiters()
            service.shm_server.close()
            server.stop(0).wait()

    cluster.closing(Stop())
    return core, port


def test_fused_degrades_to_unary_per_shard_identically(cluster, tmp_path):
    """Every shard reference-shaped (unary only): the fused fan-out
    degrades per shard to unary push, poll and pull, and two port
    workers leave the stores they leave on full port shards, byte for
    byte (the transport changes, never the math)."""
    def run(unary: bool) -> dict:
        if unary:
            shards = [_unary_only_shard(tmp_path, f"u{i}", cluster)
                      for i in range(2)]
            cores, ports = [c for c, _ in shards], [p for _, p in shards]
        else:
            full, ports, _ = cluster(True, 2)
            cores = [ps.core for ps in full]
        coord = cluster.closing(Coordinator(port_config.CoordinatorConfig(
            bind_address="127.0.0.1", port=0, ps_address="127.0.0.1",
            ps_port=ports[0], ps_shards=(f"127.0.0.1:{ports[1]}",),
            reap_period_s=600.0)))
        coord_port = coord.start()
        workers = [cluster.closing(port_worker(coord_port, i))
                   for i in range(2)]
        run_fleet(workers, 3)
        assert all(w.rode_rings != unary for w in workers)
        merged = {}
        for core in cores:
            merged.update(to_host(core.get_parameters()))
        return merged

    degraded, full = run(True), run(False)
    assert degraded and sorted(degraded) == sorted(full)
    for n in full:
        assert degraded[n].tobytes() == full[n].tobytes(), n


def test_exit_report_peak_rss_is_the_process_own():
    """Where the kernel reports VmHWM, a child's exit report gives its own
    peak resident memory, not the resident size of the process that
    started it (getrusage's ru_maxrss keeps that across exec:
    config3_wire's children all read the smoke process's size), and it
    names its source."""
    import subprocess
    import sys

    ballast = bytearray(512 << 20)
    ballast[::4096] = b"\1" * len(ballast[::4096])
    with open("/proc/self/status") as f:
        parent = next(int(line.split()[1]) * 1024 for line in f
                      if line.startswith("VmRSS:"))
    code = ("import resource\n"
            "from parameter_server_distributed_tpu_torch.cli.exit_report "
            "import peak_rss\n"
            "rss, source = peak_rss()\n"
            "assert source == 'VmHWM', source\n"
            "print(rss, resource.getrusage("
            "resource.RUSAGE_SELF).ru_maxrss * 1024)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    own, inherited = map(int, out.stdout.split())
    del ballast
    # the parent's pages at the fork and when read here differ a little
    assert own < parent // 2 < inherited and inherited > 0.95 * parent
