"""The port's flat arena (core/arena.py, ``PSDT_ARENA=1`` with the
sharded device optimizer) against the port's host numpy close and the
JAX package's flat close on jax's CPU, byte for byte: every rule at
stripes 1 / 2 / 8, the packing table's layout, padding, the downgrade
matrix (partial coverage, counts that differ, a mixed momentum seed, a
broadcast fold, a packing failure that latches the arena off), each
counted in ``ps.apply.arena_fallback`` as a delta (the counter is
process-global), a failed close that stays retryable, and BASELINE
config 1 as a mixed fleet: one port and one JAX mnist_mlp worker (bf16
on the wire, the same-host rings) on a port PS that closes on its device
(``--device=cpu``, ``sharded_sgd``, both knobs) and on a JAX host-numpy
PS, whose checkpoints must be byte-identical.  (A JAX-only fleet's
gradients differ from the port worker's in the last bits, so its
checkpoints cannot be; its losses are held within rtol 1e-4.)

Both packages run their numpy paths (restored afterwards), env knobs go
through ``monkeypatch``, torch keeps at most two intra-op threads, and
every server is stopped and every thread joined with a timeout."""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import config as ref_config
from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
    ShardedDeviceOptimizer as RefSharded
from parameter_server_distributed_tpu.core import arena as ref_arena
from parameter_server_distributed_tpu.core.ps_core import \
    ParameterServerCore as RefCore
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
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import ShardedDeviceOptimizer
from parameter_server_distributed_tpu_torch.core import arena
from parameter_server_distributed_tpu_torch.core import optimizer as port_opt
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import (to_host,
                                                                to_wire)
from parameter_server_distributed_tpu_torch.models import registry
from parameter_server_distributed_tpu_torch.obs import stats
from parameter_server_distributed_tpu_torch.ops import device_apply as da
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.data_plane import \
    decode_gradients
from parameter_server_distributed_tpu_torch.server.coordinator_service \
    import Coordinator
from parameter_server_distributed_tpu_torch.server.ps_service import \
    ParameterServer
from parameter_server_distributed_tpu_torch.worker.trainer import Trainer
from parameter_server_distributed_tpu_torch.worker.worker import Worker

SHAPES = {"emb/w": (129, 33), "l0/w": (64, 65), "l0/b": (65,),
          "head/w": (33, 17), "odd": (513,)}
LR = 0.02
CPU = torch.device("cpu")
JOIN_S = 120.0


@pytest.fixture(autouse=True)
def hygiene(monkeypatch):
    """The arena and the device close on, both packages' numpy paths,
    two torch threads."""
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
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


def host(store) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in to_host(
        {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
         for k, v in store.items()}).items()}


def same(a, b) -> bool:
    a, b = host(a), host(b)
    return sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes()
                                          for k in a)


def fallbacks() -> tuple[int, int]:
    """(flat closes, arena fallbacks) so far in this process."""
    return (stats.counter("ps.apply.arena").value,
            stats.counter("ps.apply.arena_fallback").value)


def randn(rng, shapes) -> dict:
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def closes(core, grads_by_iter, workers=1, device=False) -> dict:
    for it, grads in enumerate(grads_by_iter, start=1):
        for wid in range(workers):
            g = {k: v.copy() for k, v in grads.items()}
            if device:
                g = decode_gradients(to_wire(g, m.WIRE_RAW_F32), CPU)
            r = core.receive_gradients(wid, it, g)
        assert r.aggregation_complete, r.message
    return host(core.get_parameters())


def sharded(rule="adam", lr=LR) -> ShardedDeviceOptimizer:
    return ShardedDeviceOptimizer(rule, lr, device="cpu")


# ---------------------------------------------------------- the flat close
@pytest.mark.parametrize("stripes", [1, 2, 8])
@pytest.mark.parametrize("rule", ShardedDeviceOptimizer.RULES)
def test_flat_close_equals_host_and_jax(rule, stripes):
    """Two workers, three closes, pushes in two chunks decoded onto the
    device: the flat store equals the port's host close and the JAX
    package's flat close after every close, and every close ran flat."""
    rng = np.random.default_rng(stripes)
    init = randn(rng, SHAPES)
    grads = [[randn(rng, SHAPES) for _ in range(2)] for _ in range(3)]
    port_host = ParameterServerCore(total_workers=2, stripes=stripes,
                                    optimizer=port_opt.make_optimizer(
                                        rule, LR))
    flat = ParameterServerCore(total_workers=2, stripes=stripes,
                               optimizer=sharded(rule))
    ref = RefCore(total_workers=2, stripes=stripes,
                  optimizer=RefSharded(rule, LR))
    assert flat._arena is not None and ref._arena is not None
    for core in (port_host, flat, ref):
        core.initialize_parameters(init)
    before = fallbacks()
    for it, pair in enumerate(grads, start=1):
        for wid, g in enumerate(pair):
            port_host.receive_gradients(wid, it, g)
            names = list(g)
            sink = flat.begin_push(wid, it)
            for part in (names[:3], names[3:]):
                sink.fold(decode_gradients(
                    to_wire({k: g[k] for k in part}, m.WIRE_RAW_F32), CPU))
            sink.commit()
            ref.receive_gradients(wid, it, {k: v.copy()
                                            for k, v in g.items()})
        got = flat.get_parameters()
        assert list(got) == list(port_host.get_parameters())
        assert same(got, port_host.get_parameters()), (rule, it)
        assert same(ref.get_parameters(), port_host.get_parameters())
    after = fallbacks()
    assert after == (before[0] + 3, before[1])
    store = flat._params
    assert isinstance(store, arena.ArenaStore)
    assert same(flat.optimizer_state().get("m", {}),
                port_host.optimizer_state().get("m", {}))


def test_packing_table_matches_jax_and_only_shapes_rebuild():
    rng = np.random.default_rng(7)
    store = randn(rng, SHAPES)
    for stripes in (1, 2, 8):
        ours = arena.PackingTable(store, stripes, epoch=1)
        theirs = ref_arena.PackingTable(store, stripes, epoch=1)
        assert {n: (e.stripe, e.offset, e.length, e.shape, e.decayed)
                for n, e in ours.entries.items()} == \
            {n: (e.stripe, e.offset, e.length, e.shape, e.decayed)
             for n, e in theirs.entries.items()}
        assert ours.stripe_sizes == theirs.stripe_sizes
        for s in range(stripes):
            mask = np.asarray(theirs.decay_mask(s))
            assert not mask[ours.decay_len(s):].any()
            assert mask[:ours.decay_len(s)].all()
    mgr = arena.ArenaManager(2, CPU)
    ta = mgr.ensure_table(store)
    assert mgr.ensure_table({k: v * 2 for k, v in store.items()}).epoch \
        == ta.epoch
    grown = dict(store, odd=rng.standard_normal((3, 171)).astype(np.float32))
    assert mgr.ensure_table(grown).epoch == ta.epoch + 1


def test_alignment_pads_and_stays_exact(monkeypatch):
    monkeypatch.setenv(arena.ENV_ALIGN, "32")
    rng = np.random.default_rng(8)
    init = randn(rng, SHAPES)
    grads = [randn(rng, SHAPES) for _ in range(2)]
    for rule in ("adamw", "lion"):
        host_core = ParameterServerCore(total_workers=1, stripes=2,
                                        optimizer=port_opt.make_optimizer(
                                            rule, LR))
        core = ParameterServerCore(total_workers=1, stripes=2,
                                   optimizer=sharded(rule))
        for c in (host_core, core):
            c.initialize_parameters(init)
        assert same(closes(core, grads, device=True),
                    closes(host_core, grads))
        table = core._params.layout
        assert table.padding_elems > 0
        for s, slab in core._params.slabs.items():
            for n in table.stripe_names[s]:
                e = table.entries[n]
                end = e.offset + e.length
                assert not slab[end:-(-end // 32) * 32].any()
    assert stats.REGISTRY.snapshot()["gauges"]["ps.apply.arena_pad"] > 0


# ------------------------------------------------------- the downgrades
def test_partial_coverage_falls_back_for_that_close():
    rng = np.random.default_rng(9)
    init = randn(rng, SHAPES)
    seq = [randn(rng, SHAPES) for _ in range(3)]
    seq[1].pop("odd")
    before = fallbacks()
    core = ParameterServerCore(total_workers=1, stripes=2,
                               optimizer=sharded())
    core.initialize_parameters(init)
    flat = closes(core, seq, device=True)
    after = fallbacks()
    host_core = ParameterServerCore(total_workers=1, stripes=2,
                                    optimizer=port_opt.make_optimizer(
                                        "adam", LR))
    host_core.initialize_parameters(init)
    assert same(flat, closes(host_core, seq))
    assert after == (before[0] + 2, before[1] + 1)
    assert core._arena.last_fallback == "coverage"


def test_counts_that_differ_fall_back():
    rng = np.random.default_rng(10)
    shapes = {"a": (31,), "b": (17,)}
    init = randn(rng, shapes)
    ga = {"a": rng.standard_normal(31).astype(np.float32)}
    gb = randn(rng, shapes)

    def run(opt):
        core = ParameterServerCore(total_workers=2, stripes=1, optimizer=opt)
        core.initialize_parameters(init)
        core.receive_gradients(0, 1, {k: v.copy() for k, v in ga.items()})
        assert core.receive_gradients(1, 1, {k: v.copy() for k, v in
                                             gb.items()}).aggregation_complete
        return core

    before = fallbacks()
    core = run(sharded("sgd", 0.1))
    assert fallbacks()[1] == before[1] + 1
    assert core._arena.last_fallback == "counts"
    assert same(core.get_parameters(),
                run(port_opt.make_optimizer("sgd", 0.1)).get_parameters())


def test_mixed_momentum_seed_falls_back_then_heals():
    rng = np.random.default_rng(11)
    init = randn(rng, SHAPES)
    vel = {"velocity": {"odd": rng.standard_normal(513).astype(np.float32)}}
    grads = [randn(rng, SHAPES) for _ in range(2)]
    grads[0]["l0/b"][0] = np.float32(-0.0)     # the copy-seed's witness

    def run(opt, device):
        opt.load_state_dict({"velocity": dict(vel["velocity"])})
        core = ParameterServerCore(total_workers=1, stripes=2, optimizer=opt)
        core.initialize_parameters(init)
        return closes(core, grads, device=device), core.optimizer_state()

    before = fallbacks()
    flat, flat_state = run(sharded("momentum", 0.05), True)
    after = fallbacks()
    want, want_state = run(port_opt.make_optimizer("momentum", 0.05), False)
    assert same(flat, want)
    assert same(flat_state["velocity"], want_state["velocity"])
    assert after == (before[0] + 1, before[1] + 1)


def test_broadcast_fold_evicts_the_slab_sum_exactly():
    rng = np.random.default_rng(12)
    shapes = {"w": (4, 31), "b": (17,)}
    init = randn(rng, shapes)
    ga = randn(rng, shapes)
    gb = {"w": rng.standard_normal(31).astype(np.float32),
          "b": rng.standard_normal(17).astype(np.float32)}

    def run(opt, device):
        core = ParameterServerCore(total_workers=2, stripes=1, optimizer=opt)
        core.initialize_parameters(init)
        for wid, g in enumerate((ga, gb)):
            g = {k: v.copy() for k, v in g.items()}
            if device:
                g = {k: torch.from_numpy(v) for k, v in g.items()}
            r = core.receive_gradients(wid, 1, g)
        assert r.aggregation_complete
        return core.get_parameters()

    before = fallbacks()
    flat = run(sharded("sgd", 0.1), True)
    assert fallbacks()[1] == before[1] + 1
    assert same(flat, run(port_opt.make_optimizer("sgd", 0.1), False))


def test_packing_failure_latches_off_and_never_fails(monkeypatch):
    rng = np.random.default_rng(13)
    init = randn(rng, SHAPES)
    grads = [randn(rng, SHAPES) for _ in range(2)]
    core = ParameterServerCore(total_workers=1, stripes=2,
                               optimizer=sharded())
    core.initialize_parameters(init)

    def boom(*args, **kwargs):
        raise RuntimeError("injected packing failure")

    monkeypatch.setattr(core._arena, "ensure_param_slabs", boom)
    before = fallbacks()
    flat = closes(core, grads, device=True)
    assert not core._arena.active
    assert fallbacks()[1] == before[1] + 1
    host_core = ParameterServerCore(total_workers=1, stripes=2,
                                    optimizer=port_opt.make_optimizer(
                                        "adam", LR))
    host_core.initialize_parameters(init)
    assert same(flat, closes(host_core, grads))


def test_gates_leave_no_manager(monkeypatch):
    assert ParameterServerCore(total_workers=1,
                               optimizer=sharded())._arena is not None
    assert ParameterServerCore(total_workers=1,
                               optimizer=port_opt.SGD(LR))._arena is None
    assert ParameterServerCore(total_workers=1, aggregation="buffered",
                               optimizer=sharded())._arena is None
    monkeypatch.setenv(arena.ENV_ARENA, "0")
    assert ParameterServerCore(total_workers=1,
                               optimizer=sharded())._arena is None


def test_failed_flat_apply_leaves_barrier_retryable(monkeypatch):
    rng = np.random.default_rng(14)
    init = randn(rng, SHAPES)
    g = randn(rng, SHAPES)
    core = ParameterServerCore(total_workers=1, stripes=2,
                               optimizer=sharded("sgd"))
    want = ParameterServerCore(total_workers=1, stripes=2,
                               optimizer=port_opt.make_optimizer("sgd", LR))
    for c in (core, want):
        c.initialize_parameters(init)
    real, calls = da.sharded_update, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(da, "sharded_update", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        core.receive_gradients(0, 1, {k: torch.from_numpy(v.copy())
                                      for k, v in g.items()})
    assert same(core.get_parameters(), init)
    assert core.check_sync_status(1)[1]
    want.receive_gradients(0, 1, g)
    assert same(core.get_parameters(), want.get_parameters())


def test_to_host_waits_on_the_readback():
    waited = []

    class Readback:
        def wait(self):
            waited.append(1)

    table = arena.PackingTable({"w": np.zeros(3, np.float32)}, 1, 1)
    slab = np.arange(3, dtype=np.float32)
    store = arena.ArenaStore(table.views(0, slab), table, {0: slab},
                             Readback())
    out = to_host(store)
    assert waited == [1] and np.shares_memory(out["w"], slab)


def test_accumulator_views_and_host_copies():
    """An ArenaAccum's per-tensor device views hold the folded sums, and
    their host copies equal numpy's; a popped name leaves the close's
    coverage."""
    rng = np.random.default_rng(15)
    init = randn(rng, SHAPES)
    table = arena.PackingTable(init, 2, 1)
    accum = arena.ArenaAccum(table, CPU)
    counts = {}
    g1, g2 = randn(rng, SHAPES), randn(rng, SHAPES)
    for g in (g1, g2):
        for s in range(2):
            accum.fold_group(s, [(n, torch.from_numpy(v.copy()))
                                 for n, v in g.items()
                                 if table.entries[n].stripe == s], counts)
    assert accum.full_coverage() and set(counts.values()) == {2}
    want = {n: g1[n] + g2[n] for n in SHAPES}
    assert same(accum.to_tensor_dict(), want)
    assert accum.pop("odd").nbytes == 4 * 513
    assert not accum.full_coverage() and "odd" not in accum


def test_scale_uniform_scales_every_slab_in_one_call(monkeypatch):
    rng = np.random.default_rng(16)
    init = randn(rng, SHAPES)
    table = arena.PackingTable(init, 8, 1)
    accum = arena.ArenaAccum(table, CPU)
    counts = {}
    g = randn(rng, SHAPES)
    for s in range(8):
        items = [(n, torch.from_numpy(v.copy())) for n, v in g.items()
                 if table.entries[n].stripe == s]
        if items:
            accum.fold_group(s, items, counts)
    calls = []
    real = da.scale_mean
    monkeypatch.setattr(da, "scale_mean",
                        lambda rows: (calls.append(len(rows)), real(rows)))
    accum.scale_uniform(3)
    assert calls == [len(accum.slabs)] and len(accum.slabs) > 1
    inv = np.float32(1.0 / 3)
    assert same(accum.to_tensor_dict(), {n: v * inv for n, v in g.items()})


def test_eviction_keeps_the_partial_sum_on_the_device(monkeypatch):
    """A broadcast fold evicts the name's slab sum into the overflow as
    a device copy (a tensor, never a host array), the later device folds
    add there, and the close equals the host numpy close."""
    rng = np.random.default_rng(17)
    shapes = {"w": (4, 31), "b": (17,)}
    init = randn(rng, shapes)
    pushes = [randn(rng, shapes),
              {"w": rng.standard_normal(31).astype(np.float32),
               "b": rng.standard_normal(17).astype(np.float32)},
              randn(rng, shapes)]

    def to_numpy(*args, **kwargs):
        raise AssertionError("a device sum was read back to the host")

    core = ParameterServerCore(total_workers=3, stripes=1,
                               optimizer=sharded("sgd", 0.1))
    want = ParameterServerCore(total_workers=3, stripes=1,
                               optimizer=port_opt.make_optimizer("sgd", 0.1))
    for c in (core, want):
        c.initialize_parameters(init)
    with monkeypatch.context() as patch:
        patch.setattr(torch.Tensor, "numpy", to_numpy)
        for wid, g in enumerate(pushes[:2]):
            core.receive_gradients(wid, 1, {k: torch.from_numpy(v.copy())
                                            for k, v in g.items()})
        accum = core._iteration_states[1].accum
        assert isinstance(accum, arena.ArenaAccum)
        assert set(accum.overflow) == {"w"}
        assert isinstance(accum.overflow["w"], torch.Tensor)
        assert (accum.overflow["w"].untyped_storage().data_ptr()
                != accum.slabs[0].untyped_storage().data_ptr())
    core.receive_gradients(2, 1, {k: torch.from_numpy(v.copy())
                                  for k, v in pushes[2].items()})
    for wid, g in enumerate(pushes):
        want.receive_gradients(wid, 1, g)
    assert same(core.get_parameters(), want.get_parameters())


@pytest.mark.parametrize("first", ["host", "device"])
def test_mixed_stream_converges_on_the_device(first):
    """_fold_one: whichever residence comes first, a device gradient
    leaves the sum on the device, equal to numpy's bytes."""
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        _fold_one

    rng = np.random.default_rng(18)
    a, b, c = (rng.standard_normal((5, 7)).astype(np.float32)
               for _ in range(3))
    dev = (lambda x: torch.from_numpy(x.copy()))
    order = ([a, dev(b), c] if first == "host" else [dev(a), b, dev(c)])
    accum, counts = {}, {}
    for g in order:
        _fold_one(accum, counts, "w", g)
    assert isinstance(accum["w"], torch.Tensor) and counts["w"] == 3
    want = np.array(a)
    np.add(want, b, out=want)
    np.add(want, c, out=want)
    assert accum["w"].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("arena_on", ["0", "1"])
def test_device_close_launches_from_the_closing_thread(monkeypatch,
                                                       arena_on):
    """A device close folds, scales and updates from the thread that
    runs it: no part of it goes through the stripe pool."""
    from parameter_server_distributed_tpu_torch.core import ps_core

    monkeypatch.setenv("PSDT_ARENA", arena_on)
    rng = np.random.default_rng(19)
    init = randn(rng, SHAPES)
    grads = [randn(rng, SHAPES)]
    pooled = []
    real = ps_core.run_striped
    monkeypatch.setattr(ps_core, "run_striped",
                        lambda thunks: (pooled.append(len(thunks)),
                                        real(thunks))[1])
    core = ParameterServerCore(total_workers=2, stripes=8,
                               optimizer=sharded())
    core.initialize_parameters(init)
    got = closes(core, grads, workers=2, device=True)
    assert pooled == []
    host_core = ParameterServerCore(total_workers=2, stripes=8,
                                    optimizer=port_opt.make_optimizer(
                                        "adam", LR))
    host_core.initialize_parameters(init)
    assert same(got, closes(host_core, grads, workers=2))
    assert pooled   # the host close does fan out


# ------------------------------------------------ BASELINE config 1, mixed
BATCH, ITERATIONS = 32, 4


@pytest.fixture
def servers(tmp_path):
    started = []

    def start(port_side: bool):
        cfg = port_config if port_side else ref_config
        kw = dict(bind_address="127.0.0.1", port=0, total_workers=2,
                  checkpoint_interval=1, learning_rate=0.05,
                  checkpoint_dir=str(tmp_path / f"ck{len(started)}"))
        if port_side:
            kw.update(device="cpu", optimizer="sharded_sgd")
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


def ref_worker(coord_port: int, wid: int) -> RefWorker:
    config = ref_config.WorkerConfig(
        coordinator_address=f"127.0.0.1:{coord_port}", worker_id=wid,
        batch_size=BATCH, model="mnist_mlp", wire_dtype="bf16",
        heartbeat_period_s=1.0)
    model, batches = ref_registry.get_model_and_batches("mnist_mlp", BATCH,
                                                        seed=wid)
    return RefWorker(config, RefTrainer(model,
                                        local_devices=jax.devices()[:1]),
                     batches)


def fleet(start, port_side: bool, makers, init, tmp_path):
    """Each worker's losses and the bytes of a checkpoint the PS saves at
    the end."""
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
        assert all(w._ps._shm_ok for w in workers)
    finally:
        for w in workers:
            w.shutdown()
    path = ps.ckpt.save(epoch=9, path=str(tmp_path / f"end-{port_side}"))
    with open(path, "rb") as f:
        return losses, f.read(), ps


def test_mixed_mnist_fleet_on_a_device_close_ps_matches_jax_ps(
        servers, monkeypatch, tmp_path):
    monkeypatch.setenv("PSDT_SHM", "1")
    init = {k: np.asarray(v, np.float32)
            for k, v in ref_mlp.mnist_mlp().init_params(0).items()}
    before = fallbacks()
    device_before = stats.counter("ps.apply.device").value
    ours, ours_ckpt, ps = fleet(servers, True, [port_worker, ref_worker],
                                init, tmp_path)
    after = fallbacks()
    assert type(ps.optimizer) is ShardedDeviceOptimizer
    assert after[1] == before[1] and after[0] >= before[0] + ITERATIONS - 1
    assert stats.counter("ps.apply.device").value >= \
        device_before + ITERATIONS - 1
    theirs, theirs_ckpt, _ = fleet(servers, False, [port_worker, ref_worker],
                                   init, tmp_path)
    assert ours == theirs
    assert ours_ckpt == theirs_ckpt
    # every epoch's checkpoint the device-close PS wrote at its applies
    epochs = sorted(f for f in os.listdir(tmp_path / "ck0")
                    if f.endswith(".ckpt"))
    assert epochs == [f"checkpoint_epoch_{e}.ckpt"
                      for e in range(ITERATIONS)]
    base, _, _ = fleet(servers, False, [ref_worker, ref_worker], init,
                       tmp_path)
    for wid in (0, 1):
        np.testing.assert_allclose(ours[wid], base[wid], rtol=1e-4)
        assert ours[wid][-1] < ours[wid][0]
