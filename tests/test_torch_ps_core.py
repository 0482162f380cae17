"""The port's ``ParameterServerCore`` (core/ps_core.py) and its host
optimizers (core/optimizer.py) against the JAX package's on the same
numpy inputs.

Each scenario of tests/test_ps_core.py runs through both packages' cores
(in streaming and buffered aggregation, with 1 and 4 stripes) and
records every PushResult field, every sync status and the params it
reads; the two records must be equal.  Both packages' native C++
libraries are switched off through their public switches, so both sides
run numpy: the fold, the mean, SGD and momentum must match bit for bit
(rtol 0); Adam, AdamW and Lion within rtol 1e-6, atol 0.  The
PallasOptimizer cases of tests/test_pallas_ops.py:125-152 run the
port's kernels' plain versions (``device="cpu"``) in the port's core
against the reference core with the host optimizer, at rtol 1e-4, atol
1e-6, the reference's tolerance there."""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.core import optimizer as ref_opt
from parameter_server_distributed_tpu.core import ps_core as ref_core
from parameter_server_distributed_tpu_torch import native as port_native
from parameter_server_distributed_tpu_torch.async_sgd import device_optimizer
from parameter_server_distributed_tpu_torch.core import optimizer as port_opt
from parameter_server_distributed_tpu_torch.core import ps_core
from parameter_server_distributed_tpu_torch.obs import stats

REF = types.SimpleNamespace(Core=ref_core.ParameterServerCore,
                            opt=ref_opt)
PORT = types.SimpleNamespace(Core=ps_core.ParameterServerCore, opt=port_opt)
MODES = [dict(aggregation=a, stripes=s)
         for a in ("streaming", "buffered") for s in (1, 4)]


@pytest.fixture
def reference_numpy():
    """Both packages' numpy paths: their native kernels sum and step in
    another order than numpy (each package's native path is held to the
    other's in tests/test_torch_native.py)."""
    native.set_enabled(False)
    port_native.set_enabled(False)
    try:
        yield
    finally:
        default = os.environ.get("PSDT_NATIVE", "1").lower() not in (
            "0", "false")
        native.set_enabled(default)
        port_native.set_enabled(default)


def store(**kw):
    return {k: np.asarray(v, np.float32) for k, v in kw.items()}


def push(log, ps, worker, it, grads):
    r = ps.receive_gradients(worker, it, grads)
    log.append(("push", r.success, r.message, r.iteration,
                r.aggregation_complete, r.workers_received, r.total_workers))


def params(log, ps):
    for name, value in sorted(ps.get_parameters().items()):
        log.append(("params", name, np.asarray(value)))


# ----------------------------------------------------------- the scenarios
def barrier_width(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=3, **kw)
    ps.initialize_parameters(store(w=[10.0, 10.0]))
    for w, g in enumerate(([1.0, 2.0], [3.0, 4.0], [5.0, 6.0])):
        push(log, ps, w, 1, store(w=g))
    params(log, ps)
    return log


def mean_over_contributors(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=2, **kw)
    ps.initialize_parameters(store(w=[0.0], b=np.ones((2, 2))))
    push(log, ps, 0, 1, store(w=[2.0], b=np.full((2, 2), 2.0)))
    push(log, ps, 1, 1, store(w=[4.0], b=np.full((2, 2), 4.0)))
    params(log, ps)
    return log


def no_double_count(pkg, kw):
    """A duplicate pre-barrier push counts once: streaming keeps the first
    payload, buffered the last."""
    log = []
    ps = pkg.Core(total_workers=2, **kw)
    ps.initialize_parameters(store(w=[0.0]))
    push(log, ps, 0, 1, store(w=[2.0]))
    push(log, ps, 0, 1, store(w=[100.0]))
    push(log, ps, 1, 1, store(w=[4.0]))
    params(log, ps)
    return log


def late_push(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=2, **kw)
    ps.initialize_parameters(store(w=[0.0]))
    push(log, ps, 0, 1, store(w=[2.0]))
    push(log, ps, 1, 1, store(w=[4.0]))
    push(log, ps, 2, 1, store(w=[999.0]))
    params(log, ps)
    return log


def bootstrap(pkg, kw):
    """An empty core adopts the first mean as its params."""
    log = []
    ps = pkg.Core(total_workers=2, **kw)
    push(log, ps, 0, 0, store(w=[2.0, 4.0]))
    push(log, ps, 1, 0, store(w=[4.0, 8.0]))
    params(log, ps)
    push(log, ps, 0, 1, store(w=[1.0, 1.0]))
    push(log, ps, 1, 1, store(w=[3.0, 1.0]))
    params(log, ps)
    return log


def serve_and_status(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=2, **kw)
    log.append(("status", ps.check_sync_status(9)))
    ps.initialize_parameters(store(w=[1.0]))
    push(log, ps, 0, 9, store(w=[1.0]))
    log.append(("status", ps.check_sync_status(9)))
    push(log, ps, 1, 9, store(w=[1.0]))
    log.append(("status", ps.check_sync_status(9)))
    push(log, ps, 0, 3, store(w=[1.0]))   # current_iteration stays 9
    it, served, ready = ps.serve_parameters(iteration=12345)
    log.append(("serve", it, ready, ps.current_iteration))
    log += [("params", n, np.asarray(v)) for n, v in served.items()]
    return log


def gc_and_straggler(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=1, gc_iterations=4, **kw)
    ps.initialize_parameters(store(w=[0.0]))
    for it in range(20):
        push(log, ps, 0, it, store(w=[0.5]))
    log.append(("tracked", ps.tracked_iterations))
    push(log, ps, 1, 2, store(w=[1000.0]))   # iteration 2 was GC'd
    log.append(("status", ps.check_sync_status(2)))
    params(log, ps)
    return log


def elastic_width(pkg, kw):
    log = []
    live = {"n": 3}
    ps = pkg.Core(total_workers=5, live_workers_fn=lambda: live["n"], **kw)
    ps.initialize_parameters(store(w=[0.0]))
    for w in range(3):
        push(log, ps, w, 1, store(w=[3.0]))
    live["n"] = 1
    push(log, ps, 0, 2, store(w=[1.0]))
    live["n"] = 3
    push(log, ps, 0, 3, store(w=[2.0]))
    push(log, ps, 1, 3, store(w=[4.0]))
    log.append(("status", ps.check_sync_status(3)))
    live["n"] = 2   # worker 2 evicted: the next poll closes iteration 3
    log.append(("status", ps.check_sync_status(3)))
    params(log, ps)
    return log


def wait_for_aggregation(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=1, gc_iterations=2, **kw)
    ps.initialize_parameters(store(w=[1.0]))
    for it in range(1, 6):
        push(log, ps, 0, it, store(w=[0.25]))
    log.append(("wait", ps.wait_for_aggregation(1, timeout=0.0)))
    log.append(("wait", ps.wait_for_aggregation(5, timeout=0.0)))
    width = {"n": 3}
    ps = pkg.Core(total_workers=3, live_workers_fn=lambda: width["n"], **kw)
    ps.initialize_parameters(store(w=[10.0]))
    push(log, ps, 0, 1, store(w=[2.0]))
    log.append(("wait", ps.wait_for_aggregation(1, timeout=0.05)))
    out = {}
    waiter = threading.Thread(target=lambda: out.setdefault(
        "r", ps.wait_for_aggregation(1, timeout=10.0)))
    waiter.start()
    time.sleep(0.05)
    push(log, ps, 1, 1, store(w=[4.0]))
    width["n"] = 2   # the wait's heartbeat sees the shrink and closes
    waiter.join(timeout=5.0)
    assert not waiter.is_alive()
    log.append(("wait", out["r"]))
    params(log, ps)
    return log


def async_mode(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=4, staleness_bound=2,
                  optimizer=pkg.opt.SGD(0.5), **kw)
    ps.initialize_parameters(store(w=[10.0]))
    push(log, ps, 0, 0, store(w=[2.0]))
    log.append(("async", ps.current_iteration, ps.applied_updates))
    log.append(("status", ps.check_sync_status(0)))
    log.append(("wait", ps.wait_for_aggregation(7, timeout=0.0)))
    for i in range(1, 5):
        push(log, ps, 0, i, store(w=[0.25]))
    push(log, ps, 1, 1, store(w=[100.0]))   # 3 behind bound 2: stale
    push(log, ps, 1, ps.current_iteration, store(w=[1.0]))
    params(log, ps)
    # two workers race identical init pushes at an empty core
    ps = pkg.Core(total_workers=2, staleness_bound=2, **kw)
    push(log, ps, 0, 0, store(w=[3.0, -1.0]))
    push(log, ps, 1, 0, store(w=[3.0, -1.0]))
    push(log, ps, 0, 1, store(w=[1.0, 1.0]))
    params(log, ps)
    return log


def snapshot_restore(pkg, kw):
    log = []
    ps = pkg.Core(total_workers=1, optimizer=pkg.opt.Adam(0.1), **kw)
    ps.initialize_parameters(store(w=[1.0, 2.0], b=[0.5]))
    push(log, ps, 0, 4, store(w=[0.5, 0.5], b=[0.25]))
    ps.epoch = 2
    epoch, it, snap = ps.snapshot()
    state = ps.optimizer_state()
    log.append(("snapshot", epoch, it, state["step"]))
    ps2 = pkg.Core(total_workers=1, optimizer=pkg.opt.Adam(0.1), **kw)
    ps2.restore(epoch, it, snap, optimizer_state=state)
    log.append(("restored", ps2.epoch, ps2.current_iteration))
    for core in (ps, ps2):
        push(log, core, 0, 5, store(w=[0.5, -0.5], b=[1.0]))
        params(log, core)
    return log


def optimizers(pkg, kw):
    """Three two-worker rounds of each host optimizer over random
    stores, a 0-d tensor among them."""
    log = []
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 10), "b": (4,), "ln": (), "emb": (3, 5)}
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}
    grads = [[{n: rng.standard_normal(s).astype(np.float32)
               for n, s in shapes.items()} for _ in range(2)]
             for _ in range(3)]
    for make in (lambda o: o.SGD(0.1), lambda o: o.Momentum(0.1, 0.5),
                 lambda o: o.Adam(0.01), lambda o: o.AdamW(0.01, 0.1),
                 lambda o: o.Lion(0.01, weight_decay=0.1)):
        ps = pkg.Core(total_workers=2, optimizer=make(pkg.opt), **kw)
        ps.initialize_parameters(init)
        for it, pair in enumerate(grads, start=1):
            for w, g in enumerate(pair):
                push(log, ps, w, it, g)
        params(log, ps)
        state = ps.optimizer_state()
        log.append(("state", sorted(state)))
    return log


SCENARIOS = [barrier_width, mean_over_contributors, no_double_count,
             late_push, bootstrap, serve_and_status, gc_and_straggler,
             elastic_width, wait_for_aggregation, async_mode,
             snapshot_restore]


def assert_same(got, ref, rtol=0.0):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[0] == r[0] and len(g) == len(r), (g, r)
        if g[0] == "params":
            assert g[1] == r[1] and g[2].dtype == np.float32
            assert g[2].shape == r[2].shape, g[1]
            if rtol:
                np.testing.assert_allclose(g[2], r[2], rtol=rtol, atol=0,
                                           err_msg=g[1])
            else:
                np.testing.assert_array_equal(g[2], r[2], err_msg=g[1])
        else:
            assert g == r


@pytest.mark.parametrize("mode", MODES,
                         ids=lambda m: f"{m['aggregation']}-s{m['stripes']}")
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(reference_numpy, scenario, mode):
    assert_same(scenario(PORT, mode), scenario(REF, mode))


@pytest.mark.parametrize("mode", MODES,
                         ids=lambda m: f"{m['aggregation']}-s{m['stripes']}")
def test_host_optimizers_in_core_match_reference(reference_numpy, mode):
    """SGD and momentum bit for bit; the Adam family and Lion (whose
    divisions and square roots numpy may vectorise differently across
    array sizes) at rtol 1e-6."""
    got, ref = optimizers(PORT, mode), optimizers(REF, mode)
    per_opt = len(got) // 5
    assert_same(got[:2 * per_opt], ref[:2 * per_opt])
    assert_same(got[2 * per_opt:], ref[2 * per_opt:], rtol=1e-6)


@pytest.mark.parametrize("rule", ["sgd", "momentum", "adam"])
def test_pallas_optimizer_matches_host_in_ps_core(reference_numpy, rule):
    """tests/test_pallas_ops.py:125-152 against the port: its
    PallasOptimizer (the kernels' plain versions on the CPU) in its core,
    async at staleness 2, against the reference core with the host
    optimizer."""
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((6, 10)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    grad_seq = [{"w": rng.standard_normal((6, 10)).astype(np.float32),
                 "b": rng.standard_normal(4).astype(np.float32)}
                for _ in range(3)]
    stores = {}
    for name, core, opt in (
            ("port", ps_core.ParameterServerCore,
             device_optimizer.PallasOptimizer(rule, 0.1, device="cpu")),
            ("host", ref_core.ParameterServerCore,
             ref_opt.make_optimizer(rule, 0.1))):
        ps = core(total_workers=1, optimizer=opt, staleness_bound=2)
        ps.initialize_parameters(init)
        for it, g in enumerate(grad_seq, start=1):
            assert ps.receive_gradients(0, it, g).success
        stores[name] = ps.get_parameters()
    assert all(isinstance(v, torch.Tensor) for v in stores["port"].values())
    for key in init:
        np.testing.assert_allclose(stores["port"][key].numpy(),
                                   np.asarray(stores["host"][key]),
                                   rtol=1e-4, atol=1e-6)


class _FakeEvent:
    """Stands in for the CUDA event of an apply in flight."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


class _LazyArray(np.ndarray):
    """The reference test's in-flight jax array (is_ready flips on
    block_until_ready)."""

    def __new__(cls, values):
        obj = np.asarray(values, np.float32).view(cls)
        obj._ready = False
        return obj

    def is_ready(self):
        return self._ready

    def block_until_ready(self):
        self._ready = True
        return self


class _LazySGD(ref_opt.SGD):
    def apply(self, params, grads):
        return {k: _LazyArray(v) for k, v in super().apply(params,
                                                           grads).items()}


def test_async_serve_and_depth_bound_match_reference(reference_numpy,
                                                     monkeypatch):
    """While an async apply is in flight the previous store is served, and
    the next apply waits for it first (tests/test_ps_core.py:363-399): in
    the port the apply's CUDA event says so (faked here), in the
    reference the jax array's is_ready."""
    events = []

    def fake_event(store):
        events.append(_FakeEvent())
        return events[-1]

    monkeypatch.setattr(ps_core, "_apply_event", fake_event)
    served = {}
    for name, core, opt in (
            ("port", ps_core.ParameterServerCore, port_opt.SGD(0.5)),
            ("ref", ref_core.ParameterServerCore, _LazySGD(0.5))):
        ps = core(total_workers=1, staleness_bound=10, optimizer=opt)
        ps.initialize_parameters(store(w=[10.0]))
        seen = []
        ps.receive_gradients(0, 0, store(w=[2.0]))       # -> 9, in flight
        seen.append(float(ps.serve_parameters()[1]["w"][0]))
        ps.receive_gradients(0, 1, store(w=[2.0]))       # waits, -> 8
        seen.append(float(ps.serve_parameters()[1]["w"][0]))
        if name == "port":
            events[-1].synchronize()
        else:
            for v in ps._params.values():
                v.block_until_ready()
        seen.append(float(ps.serve_parameters()[1]["w"][0]))
        served[name] = seen
    assert served["port"] == served["ref"] == [10.0, 9.0, 8.0]
    assert events[0].done   # the second apply waited on the first


def test_sync_serves_device_optimizer_tensors_as_they_are():
    """The store a device optimizer returns is served as it is (a worker
    on the same card packs it there), and counted in ps.apply.device."""
    before = stats.counter("ps.apply.device").value
    ps = ps_core.ParameterServerCore(
        total_workers=2,
        optimizer=device_optimizer.PallasOptimizer("adam", 1e-3,
                                                   device="cpu"))
    ps.initialize_parameters(store(w=np.ones((2, 3)), b=[0.0, 1.0]))
    _, served, _ = ps.serve_parameters()
    assert all(isinstance(v, np.ndarray) for v in served.values())
    for w in (0, 1):
        ps.receive_gradients(w, 1, store(w=np.full((2, 3), w + 1.0),
                                         b=[1.0, 2.0]))
    _, served, _ = ps.serve_parameters()
    assert all(isinstance(v, torch.Tensor) for v in served.values())
    assert stats.counter("ps.apply.device").value == before + 1


def test_ingress_copies_pushed_buffers():
    """A core never keeps a pushed buffer: a worker that reuses it for its
    next step must not change an open iteration's sums."""
    for mode in ("streaming", "buffered"):
        ps = ps_core.ParameterServerCore(total_workers=2, aggregation=mode,
                                         stripes=1)
        ps.initialize_parameters(store(w=[0.0, 0.0]))
        g = store(w=[2.0, 4.0])
        ps.receive_gradients(0, 1, g)
        g["w"][:] = 1000.0
        ps.receive_gradients(1, 1, store(w=[4.0, 8.0]))
        np.testing.assert_array_equal(ps.get_parameters()["w"],
                                      [-3.0, -6.0])


@pytest.mark.parametrize("kwargs,env,match", [
    (dict(contributions_fn=lambda: {}), {}, "item 10"),
    (dict(quorum=0.5), {}, "item 11"),
    ({}, {"PSDT_QUORUM": "0.75"}, "item 11"),
    (dict(freerun=True), {}, "item 11"),
    ({}, {"PSDT_FREERUN": "1"}, "item 11"),
    ({}, {"PSDT_ARENA": "1"}, "item 5"),
    ({}, {"PSDT_DEVICE_APPLY": "1"}, "item 5"),
])
def test_unported_options_raise(monkeypatch, kwargs, env, match):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(NotImplementedError, match=match):
        ps_core.ParameterServerCore(total_workers=2, **kwargs)


def test_plain_barrier_options_do_not_raise(monkeypatch):
    """quorum 1.0 is all-of-N and freerun=False overrides the env: both
    are the plain barrier."""
    monkeypatch.setenv("PSDT_FREERUN", "1")
    ps = ps_core.ParameterServerCore(total_workers=1, quorum=1.0,
                                     freerun=False)
    ps.initialize_parameters(store(w=[1.0]))
    assert ps.receive_gradients(0, 1, store(w=[1.0])).aggregation_complete


def test_tier_aggregate_ids_raise():
    ps = ps_core.ParameterServerCore(total_workers=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        ps.receive_gradients(ps_core.TIER_AGGREGATE_ID_BASE, 1,
                             store(w=[1.0]))
    with pytest.raises(NotImplementedError, match="item 10"):
        ps.begin_push(ps_core.TIER_AGGREGATE_ID_BASE + 3, 1)


@pytest.mark.parametrize("mode", ["streaming", "buffered"])
def test_chunked_push_matches_whole_push(mode):
    """begin_push / fold per chunk / commit lands the same params as one
    whole-store push."""
    grads = [store(w=[1.0, 2.0], b=[3.0]), store(w=[5.0, 6.0], b=[7.0])]
    results = []
    for chunked in (False, True):
        ps = ps_core.ParameterServerCore(total_workers=2, aggregation=mode,
                                         stripes=2)
        ps.initialize_parameters(store(w=[0.0, 0.0], b=[0.0]))
        for w, g in enumerate(grads):
            if chunked:
                sink = ps.begin_push(w, 1)
                sink.fold({"w": g["w"]})
                sink.fold({"b": g["b"]})
                r = sink.commit()
            else:
                r = ps.receive_gradients(w, 1, g)
        assert r.aggregation_complete
        results.append(ps.get_parameters())
    for name in ("w", "b"):
        np.testing.assert_array_equal(results[0][name], results[1][name])


# ------------------------------------------------- DeviceOptimizer (optax)
def _device_stores(seed=3):
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 12), "b": (12,), "ln": (5,), "frozen": (3, 4)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items() if n != "frozen"}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("rule,kw", [
    ("sgd", dict(learning_rate=0.1)),
    ("momentum", dict(learning_rate=0.1, momentum=0.8)),
    ("adam", dict(learning_rate=0.01)),
    ("adamw", dict(learning_rate=0.01, weight_decay=0.1))])
def test_device_optimizer_matches_reference(rule, kw):
    """The port's DeviceOptimizer (optax's formulas in torch) against the
    reference's optax chains, three applies at rtol 1e-5; "frozen" has no
    gradient (a zero one on both sides)."""
    from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
        DeviceOptimizer as RefDevice

    params, grads = _device_stores()
    ref = getattr(RefDevice, rule)(**kw)
    port = getattr(device_optimizer.DeviceOptimizer, rule)(**kw,
                                                           device="cpu")
    p_ref, p = dict(params), dict(params)
    for g in grads:
        p_ref, p = ref.apply(p_ref, g), port.apply(p, g)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(p_ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adamw_bf16_first_step_matches_reference():
    """The first apply's params do not depend on the rounding (it only
    narrows the stored moments), so they match the reference's."""
    from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
        DeviceOptimizer as RefDevice

    params, grads = _device_stores(4)
    got = device_optimizer.DeviceOptimizer.adamw_bf16(
        0.01, 0.1, device="cpu").apply(params, grads[0])
    ref = RefDevice.adamw_bf16(0.01, 0.1).apply(params, grads[0])
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def _bf16_neighbours(x: torch.Tensor):
    """The bf16 values just below and above |x| in magnitude (equal when
    x is exactly a bf16)."""
    bits = x.view(torch.int32)
    low = (bits & ~0xFFFF).view(torch.float32)
    high = ((bits & ~0xFFFF) + (1 << 16)).view(torch.float32)
    return low, torch.where(low == x, low, high)


def test_stochastic_rounding_lands_on_a_neighbour_and_is_unbiased():
    """The reference draws its rounding bits from jax.random, whose stream
    torch cannot reproduce, so adamw_bf16's rounding is held by its
    properties: each value rounds to one of its two bf16 neighbours, and
    the mean over many draws is the value (within 6 standard errors)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(64)
                         .astype(np.float32) * 1e-3)
    x[0] = 1.0                                   # exactly a bf16
    draws = 4096
    rounded = device_optimizer.stochastic_round_bf16(
        x.repeat(draws), gen).float().view(draws, -1)
    low, high = _bf16_neighbours(x)
    assert bool(((rounded == low) | (rounded == high)).all())
    assert bool((rounded[:, 0] == 1.0).all())
    ulp = (high - low).abs()
    p = ((x - low) / (high - low)).nan_to_num(0.0).clamp(0, 1)
    se = ulp * torch.sqrt(p * (1 - p) / draws)
    err = (rounded.mean(0) - x).abs()
    assert bool((err <= 6 * se + 1e-12).all()), float((err / ulp).max())
    # round-to-nearest would sit a fixed distance off for most values
    assert float((x.bfloat16().float() - x).abs().mean()) > 10 * float(
        err.mean())


def test_adamw_bf16_state_round_trips():
    """count, both bf16 moments and the generator state move through
    state_dict (numpy, as the checkpoint sidecar stores it): the next two
    applies of the original and the restored optimizer are equal bit for
    bit."""
    params, grads = _device_stores(5)
    opt = device_optimizer.DeviceOptimizer.adamw_bf16(0.01, device="cpu")
    p = opt.apply(params, grads[0])
    state = opt.state_dict()
    assert state["count"] == 1 and sorted(state) == ["count", "mu", "nu",
                                                    "rng"]
    assert all(v.dtype == np.float32 for v in state["mu"].values())
    clone = device_optimizer.DeviceOptimizer.adamw_bf16(0.01, device="cpu")
    clone.load_state_dict(state)
    assert all(s.dtype == torch.bfloat16
               for s in clone._slots["mu"].values())
    a, b = dict(p), dict(p)
    for g in grads[1:]:
        a, b = opt.apply(a, g), clone.apply(b, g)
    for k in params:
        assert torch.equal(a[k], b[k]), k


def test_device_optimizer_refuses_reference_state():
    opt = device_optimizer.DeviceOptimizer.adam(device="cpu")
    with pytest.raises(ValueError, match="pickled optax"):
        opt.load_state_dict({"pickle": np.zeros(4, np.uint8)})
    opt.load_state_dict({})
    assert opt.state_dict() == {}


# ------------------------------------------------------------ make_optimizer
@pytest.mark.parametrize("name,cls", [
    ("sgd", "SGD"), ("momentum", "Momentum"), ("adam", "Adam"),
    ("adamw", "AdamW"), ("lion", "Lion")])
def test_make_optimizer_host_names_match_reference(name, cls):
    got = port_opt.make_optimizer(name, 0.5, momentum=0.7,
                                  weight_decay=0.2)
    ref = ref_opt.make_optimizer(name, 0.5, momentum=0.7, weight_decay=0.2)
    assert type(got).__name__ == type(ref).__name__ == cls
    assert vars(got).keys() == vars(ref).keys()
    for key, value in vars(ref).items():
        if not isinstance(value, dict):
            assert getattr(got, key) == value, key


@pytest.mark.parametrize("name,cls,rule", [
    ("pallas_sgd", "PallasOptimizer", "sgd"),
    ("pallas_momentum", "PallasOptimizer", "momentum"),
    ("pallas_adam", "PallasOptimizer", "adam"),
    ("device_sgd", "DeviceOptimizer", "sgd"),
    ("device_momentum", "DeviceOptimizer", "momentum"),
    ("device_adam", "DeviceOptimizer", "adam"),
    ("device_adamw", "DeviceOptimizer", "adamw"),
    ("DEVICE_ADAMW_BF16", "DeviceOptimizer", "adamw_bf16")])
def test_make_optimizer_accelerator_names(name, cls, rule):
    opt = port_opt.make_optimizer(name, 1e-3, device="cpu")
    assert type(opt).__name__ == cls and opt.rule == rule
    assert opt.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["adagrad", "pallas_adamw", "device_lion",
                                  "pallas_", "sgd_"])
def test_make_optimizer_unknown_rule_raises(name):
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.make_optimizer(name, 1e-3, device="cpu")


def test_make_optimizer_sharded_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 5"):
        port_opt.make_optimizer("sharded_adam", 1e-3)


@pytest.mark.parametrize("name,host", [
    ("pallas_sgd", "SGD"), ("pallas_momentum", "Momentum"),
    ("pallas_adam", "Adam"), ("device_adamw", "AdamW"),
    ("device_adamw_bf16", "AdamW")])
def test_make_optimizer_degrades_without_a_card(monkeypatch, name, host):
    """No card: the matching host optimizer, counted and logged."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fallback = stats.counter("ps.apply.device_fallback")
    before = fallback.value
    opt = port_opt.make_optimizer(name, 1e-3, momentum=0.8,
                                  weight_decay=0.3)
    assert type(opt).__name__ == host and opt.learning_rate == 1e-3
    assert fallback.value == before + 1
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.make_optimizer("pallas_lion", 1e-3)
    assert fallback.value == before + 1


def test_apply_time_kernel_failure_raises(monkeypatch):
    """A kernel that fails at apply time is not a degrade: the push
    raises, the barrier stays retryable and nothing is counted."""
    from parameter_server_distributed_tpu_torch.ops import fused_update

    fallback = stats.counter("ps.apply.device_fallback")
    before = fallback.value
    ps = ps_core.ParameterServerCore(
        total_workers=1, stripes=1,
        optimizer=port_opt.make_optimizer("pallas_sgd", 1.0, device="cpu"))
    ps.initialize_parameters(store(w=[1.0, 2.0]))

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    with monkeypatch.context() as m:
        m.setattr(fused_update, "fused_sgd", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            ps.receive_gradients(0, 1, store(w=[0.5, 0.5]))
    _, ready, received, _ = ps.check_sync_status(1)   # the retry closes
    assert ready and received == 1
    np.testing.assert_array_equal(ps.get_parameters()["w"].numpy(),
                                  [0.5, 1.5])
    assert fallback.value == before
