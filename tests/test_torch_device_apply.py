"""The port's device close (core/device_apply.py, ops/device_apply.py's
plain versions, async_sgd ``ShardedDeviceOptimizer`` and the core's
device fold, scale and apply, ``PSDT_DEVICE_APPLY``) against the port's
host numpy optimizers and the JAX package's ``ShardedDeviceOptimizer``
on jax's CPU: stores, wire decodes and checkpoints byte for byte.

Shapes are the JAX package's tests' (odd sizes and matrices, so both
decay lanes run); every number is seeded with numpy.  Both packages run
their numpy paths (``native.set_enabled(False)``, restored afterwards),
env knobs are set through ``monkeypatch`` and torch keeps at most two
intra-op threads.  The flat arena's cases are tests/test_torch_arena.py;
the kernels themselves on the card are
tests/test_torch_cuda_device_apply.py."""

import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native as ref_native
from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
    ShardedDeviceOptimizer as RefSharded
from parameter_server_distributed_tpu.checkpoint.manager import \
    CheckpointManager as RefManager
from parameter_server_distributed_tpu.core import device_apply as ref_da
from parameter_server_distributed_tpu.core.ps_core import \
    ParameterServerCore as RefCore
from parameter_server_distributed_tpu.rpc import codec as ref_codec
from parameter_server_distributed_tpu_torch import native
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import DeviceOptimizer, ShardedDeviceOptimizer
from parameter_server_distributed_tpu_torch.checkpoint.manager import \
    CheckpointManager
from parameter_server_distributed_tpu_torch.core import device_apply
from parameter_server_distributed_tpu_torch.core import optimizer as port_opt
from parameter_server_distributed_tpu_torch.core.ps_core import \
    ParameterServerCore
from parameter_server_distributed_tpu_torch.core.tensor import (to_host,
                                                                to_wire)
from parameter_server_distributed_tpu_torch.obs import stats
from parameter_server_distributed_tpu_torch.ops import device_apply as da
from parameter_server_distributed_tpu_torch.rpc import codec
from parameter_server_distributed_tpu_torch.rpc import messages as m
from parameter_server_distributed_tpu_torch.rpc.data_plane import \
    decode_gradients

SHAPES = {"emb/w": (129, 33), "l0/w": (64, 65), "l0/b": (65,),
          "head/w": (33, 17), "odd": (513,)}
LR = 0.02
RULES = ShardedDeviceOptimizer.RULES


@pytest.fixture(autouse=True)
def hygiene():
    """Both packages on their numpy paths; two torch threads."""
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
    return {k: np.asarray(v, np.float32)
            for k, v in to_host({k: (np.asarray(v) if not isinstance(
                v, torch.Tensor) else v) for k, v in store.items()}).items()}


def same(a, b) -> bool:
    a, b = host(a), host(b)
    return sorted(a) == sorted(b) and all(a[k].tobytes() == b[k].tobytes()
                                          for k in a)


def data(seed: int, iterations: int = 3):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [[{k: rng.standard_normal(s).astype(np.float32)
               for k, s in SHAPES.items()} for _ in range(2)]
             for _ in range(iterations)]
    return init, grads


def push(core, wid: int, it: int, grads: dict, device=None):
    """One push in two chunks; onto ``device`` through the wire decode
    (raw f32 payloads) when given."""
    names = list(grads)
    sink = core.begin_push(wid, it)
    for part in (names[:2], names[2:]):
        chunk = {k: grads[k].copy() for k in part}
        if device is not None:
            chunk = decode_gradients(to_wire(chunk, m.WIRE_RAW_F32), device)
        sink.fold(chunk)
    return sink.commit()


def three_cores(monkeypatch, rule: str, stripes: int, arena: str):
    """(port host numpy core, port device core on the CPU, JAX device
    core), all under PSDT_DEVICE_APPLY=1 and ``arena``."""
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", arena)
    port_host = ParameterServerCore(
        total_workers=2, stripes=stripes,
        optimizer=port_opt.make_optimizer(rule, LR))
    port_dev = ParameterServerCore(
        total_workers=2, stripes=stripes,
        optimizer=port_opt.make_optimizer(f"sharded_{rule}", LR,
                                          device="cpu"))
    jax_dev = RefCore(total_workers=2, stripes=stripes,
                      optimizer=RefSharded(rule, LR))
    return port_host, port_dev, jax_dev


def run_three(monkeypatch, rule, stripes, arena, seed=0):
    """Three closes on each of the three cores, the stores compared
    after every one; returns the port device core."""
    init, grads = data(seed)
    cores = three_cores(monkeypatch, rule, stripes, arena)
    port_host, port_dev, jax_dev = cores
    assert port_dev.device_fold() == torch.device("cpu")
    for core in cores:
        core.initialize_parameters(init)
    for it, pair in enumerate(grads, start=1):
        for wid, g in enumerate(pair):
            push(port_host, wid, it, g)
            push(port_dev, wid, it, g, device=torch.device("cpu"))
            jax_dev.receive_gradients(wid, it, {k: v.copy()
                                                for k, v in g.items()})
        want = host(port_host.get_parameters())
        # the store's order is its checkpoints' layout
        assert list(port_dev.get_parameters()) == list(want)
        assert same(port_dev.get_parameters(), want), (rule, stripes, it)
        assert same(jax_dev.get_parameters(), want), (rule, stripes, it)
    return port_dev


# ------------------------------------------------------------- the oracle
@pytest.mark.parametrize("rule", RULES)
def test_sharded_optimizer_equals_host_and_jax(rule):
    """Raw applies over four steps, one with a name passed through."""
    rng = np.random.default_rng(1)
    opts = [port_opt.make_optimizer(rule, LR),
            ShardedDeviceOptimizer(rule, LR, device="cpu"),
            RefSharded(rule, LR)]
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    stores = [dict(params) for _ in opts]
    for step in range(4):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in SHAPES.items()}
        if step == 2:
            grads.pop("odd")
        stores = [opt.apply(s, grads) for opt, s in zip(opts, stores)]
        assert same(stores[1], stores[0]) and same(stores[2], stores[0])
    states = [opt.state_dict() for opt in opts]
    assert sorted(states[1]) == sorted(states[0]) == sorted(states[2])
    for kind, slots in states[0].items():
        if kind == "step":
            assert states[1][kind] == states[2][kind] == slots
        else:
            assert same(states[1][kind], slots)
            assert same(states[2][kind], slots)


@pytest.mark.parametrize("stripes", [1, 2, 8])
@pytest.mark.parametrize("rule", RULES)
def test_core_device_close_equals_host_and_jax(monkeypatch, rule, stripes):
    """Per-tensor device closes (PSDT_ARENA=0), folds decoded onto the
    device, against the port's host close and the JAX device close."""
    dev = run_three(monkeypatch, rule, stripes, "0")
    assert all(isinstance(v, torch.Tensor)
               for v in dev.get_parameters().values())


# ---------------------------------------------------------------- the wire
@pytest.mark.parametrize("wire", ["raw", "bf16", "int8", "topk"])
def test_device_unpack_equals_both_codecs(wire):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4097).astype(np.float32)
    x[::97] = -0.0
    dtype = codec.WIRE_DTYPE_NAMES[wire]
    k = codec.topk_k(x.size, 0.05) if wire == "topk" else 0
    buf = bytearray(codec.payload_nbytes(dtype, x.size, k))
    codec.PythonCodec().pack_into(dtype, x, buf, k)
    raw = bytes(buf)
    want = codec.PythonCodec().unpack(dtype, raw, x.size)
    assert ref_codec.PythonCodec().unpack(dtype, raw,
                                          x.size).tobytes() == want.tobytes()
    got = device_apply.device_unpack(dtype, raw, x.size, "cpu")
    assert got.numpy().tobytes() == want.tobytes()
    ref = np.asarray(ref_da.device_unpack(dtype, raw, x.size))
    assert ref.tobytes() == want.tobytes()
    # through a wire message, shape kept
    t = m.Tensor.from_array("w", x.reshape(17, 241), wire_dtype=dtype,
                            topk_density=0.05)
    dec = decode_gradients([t], torch.device("cpu"))["w"]
    assert tuple(dec.shape) == (17, 241)
    assert dec.numpy().tobytes() == t.to_array().tobytes()


def test_topk_payload_out_of_order_is_refused():
    idx = np.array([5, 3], "<u4").tobytes()
    raw = np.uint32(2).tobytes() + idx + np.zeros(2, "<u2").tobytes()
    with pytest.raises(ValueError, match="ascending"):
        device_apply.device_unpack(m.WIRE_TOPK, raw, 10, "cpu")


@pytest.mark.parametrize("acc_shape,g_shape", [
    ((3, 4), (4,)), ((3, 4), (2, 4)), ((4,), (3, 4)), ((3, 4), (3, 4))])
def test_fold_add_shape_rule_matches_reference(acc_shape, g_shape):
    """numpy's ``np.add(acc, g, out=acc)`` rule, as the JAX package's
    fold_add checks it: g may broadcast up to acc, nothing else."""
    rng = np.random.default_rng(3)
    acc = rng.standard_normal(acc_shape).astype(np.float32)
    g = rng.standard_normal(g_shape).astype(np.float32)
    try:
        want = np.asarray(ref_da.fold_add(jnp.asarray(acc), g))
    except ValueError:
        want = None
    port_acc = torch.from_numpy(acc.copy())
    if want is None:
        with pytest.raises(ValueError, match="fold shape mismatch"):
            device_apply.fold_add(port_acc, g)
        assert port_acc.numpy().tobytes() == acc.tobytes()
        return
    got = device_apply.fold_add(port_acc, torch.from_numpy(g))
    assert got is port_acc
    assert got.numpy().tobytes() == want.tobytes()
    np.add(acc, g, out=acc)
    assert got.numpy().tobytes() == acc.tobytes()


def test_owned_copy_never_adopts_and_keeps_negative_zero():
    g = torch.tensor([-0.0, 1.5, float("inf")])
    c = device_apply.owned_copy(g, "cpu")
    assert c.data_ptr() != g.data_ptr()
    assert c.numpy().tobytes() == g.numpy().tobytes()
    assert device_apply.owned_f32(g, "cpu") is g


# -------------------------------------------------------------- checkpoints
def ckpt_files(path: str):
    with open(path, "rb") as f:
        ckpt = f.read()
    with open(path + ".meta.json", "rb") as f:
        meta = f.read()
    with zipfile.ZipFile(path + ".opt.npz") as z:
        members = {n: z.read(n) for n in z.namelist()}
    return ckpt, meta, members


@pytest.mark.parametrize("save,restore", [((1, "0"), (4, "1")),
                                          ((2, "1"), (1, "0")),
                                          ((8, "1"), (2, "1"))])
def test_checkpoint_round_trips_with_jax_files(monkeypatch, tmp_path, save,
                                               restore):
    """A sharded Adam core's checkpoint (stripes, arena flag) is
    byte-identical to a JAX host-numpy Adam core's; it loads into the
    port's host Adam and into a sharded core at other stripes and arena
    flag, and both continue as the JAX core continues."""
    init, grads = data(4, iterations=3)
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", save[1])
    from parameter_server_distributed_tpu.core.optimizer import Adam

    jax_core = RefCore(total_workers=2, stripes=save[0], optimizer=Adam(LR))
    port = ParameterServerCore(total_workers=2, stripes=save[0],
                               optimizer=ShardedDeviceOptimizer(
                                   "adam", LR, device="cpu"))
    for core in (jax_core, port):
        core.initialize_parameters(init)
        for it in (1, 2):
            for wid, g in enumerate(grads[it - 1]):
                core.receive_gradients(wid, it, {k: v.copy()
                                                 for k, v in g.items()})
        core.epoch = 5
    ref_path = RefManager(jax_core, str(tmp_path / "jax")).save()
    path = CheckpointManager(port, str(tmp_path / "port")).save()
    assert ckpt_files(path) == ckpt_files(ref_path)

    ref_next = RefCore(total_workers=2, stripes=save[0], optimizer=Adam(LR))
    RefManager(ref_next, str(tmp_path / "rr")).load(ref_path)
    for wid, g in enumerate(grads[2]):
        ref_next.receive_gradients(wid, 3, {k: v.copy() for k, v in g.items()})
    monkeypatch.setenv("PSDT_ARENA", restore[1])
    for opt in (port_opt.make_optimizer("adam", LR),
                ShardedDeviceOptimizer("adam", LR, device="cpu")):
        core = ParameterServerCore(total_workers=2, stripes=restore[0],
                                   optimizer=opt)
        assert CheckpointManager(core, str(tmp_path / "r")).load(path) \
            == (5, 2)
        for wid, g in enumerate(grads[2]):
            core.receive_gradients(wid, 3, {k: v.copy()
                                            for k, v in g.items()})
        assert same(core.get_parameters(), ref_next.get_parameters())


# ------------------------------------------------------ selection / gates
@pytest.mark.parametrize("name,env,kind,rule", [
    ("sharded_sgd", "0", ShardedDeviceOptimizer, "sgd"),
    ("sharded_lion", "0", ShardedDeviceOptimizer, "lion"),
    ("device_adam", "1", ShardedDeviceOptimizer, "adam"),
    ("device_momentum", "1", ShardedDeviceOptimizer, "momentum"),
    ("device_lion", "1", ShardedDeviceOptimizer, "lion"),
    ("device_adamw_bf16", "1", DeviceOptimizer, "adamw_bf16"),
    ("device_adam", "0", DeviceOptimizer, "adam")])
def test_make_optimizer_resolves_the_sharded_family(monkeypatch, name, env,
                                                    kind, rule):
    monkeypatch.setenv("PSDT_DEVICE_APPLY", env)
    opt = port_opt.make_optimizer(name, LR, device="cpu")
    assert type(opt) is kind and opt.rule == rule
    assert opt.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["sharded_adamw_bf16", "sharded_",
                                  "sharded_adagrad"])
def test_make_optimizer_unknown_sharded_rule_raises(name):
    with pytest.raises(ValueError, match="unknown optimizer"):
        port_opt.make_optimizer(name, LR, device="cpu")


def test_sharded_without_a_card_degrades_counted(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counter = stats.counter("ps.apply.device_fallback")
    before = counter.value
    opt = port_opt.make_optimizer("sharded_lion", LR)
    assert type(opt) is port_opt.Lion and counter.value == before + 1


def test_device_fold_gate(monkeypatch):
    def core(opt, **kw):
        return ParameterServerCore(total_workers=1, optimizer=opt, **kw)

    sharded = ShardedDeviceOptimizer("sgd", LR, device="cpu")
    monkeypatch.delenv("PSDT_DEVICE_APPLY", raising=False)
    assert core(sharded).device_fold() is None
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    assert core(sharded).device_fold() == torch.device("cpu")
    assert core(port_opt.SGD(LR)).device_fold() is None
    assert core(sharded, aggregation="buffered").device_fold() is None
    assert core(sharded, staleness_bound=2).device_fold() is None
    assert decode_gradients([], None) == {}


def test_left_out_options_raise_naming_their_item(monkeypatch):
    opt = ShardedDeviceOptimizer("adam", LR, device="cpu")
    for call in (opt.apply_arena_range, opt.commit_arena_ranges):
        with pytest.raises(NotImplementedError, match="item 13"):
            call()
    monkeypatch.setenv("PSDT_DEVICE_STAGE_CHUNK", "4096")
    with pytest.raises(NotImplementedError, match="item 13"):
        ShardedDeviceOptimizer("adam", LR, device="cpu")


def test_failed_device_apply_leaves_barrier_retryable(monkeypatch):
    """The update raising at the close puts the (scaled) sums back; the
    next poll retries and lands the host close's store.  Params and
    gradients were never written."""
    monkeypatch.setenv("PSDT_DEVICE_APPLY", "1")
    monkeypatch.setenv("PSDT_ARENA", "0")
    init, grads = data(5, iterations=1)
    kept = {k: v.copy() for k, v in init.items()}
    ref = ParameterServerCore(total_workers=2, stripes=2,
                              optimizer=port_opt.make_optimizer("sgd", LR))
    core = ParameterServerCore(total_workers=2, stripes=2,
                               optimizer=ShardedDeviceOptimizer(
                                   "sgd", LR, device="cpu"))
    for c in (ref, core):
        c.initialize_parameters(init)
    real = da.sharded_update
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(da, "sharded_update", flaky)
    for wid, g in enumerate(grads[0]):
        ref.receive_gradients(wid, 1, g)
    push(core, 0, 1, grads[0][0], device=torch.device("cpu"))
    with pytest.raises(RuntimeError, match="injected"):
        push(core, 1, 1, grads[0][1], device=torch.device("cpu"))
    assert same(core.get_parameters(), kept)
    assert core.check_sync_status(1)[1]
    assert same(core.get_parameters(), ref.get_parameters())
    assert same(init, kept)
