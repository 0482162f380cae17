"""The port's checkpoints (checkpoint/codec.py, checkpoint/manager.py)
against the JAX package's: the same files, byte for byte, both ways.

A checkpoint written by one package (params plus host-Adam or
Pallas-Adam state) is loaded by the other and by its own writer's
package, and both write it back: the ``.ckpt`` and ``.meta.json`` bytes
and every array of the ``.opt.npz`` sidecar must be equal, and the
``.ckpt`` equal to the original.  The next apply after the load must
match the writer's: host Adam at rtol 1e-6, atol 0 (both numpy), Pallas
Adam at rtol 1e-4, atol 1e-6 (the kernels' tolerance in a core,
tests/test_pallas_ops.py:152).  Card tensors reach numpy code only
through ``core.tensor.to_host``: a CPU tensor that refuses numpy
conversion, as a CUDA tensor does, stands in for them."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.async_sgd.device_optimizer import \
    PallasOptimizer as RefPallas
from parameter_server_distributed_tpu.checkpoint import codec as ref_codec
from parameter_server_distributed_tpu.checkpoint import manager as ref_manager
from parameter_server_distributed_tpu.core import optimizer as ref_opt
from parameter_server_distributed_tpu.core import ps_core as ref_core
from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
    import PallasOptimizer
from parameter_server_distributed_tpu_torch.checkpoint import codec, manager
from parameter_server_distributed_tpu_torch.core import optimizer as port_opt
from parameter_server_distributed_tpu_torch.core import ps_core
from parameter_server_distributed_tpu_torch.core.tensor import to_host

SHAPES = {"w": (6, 10), "b": (4,), "emb": (3, 5)}
PACKAGES = {
    "ref": dict(core=ref_core.ParameterServerCore,
                manager=ref_manager.CheckpointManager,
                host_adam=lambda: ref_opt.Adam(0.01),
                pallas_adam=lambda: RefPallas("adam", 0.01)),
    "port": dict(core=ps_core.ParameterServerCore,
                 manager=manager.CheckpointManager,
                 host_adam=lambda: port_opt.Adam(0.01),
                 pallas_adam=lambda: PallasOptimizer("adam", 0.01,
                                                     device="cpu")),
}
TOL = {"host_adam": dict(rtol=1e-6, atol=0),
       "pallas_adam": dict(rtol=1e-4, atol=1e-6)}


@pytest.fixture(autouse=True)
def reference_numpy():
    native.set_enabled(False)
    try:
        yield
    finally:
        native.set_enabled(os.environ.get("PSDT_NATIVE", "1").lower()
                           not in ("0", "false"))


def data(seed=0):
    rng = np.random.default_rng(seed)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in SHAPES.items()}
    grads = [[{n: rng.standard_normal(s).astype(np.float32)
               for n, s in SHAPES.items()} for _ in range(2)]
             for _ in range(3)]
    return init, grads


def run_round(ps, it, pair):
    for w, g in enumerate(pair):
        result = ps.receive_gradients(w, it, g)
    assert result.aggregation_complete


def host(store):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in store.items()}


def files(path):
    """(.ckpt bytes, .meta.json bytes, {npz member: .npy bytes})."""
    with open(path, "rb") as f:
        ckpt = f.read()
    with open(path + ".meta.json", "rb") as f:
        meta = f.read()
    with zipfile.ZipFile(path + ".opt.npz") as z:
        members = {name: z.read(name) for name in z.namelist()}
    return ckpt, meta, members


def test_codec_bytes_match_reference():
    init, _ = data(3)
    init["scalar"] = np.float32(2.5).reshape(())
    blob = codec.dumps(4, 17, init)
    assert blob == ref_codec.dumps(4, 17, init)
    for loads in (codec.loads, ref_codec.loads):
        epoch, it, got = loads(blob)
        assert (epoch, it) == (4, 17) and list(got) == list(init)
        for k in init:
            np.testing.assert_array_equal(got[k], init[k])
    # tensors (a device optimizer's store) write the same bytes
    assert codec.dumps(4, 17, {k: torch.from_numpy(np.array(v))
                               for k, v in init.items()}) == blob


@pytest.mark.parametrize("opt", ["host_adam", "pallas_adam"])
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_checkpoint_round_trip(tmp_path, writer, reader, opt):
    init, grads = data()
    w = PACKAGES[writer]
    ps = w["core"](total_workers=2, optimizer=w[opt]())
    ps.initialize_parameters(init)
    for it in (1, 2):
        run_round(ps, it, grads[it - 1])
    ps.epoch = 3
    path = w["manager"](ps, str(tmp_path / "w")).save()
    written = files(path)
    meta = json.loads(written[1])
    assert meta == {"params_version": 3}

    # the reader and the writer's own package load it and write it back
    loaded = {}
    for name in (reader, writer):
        pkg = PACKAGES[name]
        core = pkg["core"](total_workers=2, optimizer=pkg[opt]())
        mgr = pkg["manager"](core, str(tmp_path / f"r-{name}"))
        assert mgr.load(path) == (3, 2)
        assert mgr.latest() is None
        again = files(mgr.save())
        assert again[0] == written[0]
        loaded[name] = (core, again)
    assert loaded[reader][1] == loaded[writer][1]
    assert sorted(loaded[reader][1][2]) == sorted(written[2])

    # the next apply matches the writer's own
    run_round(ps, 3, grads[2])
    for core, _ in loaded.values():
        run_round(core, 3, grads[2])
    expect = host(ps.get_parameters())
    for core, _ in loaded.values():
        got = host(core.get_parameters())
        for k in SHAPES:
            np.testing.assert_allclose(got[k], expect[k], **TOL[opt],
                                       err_msg=k)


def test_retention_and_autosave(tmp_path):
    """maybe_autosave writes once per epoch advance (checkpoint_interval
    iterations), keep=2 retention drops the oldest with its sidecars, the
    daemon thread starts and stops."""
    init, grads = data(1)
    ps = ps_core.ParameterServerCore(total_workers=2,
                                     optimizer=port_opt.Adam(0.01))
    mgr = manager.CheckpointManager(ps, str(tmp_path), checkpoint_interval=1,
                                    check_period_s=0.01, keep=2)
    assert mgr.maybe_autosave() is None          # no params yet
    ps.initialize_parameters(init)
    saved = []
    for it in (1, 2, 3):
        run_round(ps, it, grads[it - 1])
        saved.append(mgr.maybe_autosave())
        assert mgr.maybe_autosave() is None      # same epoch
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"checkpoint_epoch_{e}.ckpt{s}" for e in (2, 3)
                           for s in ("", ".meta.json", ".opt.npz"))
    assert mgr.latest() == saved[-1]
    mgr.start()
    mgr.stop()
    with pytest.raises(ValueError, match="empty"):
        empty = str(tmp_path / "empty.ckpt")
        codec.save(empty, 0, 0, {})
        mgr.load(empty)


class _CardTensor(torch.Tensor):
    """A CPU tensor that refuses numpy conversion, as a tensor on the card
    does; ``.numpy()`` after a copy (what to_host does) still works."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


class _CardPallas(PallasOptimizer):
    """PallasOptimizer whose params and slots look like card tensors."""

    def apply(self, params, grads):
        out = super().apply(params, grads)
        self._slots = {k: v.as_subclass(_CardTensor)
                       for k, v in self._slots.items()}
        return {k: v.as_subclass(_CardTensor) for k, v in out.items()}


def test_card_tensors_reach_numpy_only_through_to_host(tmp_path):
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(torch.zeros(2).as_subclass(_CardTensor))
    init, grads = data(2)
    written = {}
    for name, make in (("card", _CardPallas), ("plain", PallasOptimizer)):
        ps = ps_core.ParameterServerCore(
            total_workers=2, optimizer=make("adam", 0.01, device="cpu"))
        ps.initialize_parameters(init)
        for it in (1, 2):
            run_round(ps, it, grads[it - 1])
        _, _, snap = ps.snapshot()
        assert all(type(v) is np.ndarray for v in snap.values())
        assert all(type(v) is np.ndarray
                   for v in ps.optimizer_state().values())
        written[name] = files(manager.CheckpointManager(
            ps, str(tmp_path / name)).save())
        served = ps.serve_parameters()[1]
        assert all(isinstance(v, torch.Tensor) for v in served.values())
        assert to_host(served).keys() == served.keys()
    assert written["card"] == written["plain"]
