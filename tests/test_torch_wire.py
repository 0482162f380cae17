"""The port's wire layer (rpc/codec.py, wire.py, messages.py,
data_plane.py and core/tensor.py ``to_wire``) against the JAX package's:
every message type of the wire round, built alike in both packages, must
encode to the same bytes, and each package must decode the other's bytes
back to the same message (re-encoding to the same bytes).  Tensors ride
in every wire encoding (repeated float, raw f32, bf16, int8, top-k),
with bf16 rounding ties, infinities and NaNs, and top-k ties.  The JAX
package's C++ codec is switched off (its Python codec is the byte
oracle); the port's is whichever it resolves, its C++ codec where the
library builds (tests/test_torch_codec.py holds each of the port's codecs
to each of the JAX package's)."""

import os

import numpy as np
import pytest
import torch

from parameter_server_distributed_tpu import native
from parameter_server_distributed_tpu.core import tensor as ref_tensor
from parameter_server_distributed_tpu.rpc import codec as ref_codec
from parameter_server_distributed_tpu.rpc import data_plane as ref_plane
from parameter_server_distributed_tpu.rpc import messages as ref_m
from parameter_server_distributed_tpu_torch.core import tensor as port_tensor
from parameter_server_distributed_tpu_torch.rpc import codec as port_codec
from parameter_server_distributed_tpu_torch.rpc import data_plane as port_plane
from parameter_server_distributed_tpu_torch.rpc import messages as port_m

WIRE = {"f32": 0, "raw": 1, "bf16": 2, "int8": 3, "topk": 4}


@pytest.fixture(autouse=True)
def reference_python_codec():
    """The JAX package's Python codec, restored to its process default
    afterwards."""
    native.set_enabled(False)
    try:
        yield
    finally:
        native.set_enabled(os.environ.get("PSDT_NATIVE", "1").lower()
                           not in ("0", "false"))


def arrays():
    """name -> float32 array: shapes scalar, empty, 1-D, 2-D; bf16 ties
    (1 + 2^-8 and its odd neighbour), infinities, NaNs of both signs,
    and repeated magnitudes for top-k's threshold ties."""
    rng = np.random.default_rng(7)
    special = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8),
                        np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                        3.4e38, 1e-40], np.float32)
    return {
        "scalar": np.float32(2.5).reshape(()),
        "empty": np.zeros((0,), np.float32),
        "vec": rng.standard_normal(300).astype(np.float32),
        "mat": rng.standard_normal((17, 9)).astype(np.float32),
        "ties": np.array([0.5, -0.5, 0.5, 0.25, -0.5, 0.5] * 20,
                         np.float32),
        "special": special,
    }


def finite(name: str, wire: str) -> bool:
    """int8 and top-k of non-finite values are not a wire contract."""
    return name != "special" or wire in ("f32", "raw", "bf16")


def tensors(m, wire: str):
    return [m.Tensor.from_array(n, a, wire_dtype=WIRE[wire],
                                topk_density=0.05)
            for n, a in arrays().items() if finite(n, wire)]


def build(m, kind: str, wire: str = "f32"):
    """One message of each type the wire round sends, from the package
    ``m``."""
    if kind == "GradientUpdate":
        return m.GradientUpdate(worker_id=3, iteration=41,
                                gradients=tensors(m, wire),
                                pull_wire_dtype=WIRE["bf16"],
                                trace_context=b"trace/span")
    if kind == "ParameterUpdate":
        return m.ParameterUpdate(iteration=7, parameters=tensors(m, wire),
                                 ready=True)
    if kind == "PushPullResponse.params":
        return m.PushPullResponse(params=build(m, "ParameterUpdate", wire))
    if kind == "PushPullResponse.push":
        return m.PushPullResponse(push=build(m, "PushResponse"))
    if kind == "PushResponse":
        return m.PushResponse(success=True, message="aggregation complete",
                              iteration=5, aggregation_complete=True,
                              workers_received=2, total_workers=2)
    if kind == "PullRequest":
        return m.PullRequest(worker_id=1, iteration=9,
                             wire_dtype=WIRE[wire])
    if kind == "SyncStatusRequest":
        return m.SyncStatusRequest(iteration=12)
    if kind == "SyncStatusResponse":
        return m.SyncStatusResponse(iteration=12, ready=True,
                                    workers_received=1, total_workers=2)
    if kind == "SaveCheckpointRequest":
        return m.SaveCheckpointRequest(epoch=4, path="/ck/a.ckpt")
    if kind == "SaveCheckpointResponse":
        return m.SaveCheckpointResponse(success=True, message="saved",
                                        checkpoint_path="/ck/a.ckpt")
    if kind == "LoadCheckpointRequest":
        return m.LoadCheckpointRequest(path="/ck/a.ckpt")
    if kind == "LoadCheckpointResponse":
        return m.LoadCheckpointResponse(success=True, message="loaded",
                                        epoch=4, parameters=tensors(m, wire))
    if kind == "WorkerInfo":
        return m.WorkerInfo(worker_id=2, address="10.0.0.2", port=50060,
                            hostname="host-2")
    if kind == "RegisterResponse":
        return m.RegisterResponse(success=True, message="registered",
                                  parameter_server_address="127.0.0.1:50051",
                                  total_workers=2)
    if kind == "HeartbeatRequest":
        return m.HeartbeatRequest(worker_id=2, status=1,
                                  obs_snapshot=b'{"counters": {}}')
    if kind == "HeartbeatResponse":
        return m.HeartbeatResponse(success=True, timestamp=1792230000000)
    if kind == "ListWorkersRequest":
        return m.ListWorkersRequest()
    if kind == "ListWorkersResponse":
        return m.ListWorkersResponse(
            workers=[build(m, "WorkerInfo"),
                     m.WorkerInfo(worker_id=-1, address="", port=0)],
            total_workers=2)
    if kind == "GetPSAddressRequest":
        return m.GetPSAddressRequest()
    if kind == "GetPSAddressResponse":
        return m.GetPSAddressResponse(address="127.0.0.1", port=50051,
                                      shards=["a:1", "b:2"])
    raise KeyError(kind)


TENSOR_KINDS = ["GradientUpdate", "ParameterUpdate",
                "PushPullResponse.params", "LoadCheckpointResponse"]
PLAIN_KINDS = ["PushPullResponse.push", "PushResponse", "PullRequest",
               "SyncStatusRequest", "SyncStatusResponse",
               "SaveCheckpointRequest", "SaveCheckpointResponse",
               "LoadCheckpointRequest", "WorkerInfo", "RegisterResponse",
               "HeartbeatRequest", "HeartbeatResponse", "ListWorkersRequest",
               "ListWorkersResponse", "GetPSAddressRequest",
               "GetPSAddressResponse"]
CASES = ([(k, w) for k in TENSOR_KINDS for w in WIRE]
         + [(k, "f32") for k in PLAIN_KINDS])


def message_tensors(msg):
    for attr in ("gradients", "parameters"):
        if hasattr(msg, attr):
            return getattr(msg, attr)
    if getattr(msg, "params", None) is not None:
        return msg.params.parameters
    return []


def assert_same_values(a, b):
    ta, tb = message_tensors(a), message_tensors(b)
    assert [t.name for t in ta] == [t.name for t in tb]
    for x, y in zip(ta, tb):
        np.testing.assert_array_equal(x.to_array(), y.to_array(),
                                      err_msg=x.name)


@pytest.mark.parametrize("kind,wire", CASES)
def test_messages_byte_identical_both_ways(kind, wire):
    ref, port = build(ref_m, kind, wire), build(port_m, kind, wire)
    ref_bytes, port_bytes = ref.encode(), port.encode()
    assert port_bytes == ref_bytes
    cls = kind.split(".")[0]
    # each package decodes the other's bytes to the message it sent
    from_ref = getattr(port_m, cls).decode(ref_bytes)
    from_port = getattr(ref_m, cls).decode(port_bytes)
    assert from_ref.encode() == ref_bytes
    assert from_port.encode() == port_bytes
    assert_same_values(from_ref, ref)
    assert_same_values(from_port, port)


@pytest.mark.parametrize("wire", ["raw", "bf16", "int8", "topk"])
def test_codec_payloads_match(wire):
    """The packed payloads and their decodes, array by array."""
    dtype = WIRE[wire]
    for name, a in arrays().items():
        if not finite(name, wire):
            continue
        flat = np.ascontiguousarray(a, np.float32).reshape(-1)
        k = ref_codec.topk_k(flat.size, 0.05) if wire == "topk" else 0
        n = ref_codec.payload_nbytes(dtype, flat.size, k)
        assert port_codec.payload_nbytes(dtype, flat.size, k) == n
        ref_buf, port_buf = bytearray(n), bytearray(n)
        ref_codec.PythonCodec().pack_into(dtype, flat, memoryview(ref_buf),
                                          k)
        port_codec.PythonCodec().pack_into(dtype, flat,
                                           memoryview(port_buf), k)
        assert bytes(port_buf) == bytes(ref_buf), name
        np.testing.assert_array_equal(
            port_codec.PythonCodec().unpack(dtype, bytes(ref_buf), flat.size),
            ref_codec.PythonCodec().unpack(dtype, bytes(ref_buf), flat.size),
            err_msg=name)


def test_bf16_rounding_on_every_exponent():
    """The port's bit-level bf16 cast against ml_dtypes' on random bit
    patterns, NaNs and infinities included."""
    bits = np.random.default_rng(3).integers(0, 1 << 32, 200_000,
                                             dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = x.astype(ref_codec.bf16_dtype()).view(np.uint16)
    np.testing.assert_array_equal(port_codec.bf16_bits(x), want)


def test_to_wire_matches_reference_bytes():
    """A store of host tensors and numpy arrays (float64 too) encodes to
    the bytes the JAX package's to_wire gives for its numpy values."""
    rng = np.random.default_rng(1)
    host = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float64),
            "c": rng.standard_normal((3, 2)).astype(np.float32)}
    store = {"a": host["a"], "b": host["b"], "c": torch.from_numpy(host["c"])}
    for wire in WIRE.values():
        got = [t.encode() for t in port_tensor.to_wire(store, wire)]
        want = [t.encode() for t in ref_tensor.to_wire(host, wire)]
        assert got == want
    back = port_tensor.from_wire(port_m.ParameterUpdate.decode(
        port_m.ParameterUpdate(parameters=port_tensor.to_wire(store))
        .encode()).parameters)
    for name, value in host.items():
        # the float64 tensor rides as float32 and comes back upcast
        np.testing.assert_array_equal(
            back[name], value.astype(np.float32).astype(value.dtype))


def test_data_plane_chunking_and_pre_encoded_serve():
    """split_tensors groups alike, and a pre-encoded serve chunk is the
    byte image of the ParameterUpdate it stands for."""
    ref_t, port_t = tensors(ref_m, "bf16"), tensors(port_m, "bf16")
    for budget in (1, 600, 1 << 20):
        want = [[t.name for t in g]
                for g in ref_plane.split_tensors(ref_t, budget)]
        got = [[t.name for t in g]
               for g in port_plane.split_tensors(port_t, budget)]
        assert got == want
    groups = list(port_plane.split_tensors(port_t, 600))
    bodies = port_plane.encode_parameter_record_groups(groups, stripes=4)
    assert bodies == [ref_plane.encode_parameter_records(g) for g in
                      ref_plane.split_tensors(ref_t, 600)]
    pre = port_plane.PreEncodedParameterUpdate(9, True, bodies)
    assert pre.encode() == ref_m.ParameterUpdate(iteration=9,
                                                 parameters=ref_t,
                                                 ready=True).encode()
    assert pre.encode() == ref_plane.PreEncodedParameterUpdate(
        9, True, bodies).encode()


@pytest.mark.parametrize("env,want", [
    ({}, (32 << 20, 32 << 20)),
    ({"PSDT_STREAM_CHUNK_BYTES": "4096"}, (4096, 4096)),
    ({"PSDT_STREAM_CHUNK_BYTES": "4096", "PSDT_BUCKET_BYTES": "0"},
     (4096, 0)),
])
def test_chunk_and_bucket_budgets(monkeypatch, env, want):
    for name in ("PSDT_STREAM_CHUNK_BYTES", "PSDT_BUCKET_BYTES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = (port_plane.stream_chunk_bytes(), port_plane.bucket_bytes())
    assert got == want == (ref_plane.stream_chunk_bytes(),
                           ref_plane.bucket_bytes())
