"""Wire-compatible message schemas for the two control-plane services:
the port's copy of parameter_server_distributed_tpu/rpc/messages.py.

Field numbers, types and service/method names are the reference IDL's, so
the port's services and clients speak to the JAX package's (and to the
reference's C++ peers) at the wire level:

- ParameterServer service (5 RPCs): reference proto/parameter_server.proto:5-11
- Coordinator service (4 RPCs):     reference proto/coordinator.proto:5-10

plus the JAX package's streaming data-plane extension (three more method
names on the ParameterServer service).  ``Tensor.data`` is a numpy
float32 array end to end.  Not ported: the cluster-metrics extension of
the coordinator (ROADMAP.md Queue 1, item 14).
"""

from __future__ import annotations

import numpy as np

from .codec import (PACKED_WIRE_DTYPES, TOPK_DEFAULT_DENSITY, WIRE_BF16,
                    WIRE_DTYPE_NAMES, WIRE_F32, WIRE_INT8, WIRE_RAW_F32,
                    WIRE_TOPK, active_codec, topk_k)
from .wire import ArrayPayload, Field, Message

__all__ = ["PACKED_WIRE_DTYPES", "TOPK_DEFAULT_DENSITY", "WIRE_BF16",
           "WIRE_DTYPE_NAMES", "WIRE_F32", "WIRE_INT8", "WIRE_RAW_F32",
           "WIRE_TOPK"]

# --------------------------------------------------------------------------
# parameter_server package
# --------------------------------------------------------------------------

DTYPE_FLOAT32 = 0
DTYPE_FLOAT64 = 1  # declared by the reference IDL, never used by its runtime

# WIRE_F32 is the reference encoding (packed `repeated float`, field 3).
# The packed encodings (see codec.py for layouts) are a framework extension
# carried in fields 5/6, which reference peers skip per proto3
# unknown-field rules; they are only emitted when a peer asks for them.
# WIRE_DTYPE_NAMES re-exported above — one definition, in codec.py.


class Tensor(Message):
    """Named dense tensor (reference proto/parameter_server.proto:19-24).

    Fields 1-4 mirror the reference IDL.  Fields 5/6 are the packed-payload
    extension: when `packed_dtype` != WIRE_F32 the flat data rides in the
    `packed` bytes blob (bf16 halves push/pull bytes) and field 3 is empty.
    """
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "shape", "int32", repeated=True),
        Field(3, "data", "float", repeated=True),
        Field(4, "dtype", "int32"),
        Field(5, "packed", "bytes"),
        Field(6, "packed_dtype", "int32"),
    )

    @classmethod
    def from_array(cls, name: str, array: np.ndarray,
                   wire_dtype: int = WIRE_F32,
                   topk_density: float = TOPK_DEFAULT_DENSITY) -> "Tensor":
        # float64 inputs are marked dtype=1 (the reference IDL's declared
        # float64 — proto/parameter_server.proto:23) but still ride the
        # wire as `repeated float`, exactly as a reference peer would emit
        # them (its tensor struct stores vector<float> regardless of dtype).
        src = np.asarray(array)
        dtype_tag = (DTYPE_FLOAT64 if src.dtype == np.float64
                     else DTYPE_FLOAT32)
        arr = src.astype(np.float32, copy=False)  # zero-copy for f32 input
        if wire_dtype not in PACKED_WIRE_DTYPES:
            return cls(name=name, shape=list(arr.shape),
                       data=arr.reshape(-1), dtype=dtype_tag)
        flat = arr.reshape(-1)
        k = 0
        if wire_dtype == WIRE_TOPK:
            if flat.size >= 2**32:
                # u4 wire indices would silently wrap on decode; no real
                # tensor is 4B+ elements (16 GB+ f32), so refuse loudly
                # rather than degrade to a quiet corruption.
                raise ValueError(
                    f"WIRE_TOPK indices are u32: tensor {name!r} has "
                    f"{flat.size} elements (>= 2**32); use bf16 wire")
            k = topk_k(flat.size, topk_density)
        # lazy payload for EVERY packed encoding: the cast / int8 quantize /
        # top-k sparsify runs through the codec straight into the
        # outgoing message buffer at encode time
        # (wire.ArrayPayload.pack_into)
        return cls(name=name, shape=list(arr.shape), dtype=dtype_tag,
                   packed=ArrayPayload(flat, wire_dtype, k),
                   packed_dtype=wire_dtype)

    def to_array(self) -> np.ndarray:
        packed = self.packed
        if isinstance(packed, ArrayPayload):
            # locally-built tensor read back without a wire round-trip:
            # materialize the exact bytes the wire would carry so the value
            # matches what a remote peer would decode (bf16 quantization
            # included)
            packed = packed.tobytes()
        if self.packed_dtype in PACKED_WIRE_DTYPES and packed:
            # np.prod([]) == 1: an empty shape list is a 0-d SCALAR (one
            # element), not an empty tensor — empty tensors carry [0]
            # (the dense total only matters to WIRE_TOPK's scatter)
            arr = active_codec().unpack(self.packed_dtype, packed,
                                        int(np.prod(self.shape)))
        else:
            arr = np.asarray(self.data, dtype=np.float32)
        if self.dtype == DTYPE_FLOAT64:
            # honor the reference IDL's declared float64 tag: upcast so a
            # dtype=1 tensor round-trips at the precision the sender marked
            # (wire payload itself is float-precision, as in the reference)
            arr = arr.astype(np.float64)
        if not arr.flags.writeable:
            # decode paths can yield frombuffer views (zero-copy); callers
            # get writable arrays so in-place aggregation works uniformly
            arr = arr.copy()
        if self.shape:
            arr = arr.reshape(self.shape)
        return arr


# Observability extension of the JAX package (its obs/trace.py): request
# messages may carry the caller's span context in field 999 —
# b"trace_id/span_id".  The port decodes and ignores it and never sets
# it; unset, the field elides and the bytes are the reference's.
TRACE_FIELD_NUMBER = 999


class GradientUpdate(Message):
    """Fields 1-3 mirror the reference IDL.  Field 4 is a framework
    extension read only by the fused ``PushPullStream`` data plane
    (rpc/data_plane.py): the wire encoding (WIRE_*) the pushing worker
    wants the post-barrier parameters streamed back in — the fused round
    has no separate PullRequest to carry it.  Reference peers skip it per
    proto3 unknown-field rules; the unary/stream push paths never set it."""
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "iteration", "int32"),
        Field(3, "gradients", "message", message_type=Tensor, repeated=True),
        Field(4, "pull_wire_dtype", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class PushResponse(Message):
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "message", "string"),
        Field(3, "iteration", "int32"),
        Field(4, "aggregation_complete", "bool"),
        Field(5, "workers_received", "int32"),
        Field(6, "total_workers", "int32"),
    )


class PullRequest(Message):
    """Field 3 is a framework extension: the wire encoding the client wants
    served parameters in (WIRE_*).  Reference servers skip it and serve
    repeated-float; reference clients never set it and get the default."""
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "iteration", "int32"),
        Field(3, "wire_dtype", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class ParameterUpdate(Message):
    FIELDS = (
        Field(1, "iteration", "int32"),
        Field(2, "parameters", "message", message_type=Tensor, repeated=True),
        Field(3, "ready", "bool"),
    )


class PushPullResponse(Message):
    """One frame of the fused ``PushPullStream`` response (framework
    extension, rpc/data_plane.py).  Exactly one of the two sub-messages is
    set per frame: the FIRST frame carries ``push`` (the push verdict, sent
    the instant the gradients are applied so a stale rejection never waits
    on the barrier); every later frame carries ``params`` (a chunk of the
    post-barrier parameter stream, same schema as the unary pull)."""
    FIELDS = (
        Field(1, "push", "message", message_type=PushResponse),
        Field(2, "params", "message", message_type=ParameterUpdate),
    )


class SyncStatusRequest(Message):
    FIELDS = (
        Field(1, "iteration", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class SyncStatusResponse(Message):
    FIELDS = (
        Field(1, "iteration", "int32"),
        Field(2, "ready", "bool"),
        Field(3, "workers_received", "int32"),
        Field(4, "total_workers", "int32"),
    )


class SaveCheckpointRequest(Message):
    FIELDS = (
        Field(1, "epoch", "int32"),
        Field(2, "path", "string"),
    )


class SaveCheckpointResponse(Message):
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "message", "string"),
        Field(3, "checkpoint_path", "string"),
    )


class LoadCheckpointRequest(Message):
    FIELDS = (Field(1, "path", "string"),)


class LoadCheckpointResponse(Message):
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "message", "string"),
        Field(3, "epoch", "int32"),
        Field(4, "parameters", "message", message_type=Tensor, repeated=True),
    )


# --------------------------------------------------------------------------
# coordinator package
# --------------------------------------------------------------------------

class WorkerStatus:
    """Enum (reference proto/coordinator.proto:31-36)."""
    IDLE = 0
    TRAINING = 1
    CHECKPOINTING = 2
    ERROR = 3

    _NAMES = {0: "IDLE", 1: "TRAINING", 2: "CHECKPOINTING", 3: "ERROR"}

    @classmethod
    def name(cls, value: int) -> str:
        return cls._NAMES.get(value, f"UNKNOWN({value})")


class WorkerInfo(Message):
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "address", "string"),
        Field(3, "port", "int32"),
        Field(4, "hostname", "string"),
    )


class RegisterResponse(Message):
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "message", "string"),
        Field(3, "parameter_server_address", "string"),
        Field(4, "total_workers", "int32"),
    )


class HeartbeatRequest(Message):
    """Field 999 is the JAX package's extension: a JSON metric snapshot
    of the worker's registry for its cluster metrics.  The port's
    coordinator ignores it and the port's worker leaves it empty (cluster
    metrics are ROADMAP.md Queue 1, item 14)."""
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "status", "enum"),
        Field(999, "obs_snapshot", "bytes"),
    )


class HeartbeatResponse(Message):
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "timestamp", "int64"),
    )


class ListWorkersRequest(Message):
    FIELDS = ()


class ListWorkersResponse(Message):
    FIELDS = (
        Field(1, "workers", "message", message_type=WorkerInfo, repeated=True),
        Field(2, "total_workers", "int32"),
    )


class GetPSAddressRequest(Message):
    FIELDS = ()


class GetPSAddressResponse(Message):
    """Field 3 is a framework extension: the FULL list of parameter-server
    shard addresses ("host:port", shard index = list index) when the store
    is partitioned across several PS processes.  Reference peers skip it
    per proto3 unknown-field rules and use fields 1/2 (shard 0)."""
    FIELDS = (
        Field(1, "address", "string"),
        Field(2, "port", "int32"),
        Field(3, "shards", "string", repeated=True),
    )


# --------------------------------------------------------------------------
# gRPC method tables (service and method names must match the reference IDL
# for wire-level interop: /parameter_server.ParameterServer/<M>,
# /coordinator.Coordinator/<M>)
# --------------------------------------------------------------------------

PARAMETER_SERVER_SERVICE = "parameter_server.ParameterServer"
COORDINATOR_SERVICE = "coordinator.Coordinator"

PARAMETER_SERVER_METHODS = {
    "ReceiveGradients": (GradientUpdate, PushResponse),
    "ServeParameters": (PullRequest, ParameterUpdate),
    "CheckSyncStatus": (SyncStatusRequest, SyncStatusResponse),
    "SaveCheckpoint": (SaveCheckpointRequest, SaveCheckpointResponse),
    "LoadCheckpoint": (LoadCheckpointRequest, LoadCheckpointResponse),
}

# Streaming data-plane extension (rpc/data_plane.py): the same push/pull
# payloads as a stream of chunk messages instead of one monolithic unary
# message.  Kept OUT of PARAMETER_SERVER_METHODS, whose method set is the
# reference IDL's (reference proto/parameter_server.proto:5-11) — these are
# extra method names on the same service that a reference peer simply never
# calls, and PSClient falls back to the unary RPCs when a reference server
# answers UNIMPLEMENTED.
PARAMETER_SERVER_STREAM_METHODS = {
    "PushGradientsStream": (GradientUpdate, PushResponse, "stream_unary"),
    "ServeParametersStream": (PullRequest, ParameterUpdate, "unary_stream"),
    # Fused data plane: client streams gradient chunks; the server applies
    # them, waits on the aggregation barrier (condition variable, no
    # polling), then streams the fresh parameter chunks back on the SAME
    # call — push + M sync polls + pull collapse into one RPC round.
    "PushPullStream": (GradientUpdate, PushPullResponse, "stream_stream"),
}

COORDINATOR_METHODS = {
    "RegisterWorker": (WorkerInfo, RegisterResponse),
    "Heartbeat": (HeartbeatRequest, HeartbeatResponse),
    "ListWorkers": (ListWorkersRequest, ListWorkersResponse),
    "GetParameterServerAddress": (GetPSAddressRequest, GetPSAddressResponse),
}
