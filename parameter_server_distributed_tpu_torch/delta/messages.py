"""Delta-serving and weight-publication RPC messages: the port's copy of
parameter_server_distributed_tpu/delta/messages.py, with its field
numbers and types, so every message encodes byte for byte as the JAX
package's.

They stay outside ``rpc/messages.py``, as in the JAX package: they are
extra method names on the parameter server's gRPC service.  A PS that
does not register them (a reference PS, or one at
``PSDT_DELTA_DEPTH=0``) answers UNIMPLEMENTED, and every caller takes
that as a downgrade to the full-serve protocol for the connection.

Frame protocol (all three RPCs stream :class:`DeltaFrame`):

- a FULL serve rides ``params`` chunks (the ordinary pull's
  ``ParameterUpdate`` bytes, from the encode-once cache) with
  ``to_version`` stamped, the version the receiver now holds and the
  base the next delta applies to;
- a DELTA serve rides ``entries``: per-tensor sparse (or dense)
  wire-space patches for one ``(from_version, to_version)`` pair.  The
  receiver scatters the decoded values into its cached store, which is
  then bit for bit what a full pull would decode (delta/chain.py);
- the last frame of a pair carries ``crc``, crc32 over the decoded f32
  bytes of the whole store at ``to_version`` (delta/chain.py
  ``fold_crcs``): a receiver whose base drifted fails it, drops its
  base and pulls in full.
"""

from __future__ import annotations

import os

from ..rpc.messages import (TRACE_FIELD_NUMBER, GradientUpdate,
                            ParameterUpdate, PushResponse)
from ..rpc.wire import Field, Message

# Bounded chain depth: a receiver within this many versions of the store
# is served a delta chain; one further behind (or across a restore) gets
# a full serve.  0 turns the subsystem off on both ends: the PS does not
# register the delta RPCs, and clients do not call them.
ENV_DEPTH = "PSDT_DELTA_DEPTH"
DEFAULT_DEPTH = 4

# The wire dtype the chain is built for: deltas engage only for a
# receiver whose pull encoding matches.  bf16 is where they pay: a small
# optimizer step moves many weights by less than a bf16 ulp.
ENV_DTYPE = "PSDT_DELTA_DTYPE"
DEFAULT_DTYPE = "bf16"


def delta_depth() -> int:
    return int(os.environ.get(ENV_DEPTH, str(DEFAULT_DEPTH)))


def delta_enabled() -> bool:
    return delta_depth() > 0


class DeltaEntry(Message):
    """One tensor's wire-space patch within a pair.  ``indices`` is
    packed little-endian u32 flat indices; ``values`` the matching
    wire-encoded elements (bf16: 2 bytes each; f32: 4).  ``dense=True``
    means ``values`` is the tensor's whole wire payload and ``indices``
    is empty."""
    FIELDS = (
        Field(1, "name", "string"),
        Field(2, "indices", "bytes"),
        Field(3, "values", "bytes"),
        Field(4, "dense", "bool"),
    )


class DeltaFrame(Message):
    """One frame of a delta-protocol response stream (see the module
    docstring).  ``push`` rides only on the fused
    ``PushPullDeltaStream``'s first frame; ``delta`` tells entry frames
    from full ``params`` chunks; ``last`` marks the final frame of one
    pair (delta) or of the whole full serve."""
    FIELDS = (
        Field(1, "push", "message", message_type=PushResponse),
        Field(2, "params", "message", message_type=ParameterUpdate),
        Field(3, "from_version", "int64"),
        Field(4, "to_version", "int64"),
        Field(5, "delta", "bool"),
        Field(6, "entries", "message", message_type=DeltaEntry,
              repeated=True),
        Field(7, "crc", "int64"),
        Field(8, "last", "bool"),
        Field(9, "wire_dtype", "int32"),
    )


class DeltaPullRequest(Message):
    """Version-aware pull: ``held_version`` is the store version the
    caller's cached params correspond to (0 = none: the answer is a full
    serve that establishes the base)."""
    FIELDS = (
        Field(1, "worker_id", "int32"),
        Field(2, "iteration", "int32"),
        Field(3, "wire_dtype", "int32"),
        Field(4, "held_version", "int64"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class DeltaPushChunk(Message):
    """One chunk of the version-aware fused round: the fused
    ``GradientUpdate`` chunk with the pusher's held version (read off the
    first chunk, like ``pull_wire_dtype``)."""
    FIELDS = (
        Field(1, "update", "message", message_type=GradientUpdate),
        Field(2, "held_version", "int64"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class SubscribeRequest(Message):
    """Open a live weight subscription: the server streams a frame batch
    for every new store version from ``held_version`` on (full first when
    the subscriber holds nothing or is past the chain depth) until the
    caller cancels."""
    FIELDS = (
        Field(1, "subscriber_id", "int32"),
        Field(2, "held_version", "int64"),
        Field(3, "wire_dtype", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class EncodedDeltaFrame:
    """A :class:`DeltaFrame` encoded once and replayed verbatim to every
    receiver of the same (pair, chunk budget); it quacks like a Message,
    which is all the gRPC serializer needs."""

    __slots__ = ("body",)

    def __init__(self, body: bytes):
        self.body = body

    def encoded_size(self) -> int:
        return len(self.body)

    def encode_into(self, writer) -> None:
        writer.write(memoryview(self.body))

    def encode(self) -> bytes:
        return self.body


# The extra methods on the parameter server's service.
DELTA_PS_METHODS = {
    "PullParametersDelta": (DeltaPullRequest, DeltaFrame, "unary_stream"),
    "PushPullDeltaStream": (DeltaPushChunk, DeltaFrame, "stream_stream"),
    "SubscribeWeights": (SubscribeRequest, DeltaFrame, "unary_stream"),
}
