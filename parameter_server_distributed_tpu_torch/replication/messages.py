"""Shard-map RPC messages: the port's copy of the shard-map part of
parameter_server_distributed_tpu/replication/messages.py, with its field
numbers and types, so every message encodes byte for byte as the JAX
package's.

The messages live outside ``rpc/messages.py`` as in the JAX package:
they are extra method names on the coordinator's service, which a
reference peer never calls and answers UNIMPLEMENTED.  Not ported: the
replica, retire and sharded-update messages of the PS service
(ROADMAP.md Queue 1, item 13).
"""

from __future__ import annotations

from ..rpc.messages import TRACE_FIELD_NUMBER
from ..rpc.wire import Field, Message

# The marker a PS puts in a push rejection when the push touched tensors
# that a live reshard moved to another owner; ShardedPSClient matches on
# it, waits for the map's epoch to advance, and replays the round.
STALE_SHARD_MAP = "stale shard map"


class WireShardMapEntry(Message):
    """One shard of the epoch-numbered map (``core.coordinator_core
    .ShardMapEntry`` on the wire)."""
    FIELDS = (
        Field(1, "primary", "string"),
        Field(2, "backup", "string"),
        Field(3, "epoch", "int32"),
    )


class ShardMapRequest(Message):
    FIELDS = (Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),)


class ShardMapResponse(Message):
    FIELDS = (
        Field(1, "epoch", "int32"),
        Field(2, "entries", "message", message_type=WireShardMapEntry,
              repeated=True),
    )


class ShardFailureReport(Message):
    """A worker saw ``observed_primary`` (shard ``shard_index``) fail at
    map epoch ``epoch``.  The coordinator promotes the shard's backup
    when it has one and returns the current map either way."""
    FIELDS = (
        Field(1, "shard_index", "int32"),
        Field(2, "observed_primary", "string"),
        Field(3, "epoch", "int32"),
        Field(4, "worker_id", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


REPLICATION_COORD_METHODS = {
    "GetShardMap": (ShardMapRequest, ShardMapResponse),
    "ReportShardFailure": (ShardFailureReport, ShardMapResponse),
}
