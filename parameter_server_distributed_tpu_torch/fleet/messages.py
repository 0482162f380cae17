"""Decode-fleet RPC messages: the port's copy of
parameter_server_distributed_tpu/fleet/messages.py, with its field
numbers and types, so every message encodes byte for byte as the JAX
package's.

Two surfaces:

- ``UpdateFleet``, an extra method on the coordinator's service: one
  RPC registers a decode server, refreshes its load heartbeat (free
  slots, queue depth, weight version, prefix fingerprint), announces a
  graceful leave, requests a drain, sets the manual scale target and
  queries the epoch-numbered fleet table.  A coordinator without it
  answers UNIMPLEMENTED, and a decode server then serves standalone for
  good.
- the decode service ``psdt_fleet.Decode``: ``SubmitStream`` takes one
  request and streams its tokens back, each chunk stamped with the
  weight version that decoded it; ``Control`` probes status, swaps
  weight versions, rolls back to a pinned version, unpins and drains.
  The router speaks ``SubmitStream`` on both faces, so a client cannot
  tell a router from a single server.

Fleet member states are the elastic membership constants
(:mod:`..elastic.messages`).
"""

from __future__ import annotations

from ..elastic.messages import (MEMBER_ACTIVE, MEMBER_DRAINING,  # noqa: F401
                                MEMBER_GONE, MEMBER_JOINING, STATE_NAMES)
from ..rpc.messages import TRACE_FIELD_NUMBER
from ..rpc.wire import Field, Message

# UpdateFleet actions.  Append-only: values ride the wire.
FLEET_QUERY = 0      # pure read (router poll, ctl_main fleet)
FLEET_REGISTER = 1   # a decode server announces itself (-> ACTIVE)
FLEET_HEARTBEAT = 2  # load refresh: free slots / queue depth / version
FLEET_LEAVE = 3      # graceful leave (drain completed / shutdown)
FLEET_DRAIN = 4      # mark target_server_id DRAINING (scale-in, ctl)
FLEET_SCALE = 5      # set the manual scale target (0 = autoscale)

# Control actions on the decode service.
CTRL_STATUS = 0      # status probe (no side effect)
CTRL_SWAP = 1        # swap to held version `version` (-1 = newest held)
CTRL_ROLLBACK = 2    # swap back to `version` and pin there: no newer
                     # version serves a continuation until CTRL_UNPIN
CTRL_UNPIN = 3       # clear the rollback pin
CTRL_DRAIN = 4       # stop admitting, finish in-flight streams, leave


class FleetEntry(Message):
    """One decode server's fleet row: identity, capacity, the load
    signals the router scores on, the weight version it serves and its
    radix prefix-cache fingerprint (packed block hashes,
    models/prefix_tree.py; empty without a prefix cache)."""
    FIELDS = (
        Field(1, "server_id", "int32"),
        Field(2, "address", "string"),
        Field(3, "slots", "int32"),
        Field(4, "free_slots", "int32"),
        Field(5, "queue_depth", "int32"),
        Field(6, "weight_version", "int32"),
        Field(7, "state", "int32"),
        Field(8, "epoch", "int32"),
        Field(9, "active_streams", "int32"),
        Field(10, "prefix_fp", "bytes"),
    )


class FleetRequest(Message):
    """Register, heartbeat or query in one RPC.  ``target_server_id`` is
    read only for ``FLEET_DRAIN``, ``scale_target`` only for
    ``FLEET_SCALE``."""
    FIELDS = (
        Field(1, "server_id", "int32"),
        Field(2, "action", "int32"),
        Field(3, "address", "string"),
        Field(4, "slots", "int32"),
        Field(5, "free_slots", "int32"),
        Field(6, "queue_depth", "int32"),
        Field(7, "weight_version", "int32"),
        Field(8, "active_streams", "int32"),
        Field(9, "target_server_id", "int32"),
        Field(10, "scale_target", "int32"),
        Field(11, "prefix_fp", "bytes"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class FleetResponse(Message):
    """``self_state`` answers the requesting server (its drain signal;
    -1 = unknown); ``scale_target`` echoes the manual target (0 =
    autoscale)."""
    FIELDS = (
        Field(1, "epoch", "int32"),
        Field(2, "success", "bool"),
        Field(3, "message", "string"),
        Field(4, "self_state", "int32"),
        Field(5, "entries", "message", message_type=FleetEntry,
              repeated=True),
        Field(6, "scale_target", "int32"),
    )


class DecodeRequest(Message):
    """One stream admission: the prompt's token ids, the generation
    budget and per-request sampling (temperature < 0 = the server's
    default)."""
    FIELDS = (
        Field(1, "tokens", "int32", repeated=True),
        Field(2, "max_new", "int32"),
        Field(3, "temperature", "float"),
        Field(4, "stop", "int32", repeated=True),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class DecodeChunk(Message):
    """One streamed token or the terminal chunk.  ``weight_version`` is
    the params version that decoded this token; ``error`` non-empty
    means the request failed; ``done`` closes the stream."""
    FIELDS = (
        Field(1, "request_id", "int32"),
        Field(2, "token", "int32"),
        Field(3, "done", "bool"),
        Field(4, "error", "string"),
        Field(5, "weight_version", "int32"),
    )


class DecodeControlRequest(Message):
    FIELDS = (
        Field(1, "action", "int32"),
        Field(2, "version", "int32"),
        Field(TRACE_FIELD_NUMBER, "trace_context", "bytes"),
    )


class DecodeControlResponse(Message):
    """A server's status: capacity, load, the serving version, the held
    versions, the rollback pin (-1 = unpinned), streams served, and the
    prompt phase's forwarded tokens against prompt tokens admitted."""
    FIELDS = (
        Field(1, "success", "bool"),
        Field(2, "message", "string"),
        Field(3, "server_id", "int32"),
        Field(4, "state", "int32"),
        Field(5, "slots", "int32"),
        Field(6, "free_slots", "int32"),
        Field(7, "queue_depth", "int32"),
        Field(8, "weight_version", "int32"),
        Field(9, "pinned_version", "int32"),
        Field(10, "versions_held", "int32", repeated=True),
        Field(11, "streams_served", "int32"),
        Field(12, "prefill_tokens", "int64"),
        Field(13, "prompt_tokens", "int64"),
    )


# The extra method on the coordinator's service.
FLEET_COORD_METHODS = {
    "UpdateFleet": (FleetRequest, FleetResponse),
}

# A service of its own: the decode plane shares no method path with the
# reference protocol.
DECODE_SERVICE = "psdt_fleet.Decode"
DECODE_METHODS = {
    "SubmitStream": (DecodeRequest, DecodeChunk, "unary_stream"),
    "Control": (DecodeControlRequest, DecodeControlResponse),
}
