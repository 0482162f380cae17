"""Decode fleet control: the port of the fleet commands of
parameter_server_distributed_tpu/cli/ctl_main.py.

    python -m parameter_server_distributed_tpu_torch.cli.ctl_main \\
        fleet [coordinator_addr]
    ... fleet-drain <server_id> [coordinator_addr]
    ... scale <n> [coordinator_addr]

``fleet`` prints the decode fleet table (state, free and total slots,
queue depth, serving weight version and streams per server: the rows
the router scores on), as the JAX package's tool does.  ``fleet-drain``
marks a server DRAINING: it stops admitting, finishes its in-flight
streams and leaves.  ``scale <n>`` sets the manual fleet-size target (0
hands control back to the autoscaler's watermarks); it changes nothing
unless a process runs a ``FleetController`` autoscaler
(``start_autoscaler``), which no CLI starts.  The coordinator
defaults to 127.0.0.1:50052.  Against a coordinator without
``UpdateFleet`` each command says so and exits 1.  Not ported: ``drain``
and ``members`` (worker membership, ROADMAP.md Queue 1, item 11).
"""

from __future__ import annotations

import sys

import grpc

from ..config import parse_argv
from ..fleet import messages as fmsg
from ..rpc import messages as m
from ..rpc.service import RpcClient
from ..rpc.service import status_code as _status_code

USAGE = ("usage: ctl_main fleet [coordinator_addr]\n"
         "       ctl_main fleet-drain <server_id> [coordinator_addr]\n"
         "       ctl_main scale <n> [coordinator_addr]")
ROADMAP_MEMBERSHIP = ("worker membership (UpdateMembership) is not ported "
                      "yet: ROADMAP.md Queue 1, item 11 (elastic/)")
DEFAULT_COORDINATOR = "127.0.0.1:50052"


def _fleet_call(coordinator: str,
                request: fmsg.FleetRequest) -> fmsg.FleetResponse | None:
    """One UpdateFleet round trip; None (after saying why) when the
    coordinator lacks the method."""
    client = RpcClient(coordinator, m.COORDINATOR_SERVICE,
                       fmsg.FLEET_COORD_METHODS)
    try:
        return client.call("UpdateFleet", request, timeout=5.0)
    except grpc.RpcError as exc:
        if _status_code(exc) == grpc.StatusCode.UNIMPLEMENTED:
            print("fleet unavailable: coordinator does not implement "
                  "UpdateFleet (reference build?)", file=sys.stderr)
            return None
        raise
    finally:
        client.close()


def _print_fleet(resp: fmsg.FleetResponse) -> None:
    target = (f", target {resp.scale_target}" if resp.scale_target
              else ", autoscale")
    print(f"fleet epoch {resp.epoch} ({len(resp.entries)} servers"
          f"{target})")
    for entry in resp.entries:
        state = fmsg.STATE_NAMES.get(int(entry.state),
                                     f"state{entry.state}")
        print(f"  server {entry.server_id} [{entry.address}]: {state}, "
              f"{entry.free_slots}/{entry.slots} slots free, "
              f"queue {entry.queue_depth}, "
              f"version {entry.weight_version}, "
              f"{entry.active_streams} streams")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    positional, _flags = parse_argv(argv)
    if not positional:
        print(USAGE, file=sys.stderr)
        return 2
    command, args = positional[0], positional[1:]
    if command in ("drain", "members"):
        raise NotImplementedError(f"ctl_main {command}: "
                                  f"{ROADMAP_MEMBERSHIP}")
    if command == "fleet":
        resp = _fleet_call(args[0] if args else DEFAULT_COORDINATOR,
                           fmsg.FleetRequest(server_id=-1,
                                             action=fmsg.FLEET_QUERY))
        if resp is None:
            return 1
        _print_fleet(resp)
        return 0
    if command in ("fleet-drain", "scale") and args:
        target = int(args[0])
        request = (fmsg.FleetRequest(server_id=-1, action=fmsg.FLEET_DRAIN,
                                     target_server_id=target)
                   if command == "fleet-drain" else
                   fmsg.FleetRequest(server_id=-1, action=fmsg.FLEET_SCALE,
                                     scale_target=target))
        resp = _fleet_call(args[1] if len(args) > 1
                           else DEFAULT_COORDINATOR, request)
        if resp is None:
            return 1
        print(f"{resp.message} (fleet epoch {resp.epoch})")
        return 0 if resp.success else 1
    print(USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
