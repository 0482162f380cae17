"""The decode fleet's front-door stream router: the port of
parameter_server_distributed_tpu/cli/route_main.py.

    python -m parameter_server_distributed_tpu_torch.cli.route_main \\
        --coordinator=HOST:PORT [--port=0] [--poll-s=0.5] [--report=PATH]

Speaks the ``psdt_fleet.Decode`` service the decode servers speak, so a
client cannot tell the router from a single server: each
``SubmitStream`` goes to the best ACTIVE backend of the coordinator's
fleet table (fleet/router.py) and stays pinned there for its life.
``--port`` 0 asks for a free port; the bound one is printed as ``fleet
router on port P``.  SIGTERM or SIGINT stops it; ``--report`` then
writes the streams routed and rejected (cli/exit_report.py).  The
router touches no device.
"""

from __future__ import annotations

import logging
import signal
import sys

from ..config import parse_argv, require_flag_value

KNOWN_FLAGS = frozenset({"coordinator", "port", "poll-s", "report"})


def _interrupt(_signum, _frame):
    raise KeyboardInterrupt


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    _, flags = parse_argv(argv)
    if "help" in flags:
        print(__doc__)
        return 0
    require_flag_value(argv, "--coordinator", "--port", "--poll-s",
                       "--report",
                       hint="e.g. --coordinator=10.0.0.5:50052 "
                            "--port=50060")
    unknown = set(flags) - KNOWN_FLAGS
    if unknown:
        raise SystemExit(f"unknown flag(s): {', '.join(sorted(unknown))}; "
                         f"--help lists the accepted flags")
    if not flags.get("coordinator"):
        raise SystemExit("route_main needs --coordinator=HOST:PORT "
                         "(the fleet table lives there)")

    from ..fleet.router import FleetRouter
    router = FleetRouter(flags["coordinator"],
                         port=int(flags.get("port", "0")),
                         bind_address="0.0.0.0",
                         poll_s=float(flags.get("poll-s", "0.5")))
    signal.signal(signal.SIGTERM, _interrupt)
    port = router.start()
    print(f"fleet router on port {port} "
          f"(coordinator {flags['coordinator']})", file=sys.stderr,
          flush=True)
    try:
        router.wait()
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
    if flags.get("report"):
        from .exit_report import write_exit_report
        write_exit_report(flags["report"], "router",
                          streams_routed=router.streams_routed,
                          streams_rejected=router.streams_rejected)
    return 0


if __name__ == "__main__":
    sys.exit(main())
