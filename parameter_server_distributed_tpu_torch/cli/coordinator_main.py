"""Coordinator process entry point: the port of
parameter_server_distributed_tpu/cli/coordinator_main.py.

    python -m parameter_server_distributed_tpu_torch.cli.coordinator_main \\
        [bind_addr] [ps_addr] [--ps-shards=host:port,host:port,...]

    bind_addr  default 0.0.0.0:50052
    ps_addr    default 127.0.0.1:50051 (host:port split like the reference)

The argv contract is the reference's (src/coordinator_main.cpp:6-20).
``--ps-shards`` lists the PS shards beyond ps_addr: the store is then
partitioned by tensor name over all of them (one ``ps_main`` a shard,
each with its own ``--ckpt-dir``), and workers fan their pushes and
pulls out per owner (worker/ps_shards.py); a reference worker sees
ps_addr only.  The coordinator touches no device.  SIGTERM or SIGINT
stops it cleanly.  Not ported: ``--ps-backups`` (ROADMAP.md Queue 1,
item 13: backups, promotion, resharding, replication).
"""

from __future__ import annotations

import logging
import signal
import sys

from ..config import (DEFAULT_COORDINATOR_PORT, DEFAULT_PS_PORT,
                      CoordinatorConfig, parse_argv, parse_host_port,
                      require_flag_value)
from ..server.coordinator_service import Coordinator

ROADMAP_REPLICATION = ("ROADMAP.md Queue 1, item 13 (failover, promotion, "
                       "backups, resharding and replication)")


def _interrupt(_signum, _frame):
    raise KeyboardInterrupt


def build_config(argv: list[str]) -> CoordinatorConfig:
    """The coordinator's config from its argv."""
    positional, flags = parse_argv(argv)
    if "ps-backups" in flags:
        raise NotImplementedError(f"--ps-backups: {ROADMAP_REPLICATION}")
    require_flag_value(argv, "--ps-shards", hint="host:port,host:port")
    bind = positional[0] if len(positional) > 0 \
        else f"0.0.0.0:{DEFAULT_COORDINATOR_PORT}"
    ps = positional[1] if len(positional) > 1 \
        else f"127.0.0.1:{DEFAULT_PS_PORT}"
    bind_host, bind_port = parse_host_port(bind, DEFAULT_COORDINATOR_PORT)
    ps_host, ps_port = parse_host_port(ps, DEFAULT_PS_PORT)
    shards = tuple(s for s in flags.get("ps-shards", "").split(",") if s)
    return CoordinatorConfig(bind_address=bind_host, port=bind_port,
                             ps_address=ps_host, ps_port=ps_port,
                             ps_shards=shards)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config = build_config(argv)
    coordinator = Coordinator(config)
    signal.signal(signal.SIGTERM, _interrupt)
    port = coordinator.start()
    # the bound port (a port of 0 asks for any free one)
    print(f"Coordinator server listening on {config.bind_address}:{port}",
          flush=True)
    try:
        coordinator.wait()
    except KeyboardInterrupt:
        pass
    finally:
        coordinator.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
