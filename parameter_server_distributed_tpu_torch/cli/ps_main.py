"""Parameter-server process entry point: the port of
parameter_server_distributed_tpu/cli/ps_main.py — the plain synchronous
PS.

    python -m parameter_server_distributed_tpu_torch.cli.ps_main \\
        [bind_addr] [total_workers] [checkpoint_interval] [flags...]

    bind_addr            default 0.0.0.0:50051 (port 0: any free port)
    total_workers        default 2
    checkpoint_interval  default 10 (iterations per checkpoint epoch; each
                         epoch's checkpoint holds the store of the apply
                         that advanced it)

Flags beyond the reference's argv (src/parameter_main.cpp:6-18):
    --lr=F           learning rate (default 1.0, the reference's implicit lr)
    --optimizer=S    pallas_sgd (the default: the reference's SGD rule on
                     the fused-update kernel, bit-exact with the host
                     numpy sgd), pallas_{momentum,adam}, or
                     device_{sgd,momentum,adam,adamw,adamw_bf16} for a
                     store on the device, sharded_{sgd,momentum,adam,
                     adamw,lion} for the device close (with
                     PSDT_DEVICE_APPLY=1, and PSDT_ARENA=1 for its flat
                     slabs; a device_ name of those rules resolves to it
                     under PSDT_DEVICE_APPLY=1), or sgd | momentum | adam
                     | adamw | lion on the host (core/optimizer.py
                     make_optimizer)
    --staleness=N    bounded-staleness async mode (0 = synchronous)
    --aggregation=S  streaming (default) | buffered
    --ckpt-dir=D     checkpoint directory (default .)
    --keep=N         checkpoint retention (0 = keep all)
    --device=D       the optimizer's device: cuda (default) or cpu; with
                     no card and no --device=cpu the PS exits with an error
    --report=PATH    write the exit report there (cli/exit_report.py)

The bound address is printed as "Parameter server listening on
HOST:PORT".  SIGTERM or SIGINT stops it cleanly.  Not ported: --elastic
(ROADMAP.md Queue 1, item 11), --coordinator (the tier contribution
provider, item 10), --quorum, --quorum-grace-ms and --freerun (item 11),
--backup, --replication and --standby (item 13).
"""

from __future__ import annotations

import logging
import signal
import sys

from ..config import (DEFAULT_OPTIMIZER, DEFAULT_PS_PORT,
                      ParameterServerConfig, parse_argv, parse_host_port,
                      require_flag_value)

UNPORTED_FLAGS = {
    "elastic": "ROADMAP.md Queue 1, item 11 (quorum barriers, free-run)",
    "coordinator": "the tier contribution provider: ROADMAP.md Queue 1, "
                   "item 10 (hierarchical aggregation)",
    **dict.fromkeys(("quorum", "quorum-grace-ms", "freerun"),
                    "ROADMAP.md Queue 1, item 11 (quorum barriers, "
                    "free-run)"),
    **dict.fromkeys(("backup", "replication", "standby"),
                    "ROADMAP.md Queue 1, item 13 (replication and "
                    "resharding)"),
}


def build_config(argv: list[str]) -> tuple[ParameterServerConfig, str]:
    """(config, report path or "") from the command line."""
    require_flag_value(argv, "--lr", "--optimizer", "--ckpt-dir",
                       "--device", "--report")
    positional, flags = parse_argv(argv)
    for flag, where in UNPORTED_FLAGS.items():
        if flag in flags:
            raise NotImplementedError(f"--{flag}: {where}")
    bind = positional[0] if len(positional) > 0 \
        else f"0.0.0.0:{DEFAULT_PS_PORT}"
    host, port = parse_host_port(bind, DEFAULT_PS_PORT)
    config = ParameterServerConfig(
        bind_address=host, port=port,
        total_workers=int(positional[1]) if len(positional) > 1 else 2,
        checkpoint_interval=int(positional[2]) if len(positional) > 2
        else 10,
        learning_rate=float(flags.get("lr", 1.0)),
        optimizer=flags.get("optimizer", DEFAULT_OPTIMIZER),
        staleness_bound=int(flags.get("staleness", 0)),
        aggregation=flags.get("aggregation", ""),
        checkpoint_dir=flags.get("ckpt-dir", "."),
        checkpoint_keep=int(flags.get("keep", 0)),
        device=flags.get("device") or None,
    )
    return config, flags.get("report", "")


def _interrupt(_signum, _frame):
    raise KeyboardInterrupt


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    config, report = build_config(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    from ..server.ps_service import ParameterServer

    ps = ParameterServer(config)
    signal.signal(signal.SIGTERM, _interrupt)
    port = ps.start()
    print(f"Parameter server listening on {config.bind_address}:{port}",
          flush=True)
    try:
        ps.wait()
    except KeyboardInterrupt:
        pass
    finally:
        ps.stop()
        if report:
            from .exit_report import write_exit_report
            write_exit_report(report, "ps",
                              optimizer=type(ps.optimizer).__name__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
