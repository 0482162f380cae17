"""Typed configuration of the wire round's processes and the command-line
helpers shared by the port's CLI mains: the port's copy of the
coordinator, parameter-server and worker configs, ``parse_argv``,
``require_flag_value`` and ``parse_host_port`` from
parameter_server_distributed_tpu/config.py.

Each config keeps only the fields the port's services, ``Worker`` and
CLIs read, with the reference's defaults, plus ``device`` where the
port needs one: the card (None) unless the caller asks for "cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Defaults mirroring the reference
DEFAULT_PS_PORT = 50051          # reference: src/parameter_main.cpp:7
DEFAULT_COORDINATOR_PORT = 50052  # reference: scripts/start_coordinator.sh
DEFAULT_TOTAL_WORKERS = 2        # reference: src/parameter_main.cpp:14
DEFAULT_CHECKPOINT_INTERVAL = 10  # iterations/epoch: src/parameter_main.cpp:8
HEARTBEAT_PERIOD_S = 5.0         # reference: src/worker.cpp:233
STALE_TIMEOUT_S = 30.0           # reference: src/coordinator.cpp:52
REAP_PERIOD_S = 10.0             # reference: src/coordinator_service.cpp:104-105
SYNC_POLL_PERIOD_S = 0.05        # reference: src/worker.cpp:372
SYNC_POLL_MAX = 200              # reference: src/worker.cpp:373
SYNC_OUTER_RETRIES = 3           # reference: src/worker.cpp:334
RETRY_MAX_ATTEMPTS = 5           # reference: src/worker.cpp:130
RETRY_BASE_DELAY_S = 0.1         # reference: src/worker.cpp:135 (100ms * 2^n)
# the PS's optimizer: the reference's SGD rule on the fused-update kernel
# (on the card unless the config's device is "cpu")
DEFAULT_OPTIMIZER = "pallas_sgd"


@dataclasses.dataclass(frozen=True)
class CoordinatorConfig:
    bind_address: str = "0.0.0.0"
    port: int = DEFAULT_COORDINATOR_PORT
    ps_address: str = "127.0.0.1"
    ps_port: int = DEFAULT_PS_PORT
    stale_timeout_s: float = STALE_TIMEOUT_S
    reap_period_s: float = REAP_PERIOD_S
    # PS shard addresses ("host:port") beyond the primary above: the
    # store is then partitioned by tensor name over all of them and
    # workers fan pushes and pulls out per owner; () = one PS
    ps_shards: tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ParameterServerConfig:
    bind_address: str = "0.0.0.0"
    port: int = DEFAULT_PS_PORT
    total_workers: int = DEFAULT_TOTAL_WORKERS
    checkpoint_interval: int = DEFAULT_CHECKPOINT_INTERVAL
    checkpoint_dir: str = "."
    checkpoint_keep: int = 0     # keep the newest N checkpoints (0 = all)
    learning_rate: float = 1.0   # reference applies param -= mean_grad
    optimizer: str = DEFAULT_OPTIMIZER   # core/optimizer.py make_optimizer
    momentum: float = 0.9
    weight_decay: float = 1e-4   # adamw variants only
    staleness_bound: int = 0     # 0 = strictly synchronous (reference)
    aggregation: str = ""        # streaming | buffered ("" = env/default)
    gc_iterations: int = 64      # retain at most this many iteration states
    device: str | None = None    # the optimizer's device; None = the card


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    coordinator_address: str = "127.0.0.1:50052"
    worker_id: int = 0
    iterations: int = 10
    address: str = "127.0.0.1"
    port: int = 50060
    checkpoint_path: str = ""
    heartbeat_period_s: float = HEARTBEAT_PERIOD_S
    retry_max_attempts: int = RETRY_MAX_ATTEMPTS
    retry_base_delay_s: float = RETRY_BASE_DELAY_S
    sync_poll_period_s: float = SYNC_POLL_PERIOD_S
    sync_poll_max: int = SYNC_POLL_MAX
    sync_outer_retries: int = SYNC_OUTER_RETRIES
    batch_size: int = 32
    model: str = "llama_350m"
    model_dtype: str = ""        # "f32" / "bf16"; "" = the model's default
    # file-backed data: a token shard or .txt corpus for an LM, an npz
    # of x and y for a classification row; "" = the synthetic stream
    data_path: str = ""
    # payload encoding on push/pull: f32 (reference repeated float), raw
    # or bf16; packed encodings are negotiated and fall back to f32
    # against a reference PS (int8 and topk need error feedback, which
    # is not ported)
    wire_dtype: str = "f32"
    # the fused push→barrier→pull round with bucketed downloads;
    # degrades per connection to the serial protocol against a reference
    # PS, False forces the serial protocol
    fused_step: bool = True
    # the fused call spans push + barrier wait + pull, so it exceeds the
    # server's barrier cap (PSDT_FUSED_BARRIER_TIMEOUT_S, 60 s)
    fused_timeout_s: float = 120.0
    device: str | None = None    # the trainer's device; None = the card


def parse_argv(argv: Sequence[str]) -> tuple[list[str], dict[str, str]]:
    """Split argv into (positional, flags): ``--k=v`` -> flags[k]=v,
    bare ``--k`` -> flags[k]="1"."""
    positional = [a for a in argv if not a.startswith("--")]
    flags = dict(f.lstrip("-").split("=", 1) if "=" in f else (f.lstrip("-"), "1")
                 for f in argv if f.startswith("--"))
    return positional, flags


def require_flag_value(argv: Sequence[str], *names: str,
                       hint: str = "") -> None:
    """Reject bare value-flags: :func:`parse_argv` maps ``--k`` (no "=")
    to "1", which would silently stand in for a real value."""
    for name in names:
        if name in argv:
            raise SystemExit(f"{name} requires an explicit value "
                             f"({name}=...{f' — {hint}' if hint else ''})")


def parse_host_port(addr: str, default_port: int) -> tuple[str, int]:
    """Split 'host:port' like the reference coordinator main
    (reference: src/coordinator_main.cpp:12-18)."""
    if ":" in addr:
        host, _, port = addr.rpartition(":")
        return host, int(port)
    return addr, default_port
