"""Worker process entry point: the port of
parameter_server_distributed_tpu/cli/worker_main.py.

    python -m parameter_server_distributed_tpu_torch.cli.worker_main \\
        [coordinator_addr] [worker_id] [iterations] [worker_addr]
        [worker_port] [checkpoint_path] [flags...]

The argv contract is the reference's (src/worker_main.cpp:6-18).  A
non-empty checkpoint_path asks the PS to restore it at startup, tolerant
of failure (reference: src/worker_main.cpp:28-38).

Flags:
    --model=NAME     registry model (default llama_350m): a transformer
                     LM, mnist_mlp / mlp_1b, resnet18_cifar /
                     resnet50_imagenet or vit_tiny_cifar /
                     vit_s16_imagenet (models/registry.py)
    --batch=N        per-worker batch size (default 32)
    --seed=N         data seed (default: the worker id, so streams differ)
    --data=PATH      file-backed data: a token shard (.bin uint16, .u32)
                     or a .txt corpus for an LM, an npz of x and y for a
                     classification row (default: the synthetic stream)
    --dtype=f32|bf16 model compute dtype (default: the model's)
    --remat / --no-remat / --scan-layers / --no-scan-layers
                     layer-loop knobs (absent = the model's default)
    --wire=ENC       payload encoding: f32 (reference-compatible, default),
                     raw or bf16 (packed; negotiated with the PS)
    --no-fused       the serial push / poll / pull protocol instead of the
                     fused PushPullStream round
    --device=D       cuda (default) or cpu; with no card and no
                     --device=cpu the worker exits with an error
    --report=PATH    write the exit report there (cli/exit_report.py)

``PSDT_METRICS_FILE`` (``%d`` becomes the worker id) receives one JSON
record per iteration with its phase times (worker/worker.py).  The
worker keeps float32 convolutions at float32 on the card: it turns
cuDNN's TF32 off at its start (torch's default lets cuDNN run float32
convolutions in TF32, which the reference's float32 convs are not).
Not ported: --mesh (ROADMAP.md Queue 1, item 8), --freerun (item 11),
--tiers (item 10), the int8 and topk encodings and --topk-density
(their error feedback, item 10).
"""

from __future__ import annotations

import logging
import sys

import torch

from ..config import WorkerConfig, parse_argv, require_flag_value
from ..models.registry import get_model_and_batches
from ..worker.trainer import Trainer
from ..worker.worker import Worker

UNPORTED_FLAGS = {
    "mesh": "ROADMAP.md Queue 1, item 8 (multi-device SPMD)",
    "freerun": "ROADMAP.md Queue 1, item 11 (quorum barriers, free-run)",
    **dict.fromkeys(("tiers", "no-tiers", "topk-density"),
                    "ROADMAP.md Queue 1, item 10 (hierarchical aggregation, "
                    "error feedback)"),
}


def build_worker(config: WorkerConfig, seed: int | None = None,
                 remat: bool | None = None,
                 scan: bool | None = None) -> Worker:
    """A Worker over a registry model and its data stream (synthetic, or
    the file ``config.data_path``; seeded with the worker id unless
    ``seed`` is given), on ``config.device``."""
    data_seed = config.worker_id if seed is None else seed
    model, batches = get_model_and_batches(
        config.model, config.batch_size, seed=data_seed,
        data_path=config.data_path, dtype=config.model_dtype,
        device=config.device, remat=remat, scan=scan)
    return Worker(config, Trainer(model, device=config.device), batches)


def _tri(flags: dict, name: str) -> bool | None:
    return (False if f"no-{name}" in flags
            else True if name in flags else None)


def build_config(argv: list[str]) -> tuple[WorkerConfig, dict]:
    """(config, flags) from the command line; unported flags raise."""
    require_flag_value(argv, "--model", "--batch", "--seed", "--dtype",
                       "--wire", "--device", "--report", "--data")
    positional, flags = parse_argv(argv)
    for flag, where in UNPORTED_FLAGS.items():
        if flag in flags:
            raise NotImplementedError(f"--{flag}: {where}")
    config = WorkerConfig(
        coordinator_address=(positional[0] if len(positional) > 0
                             else "127.0.0.1:50052"),
        worker_id=int(positional[1]) if len(positional) > 1 else 0,
        iterations=int(positional[2]) if len(positional) > 2 else 10,
        address=positional[3] if len(positional) > 3 else "127.0.0.1",
        port=int(positional[4]) if len(positional) > 4 else 50060,
        checkpoint_path=positional[5] if len(positional) > 5 else "",
        model=flags.get("model", "llama_350m"),
        batch_size=int(flags.get("batch", 32)),
        model_dtype=flags.get("dtype", ""),
        data_path=flags.get("data", ""),
        wire_dtype=flags.get("wire", "f32"),
        fused_step="no-fused" not in flags,
        device=flags.get("device") or None,
    )
    return config, flags


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    config, flags = build_config(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    torch.backends.cudnn.allow_tf32 = False
    worker = build_worker(
        config, seed=int(flags["seed"]) if "seed" in flags else None,
        remat=_tri(flags, "remat"), scan=_tri(flags, "scan-layers"))
    report = flags.get("report", "")
    try:
        worker.initialize()
        if config.checkpoint_path:
            # tolerant of failure, like the reference
            try:
                worker.load_checkpoint_from_server(config.checkpoint_path)
            except Exception as exc:  # noqa: BLE001
                logging.warning("checkpoint restore failed (continuing): %s",
                                exc)
        for i in range(config.iterations):
            it = max(i, worker.iteration + 1)
            loss = worker.run_iteration(it)
            desc = ("bootstrap: seeded PS init" if worker.last_bootstrap
                    else f"loss {loss:.4f}")
            print(f"Worker {config.worker_id} completed iteration {it} "
                  f"({desc})", flush=True)
    finally:
        worker.shutdown()
        if report:
            from .exit_report import write_exit_report
            write_exit_report(report, f"worker {config.worker_id}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
