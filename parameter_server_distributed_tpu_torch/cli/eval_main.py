"""Standalone evaluation on the port: the loss and perplexity (LMs) or
the loss and accuracy (classifiers) of a checkpoint over a dataset, with
no training step and no server.

    python -m parameter_server_distributed_tpu_torch.cli.eval_main \\
        --model=small_lm [--ckpt=path.ckpt [--lora-alpha=A]] \\
        [--data=corpus.txt|shard.bin|data.npz] [--batch=32] [--steps=16] \\
        [--seq=N] [--seed=0] [--dtype=bf16] \\
        [--scan-layers | --no-scan-layers] [--device=cuda|cpu]
    python -m parameter_server_distributed_tpu_torch.cli.eval_main \\
        --hf-gpt2=<checkout> [--data=...]      # a converted checkpoint

The output is one strict-JSON line: ``{"model": ..., "loss": mean,
"batches": n, "perplexity": exp(loss)}`` for a token model (the loss is
the mean next-token NLL; an MoE model's loss includes the load-balance
aux term, so its line carries a ``note`` instead of a skewed
perplexity), or ``{"model": ..., "loss": ..., "batches": n,
"accuracy": top1}`` for an (x, y) model.  A non-finite loss reports
``null``.  ``--data`` takes the sources the trainer takes (a .txt corpus
byte-tokenized, a .bin token shard, an npz of x and y); without it the
registry's synthetic stream evaluates, a smoke check only.  The stream
is the registry's at ``seed + 100003``, a held-out shift, as in the
reference's ``pst-eval``.  Weights come from ``--ckpt`` (the PS's host
checkpoint format), ``--hf-gpt2`` (models/hf.py ``from_hf_gpt2``) or a
fresh ``--seed`` init.  Runs on the CUDA card unless ``--device=cpu``
asks for the CPU.
"""

from __future__ import annotations

import json
import sys

from ..config import parse_argv, require_flag_value

KNOWN_FLAGS = frozenset({
    "model", "hf-gpt2", "dtype", "scan-layers", "no-scan-layers", "seed",
    "ckpt", "lora-alpha", "data", "batch", "steps", "seq", "device",
})

# the reference's other pst-eval flags, and where each is planned
UNPORTED_FLAGS = dict.fromkeys(
    ("ckpt-dir", "avg-last"),
    "sharded checkpoints (ROADMAP.md Queue 1, item 8, train_loop: "
    "checkpoint/sharded.py)")

# the registry stream's shift for evaluation: batches a training run
# with the same seed never saw
HELD_OUT_SHIFT = 100_003


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _, flags = parse_argv(argv)
    if "help" in flags:
        print(__doc__)
        return 0
    unported = sorted(set(flags) & set(UNPORTED_FLAGS))
    if unported:
        raise SystemExit("; ".join(f"--{name} is not ported yet: "
                                   f"{UNPORTED_FLAGS[name]}"
                                   for name in unported))
    require_flag_value(argv, "--lora-alpha",
                       hint="the ALPHA the run trained with")
    require_flag_value(argv, "--device", hint="cuda or cpu")
    unknown = set(flags) - KNOWN_FLAGS
    if unknown:
        raise SystemExit(f"unknown flag(s): {', '.join(sorted(unknown))}; "
                         f"--help lists the accepted flags")

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.registry import get_model_and_batches, lm_batches
    from ..models.transformer import Transformer
    from .generate_main import load_hf, load_params, match_layout

    device = resolve_device(flags.get("device"))
    name = flags.get("model", "small_lm")
    batch = int(flags.get("batch", 32))
    steps = max(1, int(flags.get("steps", 16)))
    seed = int(flags.get("seed", 0))
    if flags.get("hf-gpt2"):
        # --hf-gpt2 defines the model and its weights: the flags that
        # pick or adjust either would be silently ignored
        conflicts = {"model", "ckpt", "lora-alpha"} & set(flags)
        if conflicts:
            raise SystemExit(
                "--hf-gpt2 defines model AND weights; drop "
                + "/".join(sorted("--" + c for c in conflicts)))
        if flags.get("seq"):
            raise SystemExit("--hf-gpt2 fixes seq (n_positions); "
                             "drop --seq")
        model, params, _ = load_hf(flags, device)
        name = f"hf-gpt2:{flags['hf-gpt2']}"
        source = name
        batches = lm_batches(model, batch, seed=seed + HELD_OUT_SHIFT,
                             data_path=flags.get("data", ""), device=device)
    else:
        model, batches = get_model_and_batches(
            name, batch, seed=seed + HELD_OUT_SHIFT,
            data_path=flags.get("data", ""), dtype=flags.get("dtype", ""),
            device=device,
            scan=(False if "no-scan-layers" in flags
                  else True if "scan-layers" in flags else None),
            seq_len=int(flags.get("seq", 0)))
        params, source = load_params(flags, model, seed, device)
    is_lm = isinstance(model, Transformer)
    if is_lm:
        params = match_layout(model, params)
    print(f"evaluating: {source}", file=sys.stderr)

    total_loss, correct, count = 0.0, 0, 0
    with torch.inference_mode():
        for _ in range(steps):
            data = next(batches)
            if is_lm:
                total_loss += float(model.loss(params, data))
                continue
            # one forward serves both metrics: the classifiers' losses
            # are all plain softmax cross-entropy over apply()'s logits
            x, y = data
            logits = model.apply(params, x).float()
            logp = torch.log_softmax(logits, dim=-1)
            total_loss += float(-logp.gather(-1, y.long()[:, None]).mean())
            correct += int((logits.argmax(dim=-1) == y.long()).sum())
            count += int(y.shape[0])
    mean_loss = total_loss / steps
    finite = bool(np.isfinite(mean_loss))
    out = {"model": name, "loss": round(mean_loss, 6) if finite else None,
           "batches": steps}
    if is_lm and finite and model.config.moe_every == 0:
        # capped as the reference caps it: strict-JSON safe
        out["perplexity"] = round(float(np.exp(min(mean_loss, 700.0))), 4)
    elif is_lm and finite:
        out["note"] = ("loss includes the MoE load-balance aux term; "
                       "perplexity omitted")
    if count:
        out["accuracy"] = round(correct / count, 4)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
