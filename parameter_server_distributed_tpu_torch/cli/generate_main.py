"""Text generation from a language model (KV-cached decode) on the port.

    python -m parameter_server_distributed_tpu_torch.cli.generate_main \\
        --model=small_lm --prompt="the quick brown" --max-new=64 \\
        [--ckpt=path.ckpt [--lora-alpha=A]] [--seed=0] \\
        [--temperature=0.8] [--top-k=40] [--top-p=0.9] \\
        [--quant=int8] [--kv-cache=int8] \\
        [--dtype=bf16] [--scan-layers | --no-scan-layers] \\
        [--tokens=1,2,3] [--device=cuda|cpu]

Parameters come from ``--ckpt`` (the host binary checkpoint format, the
files the PS writes; adapters of a LoRA run are merged with
``--lora-alpha``, the alpha the run trained with) or fresh ``--seed``
init.  Either layer layout decodes: a store is converted to the layout
this process's model uses.  ``--quant=int8`` quantizes the weights
(models/quant.py) and ``--kv-cache=int8`` the KV cache.  Prompts are
byte-tokenized (data/text.ByteTokenizer, vocab 258); ``--tokens`` takes
raw comma-separated ids and prints ids.  Runs on the CUDA card unless
``--device=cpu`` asks for the CPU.
"""

from __future__ import annotations

import sys

from ..config import parse_argv, require_flag_value

KNOWN_FLAGS = frozenset({
    "model", "dtype", "scan-layers", "no-scan-layers", "seed", "ckpt",
    "tokens", "prompt", "top-k", "top-p", "temperature", "max-new",
    "lora-alpha", "quant", "kv-cache", "device",
})

_SPEC_BEAM = ("speculative decoding and beam search (ROADMAP.md Queue 1, "
              "item 6, serving: the rest)")
# the reference's other pst-generate flags, and where each is planned
UNPORTED_FLAGS = {
    **dict.fromkeys(("beam", "length-penalty"), _SPEC_BEAM),
    **dict.fromkeys(("draft-model", "draft-ckpt", "draft-seed", "draft-len",
                     "adaptive-draft", "draft-cost-ratio",
                     "draft-lora-alpha"), _SPEC_BEAM),
    **dict.fromkeys(("ckpt-dir", "avg-last"),
                    "sharded checkpoints (ROADMAP.md Queue 1, item 8, "
                    "train_loop: checkpoint/sharded.py)"),
    "hf-gpt2": "HF conversion (ROADMAP.md Queue 1, item 7, other model "
               "families: hf.py)",
}


def check_flags(argv: list[str], flags: dict) -> None:
    """Refuse unported and unknown flags (a typo falling back to its
    default would corrupt results invisibly), and values the port does
    not take."""
    unported = sorted(set(flags) & set(UNPORTED_FLAGS))
    if unported:
        raise SystemExit("; ".join(f"--{name} is not ported yet: "
                                   f"{UNPORTED_FLAGS[name]}"
                                   for name in unported))
    unknown = set(flags) - KNOWN_FLAGS - {"help"}
    if unknown:
        raise SystemExit(f"unknown flag(s): {', '.join(sorted(unknown))}; "
                         f"--help lists the accepted flags")
    # bare --lora-alpha would merge with alpha 1 instead of the trained
    # value, silently mis-scaling every adapter
    require_flag_value(argv, "--lora-alpha",
                       hint="the ALPHA the run trained with")
    require_flag_value(argv, "--device", hint="cuda or cpu")
    for name in ("quant", "kv-cache"):
        if flags.get(name, "int8") != "int8":
            raise SystemExit(f"--{name} takes int8, got {flags[name]!r}")


def _merge_if_lora(store: dict, flags: dict, what: str):
    """A checkpoint of a LoRA run carries adapter entries: fold them into
    dense weights.  alpha must match training (it scales the adapters),
    so it is demanded rather than defaulted."""
    import torch

    from ..models.lora import lora_names, merge_lora

    if not lora_names(store):
        return store, what
    if not flags.get("lora-alpha"):
        raise SystemExit(
            f"{what} contains LoRA adapters; pass --lora-alpha=A (the ALPHA "
            f"the run trained with, e.g. --lora=8:16 -> 16) to merge them "
            f"for serving")
    alpha = float(flags["lora-alpha"])
    merged = merge_lora({k: torch.from_numpy(v) for k, v in store.items()},
                        alpha=alpha)
    return ({k: v.numpy() for k, v in merged.items()},
            f"{what} (LoRA merged, alpha {alpha:g})")


def load_params(flags: dict, model, seed: int, device):
    """(params on ``device``, description): ``--ckpt`` through the port's
    checkpoint codec, converted to the model's dtype and layout, or a
    fresh init from ``seed``."""
    if flags.get("ckpt"):
        import numpy as np

        from ..checkpoint import codec
        from ..models.convert import params_from_numpy

        _, iteration, store = codec.load(flags["ckpt"])
        store, what = _merge_if_lora(
            {k: np.asarray(v) for k, v in store.items()}, flags,
            f"host checkpoint {flags['ckpt']} (iter {iteration})")
        return params_from_numpy(store, model.config, device=device), what
    return (model.init_params(seed, device=device),
            f"fresh init (seed {seed})")


def match_layout(model, params):
    """Convert a store to the layout this model uses (stacked blocks/*
    for scan_layers, unrolled layer<i>/* otherwise)."""
    from ..models.transformer import stack_layers, unstack_layers

    stacked_store = any(n.startswith("blocks/") for n in params)
    if model.config.scan_layers and not stacked_store:
        return stack_layers(params, model.config.n_layers)
    if not model.config.scan_layers and stacked_store:
        return unstack_layers(params)
    return params


def build_model(flags: dict):
    """The registry LM ``--model`` names, with ``--dtype`` and the layer
    layout flags."""
    from ..models.registry import get_model

    name = flags.get("model", "small_lm")
    model = get_model(name, dtype=flags.get("dtype", ""),
                      scan=(False if "no-scan-layers" in flags
                            else True if "scan-layers" in flags else None))
    if not hasattr(model.config, "vocab"):
        raise SystemExit(f"--model={name}: serving takes a language model")
    return model


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _, flags = parse_argv(argv)
    if "help" in flags:
        print(__doc__)
        return 0
    check_flags(argv, flags)

    import numpy as np

    from ..data.text import ByteTokenizer, require_vocab
    from ..device import resolve_device
    from ..models.generation import generate
    from ..models.quant import quantize_params

    device = resolve_device(flags.get("device"))
    model = build_model(flags)
    seed = int(flags.get("seed", 0))
    params, source = load_params(flags, model, seed, device)
    params = match_layout(model, params)
    if flags.get("quant"):
        params = quantize_params(params)
        source += " (int8 weights)"
    print(f"params: {source}", file=sys.stderr)

    tokenizer = ByteTokenizer()
    if flags.get("tokens"):
        ids = [int(t) for t in flags["tokens"].split(",")]
        decode_text = False
    else:
        require_vocab(model.config.vocab, tokenizer)
        ids = tokenizer.encode(flags.get("prompt", "hello")) or [
            tokenizer.BOS]
        decode_text = True
    top_k = int(flags.get("top-k", 0))
    top_p = float(flags.get("top-p", 0.0))
    # sampling flags imply sampling: temperature 0 (greedy) would silently
    # ignore top-k/top-p, so they default the temperature to 1.0
    temperature = float(flags.get("temperature",
                                  "1.0" if (top_k or top_p) else "0.0"))
    out = generate(model, params, np.asarray([ids], np.int32),
                   int(flags.get("max-new", 64)), temperature=temperature,
                   top_k=top_k, top_p=top_p, rng=seed,
                   cache_dtype="int8" if flags.get("kv-cache") else "native",
                   device=device)
    tokens = out[0].cpu().numpy()
    if decode_text:
        stop = np.nonzero(tokens == tokenizer.EOS)[0]
        if stop.size:      # trim at the first EOS
            tokens = tokens[:int(stop[0])]
        print(tokenizer.decode(tokens), flush=True)
    else:
        print(",".join(str(int(t)) for t in tokens), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
