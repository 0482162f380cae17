"""Text generation from a language model (KV-cached decode) on the port.

    python -m parameter_server_distributed_tpu_torch.cli.generate_main \\
        --model=small_lm --prompt="the quick brown" --max-new=64 \\
        [--ckpt=path.ckpt [--lora-alpha=A]] [--seed=0] \\
        [--temperature=0.8] [--top-k=40] [--top-p=0.9] \\
        [--quant=int8] [--kv-cache=int8] \\
        [--beam=4 [--length-penalty=0.6]] \\
        [--draft-model=tiny_lm [--draft-ckpt=path.ckpt \\
         [--draft-lora-alpha=A]] [--draft-seed=1] [--draft-len=4] \\
         [--adaptive-draft] [--draft-cost-ratio=R]] \\
        [--dtype=bf16] [--scan-layers | --no-scan-layers] \\
        [--tokens=1,2,3] [--device=cuda|cpu]
    python -m parameter_server_distributed_tpu_torch.cli.generate_main \\
        --hf-gpt2=<checkout> [--tokens=1,2,3 | --prompt=...] ...

Parameters come from ``--ckpt`` (the host binary checkpoint format, the
files the PS writes; adapters of a LoRA run are merged with
``--lora-alpha``, the alpha the run trained with) or fresh ``--seed``
init.  Either layer layout decodes: a store is converted to the layout
this process's model uses.  ``--quant=int8`` quantizes the weights
(models/quant.py) and ``--kv-cache=int8`` the KV cache.  ``--beam=W``
(W > 1) runs beam search (models/generation.py ``beam_search``; in text
mode the tokenizer's EOS finishes a beam); ``--draft-model`` runs
speculative decoding with that registry LM as the draft
(``speculative_generate_batched``; its weights from ``--draft-ckpt`` or
``--draft-seed``, default seed + 1), ``--draft-len`` proposals a round,
the depth adaptive up to it with ``--adaptive-draft``.  Prompts are
byte-tokenized (data/text.ByteTokenizer, vocab 258); ``--tokens`` takes
raw comma-separated ids and prints ids.  Runs on the CUDA card unless
``--device=cpu`` asks for the CPU.  ``--hf-gpt2`` converts a
``transformers`` GPT-2 checkpoint (a local ``save_pretrained`` directory
or a hub name already in the local cache; models/hf.py ``from_hf_gpt2``,
f32 unless ``--dtype``) and takes its prompts through the checkpoint's
own tokenizer when it ships one, else raw ``--tokens``.
"""

from __future__ import annotations

import os
import sys

from ..config import parse_argv, require_flag_value

KNOWN_FLAGS = frozenset({
    "model", "dtype", "scan-layers", "no-scan-layers", "seed", "ckpt",
    "tokens", "prompt", "top-k", "top-p", "temperature", "max-new",
    "lora-alpha", "quant", "kv-cache", "device", "beam", "length-penalty",
    "draft-model", "draft-ckpt", "draft-seed", "draft-len",
    "adaptive-draft", "draft-cost-ratio", "draft-lora-alpha", "hf-gpt2",
})

# the reference's other pst-generate flags, and where each is planned
UNPORTED_FLAGS = {
    **dict.fromkeys(("ckpt-dir", "avg-last"),
                    "sharded checkpoints (ROADMAP.md Queue 1, item 8, "
                    "train_loop: checkpoint/sharded.py)"),
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
    require_flag_value(argv, "--lora-alpha", "--draft-lora-alpha",
                       "--draft-cost-ratio",
                       hint="the ALPHA the run trained with")
    require_flag_value(argv, "--device", hint="cuda or cpu")
    for name in ("quant", "kv-cache"):
        if flags.get(name, "int8") != "int8":
            raise SystemExit(f"--{name} takes int8, got {flags[name]!r}")


def draft_cost_ratio(flags: dict, draft, model) -> float:
    """--draft-cost-ratio if given, else the parameter-count proxy the
    adaptive depth controller's cost model defaults to (a token's decode
    cost tracks the parameters).  Shared by generate_main and serve_main
    so the default cannot drift."""
    if "draft-cost-ratio" in flags:
        return float(flags["draft-cost-ratio"])
    return max(0.05, draft.num_params() / model.num_params())


def draft_ckpt_flags(path: str, lora_alpha: str = "") -> dict:
    """--draft-ckpt takes either checkpoint form: a host checkpoint file,
    or a sharded checkpoint directory (not ported: refused by
    :func:`load_params`), dispatched by what the path is into the flag
    load_params reads.  ``lora_alpha`` (--draft-lora-alpha: a draft may
    be LoRA-trained with another alpha than the target) goes with it."""
    out = {"ckpt-dir": path} if os.path.isdir(path) else {"ckpt": path}
    if lora_alpha:
        out["lora-alpha"] = lora_alpha
    return out


def _merge_if_lora(store: dict, flags: dict, what: str,
                   lora_flag: str = "--lora-alpha"):
    """A checkpoint of a LoRA run carries adapter entries: fold them into
    dense weights.  alpha must match training (it scales the adapters),
    so it is demanded rather than defaulted; ``lora_flag`` names the flag
    that feeds it (--draft-lora-alpha for a draft checkpoint)."""
    import torch

    from ..models.lora import lora_names, merge_lora

    if not lora_names(store):
        return store, what
    if not flags.get("lora-alpha"):
        raise SystemExit(
            f"{what} contains LoRA adapters; pass {lora_flag}=A (the ALPHA "
            f"the run trained with, e.g. --lora=8:16 -> 16) to merge them "
            f"for serving")
    alpha = float(flags["lora-alpha"])
    merged = merge_lora({k: torch.from_numpy(v) for k, v in store.items()},
                        alpha=alpha)
    return ({k: v.numpy() for k, v in merged.items()},
            f"{what} (LoRA merged, alpha {alpha:g})")


def load_params(flags: dict, model, seed: int, device,
                lora_flag: str = "--lora-alpha"):
    """(params on ``device``, description): ``--ckpt`` through the port's
    checkpoint codec, converted to the model's dtype and layout, or a
    fresh init from ``seed``.  ``lora_flag`` names the alpha flag in a
    merge error."""
    if flags.get("ckpt-dir"):
        raise SystemExit(f"a sharded checkpoint directory "
                         f"({flags['ckpt-dir']}) is not ported yet: "
                         f"{UNPORTED_FLAGS['ckpt-dir']}")
    if flags.get("ckpt"):
        import numpy as np

        from ..checkpoint import codec
        from ..models.convert import params_from_numpy

        _, iteration, store = codec.load(flags["ckpt"])
        store, what = _merge_if_lora(
            {k: np.asarray(v) for k, v in store.items()}, flags,
            f"host checkpoint {flags['ckpt']} (iter {iteration})",
            lora_flag)
        return params_from_numpy(store, model.config, device=device), what
    return (model.init_params(seed, device=device),
            f"fresh init (seed {seed})")


def load_hf(flags: dict, device):
    """--hf-gpt2=<local dir or cached hub name>: convert a
    ``transformers`` GPT-2 checkpoint (models/hf.py) in ``--dtype``
    (default f32) onto ``device``, with its own tokenizer where its files
    exist.  Returns (model, params, tokenizer or None).  ``transformers``
    is imported here only: nothing else of the port needs it."""
    import torch
    import transformers

    from ..models.hf import from_hf_gpt2
    from ..models.registry import resolve_dtype

    src = flags["hf-gpt2"]
    hf_model = transformers.GPT2LMHeadModel.from_pretrained(src)
    dtype_flag = flags.get("dtype", "")
    dtype = resolve_dtype(dtype_flag) if dtype_flag else torch.float32
    model, params = from_hf_gpt2(
        hf_model, dtype=dtype, scan_layers=("scan-layers" in flags),
        device=device)
    try:
        tok = transformers.AutoTokenizer.from_pretrained(src)
    except Exception:  # noqa: BLE001 — tokenizer files may be absent
        tok = None
    return model, params, tok


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


def build_draft(flags: dict, seed: int, device):
    """The ``--draft-model`` registry LM (in ``--dtype``, the default
    layer layout) and its params from ``--draft-ckpt`` (merged with
    ``--draft-lora-alpha``) or ``--draft-seed`` (default seed + 1):
    (draft, params, description)."""
    from ..models.registry import get_model

    name = flags["draft-model"]
    draft = get_model(name, dtype=flags.get("dtype", ""))
    if not hasattr(draft.config, "vocab"):
        raise ValueError(f"--draft-model={name!r} is not an LM")
    dparams, source = load_params(
        draft_ckpt_flags(flags.get("draft-ckpt", ""),
                         flags.get("draft-lora-alpha", "")), draft,
        int(flags.get("draft-seed", seed + 1)), device,
        lora_flag="--draft-lora-alpha")
    return draft, match_layout(draft, dparams), source


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
    from ..models import generation
    from ..models.quant import quantize_params

    device = resolve_device(flags.get("device"))
    seed = int(flags.get("seed", 0))
    hf_tok = None
    if flags.get("hf-gpt2"):
        if flags.get("ckpt"):
            raise ValueError("--hf-gpt2 provides its own weights; it does "
                             "not combine with --ckpt/--ckpt-dir")
        model, params, hf_tok = load_hf(flags, device)
        source = (f"HF GPT-2 checkpoint {flags['hf-gpt2']} "
                  f"({model.num_params() / 1e6:.1f}M params)")
    else:
        model = build_model(flags)
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
    elif hf_tok is not None:
        ids = hf_tok.encode(flags.get("prompt", "hello"))
        decode_text = True
    elif flags.get("hf-gpt2"):
        raise ValueError("--hf-gpt2 checkpoint has no tokenizer files; "
                         "pass raw ids via --tokens=1,2,3")
    else:
        require_vocab(model.config.vocab, tokenizer)
        ids = tokenizer.encode(flags.get("prompt", "hello")) or [
            tokenizer.BOS]
        decode_text = True
    eos_id = hf_tok.eos_token_id if hf_tok is not None else tokenizer.EOS
    top_k = int(flags.get("top-k", 0))
    top_p = float(flags.get("top-p", 0.0))
    beam = int(flags.get("beam", 0))
    # sampling flags imply sampling: temperature 0 (greedy) would silently
    # ignore top-k/top-p, so they default the temperature to 1.0
    temperature = float(flags.get("temperature",
                                  "1.0" if (top_k or top_p) else "0.0"))
    prompt = np.asarray([ids], np.int32)
    max_new = int(flags.get("max-new", 64))
    cache_dtype = "int8" if flags.get("kv-cache") else "native"
    if beam <= 1 and "length-penalty" in flags:
        raise ValueError("--length-penalty applies to beam search; "
                         "pass --beam=W > 1")
    if flags.get("draft-model"):
        if beam > 1 or top_k or top_p:
            raise ValueError("--draft-model (speculative decoding) "
                             "supports greedy (default) or plain "
                             "--temperature sampling; it does not combine "
                             "with --beam/--top-k/--top-p")
        draft, dparams, dsource = build_draft(flags, seed, device)
        if flags.get("quant"):
            dparams = quantize_params(dparams)
            dsource += " (int8 weights)"
        print(f"draft params: {dsource}", file=sys.stderr)
        # --adaptive-draft: --draft-len becomes the cap; the first call
        # calibrates (a one-shot call pays for it, so fixed depth is the
        # default here)
        adaptive = "adaptive-draft" in flags
        out, stats = generation.speculative_generate_batched(
            model, params, draft, dparams, prompt, max_new,
            draft_len=int(flags.get("draft-len", 4)),
            temperature=temperature, seed=seed, cache_dtype=cache_dtype,
            adaptive=adaptive,
            draft_cost_ratio=draft_cost_ratio(flags, draft, model),
            device=device)
        depth_note = (f", settled depth {stats['draft_depth']}"
                      if adaptive else "")
        print(f"speculative: {stats['tokens_per_target_forward']:.2f} "
              f"tokens/target-forward (incl. prefill), accept rate "
              f"{stats['draft_accept_rate']:.2f}{depth_note}",
              file=sys.stderr)
    elif beam > 1:
        if top_k or top_p or "temperature" in flags:
            raise ValueError("--beam is deterministic; it does not combine "
                             "with --temperature/--top-k/--top-p")
        if cache_dtype != "native":
            raise ValueError("--beam runs on the native cache; it does not "
                             "combine with --kv-cache=int8")
        # text mode: the tokenizer's EOS finishes beams early; raw-token
        # mode has no reserved stop id
        out, score = generation.beam_search(
            model, params, prompt, max_new, beam_width=beam,
            eos_id=eos_id if decode_text else None,
            length_penalty=float(flags.get("length-penalty", 0.0)),
            device=device)
        print(f"beam: width {beam}, joint logprob {float(score[0]):.3f}",
              file=sys.stderr)
    else:
        out = generation.generate(
            model, params, prompt, max_new, temperature=temperature,
            top_k=top_k, top_p=top_p, rng=seed, cache_dtype=cache_dtype,
            device=device)
    tokens = out[0].cpu().numpy()
    if decode_text:
        stop = np.nonzero(tokens == eos_id)[0]
        if stop.size:      # trim at the first EOS (beam padding or natural)
            tokens = tokens[:int(stop[0])]
        print(hf_tok.decode(tokens) if hf_tok is not None
              else tokenizer.decode(tokens), flush=True)
    else:
        print(",".join(str(int(t)) for t in tokens), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
