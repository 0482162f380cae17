"""Continuous-batching serving process over the port's DecodeServer.

    python -m parameter_server_distributed_tpu_torch.cli.serve_main \\
        --model=llama_350m [--dtype=bf16] [--seed=0] [--slots=8] \\
        [--max-len=2048] [--temperature=0.8 --top-k=40 --top-p=0.9] \\
        [--eos=ID] [--default-max-new=64] [--device=cuda|cpu]

Weights are fresh from ``--seed``.  The model runs on the CUDA card unless
``--device=cpu`` asks for the CPU; with no card and no such request it
exits with an error.  ``PSDT_FLASH_ATTENTION=1`` routes prefill attention
through the flash kernel.

Line protocol (JSONL on stdin/stdout), as the reference's pst-serve:

    -> {"id": 1, "prompt": "hello"}             # or "tokens": [1,2,3]
    -> {"id": 2, "tokens": [5,6], "max_new": 32}
    -> {"id": 4, "prompt": "hi", "temperature": 0.7, "stop": [13]}
    <- {"id": 1, "token": 42}                   # streamed as decoded
    <- {"id": 1, "done": true, "text": "..."}   # or "tokens": [...]
    <- {"id": 3, "error": "..."}                # bad request

Requests are admitted the moment a slot frees; stdin close drains the
in-flight work and exits.
"""

from __future__ import annotations

import json
import queue
import sys
import threading

from ..config import parse_argv, require_flag_value

KNOWN_FLAGS = frozenset({
    "model", "dtype", "seed", "slots", "max-len", "temperature", "top-k",
    "top-p", "eos", "default-max-new", "device", "help",
})

# the reference's other pst-serve flags, and where each is planned
UNPORTED_FLAGS = {
    **dict.fromkeys(("ckpt", "ckpt-dir", "avg-last"),
                    "checkpoint loading (ROADMAP.md Queue 1, serving: "
                    "cli/serve_main.py and cli/generate_main.py)"),
    **dict.fromkeys(("scan-layers", "no-scan-layers"),
                    "the scanned layout flag (ROADMAP.md Queue 1, serving: "
                    "cli/serve_main.py)"),
    "hf-gpt2": "HF conversion (ROADMAP.md Queue 1, other model families: "
               "hf.py)",
    "quant": "int8 weights (ROADMAP.md Queue 1, serving: models/quant.py)",
    "kv-cache": "the int8 KV cache (ROADMAP.md Queue 1, serving)",
    **dict.fromkeys(("lora-alpha", "draft-lora-alpha"),
                    "LoRA merging (ROADMAP.md Queue 1, serving: "
                    "models/lora.py)"),
    "prompt-cache": "the radix prefix cache (ROADMAP.md Queue 1, serving)",
    **dict.fromkeys(("draft-model", "draft-ckpt", "draft-seed", "draft-len",
                     "no-adaptive-draft", "draft-cost-ratio"),
                    "speculative decoding (ROADMAP.md Queue 1, serving)"),
    "fused-rounds": "fused decode rounds in the CLI (ROADMAP.md Queue 1, "
                    "serving: cli/serve_main.py)",
    **dict.fromkeys(("follow", "subscriber-id"),
                    "live weight publication (ROADMAP.md Queue 1, serving: "
                    "fleet/decode.py)"),
    **dict.fromkeys(("serve-port", "coordinator", "server-id"),
                    "decode fleet mode (ROADMAP.md Queue 1, serving: "
                    "fleet/decode.py)"),
}


def _reader(out_q: "queue.Queue[tuple | None]") -> None:
    """stdin -> request queue as typed items — ("req", dict) or ("err",
    message) — with None marking end of input."""
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as exc:
            out_q.put(("err", str(exc)))
            continue
        if not isinstance(obj, dict):
            out_q.put(("err",
                       f"request must be a JSON object, got {line[:80]!r}"))
            continue
        out_q.put(("req", obj))
    out_q.put(None)


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    _, flags = parse_argv(argv)
    if "help" in flags:
        print(__doc__)
        return 0
    require_flag_value(argv, "--device", hint="cuda or cpu")
    unported = sorted(set(flags) & set(UNPORTED_FLAGS))
    if unported:
        raise SystemExit("; ".join(f"--{name} is not ported yet: "
                                   f"{UNPORTED_FLAGS[name]}"
                                   for name in unported))
    unknown = set(flags) - KNOWN_FLAGS
    if unknown:
        raise SystemExit(f"unknown flag(s): {', '.join(sorted(unknown))}; "
                         f"--help lists the accepted flags")

    from ..data.text import ByteTokenizer, require_vocab
    from ..device import resolve_device
    from ..models.registry import get_model
    from ..models.serving import DecodeServer

    device = resolve_device(flags.get("device"))
    name = flags.get("model", "small_lm")
    model = get_model(name, dtype=flags.get("dtype", ""))
    if not hasattr(model.config, "vocab"):
        raise SystemExit(f"--model={name}: serving takes a language model")
    seed = int(flags.get("seed", 0))
    params = model.init_params(seed, device=device)
    print(f"serving: {name} fresh weights from seed {seed} on {device}",
          file=sys.stderr)
    tokenizer = ByteTokenizer()
    eos = int(flags["eos"]) if flags.get("eos") else None
    srv = DecodeServer(
        model, params,
        slots=int(flags.get("slots", "8")),
        max_len=int(flags.get("max-len", "2048")),
        temperature=float(flags.get("temperature", "0.0")),
        top_k=int(flags.get("top-k", "0")),
        top_p=float(flags.get("top-p", "0.0")),
        eos_id=eos, seed=seed, device=device)
    default_max_new = int(flags.get("default-max-new", "64"))

    in_q: "queue.Queue[tuple | None]" = queue.Queue()
    threading.Thread(target=_reader, args=(in_q,), daemon=True,
                     name="serve-stdin").start()

    pending: list[dict] = []          # parsed, awaiting a free slot
    live: dict[int, dict] = {}        # request_id -> request (slot-held)
    text_mode: dict[int, bool] = {}
    eof = False

    def finish(req: dict, tokens: list[int], is_text: bool) -> None:
        done: dict = {"id": req.get("id"), "done": True}
        if is_text:
            # the terminator (global eos or a per-request stop token) is
            # metadata, not content: trim it from the decoded text
            enders = {int(t) for t in req.get("stop") or ()}
            if eos is not None:
                enders.add(eos)
            cut = [i for i, t in enumerate(tokens) if t in enders]
            done["text"] = tokenizer.decode(tokens[:cut[0]] if cut
                                            else tokens)
        else:
            done["tokens"] = tokens
        _emit(done)

    def finish_run() -> int:
        print(f"serving stats: {json.dumps(srv.stats)}", file=sys.stderr)
        return 0

    def admit() -> None:
        while pending and srv.has_free_slot:
            req = pending.pop(0)
            rid_key = req.get("id")
            try:
                if "tokens" in req:
                    ids = [int(t) for t in req["tokens"]]
                    is_text = False
                elif "prompt" in req:
                    require_vocab(model.config.vocab, tokenizer)
                    ids = tokenizer.encode(req["prompt"]) or [tokenizer.BOS]
                    is_text = True
                else:
                    raise ValueError("request needs 'prompt' or 'tokens'")
                temp = req.get("temperature")
                stop_field = req.get("stop", [])
                if not isinstance(stop_field, list):
                    # a JSON string would silently iterate per character
                    raise ValueError("'stop' must be an array of token ids")
                rid = srv.submit(
                    ids, int(req.get("max_new", default_max_new)),
                    temperature=None if temp is None else float(temp),
                    stop=[int(t) for t in stop_field])
            except (ValueError, TypeError, KeyError) as exc:
                # a malformed request becomes a per-request error and
                # never kills the other in-flight work
                _emit({"id": rid_key, "error": str(exc)})
                continue
            if rid in srv.finished():
                # max_new=1 (or instant EOS): the prefill token already
                # completed the request inside submit()
                tokens = srv.result(rid)
                for t in tokens:
                    _emit({"id": rid_key, "token": int(t)})
                finish(req, tokens, is_text)
                continue
            # the prefill produced the first token: stream it now
            _emit({"id": rid_key, "token": int(srv.peek(rid)[0])})
            live[rid] = req
            text_mode[rid] = is_text

    while True:
        # drain whatever arrived on stdin without blocking the decode loop
        try:
            while True:
                item = in_q.get_nowait()
                if item is None:
                    eof = True
                    break
                tag, payload = item
                if tag == "err":
                    _emit({"error": payload})
                else:
                    pending.append(payload)
        except queue.Empty:
            pass
        admit()
        if srv.idle:
            if eof and not pending:
                return finish_run()
            if not pending:
                # nothing in flight: block for the next request (or EOF)
                item = in_q.get()
                if item is None:
                    return finish_run()
                tag, payload = item
                if tag == "err":
                    _emit({"error": payload})
                else:
                    pending.append(payload)
                continue
        emitted = srv.step()
        done_now = set(srv.finished())
        for rid, token in emitted:
            _emit({"id": live[rid].get("id"), "token": int(token)})
        for rid in done_now & set(live):
            finish(live[rid], srv.result(rid), text_mode[rid])
            del live[rid], text_mode[rid]


if __name__ == "__main__":
    sys.exit(main())
