"""Continuous-batching serving process over the port's DecodeServer.

    python -m parameter_server_distributed_tpu_torch.cli.serve_main \\
        --model=llama_350m [--dtype=bf16] [--seed=0] [--slots=8] \\
        [--max-len=2048] [--temperature=0.8 --top-k=40 --top-p=0.9] \\
        [--eos=ID] [--default-max-new=64] [--device=cuda|cpu] \\
        [--ckpt=path.ckpt [--lora-alpha=A] | --hf-gpt2=<checkout>] \\
        [--scan-layers | --no-scan-layers] \\
        [--quant=int8] [--kv-cache=int8] \\
        [--prompt-cache=N]   # the radix prefix cache: repeated prompts
                             # skip the prefill, shared prefixes forward
                             # only their suffix (PSDT_PREFIX_CACHE_BYTES)
        [--fused-rounds=N]   # up to N decode rounds per host decision
                             # when no request waits (token-exact)
        [--draft-model=tiny_lm [--draft-ckpt=path.ckpt \\
         [--draft-lora-alpha=A]] [--draft-seed=S] [--draft-len=4] \\
         [--no-adaptive-draft] [--draft-cost-ratio=R]]
                             # speculative serving: --draft-len is the
                             # depth cap, adapted from the accept rate
                             # unless --no-adaptive-draft pins it
        [--serve-port=P [--coordinator=HOST:PORT] [--server-id=N]]
                             # decode fleet mode (gRPC, below)
        [--follow=HOST:PORT [--subscriber-id=N]]
                             # live weights from a training PS (below)
        [--report=PATH]      # exit report (cli/exit_report.py)

Weights come from ``--ckpt`` (the host checkpoint format the PS writes;
a LoRA run's adapters are merged with ``--lora-alpha``), from a
``transformers`` GPT-2 checkpoint converted with ``--hf-gpt2`` (model
and weights; text prompts through its own tokenizer when it ships one,
whose EOS then ends a request unless ``--eos`` is given) or fresh from
``--seed``.  ``--quant=int8`` quantizes them (models/quant.py) and
``--kv-cache=int8`` the slot cache.  ``--follow`` subscribes to a
training PS (delta/subscriber.py ``WeightFollower``, ``SubscribeWeights``
on the port's or the JAX package's PS) and hot-swaps each new weight
version between decode rounds: the follower's host float32 store goes
to the card in the server's dtype through one pinned copy
(models/convert.py ``StoreUploader``), then through the ``--quant``
quantizer, as the boot weights do.  A feed that fails degrades to the
last good weights; the server never stops for it.  The model runs on
the CUDA card
unless ``--device=cpu`` asks for the CPU; with no card and no such
request it exits with an error.  ``PSDT_FLASH_ATTENTION=1`` routes
prefill attention through the flash kernel.  With ``--draft-model``
each decode round is a speculative round (greedy or plain
``--temperature``; a request may get several tokens a round, each
streamed as its own line).

Line protocol (JSONL on stdin/stdout), as the reference's pst-serve:

    -> {"id": 1, "prompt": "hello"}             # or "tokens": [1,2,3]
    -> {"id": 2, "tokens": [5,6], "max_new": 32}
    -> {"id": 4, "prompt": "hi", "temperature": 0.7, "stop": [13]}
    <- {"id": 1, "token": 42}                   # streamed as decoded
    <- {"id": 1, "done": true, "text": "..."}   # or "tokens": [...]
    <- {"id": 3, "error": "..."}                # bad request

Requests are admitted the moment a slot frees; stdin close drains the
in-flight work and exits.

Decode fleet mode (``--serve-port`` or ``--coordinator``): the server
speaks the ``psdt_fleet.Decode`` gRPC service (fleet/decode.py) instead
of the line protocol, on ``--serve-port`` (0 asks for a free port; the
port is printed as ``decode fleet server ID on port P``), and with
``--coordinator`` registers as ``--server-id`` and heartbeats its load,
so ``cli.route_main`` routes streams to it.  Published weight versions
go through the same ``--quant`` transform as the boot weights.  SIGTERM
drains: the in-flight streams finish, the server leaves the fleet and
the process exits 0.  ``--report`` writes the kernel launch counts, the
server's stats and the streams served at exit, and with ``--follow``
the follower's versions, sessions and checksums and the server's swaps.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time

from ..config import parse_argv, require_flag_value
from . import generate_main

KNOWN_FLAGS = frozenset({
    "model", "dtype", "seed", "slots", "max-len", "temperature", "top-k",
    "top-p", "eos", "default-max-new", "device", "help", "ckpt",
    "lora-alpha", "quant", "kv-cache", "prompt-cache", "fused-rounds",
    "scan-layers", "no-scan-layers", "draft-model", "draft-ckpt",
    "draft-seed", "draft-len", "no-adaptive-draft", "draft-cost-ratio",
    "draft-lora-alpha", "serve-port", "coordinator", "server-id",
    "report", "follow", "subscriber-id", "hf-gpt2",
})

# the reference's other pst-serve flags, and where each is planned
UNPORTED_FLAGS = {
    **dict.fromkeys(("ckpt-dir", "avg-last"),
                    "sharded checkpoints (ROADMAP.md Queue 1, item 8, "
                    "train_loop: checkpoint/sharded.py)"),
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
    unported = sorted(set(flags) & set(UNPORTED_FLAGS))
    if unported:
        raise SystemExit("; ".join(f"--{name} is not ported yet: "
                                   f"{UNPORTED_FLAGS[name]}"
                                   for name in unported))
    unknown = set(flags) - KNOWN_FLAGS
    if unknown:
        raise SystemExit(f"unknown flag(s): {', '.join(sorted(unknown))}; "
                         f"--help lists the accepted flags")
    # bare --fused-rounds would parse as 1 and silently turn off what was
    # asked for
    require_flag_value(argv, "--fused-rounds",
                       hint="decode rounds per host decision, e.g. "
                            "--fused-rounds=8")
    # bare --serve-port parses as 1 and binds an arbitrary low port;
    # bare --coordinator would register against nothing
    require_flag_value(argv, "--serve-port", "--coordinator",
                       "--server-id", "--report",
                       hint="fleet mode, e.g. --serve-port=50070 "
                            "--coordinator=10.0.0.5:50052 --server-id=0")
    # bare --follow would serve the boot weights forever
    require_flag_value(argv, "--follow", "--subscriber-id",
                       hint="the training PS to track, e.g. "
                            "--follow=10.0.0.5:50051")
    generate_main.check_flags(argv, {k: v for k, v in flags.items()
                                     if k in generate_main.KNOWN_FLAGS})

    import os

    from ..data.text import ByteTokenizer, require_vocab
    from ..device import resolve_device
    from ..models.convert import StoreUploader
    from ..models.quant import quantize_params
    from ..models.serving import DecodeServer

    device = resolve_device(flags.get("device"))
    seed = int(flags.get("seed", 0))
    hf_tok = None
    if flags.get("hf-gpt2"):
        model, params, hf_tok = generate_main.load_hf(flags, device)
        source = f"HF GPT-2 checkpoint {flags['hf-gpt2']}"
    else:
        model = generate_main.build_model(flags)
        params, source = generate_main.load_params(flags, model, seed,
                                                   device)
        params = generate_main.match_layout(model, params)
        source = f"{flags.get('model', 'small_lm')} {source}"
    if flags.get("quant"):
        params = quantize_params(params)
        source += " (int8 weights)"
    print(f"serving: {source} on {device}", file=sys.stderr)
    spec_kwargs: dict = {}
    if flags.get("draft-model"):
        # speculative continuous batching, greedy or plain --temperature
        # (DecodeServer refuses top-k/top-p)
        draft, dparams, dsource = generate_main.build_draft(flags, seed,
                                                            device)
        if flags.get("quant"):
            dparams = quantize_params(dparams)
            dsource += " (int8 weights)"
        print(f"draft: {dsource}", file=sys.stderr)
        spec_kwargs = dict(
            draft=draft, draft_params=dparams,
            draft_len=int(flags.get("draft-len", "4")),
            # adaptive depth by default (--draft-len is the cap)
            adaptive_draft="no-adaptive-draft" not in flags,
            draft_cost_ratio=generate_main.draft_cost_ratio(flags, draft,
                                                            model))
    follower = None
    if flags.get("follow"):
        # live weight publication: every failure degrades to the last
        # good weights (delta/subscriber.py)
        from ..delta.subscriber import WeightFollower

        follower = WeightFollower(
            flags["follow"],
            subscriber_id=int(flags.get("subscriber-id",
                                        str(os.getpid() & 0x7FFF))))
        follower.start()
        print(f"following weights from {flags['follow']}",
              file=sys.stderr, flush=True)
    # one binding for both weight paths: a followed store goes to the
    # card in the model's dtype and layout, then quantizes as the boot
    # weights did
    upload = StoreUploader(model.config, device)

    def transform(store: dict) -> dict:
        params = upload(store)
        return quantize_params(params) if flags.get("quant") else params

    tokenizer = ByteTokenizer()
    eos = int(flags["eos"]) if flags.get("eos") else (
        hf_tok.eos_token_id if hf_tok is not None else None)
    srv = DecodeServer(
        model, params,
        slots=int(flags.get("slots", "8")),
        max_len=int(flags.get("max-len", "2048")),
        temperature=float(flags.get("temperature", "0.0")),
        top_k=int(flags.get("top-k", "0")),
        top_p=float(flags.get("top-p", "0.0")),
        eos_id=eos, seed=seed, device=device,
        cache_dtype="int8" if flags.get("kv-cache") else "native",
        prompt_cache=int(flags.get("prompt-cache", "0")), **spec_kwargs)
    default_max_new = int(flags.get("default-max-new", "64"))
    fused_rounds = int(flags.get("fused-rounds", "1"))

    def report(streams_served: int | None = None, swaps=None) -> None:
        if flags.get("report"):
            from .exit_report import write_exit_report
            extra = {}
            if follower is not None:
                extra["follower"] = follower_report(follower)
            if swaps is not None:
                extra["swaps"] = [list(s) for s in swaps]
            write_exit_report(flags["report"], "serve", stats=srv.stats,
                              streams_served=streams_served, **extra)

    def stop_follower() -> None:
        if follower is None:
            return
        follower.stop()
        if follower.degraded:
            print(f"weight follower degraded: {follower.degrade_reason} "
                  f"(kept serving version {srv.params_version})",
                  file=sys.stderr)

    if flags.get("serve-port") is not None or flags.get("coordinator"):
        try:
            return _serve_fleet(srv, flags, transform, follower, report)
        finally:
            stop_follower()

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
            trim = tokens[:cut[0]] if cut else tokens
            done["text"] = (hf_tok.decode(trim) if hf_tok is not None
                            else tokenizer.decode(trim))
        else:
            done["tokens"] = tokens
        _emit(done)

    swaps: list = []

    def finish_run() -> int:
        stop_follower()
        print(f"serving stats: {json.dumps(srv.stats)}", file=sys.stderr)
        report(swaps=swaps)
        return 0

    def maybe_swap() -> None:
        """Swap in the follower's newest version, between admissions; a
        bad publication keeps the last good weights."""
        if follower is None:
            return
        fresh = follower.poll()
        if fresh is None:
            return
        store, version = fresh
        try:
            srv.swap_params(transform(store), version=version)
        except Exception as exc:  # noqa: BLE001 — the serving boundary:
            # decoding goes on with the last good weights
            print(f"weight swap to version {version} failed ({exc}); "
                  f"keeping last-good weights", file=sys.stderr)
            return
        swaps.append((version, time.time()))
        print(f"weights: swapped to version {version}", file=sys.stderr)

    def admit() -> None:
        while pending and srv.has_free_slot:
            req = pending.pop(0)
            rid_key = req.get("id")
            try:
                if "tokens" in req:
                    ids = [int(t) for t in req["tokens"]]
                    is_text = False
                elif "prompt" in req:
                    if hf_tok is not None:
                        ids = hf_tok.encode(req["prompt"])
                    else:
                        require_vocab(model.config.vocab, tokenizer)
                        ids = (tokenizer.encode(req["prompt"])
                               or [tokenizer.BOS])
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
        # between admissions no round is in flight: the swap point
        maybe_swap()
        admit()
        if srv.idle:
            if eof and not pending:
                return finish_run()
            if not pending:
                # nothing in flight: block for the next request (or EOF);
                # a follower wakes it so versions swap in while idle
                try:
                    item = in_q.get(
                        timeout=0.5 if follower is not None else None)
                except queue.Empty:
                    continue
                if item is None:
                    return finish_run()
                tag, payload = item
                if tag == "err":
                    _emit({"error": payload})
                else:
                    pending.append(payload)
                continue
        # fuse rounds only when nothing waits for a slot: a pending
        # request gets the next admission opportunity
        emitted = (srv.step_many(fused_rounds)
                   if fused_rounds > 1 and not pending else srv.step())
        done_now = set(srv.finished())
        # stream every token before retiring finished requests: a
        # speculative round can emit several tokens for one request, and
        # its finishing token need not be its last pair
        for rid, token in emitted:
            _emit({"id": live[rid].get("id"), "token": int(token)})
        for rid in done_now & set(live):
            finish(live[rid], srv.result(rid), text_mode[rid])
            del live[rid], text_mode[rid]


def follower_report(follower) -> dict:
    """A weight follower's state for the exit report."""
    return {"target": follower.target, "version": follower.version,
            "versions_received": follower.versions_received,
            "versions_consumed": follower.versions_consumed,
            "sessions": follower.sessions, "degraded": follower.degraded,
            "degrade_reason": follower.degrade_reason,
            "history": [list(h) for h in follower.history]}


def _serve_fleet(srv, flags: dict, transform, follower, report) -> int:
    """Decode fleet mode: serve ``srv`` over gRPC until SIGTERM (or
    Ctrl-C) drains it; returns the exit code."""
    import signal

    from ..fleet.decode import FleetDecodeServer

    fds = FleetDecodeServer(
        srv, server_id=int(flags.get("server-id", "0")),
        port=int(flags.get("serve-port", "0")),
        coordinator=flags.get("coordinator") or None,
        follower=follower,
        # boot weights and every published version quantize alike
        transform=transform)
    port = fds.start()
    print(f"decode fleet server {fds.server_id} on port {port}"
          + (f", registered with {flags['coordinator']}"
             if flags.get("coordinator") else " (standalone)"),
          file=sys.stderr, flush=True)
    # SIGTERM drains: the in-flight streams finish, then the server
    # leaves the fleet (the scale-in path)
    signal.signal(signal.SIGTERM, lambda *_: fds.drain())
    try:
        while not fds.wait_drained(0.5):
            pass
    except KeyboardInterrupt:
        fds.drain()
        fds.wait_drained(10.0)
    fds.stop()
    print(f"serving stats: {json.dumps(srv.stats)}", file=sys.stderr)
    report(fds.streams_served, fds.swaps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
