"""The int8 serving kernels of another ``int8_serve.cu`` against this
checkout's, on one card in one process, in turns (other, this, this,
other):

- K5 (``int8_wdot``): the device time of a call with a cold L2
  (``chip_smoke.cold_ms``) and the eager event time, at every llama_350m
  product (``chip_smoke.INT8_WDOT_SHAPES``) and row count
  (``chip_smoke.INT8_WDOT_ROWS``), bf16 x;
- K6 (``decode_attention_int8``) at a decode round, at the extension
  shape and at a long cache's decode round, and K7 (``kv_quantize``) at
  a prefill stack and a decode round's write, as
  ``chip_smoke.time_int8_attention`` and ``chip_smoke.time_kv_quantize``
  time them (device time in a CUDA graph, K6 and the prefill stack with
  a cold L2; eager time; host time a call);
- the int8 serving burst of ``chip_smoke.serve_int8`` (llama_350m, int8
  weights and cache, 8 slots, the same 8 prompts), ``--bursts`` times
  (default 2) over the four turns: TTFT, tokens/s, the rounds' gaps, the
  host time spent inside K5's C entry point (``psdt_int8_wdot``: the
  launcher and the launch) in each prefill and each round, and one
  profiled request (8 new tokens): the device busy share and the kernel
  time by group, as ``chip_smoke.serve_int8``'s ``profile_int8`` phase
  takes them.

Usage, with the other source's headers beside it::

    git show PARENT:parameter_server_distributed_tpu_torch/csrc/int8_serve.cu \\
        > build/other/int8_serve.cu
    cp parameter_server_distributed_tpu_torch/csrc/*.cuh \\
       parameter_server_distributed_tpu_torch/csrc/*.h build/other/
    python3 k5_compare.py build/other/int8_serve.cu \\
        [--phases=k5,k6k7,burst] [--bursts=2] \\
        [--k6-shapes=decode,extend,long]

``--phases`` picks the phases above (all by default); ``--k6-shapes``
picks K6's shapes (leave out "long" for a source whose K6 takes no long
cache).  The other source is built with this checkout's nvcc flags into
build/.  Every result is one JSON line on stdout.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from parameter_server_distributed_tpu_torch.ops import build
from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

TURNS = ("other", "this", "this", "other")


class TimedLib:
    """A K5 library whose ``psdt_int8_wdot`` adds its host time to
    ``seconds``; every other entry point passes through."""

    def __init__(self, lib):
        self.lib, self.seconds = lib, 0.0

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def psdt_int8_wdot(self, *args):
        t0 = time.perf_counter()
        err = self.lib.psdt_int8_wdot(*args)
        self.seconds += time.perf_counter() - t0
        return err


def load_other(source: str, ours) -> ctypes.CDLL:
    out = os.path.join(build.BUILD_DIR, "libint8_serve-other.so")
    subprocess.run([build.nvcc(), *build.flags("int8_serve"), "-o", out,
                    source], check=True, timeout=600)
    lib = ctypes.CDLL(out)
    for name in ("psdt_int8_wdot", "psdt_decode_attention_int8",
                 "psdt_kv_quantize"):
        fn, mine = getattr(lib, name), getattr(ours, name)
        fn.argtypes, fn.restype = mine.argtypes, mine.restype
    return lib


def device_times(libs: dict) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, n in cs.INT8_WDOT_SHAPES:
        q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
        for m in cs.INT8_WDOT_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            ms, eager = {}, {}
            for turn, name in enumerate(TURNS):
                i8._LIB = libs[name]
                ms[f"{name}_{turn}"] = cs.cold_ms(
                    torch, lambda c: i8.int8_wdot(x, c, scale), q)
                eager[f"{name}_{turn}"] = cs.cuda_ms(
                    torch, lambda: i8.int8_wdot(x, q, scale))
            cs.emit({"phase": "k5_device", "shape": f"{m}x{k}x{n}",
                     "ms": ms, "eager_ms": eager})
        del q, scale
    torch.cuda.empty_cache()


def attention_times(libs: dict, shapes: tuple) -> None:
    """K6 at ``shapes`` and K7 at its serving shapes, each library in
    turns."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    inp = cs.int8_attention_inputs(torch, np, gen)
    for turn, name in enumerate(TURNS):
        i8._LIB = libs[name]
        cs.emit({"phase": "k6_k7_device", "lib": name, "turn": turn,
                 "decode_attention_int8": cs.time_int8_attention(
                     torch, i8, inp, shapes),
                 "kv_quantize": cs.time_kv_quantize(torch, i8, inp)})
    del inp
    torch.cuda.empty_cache()


def burst(model, params, lib: TimedLib, prompts) -> dict:
    """serve_int8's burst on ``lib``: TTFT, gaps, tokens/s, and K5's host
    time in each prefill and round; then one profiled request."""
    from parameter_server_distributed_tpu_torch.models import serving

    i8._LIB = lib
    srv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                               cache_dtype="int8", device="cuda")
    for n in sorted({min(serving._bucket(n), 2048) for n in cs.PROMPT_LENS}):
        srv.submit((prompts[0] * (n // len(prompts[0]) + 1))[:n - 2],
                   max_new_tokens=2)
        srv.run_to_completion()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, prefill_ms, prefill_k5_ms, gaps, round_k5_ms, rids = \
        [], [], [], [], [], []
    for p in prompts:
        lib.seconds = 0.0
        t1 = time.perf_counter()
        rids.append(srv.submit(p, max_new_tokens=cs.NEW_TOKENS))
        t2 = time.perf_counter()
        ttft.append(t2 - t0)
        prefill_ms.append(1e3 * (t2 - t1))
        prefill_k5_ms.append(1e3 * lib.seconds)
    while not srv.idle:
        lib.seconds = 0.0
        t1 = time.perf_counter()
        srv.step()
        gaps.append(1e3 * (time.perf_counter() - t1))
        round_k5_ms.append(1e3 * lib.seconds)
    results = srv.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def one_request():
        srv.submit(prompts[-1], max_new_tokens=8)
        srv.run_to_completion()

    prof = cs.profile_window(torch, one_request, cs.INT8_PROFILE_GROUPS)
    del srv
    torch.cuda.empty_cache()
    return {"ttft_p50_s": float(np.median(ttft)),
            "tokens_per_s": sum(len(results[r]) for r in rids) / wall,
            "gap_p50_ms": float(np.median(gaps)), "gap_max_ms": max(gaps),
            "prefill_ms": prefill_ms, "prefill_k5_host_ms": prefill_k5_ms,
            "round_k5_host_ms_p50": float(np.median(round_k5_ms)),
            "rounds": len(gaps),
            "profile": {key: prof[key] for key in (
                "window_s", "kernel_ms", "device_busy_share", "group_ms",
                "trace")}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other")
    parser.add_argument("--phases", default="k5,k6k7,burst")
    parser.add_argument("--bursts", type=int, default=2)
    parser.add_argument("--k6-shapes", default="decode,extend,long")
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available() or not phases <= {"k5", "k6k7",
                                                       "burst"}:
        print(__doc__, file=sys.stderr)
        return 2
    os.environ["PSDT_FLASH_ATTENTION"] = "1"
    cs.emit({"phase": "device", "nvidia_smi": cs.nvidia_smi()})
    ours = i8._lib()
    libs = {"other": load_other(args.other, ours), "this": ours}
    with torch.inference_mode():
        if "k5" in phases:
            device_times(libs)
        if "k6k7" in phases:
            attention_times(libs, tuple(args.k6_shapes.split(",")))
    if "burst" not in phases:
        return 0
    from parameter_server_distributed_tpu_torch.models.quant import \
        quantize_params
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    model = get_model("llama_350m", dtype="bf16")
    params = quantize_params(model.init_params(0, device="cuda"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab, n).tolist()
               for n in cs.PROMPT_LENS]
    timed = {name: TimedLib(lib) for name, lib in libs.items()}
    for turn, name in enumerate(TURNS * args.bursts):
        cs.emit({"phase": "k5_burst", "lib": name, "turn": turn,
                 **burst(model, params, timed[name], prompts)})
    i8._LIB = ours
    return 0


if __name__ == "__main__":
    sys.exit(main())
