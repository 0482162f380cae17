"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, all at once; the build phase counts each kernel's
tensor-core instructions in its SASS), holds each kernel against its plain
PyTorch version on the card and times it beside its bound and a library
yardstick (the device close's four, csrc/device_apply.cu, byte for byte
at the llama_350m store's shapes under all five rules), then drives the
two paths of the port:

- serving: a full-width llama_350m DecodeServer (bf16, 8 slots, max_len
  2048, flash prefill, random weights from a seed) answering 8 requests,
  and the serve_main CLI answering 2 JSONL requests;
- int8 serving (serve_int8): the same store through quantize_params on a
  DecodeServer with the int8 KV cache, the same 8 requests, the three
  int8 kernels of csrc/int8_serve.cu (K5 int8_wdot, K6
  decode_attention_int8, K7 kv_quantize; checked first against their
  plain versions at the llama_350m shapes, K7 byte for byte) launched as
  the design counts; then the radix prefix cache (a 1024-token prefix, 8
  extensions of it, an exact resubmission), a 2-layer f32 model's int8
  streams token-exact against generate, and serve_main and
  generate_main with --quant=int8 --kv-cache=int8 as processes;
- speculative serving (serve_spec): K5-K7 first held against their plain
  versions at the shapes a speculative round gives them (K5 at 16 and 40
  rows, K6 and K7 at a ragged verify block of 5 queries, writes past the
  cache dropped); then the same burst on speculative DecodeServers in
  three legs (llama_350m drafting for itself at k = 4, a random 2-layer
  draft under the adaptive depth controller, the self-draft with int8
  weights and cache), each in turns with plain decode and its launches
  held to the design's counts; beam search at width 4; a 2-layer f32
  model's speculative streams token-exact against generate (both cache
  dtypes, the prefix cache) and beam width 1 equal to greedy; serve_main
  --draft-model and generate_main --beam as processes;
- the decode fleet: fleet_wire runs cli.coordinator_main, two
  cli.serve_main processes in fleet mode (llama_350m bf16, the prefix
  cache) and cli.route_main on the card, this process the client
  through the router, at the default fingerprint cap: a shared prefix's
  8 extensions all on its holder, a 16-stream burst on two servers at
  rest and one right after it, 8 on each, ctl_main fleet-drain 1
  mid-burst (server 1 finishes, shows GONE, exits 0), the burst again on
  the fleet of one, each server's flash launches from its exit report;
  fleet_update runs two in-process FleetDecodeServers (int8 weights and
  cache, quantize_params as their transform) behind a Coordinator and
  FleetRouter: a rolling update mid-burst (version stamps 0...0 1...1,
  no stream dropped), a rollback pin, a drifted store refused, K5-K7
  launches exact, a 2-layer f32 fleet token-exact against generate;
- live weight publication (delta_follow): cli.ps_main (llama_350m, the
  device close), cli.coordinator_main and one cli.worker_main training,
  and cli.serve_main --follow (int8 weights and cache) hot-swapping
  every version the PS publishes while a burst of 8 streams runs; every
  followed version's crc the PS's, the last one byte for byte a full
  bf16 pull (a second follower in this process), no stream broken;
- training: full-width llama_350m (bf16, remat "full", loss_chunk 128,
  flash attention, weights from a seed) taking 5 Trainer.compute_gradients
  -> PallasOptimizer("adam").apply steps on one batch of 8 x 1024 random
  tokens, then one sgd and one momentum apply over the same store; then
  the same 5 steps with dense attention, whose losses stand beside the
  kernels' (the first must agree within 1e-3);
- the parameter-server round: CoordinatorCore and ParameterServerCore
  (make_optimizer("pallas_adam")) driving two llama_350m workers through
  2 synchronous rounds (serve -> gradient step -> push; the second push
  closes the barrier), the round-1 params held against the plain Adam
  update, one pallas_sgd and one pallas_momentum apply through a core,
  and a CheckpointManager save / load / resume that must be bit-exact;
- the PS's close on the card in process (ps_device_round): the same two
  workers for 3 rounds, their pushes encoded for the wire (f32; bf16 and
  int8; top-k and raw f32) and fed to three cores at 8 stripes, host
  numpy adam, sharded_adam under PSDT_DEVICE_APPLY=1 and the same with
  PSDT_ARENA=1, whose stores must be byte-identical after every round,
  with the device close's launches as its design gives them and no
  fallback;
- mixture-of-experts and the Hugging Face conversion, each phase alone
  on an emptied card: moe_serve (moe_350m, 1,072,317,440 parameters,
  bf16, serve's 8 prompts on a DecodeServer, flash launches 24 a
  prefill, its burst in turns with a llama_350m server's and each
  model's profiled request, a decode round's host syncs equal to
  llama_350m's, float32 streams at bucket-sized prompts token-exact
  against generate, prefill logits with flash against dense attention
  given the same routes), moe_train (moe_350m through the PS round in
  process, one worker, 2 rounds of pallas_adam, launches as designed,
  the first loss within 1e-3 of dense attention's and the first
  gradients within 2^-5 in L2 of float32 dense attention's on the same
  routes, each round's NLL and aux, each MoE layer's dropped share) and
  hf_serve (a GPT-2 small-shaped store under the Hugging Face
  names converted by from_hf_gpt2 and served in float32, 12 flash
  launches a prefill, the first stream equal to generate's; the
  llama_350m store round to_hf_llama -> from_hf_llama byte for byte);
- the same round over the wire: cli.ps_main, cli.coordinator_main and
  two cli.worker_main processes (llama_350m) on localhost, a bootstrap
  iteration and gradient rounds over the fused PushPullStream data
  plane, which the same-host shared-memory rings carry with the native
  host codec (no process may fall back to gRPC or to the Python codec,
  each worker moves its pushes and pulls through the rings, and no
  segment is left in /dev/shm), in two legs run at once, and at once with
  config 1's four below: the PS's pallas_adam after
  a host fold (2 rounds; its epoch-1 checkpoint held against ps_round's
  round-1 store) and --optimizer=sharded_adam under both device-close
  knobs (2 rounds; its epoch-1 checkpoint byte-identical to
  ps_device_round's round-1 store, no apply fallback); every epoch's
  checkpoint holding its own iteration and Adam step, and the
  processes' launch counts from their exit reports;
- BASELINE config 1 as the reference runs it: cli.ps_main (1 worker, its
  default optimizer, pallas_sgd), cli.coordinator_main and one
  cli.worker_main (mnist_mlp, batch 256, bf16 on the wire), a bootstrap
  and 5 gradient rounds, in four legs run at once (shm and the native
  codec; gRPC; gRPC, the Python codec and the PS's plain host SGD; shm with
  --optimizer=sharded_sgd and the device close, the bf16 pushes decoded
  on the card) whose checkpoints must be byte-identical, one fused_sgd
  launch per kernel apply, the device close's launches and a falling
  loss;
- BASELINE config 3 (config3_wire): four cli.ps_main shards behind
  cli.coordinator_main --ps-shards and CONFIG3["workers"] mlp_1b workers
  (batch 2048, bf16 on the wire, 3 rounds), the store split by
  shard_owner (each shard's exit store its names, one fused_sgd launch
  a shard an apply, whole pulls, the rings and the native codec, a
  falling loss), beside an exact leg: one mnist_mlp worker over four
  shards whose merged checkpoints hold config 1 leg (a)'s bytes;
- the 1.34B-parameter MLP (mlp_1b, bf16, batch 2048): 3
  Trainer.compute_gradients -> PallasOptimizer("adam") steps on one
  batch, the loss falling, one Adam launch per apply, the first apply
  held against the plain Adam update tensor by tensor (the store spans
  two launches), then one profiled step.

The build phase also builds the host C++ library (native/psdt_native.cpp,
g++) that the wire phases' codec and rings run on.  Each path's launch
counts are set to 0 just before it runs and read just after (a process
of the wire phases counts from 0 and reports at exit), and must equal
the expected counts.  Phases that start processes of their own run
beside others where the card's and the host's memory allow (the wire
round's two legs with config 1's four, config 2 beside this process's
1B MLP and image rows, config 3's exact leg beside its big leg), so
their times are taken beside each other's.  Each phase prints one JSON
line; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero
without one.

Comparisons in float32 run with TF32 off (torch.backends.*.allow_tf32 =
False), so float32 products are full float32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import struct
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "parameter_server_distributed_tpu_torch"
PALLAS = "parameter_server_distributed_tpu/ops/pallas/"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 on
# the CUDA cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

LLAMA = dict(heads=16, kv=4, d=64, layers=24)   # llama_350m attention
PROMPT_LENS = (129, 200, 300, 511, 513, 700, 1000, 1200)
NEW_TOKENS = 32
TRAIN = dict(batch=8, seq=1024, steps=5, lr=1e-3)
ROUND = dict(workers=2, rounds=2)
# the stripes of the in-process device round and of the device legs
DEVICE_STRIPES = 8
# the wire round's legs: the PS's optimizer, its gradient rounds after the
# bootstrap, and the knobs of its processes (the device leg closes on the
# card through the flat arena, at DEVICE_STRIPES stripes)
WIRE_LEGS = {"host": ("pallas_adam", 2, {}),
             "device": ("sharded_adam", 2,
                        {"PSDT_DEVICE_APPLY": "1", "PSDT_ARENA": "1",
                         "PSDT_STRIPES": str(DEVICE_STRIPES)})}
WIRE_LIMIT_S = 420.0   # a wire leg's wall-clock limit, children included
# BASELINE config 1 (1 PS, 1 worker, mnist_mlp) at the JAX bench's batch
# for it; a learning rate at which the loss falls
CONFIG1 = dict(batch=256, rounds=5, lr=0.05)
CONFIG1_LIMIT_S = 180.0   # one leg's wall-clock limit, children included
# the mlp_1b step at the JAX bench's headline batch (bench.py); Adam at a
# rate that lowers the loss of its one batch in 3 steps at width 16384
MLP_TRAIN = dict(batch=2048, steps=3, lr=2e-5)
# ps_wire_round over gRPC, before the rings carried it (PERF.md section
# 5, three runs on an H100 80GB HBM3 at 700 W), printed beside this run's
GRPC_ROUNDS = {"round_s": [10.134, 7.772, 8.059],
               "fused_push_barrier_pull_s": [8.611, 6.572, 6.701]}
# a profiled window whose trace is empty or lacks records of work that
# the path's own counts say it did is taken again, at most this many
# times in all
PROFILE_ATTEMPTS = 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    """Least time on this card in ms: the larger of the operations over
    the peak rate for the input type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, s, h, kv, d, dtype_name: str) -> tuple[float, str]:
    """Causal attention forward: 2*B*H*D*S^2 operations (the causal half
    of QK^T and PV); q, k, v read once, o and the f32 lse written once."""
    elt = 2 if dtype_name == "bfloat16" else 4
    return bound(2.0 * b * h * d * s * s,
                 elt * b * s * (2 * h + 2 * kv) * d + 4 * b * h * s,
                 dtype_name)


def attention_bwd_bound(kernel: str, b, s, h, kv, d,
                        dtype_name: str) -> tuple[float, str]:
    """The backward kernels: each causal-half product is B*H*D*S^2
    operations, three for dQ (QK^T, dO V^T, dS K) and four for dK/dV
    (QK^T, dO V^T, P^T dO, dS^T Q).  Both read q, o, dO (H-sized), k, v
    (KV-sized) and the f32 lse once; dQ writes dq, dK/dV writes dk, dv."""
    elt = 2 if dtype_name == "bfloat16" else 4
    products, out_heads = (3, h) if kernel == "flash_bwd_dq" else (4, 2 * kv)
    nbytes = (elt * b * s * d * (3 * h + 2 * kv + out_heads)
              + 4 * b * h * s)
    return bound(products * b * h * d * s * s, nbytes, dtype_name)


# bytes per element of each update (each operand read once, each output
# written once): sgd p, g -> p'; momentum p, g, v -> p', v'; adam p, g, m,
# v -> p', m', v'; and f32 operations per element (adam: 3 for m, 4 for v,
# 7 for the step with its sqrt and three divisions)
UPDATE_BYTES = {"sgd": 12, "momentum": 20, "adam": 28}
UPDATE_FLOPS = {"sgd": 2, "momentum": 4, "adam": 14}


def folded_inputs(torch, gen, b, s, heads, kv, d, dtype):
    """The main path's flash inputs for a [B, S, H, D] layer, in the
    kernels' folded layout: q [B*KV, G*S, D], k/v [B*KV, S, D]."""
    q = torch.randn((b * kv, (heads // kv) * s, d), generator=gen,
                    device="cuda", dtype=dtype)
    k, v = (torch.randn((b * kv, s, d), generator=gen, device="cuda",
                        dtype=dtype) for _ in range(2))
    return q, k, v


def kernel_label(mangled: str) -> str:
    """``name/D<head_dim>[/bf16]`` of a mangled kernel symbol: the last of
    its length-prefixed name components (after the anonymous
    namespace's), its first integer template argument, and /bf16 where
    its first template argument is the bf16 type."""
    pos, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while (m := re.match(r"\d+", mangled[pos:])):
        start = pos + len(m.group())
        name, pos = mangled[start:start + int(m.group())], start + int(
            m.group())
    dim = re.search(r"Li(\d+)E", mangled[pos:])
    return (name + (f"/D{dim.group(1)}" if dim else "")
            + ("/bf16" if mangled[pos:].startswith("I13__nv_bfloat16")
               else ""))


def ptxas_report(log: str) -> dict[str, str]:
    """Registers, barriers and spills per kernel from nvcc's -Xptxas -v
    output."""
    out, kernel = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = kernel_label(m.group(1))
        elif kernel and ("registers" in line or "spill" in line):
            out[kernel] = (out.get(kernel, "") + " " + line.split(":", 1)[
                -1].strip()).strip()
    return out


def tensor_core_counts(build) -> dict:
    """Tensor-core instructions in each built library's SASS
    (``cuobjdump -sass``): HGMMA for wgmma, HMMA for mma.sync, per source
    and per kernel (its name and head_dim, summed over types), each
    kernel's by instruction."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = {}
    for name in build.SOURCES:
        sass = subprocess.run([tool, "-sass", build.library_path(name)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        totals, by_kernel, kernel = {"HGMMA": 0, "HMMA": 0}, {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                kernel = kernel_label(line.split("Function :")[1].strip())
                by_kernel.setdefault(kernel, {"HGMMA": 0, "HMMA": 0})
                continue
            op = re.search(r"\b(HGMMA|HMMA)\b", line)
            if op and kernel:
                totals[op.group(1)] += 1
                by_kernel[kernel][op.group(1)] += 1
        out[name] = {**totals, "by_kernel": by_kernel}
    return out


def check_flash_fwd(torch, fa, gen) -> float:
    """flash_fwd against its plain version at every shape the main paths
    give it (each serving prefill bucket at B=1, the llama_350m training
    batch, the f32 models of the serve_vs_generate and
    train_flash_vs_dense phases; moe_350m's MHA at its serving buckets,
    its training batch and its f32 bucket-sized prompts, GPT-2's f32
    buckets), D=128 and ragged segments (S=200, whose last q tile runs
    into the next segment's rows); returns the largest |o| error."""
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    cases = [(1, s, heads, kv, d, torch.bfloat16)
             for s in (128, 256, 512, 1024, 2048)]
    # moe_350m (MHA, 16 heads): serving buckets, training batch, f32
    cases += [(1, s, 16, 16, 64, torch.bfloat16)
              for s in (256, 512, 1024, 2048)]
    cases += [(TRAIN["batch"], TRAIN["seq"], 16, 16, 64, torch.bfloat16)]
    cases += [(1, s, 16, 16, 64, torch.float32) for s in (256, 512)]
    # GPT-2 small's shape (12 heads, f32): hf_serve's buckets
    cases += [(1, s, 12, 12, 64, torch.float32) for s in (256, 512, 1024)]
    cases += [(TRAIN["batch"], TRAIN["seq"], heads, kv, d, torch.bfloat16),
              (1, 512, 8, 8, 128, torch.bfloat16),      # lm_350m_hd128
              (2, 512, 16, 4, 128, torch.bfloat16),     # D=128, G=4
              (2, 200, 6, 2, 64, torch.bfloat16),       # S % 64 != 0, G=3
              (1, 512, 16, 4, 64, torch.float32),
              (4, 256, 4, 2, 64, torch.float32),        # the 2-layer f32
              (1, 256, 8, 8, 128, torch.float32)]
    max_err = 0.0
    for b, s, heads, kv, d, dtype in cases:
        q, k, v = folded_inputs(torch, gen, b, s, heads, kv, d, dtype)
        block = next(x for x in (128, 64, 8) if s % x == 0)
        with torch.inference_mode():
            o, lse = fa._flash_fwd(q, k, v, block, block, s // block)
            torch.cuda.synchronize()
            # the f32 plain output from the same inputs (bf16 o is
            # rounded once, so it is held within 2e-2 of that)
            o_ref, lse_ref = fa.flash_fwd_reference(q.float(), k.float(),
                                                    v.float(), s)
        if o.shape != q.shape or o.dtype != dtype or lse.shape != (
                b * kv, 1, q.shape[1]):
            fail(f"flash_fwd shapes {tuple(o.shape)} {o.dtype} "
                 f"{tuple(lse.shape)}")
        d_o = float((o.float() - o_ref).abs().max())
        # lse relative, floored at 1 (a one-key row's lse is its score,
        # which may sit near 0)
        d_lse = float(((lse - lse_ref).abs()
                       / lse_ref.abs().clamp_min(1.0)).max())
        tol_o = 2e-2 if dtype == torch.bfloat16 else 2e-4
        emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd",
              "batch": b, "seq": s, "heads": heads, "kv_heads": kv,
              "head_dim": d, "dtype": str(dtype).split(".")[-1],
              "max_abs_do": d_o, "tol_o": tol_o, "max_rel_dlse": d_lse,
              "tol_lse": 1e-4})
        if not (math.isfinite(d_o) and d_o <= tol_o and d_lse <= 1e-4):
            fail(f"flash_fwd disagrees with its plain version at B={b} "
                 f"S={s} H={heads} KV={kv} D={d} {dtype}: |do| {d_o}, "
                 f"rel |dlse| {d_lse}")
        max_err = max(max_err, d_o)
    return max_err


def bwd_inputs(torch, fa, gen, b, s, heads, kv, d, dtype):
    """(q, k, v, o, lse, dO) for the backward kernels: o and lse from the
    f32 plain forward, o rounded to the input type."""
    q, k, v = folded_inputs(torch, gen, b, s, heads, kv, d, dtype)
    g = torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)
    with torch.inference_mode():
        o, lse = fa.flash_fwd_reference(q.float(), k.float(), v.float(), s)
    return q, k, v, o.to(dtype), lse, g


def check_flash_bwd(torch, fa, gen) -> dict[str, float]:
    """dQ and dK/dV against flash_bwd_reference on the same inputs: the
    llama_350m and moe_350m (MHA) training shapes, MHA, D=128, f32, and
    segments that are not a multiple of the 64-row tile.  f32 within
    rtol 5e-4, atol 1e-5 (the reference's gradient tolerance); bf16
    within rtol 1e-2, atol 1e-3 of the f32 plain result on the same bf16
    inputs (each output is rounded once to bf16).  Returns each kernel's
    largest absolute error."""
    b, heads, kv, d = TRAIN["batch"], LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    cases = [(b, TRAIN["seq"], heads, kv, d, torch.bfloat16),
             (b, TRAIN["seq"], 16, 16, 64, torch.bfloat16),   # moe_350m
             (1, 512, 16, 16, 64, torch.bfloat16),     # MHA
             (2, 512, 8, 2, 128, torch.bfloat16),      # D=128, G=4
             (2, 200, 6, 2, 64, torch.bfloat16),       # S % 64 != 0, G=3
             (1, 200, 6, 2, 128, torch.bfloat16),
             (2, 256, 16, 4, 64, torch.float32),
             (1, 200, 6, 2, 128, torch.float32)]        # S % 64 != 0
    max_err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for b_, s, h, kv_, d_, dtype in cases:
        q, k, v, o, lse, g = bwd_inputs(torch, fa, gen, b_, s, h, kv_, d_,
                                        dtype)
        block = next(x for x in (128, 64, 8) if s % x == 0)
        with torch.inference_mode():
            got = fa._flash_bwd(q, k, v, o, lse, g, block, block,
                                s // block)
            torch.cuda.synchronize()
            ref = fa.flash_bwd_reference(*(x.float() for x in (q, k, v, o)),
                                         lse, g.float(), s)
        rtol, atol = (5e-4, 1e-5) if dtype == torch.float32 else (1e-2, 1e-3)
        errs, ok = {}, True
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            if a.shape != r.shape or a.dtype != dtype:
                fail(f"flash_bwd {name} {tuple(a.shape)} {a.dtype}")
            diff = (a.float() - r).abs()
            errs[name] = float(diff.max())
            ok = ok and bool((diff <= atol + rtol * r.abs()).all())
        emit({"phase": "kernel_vs_plain", "kernel": "flash_bwd_dq+dkv",
              "batch": b_, "seq": s, "heads": h, "kv_heads": kv_,
              "head_dim": d_, "dtype": str(dtype).split(".")[-1],
              "max_abs_err": errs, "rtol": rtol, "atol": atol, "ok": ok})
        if not ok or not all(math.isfinite(e) for e in errs.values()):
            fail(f"flash backward disagrees with its plain version at "
                 f"B={b_} S={s} H={h} KV={kv_} D={d_} {dtype}: {errs}")
        max_err["flash_bwd_dq"] = max(max_err["flash_bwd_dq"], errs["dq"])
        max_err["flash_bwd_dkv"] = max(max_err["flash_bwd_dkv"], errs["dk"],
                                       errs["dv"])
    return max_err


def llama_store(torch, shapes, gen, abs_=False):
    return {name: (lambda x: x.abs() if abs_ else x)(
        torch.randn(shape, generator=gen, device="cuda"))
        for name, shape in shapes.items()}


def update_launches(fu, shapes) -> int:
    """Launches of one update over the store: the planner's tables."""
    sizes = [math.prod(s) for s in shapes.values()]
    return len(fu.plan(sizes, [True] * len(sizes)))


def check_updates(torch, fu, shapes, gen) -> dict[str, float]:
    """Each update kernel against its plain version over the full
    llama_350m store (219 f32 tensors), slots included, within rtol 1e-5,
    atol 1e-7 (the reference's tolerance), in the planner's number of
    launches.  Returns each kernel's largest absolute error."""
    p, g = llama_store(torch, shapes, gen), llama_store(torch, shapes, gen)
    max_err = {}
    for rule in ("sgd", "momentum", "adam"):
        slots = [llama_store(torch, shapes, gen, abs_=(i == 1))
                 for i in range({"sgd": 0, "momentum": 1, "adam": 2}[rule])]
        ref_slots = [{n: x.clone() for n, x in s.items()} for s in slots]
        fu.reset_launches()
        with torch.inference_mode():
            if rule == "sgd":
                out = fu.fused_sgd(p, g, 0.1)
                ref = {n: fu.sgd_reference(p[n], g[n], 0.1) for n in p}
            elif rule == "momentum":
                out, _ = fu.fused_momentum(p, g, slots[0], 0.1, 0.9)
                ref = {n: fu.momentum_reference(p[n], g[n], ref_slots[0][n],
                                                0.1, 0.9) for n in p}
            else:
                out = fu.fused_adam(p, g, slots[0], slots[1], 3, 1e-3)[0]
                bc = fu.bias_corrections(3, 0.9, 0.999)
                ref = {n: fu.adam_reference(p[n], g[n], ref_slots[0][n],
                                            ref_slots[1][n], 1e-3, 0.9,
                                            0.999, 1e-8, *bc) for n in p}
            torch.cuda.synchronize()
        n_launch = fu.launches[f"fused_{rule}"]
        pairs = [(out[n], ref[n]) for n in p] + [
            (s[n], r[n]) for s, r in zip(slots, ref_slots) for n in p]
        err = max(float((a - b).abs().max()) for a, b in pairs)
        ok = all(bool(torch.isclose(a, b, rtol=1e-5, atol=1e-7).all())
                 for a, b in pairs)
        exact = all(bool(torch.equal(a, b)) for a, b in pairs)
        emit({"phase": "kernel_vs_plain", "kernel": f"fused_{rule}",
              "tensors": len(p), "elements": sum(x.numel()
                                                 for x in p.values()),
              "launches": n_launch,
              "expected_launches": update_launches(fu, shapes),
              "max_abs_err": err, "bit_exact": exact, "rtol": 1e-5,
              "atol": 1e-7, "ok": ok})
        if not ok or not math.isfinite(err):
            fail(f"fused_{rule} disagrees with its plain version: {err}")
        if n_launch != update_launches(fu, shapes):
            fail(f"fused_{rule} took {n_launch} launches over the store, "
                 f"not the planner's {update_launches(fu, shapes)}")
        max_err[f"fused_{rule}"] = err
    return max_err


def time_flash_fwd(torch, F, fa, gen) -> dict:
    """flash_fwd at the llama_350m prefill shapes, beside the plain
    version, SDPA and the bound."""
    timing = {}
    for s in (256, 512, 1024, 2048):
        heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
        q, k, v = folded_inputs(torch, gen, 1, s, heads, kv, d,
                                torch.bfloat16)
        # SDPA (the yardstick; the port never calls it) on the same
        # inputs in its [B, H, S, D] layout: query head h = kv_head * G +
        # group reads kv head h // G, as enable_gqa does; and once more on
        # K/V expanded to H heads beforehand
        g = heads // kv
        q_l = q.reshape(1, kv * g, s, d)
        k_l, v_l = k.reshape(1, kv, s, d), v.reshape(1, kv, s, d)
        k_x, v_x = (x.repeat_interleave(g, dim=1) for x in (k_l, v_l))
        with torch.inference_mode():
            plain = cuda_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, s), iters=5)
            kernel = cuda_ms(torch, lambda: fa._flash_fwd(
                q, k, v, 128, 128, s // 128))
            library = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q_l, k_l, v_l, is_causal=True, enable_gqa=True))
            library_x = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q_l, k_x, v_x, is_causal=True))
            kernel2 = cuda_ms(torch, lambda: fa._flash_fwd(
                q, k, v, 128, 128, s // 128))
            plain2 = cuda_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, s), iters=5)
        bound_ms, bound_by = attention_bound(1, s, heads, kv, d, "bfloat16")
        timing[s] = dict(ms=min(kernel, kernel2), plain_ms=min(plain, plain2),
                         library_ms=library, bound_ms=bound_ms,
                         bound_by=bound_by)
        emit({"phase": "times", "kernel": "flash_fwd", "seq": s,
              "heads": heads, "kv_heads": kv, "head_dim": d,
              "dtype": "bfloat16", "ms_runs": [kernel, kernel2],
              "plain_ms_runs": [plain, plain2],
              "library_expanded_kv_ms": library_x, **timing[s]})
    return timing


def time_flash_train(torch, F, fa, gen) -> dict:
    """The three flash kernels at the llama_350m training shape (B=8,
    S=1024, H=16, KV=4, D=64, bf16), beside the plain versions, the bound
    and SDPA (forward; and its backward through autograd, which computes
    dq, dk and dv in one call, so it stands beside both backward
    kernels).  The plain backward computes dq, dk and dv in one pass too:
    its time stands beside both."""
    b, s = TRAIN["batch"], TRAIN["seq"]
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    q, k, v, o, lse, g = bwd_inputs(torch, fa, gen, b, s, heads, kv, d,
                                    torch.bfloat16)
    grp = heads // kv
    # SDPA layout [B, H, S, D] over the same memory: folded row
    # (b*KV + kv, g*S + s) is query head kv*G + g, as enable_gqa reads
    q_l = q.reshape(b, kv * grp, s, d).detach().requires_grad_()
    k_l = k.reshape(b, kv, s, d).detach().requires_grad_()
    v_l = v.reshape(b, kv, s, d).detach().requires_grad_()
    g_l = g.reshape(b, kv * grp, s, d)
    out_l = F.scaled_dot_product_attention(q_l, k_l, v_l, is_causal=True,
                                           enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(out_l, (q_l, k_l, v_l), g_l,
                                   retain_graph=True)

    args = (q, k, v, o, lse, g, s)
    with torch.inference_mode():
        plain_f = cuda_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, s),
                          iters=3)
        plain_b = cuda_ms(torch, lambda: fa.flash_bwd_reference(*args),
                          iters=3)
        fwd = [cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, 128, 128,
                                                    s // 128))]
        dq = [cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(*args))]
        dkv = [cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(*args))]
        lib_f = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q_l, k_l, v_l, is_causal=True, enable_gqa=True))
    lib_b = cuda_ms(torch, sdpa_bwd)
    with torch.inference_mode():
        fwd.append(cuda_ms(torch, lambda: fa._flash_fwd(q, k, v, 128, 128,
                                                        s // 128)))
        dq.append(cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(*args)))
        dkv.append(cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(*args)))
        plain_b2 = cuda_ms(torch, lambda: fa.flash_bwd_reference(*args),
                           iters=3)
        # device-only times (kernels summed by the profiler over 5 calls):
        # the event time of SDPA's backward also holds autograd's host
        # work, which moves between runs
        device = {name: device_profile(torch, fn) for name, fn in (
            ("flash_fwd", lambda: fa._flash_fwd(q, k, v, 128, 128,
                                                s // 128)),
            ("flash_bwd_dq", lambda: fa._flash_bwd_dq_cuda(*args)),
            ("flash_bwd_dkv", lambda: fa._flash_bwd_dkv_cuda(*args)),
            ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                q_l, k_l, v_l, is_causal=True, enable_gqa=True)))}
    device["sdpa_bwd"] = device_profile(torch, sdpa_bwd)
    out = {}
    for name, runs, plain, lib, lib_dev in (
            ("flash_fwd", fwd, plain_f, lib_f, device["sdpa_fwd"]),
            ("flash_bwd_dq", dq, min(plain_b, plain_b2), lib_b,
             device["sdpa_bwd"]),
            ("flash_bwd_dkv", dkv, min(plain_b, plain_b2), lib_b,
             device["sdpa_bwd"])):
        if name == "flash_fwd":
            bound_ms, bound_by = attention_bound(b, s, heads, kv, d,
                                                 "bfloat16")
        else:
            bound_ms, bound_by = attention_bwd_bound(name, b, s, heads, kv,
                                                     d, "bfloat16")
        out[name] = dict(ms=min(runs), plain_ms=plain, library_ms=lib,
                         bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "times", "kernel": name, "batch": b, "seq": s,
              "heads": heads, "kv_heads": kv, "head_dim": d,
              "dtype": "bfloat16", "ms_runs": runs, **out[name],
              "device_ms": device[name]["ms"],
              "device_events": device[name]["events"],
              "library_device_ms": lib_dev["ms"], "library_device": lib_dev,
              "library": ("SDPA forward" if name == "flash_fwd" else
                          "SDPA backward (autograd, dq+dk+dv)")})
    return out


def device_profile(torch, fn, calls: int = 5) -> dict:
    """Device time of one call of ``fn`` (every kernel the profiler saw
    over ``calls`` calls, summed, over ``calls``), the kernel records per
    call (a record the trace lost shows as a fraction here), the window's
    wall time per call and its largest kernels; the times are None where
    every trace of the window was lost."""
    def run():
        for _ in range(calls):
            fn()
    prof = profile_window(torch, run, {})
    lost = prof["kernel_ms"] is None
    return {"ms": None if lost else prof["kernel_ms"] / calls,
            "events": prof["kernel_events"] / calls,
            "window_ms": 1e3 * prof["window_s"] / calls,
            "top": prof["top"][:3], "trace": prof["trace"]}


def time_updates(torch, fu, shapes, gen) -> dict:
    """Each update over the full llama_350m store (the planner's launches,
    checked), beside the plain version, the bound and torch.optim's fused
    optimizer over the same tensor list (Adam, SGD, SGD with momentum),
    with the kernel's and torch.optim's device-only times."""
    n = sum(math.prod(s) for s in shapes.values())
    out = {}
    for rule in ("sgd", "momentum", "adam"):
        p, g = llama_store(torch, shapes, gen), llama_store(torch, shapes, gen)
        slots = [llama_store(torch, shapes, gen, abs_=(i == 1))
                 for i in range({"sgd": 0, "momentum": 1, "adam": 2}[rule])]
        names = list(p)
        if rule == "sgd":
            def kernel():
                return fu.fused_sgd(p, g, 1e-3)

            def plain():
                return [fu.sgd_reference(p[x], g[x], 1e-3) for x in names]
        elif rule == "momentum":
            def kernel():
                return fu.fused_momentum(p, g, slots[0], 1e-3, 0.9)

            def plain():
                return [fu.momentum_reference(p[x], g[x], slots[0][x], 1e-3,
                                              0.9) for x in names]
        else:
            bc = fu.bias_corrections(3, 0.9, 0.999)

            def kernel():
                return fu.fused_adam(p, g, slots[0], slots[1], 3, 1e-3)

            def plain():
                return [fu.adam_reference(p[x], g[x], slots[0][x],
                                          slots[1][x], 1e-3, 0.9, 0.999,
                                          1e-8, *bc) for x in names]
        with torch.inference_mode():
            plain1 = cuda_ms(torch, plain, iters=3)
            runs = [cuda_ms(torch, kernel, iters=10)]
        # torch.optim's fused step (the yardstick; the port never calls
        # it) on copies of the same params with the same grads
        params = [torch.nn.Parameter(p[x].clone()) for x in names]
        for param, x in zip(params, names):
            param.grad = g[x]
        opt = (torch.optim.Adam(params, lr=1e-3, fused=True)
               if rule == "adam" else
               torch.optim.SGD(params, lr=1e-3, fused=True,
                               momentum=0.9 if rule == "momentum" else 0.0))
        library = cuda_ms(torch, opt.step, iters=10)
        # its device-only time (the event time also holds its host work)
        library_dev = device_profile(torch, opt.step)
        del opt, params
        fu.reset_launches()
        with torch.inference_mode():
            runs.append(cuda_ms(torch, kernel, iters=10))
            per_call = fu.launches[f"fused_{rule}"] / 13   # 3 warm-up + 10
            plain2 = cuda_ms(torch, plain, iters=3)
            # the kernel's own device time in one apply (the event time
            # above also holds the host's work between applies)
            kernel_dev = device_profile(torch, kernel)
        if per_call != update_launches(fu, shapes):
            fail(f"fused_{rule} took {per_call} launches an apply, not the "
                 f"planner's {update_launches(fu, shapes)}")
        bound_ms, bound_by = bound(UPDATE_FLOPS[rule] * n,
                                   UPDATE_BYTES[rule] * n, "float32")
        out[f"fused_{rule}"] = dict(ms=min(runs), plain_ms=min(plain1, plain2),
                                    library_ms=library, bound_ms=bound_ms,
                                    bound_by=bound_by)
        emit({"phase": "times", "kernel": f"fused_{rule}",
              "tensors": len(names), "elements": n, "ms_runs": runs,
              "launches_per_apply": per_call,
              "plain_ms_runs": [plain1, plain2],
              "device_ms": kernel_dev["ms"],
              "device_events": kernel_dev["events"],
              "library_device_ms": library_dev["ms"],
              "library_device": library_dev,
              "library": f"torch.optim.{'Adam' if rule == 'adam' else 'SGD'}"
                         f"(fused=True)", **out[f"fused_{rule}"]})
        del p, g, slots
        torch.cuda.empty_cache()
    return out


def dtoh_copies(torch, fn) -> int:
    """Run ``fn`` once and count the device-to-host copies that the ops
    it runs ask for: each op that reads a card tensor and gives a host
    tensor that is not empty, or a Python number (``.item()``,
    ``torch.equal``).  The count comes from the dispatcher, on the host,
    and does not rest on the profiler's trace."""
    return host_syncs(torch, fn)["dtoh"]


def host_syncs(torch, fn) -> dict:
    """Run ``fn`` once and count, at the dispatcher, the ops that make the
    host wait on the card: device-to-host reads (``dtoh``, as
    dtoh_copies counts them), ``nonzero`` of a card tensor (its output
    size is data) and copies of host tensors to the card (``htod``: a
    pageable copy is synchronous)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    scalar_ops = {torch.ops.aten._local_scalar_dense.default,
                  torch.ops.aten.equal.default}
    counts = {"dtoh": 0, "nonzero": 0, "htod": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [x for x in tree_leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            outs = [x for x in tree_leaves(out)
                    if isinstance(x, torch.Tensor)]
            if any(x.is_cuda for x in ins):
                if func is torch.ops.aten.nonzero.default:
                    counts["nonzero"] += 1
                elif func in scalar_ops or any(
                        not x.is_cuda and x.numel() > 0 for x in outs):
                    counts["dtoh"] += 1
            if (any(not x.is_cuda and x.numel() > 0 for x in ins)
                    and any(x.is_cuda for x in outs)):
                counts["htod"] += 1
            return out

    with Count():
        fn()
    torch.cuda.synchronize()
    return counts


def profile_window(torch, fn, names: dict[str, str],
                   whole: dict[str, int] | None = None,
                   launches: dict | None = None) -> dict:
    """Run ``fn`` under torch.profiler; kernel time summed by name, the
    device busy share (kernel time / the window's wall time) and the time
    of each group in ``names`` (group -> substring of kernel names).

    The trace is a measurement, never the check of a path: the path's
    own counts are.  ``whole`` maps groups to the events a whole trace of
    the window holds.  Its "fused_adam" count must also be what the Adam
    wrapper's own count (``launches``, fu.launches) rose by over the
    window, or the path is at fault and the run fails; so must a trace
    holding more events of a group than ``whole`` says.  A trace holding
    no device event, or fewer events of a group than ``whole`` says, lost
    records of work the path did (on the card, CUPTI has been seen to
    lose a whole window, or its first or last records): its counts are
    printed and the window taken again, at most PROFILE_ATTEMPTS times
    in all.  If every trace was short, the last one's breakdown comes
    back marked "trace": "lost", its times None."""
    lost = []
    for _ in range(PROFILE_ATTEMPTS):
        before = launches["fused_adam"] if launches else 0
        out = _profile_once(torch, fn, names)
        if whole is not None:
            made = launches["fused_adam"] - before
            if made != whole["fused_adam"]:
                fail(f"a profiled window launched fused_adam {made} times, "
                     f"not {whole['fused_adam']}")
        short = {g: n - out["group_events"][g]
                 for g, n in (whole or {}).items()
                 if out["group_events"][g] != n}
        if short and min(short.values()) < 0:
            fail(f"a profiled window holds more events than a whole trace "
                 f"should (negative counts): {short}")
        if out["kernel_events"] and not short:
            return {**out, "trace": "whole", "attempts": len(lost) + 1,
                    "incomplete": lost}
        lost.append({"group_events": out["group_events"],
                     "kernel_events": out["kernel_events"], "lost": short})
        emit({"phase": "profile_retake", **lost[-1]})
    return {**out, "kernel_ms": None, "device_busy_share": None,
            "group_ms": {g: None for g in out["group_ms"]},
            "trace": "lost", "attempts": len(lost), "incomplete": lost}


def _profile_once(torch, fn, names: dict[str, str]) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t1
    by_name: dict[str, list] = {}
    for evt in prof.events():
        # a record_function range (torch.optim's "Optimizer.step#...")
        # is mirrored on the device timeline over the kernels it holds:
        # not a kernel of its own
        if evt.device_type == DeviceType.CUDA and not getattr(
                evt, "is_user_annotation", False):
            entry = by_name.setdefault(evt.name, [0.0, 0])
            entry[0] += evt.time_range.elapsed_us() / 1e3
            entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    groups = {group: [sum(x[i] for name, x in by_name.items() if key in name)
                      for i in (0, 1)] for group, key in names.items()}
    return {"window_s": window, "kernel_ms": busy_ms,
            "kernel_events": sum(n for _, n in by_name.values()),
            "device_busy_share": busy_ms / 1e3 / window,
            "group_ms": {g: ms for g, (ms, _) in groups.items()},
            "group_events": {g: n for g, (_, n) in groups.items()},
            "top": [[name[:80], ms, n] for name, (ms, n) in top[:12]]}


def warm_buckets(serving, srv, prompt, lens=PROMPT_LENS,
                 max_len: int = 2048) -> None:
    """One request per prefill bucket of ``lens``, outside any count, so
    a measured burst sees steady-state library and allocator state."""
    for n in sorted({min(serving._bucket(n), max_len) for n in lens}):
        srv.submit((prompt * (n // len(prompt) + 1))[:n - 2],
                   max_new_tokens=2)
        srv.run_to_completion()


def burst(torch, srv, prompts) -> dict:
    """All ``prompts`` arrive at t0 and are admitted back to back, then
    decode rounds run until the server is idle.  A request's TTFT is from
    t0 to its first token on the host (its prefill plus the prefills
    queued ahead of it); a gap is one decode round (``step`` returns with
    the tokens on the host); the card is synchronized before t0 and before
    the wall time.  Returns the request ids, their streams, each round's
    emitting requests and the times."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, prefill_s, gaps, rids, emitted = [], [], [], [], []
    for p in prompts:
        t1 = time.perf_counter()
        rids.append(srv.submit(p, max_new_tokens=NEW_TOKENS))
        prefill_s.append(time.perf_counter() - t1)
        ttft.append(time.perf_counter() - t0)
    while not srv.idle:
        t1 = time.perf_counter()
        emitted.append({rid for rid, _ in srv.step()})
        gaps.append(time.perf_counter() - t1)
    results = srv.run_to_completion()
    torch.cuda.synchronize()
    return {"rids": rids, "results": results, "ttft": ttft,
            "prefill_s": prefill_s, "gaps": gaps, "emitted": emitted,
            "wall": time.perf_counter() - t0}


def burst_report(np, b: dict) -> dict:
    """The fields every serving phase reports of its burst."""
    tokens = sum(len(b["results"][r]) for r in b["rids"])
    return {"requests_answered": len(b["rids"]), "tokens_generated": tokens,
            "wall_s": b["wall"], "tokens_per_s": tokens / b["wall"],
            "ttft_p50_s": float(np.median(b["ttft"])), "ttft_s": b["ttft"],
            "prefill_s": b["prefill_s"], "decode_rounds": len(b["gaps"]),
            "gap_p50_s": float(np.median(b["gaps"])),
            "gap_max_s": max(b["gaps"])}


def check_streams(b: dict, vocab: int, what: str) -> None:
    """Every request of the burst answered with NEW_TOKENS in-vocab
    tokens."""
    if any(len(b["results"].get(r, ())) != NEW_TOKENS
           or not all(0 <= t < vocab for t in b["results"][r])
           for r in b["rids"]):
        fail(f"{what} did not answer every request with {NEW_TOKENS} "
             f"in-vocab tokens")


def serve(torch, np, fa, rng) -> dict:
    """The serving path: llama_350m through DecodeServer, its profiled
    window, flash-vs-dense logits, f32 server-vs-generate and the CLI.
    Returns the path's flash_fwd launch count."""
    from parameter_server_distributed_tpu_torch.models import serving
    from parameter_server_distributed_tpu_torch.models.generation import \
        generate
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, causal_attention,
        flash_attention_auto)

    model = get_model("llama_350m", dtype="bf16")
    if model.attention_fn is not flash_attention_auto:
        fail("PSDT_FLASH_ATTENTION=1 did not select the flash kernel")
    params = model.init_params(0, device="cuda")
    prompts = [rng.integers(0, model.config.vocab, n).tolist()
               for n in PROMPT_LENS]
    srv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                               device="cuda")
    warm_buckets(serving, srv, prompts[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    b = burst(torch, srv, prompts)
    launches = dict(fa.launches)
    prefills = len(prompts)
    emit({"phase": "serve", "model": "llama_350m", "dtype": "bfloat16",
          "params": model.num_params(), "slots": 8, "max_len": 2048,
          "prompt_lens": list(PROMPT_LENS),
          "buckets": [min(serving._bucket(n), 2048) for n in PROMPT_LENS],
          **burst_report(np, b),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "flash_launches": launches,
          "expected_launches": {"flash_fwd": LLAMA["layers"] * prefills},
          "stats": srv.stats})
    check_streams(b, model.config.vocab, "serving")
    if launches != {"flash_fwd": LLAMA["layers"] * prefills,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        fail(f"serving flash launches {launches} != 24 x {prefills} "
             f"prefills of flash_fwd")

    # where the device time goes: one profiled request at the largest
    # bucket (prefill of 1200 tokens in a 2048 bucket, then 7 decode
    # rounds)
    def one_request():
        srv.submit(prompts[-1], max_new_tokens=8)
        srv.run_to_completion()

    emit({"phase": "profile", **profile_window(
        torch, one_request, {"flash_ms": "flash_fwd"})})

    # llama_350m prefill logits: flash against dense attention, one prompt
    dense = Transformer(model.config, attention_fn=causal_attention)
    tok = torch.tensor([prompts[3] + [0]], device="cuda")   # S = 512
    with torch.inference_mode():
        lf = model.apply(params, tok)[0, -2]
        ld = dense.apply(params, tok)[0, -2]
    rel = float((lf - ld).abs().max() / ld.abs().max())
    emit({"phase": "logits_flash_vs_dense", "model": "llama_350m",
          "seq": 512, "finite": bool(torch.isfinite(lf).all()),
          "max_rel_diff": rel, "tol": 5e-2})
    if not torch.isfinite(lf).all() or rel > 5e-2:
        fail(f"llama_350m flash logits off dense by {rel}")

    # float32 small model: the server (flash prefill) token-exact against
    # generate (the repo's own serving contract), prompts at bucket sizes
    small = Transformer(TransformerConfig(
        vocab=1024, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=torch.float32),
        attention_fn=flash_attention_auto)          # head_dim 64
    sparams = small.init_params(1, device="cuda")
    sprompts = [rng.integers(0, 1024, n).tolist() for n in (128, 256)]
    ssrv = serving.DecodeServer(small, sparams, slots=2, max_len=512,
                                device="cuda")
    srids = [ssrv.submit(p, max_new_tokens=8) for p in sprompts]
    sres = ssrv.run_to_completion()
    exact = [sres[r] == generate(small, sparams, [p], 8)[0].tolist()
             for r, p in zip(srids, sprompts)]
    emit({"phase": "serve_vs_generate_f32",
          "model": "2-layer f32, head_dim 64", "token_exact": exact})
    if not all(exact):
        fail("f32 DecodeServer streams differ from generate")

    # the CLI: 2 JSONL requests through serve_main
    reqs = [{"id": 1, "tokens": prompts[1], "max_new": 8},
            {"id": 2, "prompt": "The parameter server " * 10, "max_new": 8}]
    env = dict(os.environ, PYTHONPATH=HERE, PSDT_FLASH_ATTENTION="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.cli.serve_main",
         "--model=llama_350m", "--slots=2", "--max-len=2048"],
        cwd=HERE, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(
            "".join(json.dumps(r) + "\n" for r in reqs), timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    done = [line for line in lines if line.get("done")]
    emit({"phase": "cli", "returncode": proc.returncode,
          "done_lines": len(done), "lines": len(lines),
          "stderr_tail": err[-400:]})
    if proc.returncode != 0 or sorted(d["id"] for d in done) != [1, 2]:
        fail(f"serve_main answered {len(done)} of 2 requests "
             f"(exit {proc.returncode})")
    return launches["flash_fwd"]


INT8_REF = "parameter_server_distributed_tpu/models/"
# the int8 serving kernels (csrc/int8_serve.cu) and the JAX package's
# device program each replaces (XLA fusions, not Pallas)
INT8_REPLACES = {"int8_wdot": "quant.py:106",
                 "decode_attention_int8": "generation.py:224",
                 "kv_quantize": "generation.py:79"}
# llama_350m's (K, N) products: wq/wo, wk/wv, w1/w3, w2, lm_head; at
# these rows: a decode round of 1, 8 and 16 slots (the skinny kernel) and
# the largest prefill bucket
INT8_WDOT_SHAPES = ((1024, 1024), (1024, 256), (1024, 2816), (2816, 1024),
                    (1024, 32000))
INT8_WDOT_ROWS = (1, 8, 16, 2048)
# bytes a cold-L2 timing's operand copies span in all: past twice the
# card's 50 MB L2, so no call finds its operand there
COLD_BYTES = 128 << 20
# the prefix leg: a shared prefix, then 8 prompts extending it
PREFIX_LEN = 1024
PREFIX_SUFFIXES = (64, 90, 128, 150, 180, 200, 230, 256)


def call_us(torch, fn, calls: int = 200) -> float:
    """Host wall time of one call in microseconds, ``calls`` back to back
    then one synchronize (the larger of the host's and the card's time
    a call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def host_us(torch, fn, calls: int = 20) -> float:
    """Host time of one call in microseconds: ``calls`` calls back to
    back, timed without waiting for the card (what each call costs the
    host to enqueue; the card's queue holds them all)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / calls


def same_bytes(torch, got, want) -> bool:
    """int8 codes equal, f32 scales bytes equal."""
    if got.dtype == torch.int8:
        return want.dtype == torch.int8 and bool(torch.equal(got, want))
    return bits_equal(torch, got, want)


def graph_ms(torch, calls, replays: int = 3) -> float:
    """Device time of one call: the thunks ``calls`` captured in order in
    a CUDA graph, replayed between CUDA events, so no host time lies
    between launches; the median of ``replays`` replays, per call."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return sorted(times)[len(times) // 2]


def cold_ms(torch, fn, operand, min_calls: int = 8,
            replays: int = 3) -> float:
    """Device time of one call ``fn(copy)`` with a cold L2: a CUDA graph
    of calls that rotate over copies of ``operand`` (COLD_BYTES in all,
    so each call reads its copy from device memory, as a decode round
    that streams every weight does), replayed between CUDA events; the
    median of ``replays`` replays, per call.  The graph leaves no host
    time between the launches.  ``operand`` is a tensor or a tuple of
    tensors, copied together."""
    parts = operand if isinstance(operand, tuple) else (operand,)
    nbytes = sum(t.numel() * t.element_size() for t in parts)

    def clone():
        if isinstance(operand, tuple):
            return tuple(t.clone() for t in operand)
        return operand.clone()

    copies = [operand] + [clone() for _ in range(
        max(1, -(-COLD_BYTES // nbytes)) - 1)]
    calls = len(copies) * -(-min_calls // len(copies))
    for c in copies[:2]:   # warm-up (a library call may set itself up)
        fn(c)
    torch.cuda.synchronize()
    ms = graph_ms(torch, [lambda c=copies[i % len(copies)]: fn(c)
                          for i in range(calls)], replays)
    del copies
    # a library call captured in the graph leaves its workspace cached for
    # the capture stream: let it go with the graph
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    return ms


def int8pack_mm(torch, x, q_t, scale):
    """The library's weight-only int8 product, ``x [M, K]`` by ``q_t [N,
    K]`` with a per-channel scale, output in x's dtype; None and the
    reason where this torch has no CUDA kernel for it."""
    try:
        out = torch._weight_int8pack_mm(x, q_t, scale.to(x.dtype))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as err:
        return None, f"none: {type(err).__name__}: {str(err)[:160]}"
    return out, "torch._weight_int8pack_mm"


def time_int8_wdot(torch, i8, x, q, scale) -> dict:
    """K5 at one shape, bf16 x: the device time of a call with a cold L2
    (``ms``, cold_ms), the eager event time of back-to-back calls
    (``eager_ms``, the host's cost between them included), the host time
    of a call (``call_us``), the plain version, the bound, and beside
    them torch._weight_int8pack_mm (the library's int8-weight product,
    ``library_ms``, cold) and a dense bf16 torch.matmul over a widened
    copy of q (``dense_ms``, cold; it reads twice the weight bytes).
    Neither yardstick is called by the port."""
    m, k = x.shape
    n = q.shape[1]
    out = {"kernel": i8.int8_wdot_shape(x, q),
           "ms": cold_ms(torch, lambda c: i8.int8_wdot(x, c, scale), q),
           "eager_ms": cuda_ms(torch, lambda: i8.int8_wdot(x, q, scale)),
           "call_us": call_us(torch, lambda: i8.int8_wdot(x, q, scale)),
           "plain_ms": cuda_ms(torch, lambda: i8.int8_wdot_reference(
               x, q, scale), iters=5)}
    b_ms, b_by = bound(2.0 * m * k * n, k * n + 4 * n + 2 * m * k + 4 * m * n,
                       "bfloat16")
    out.update(bound_ms=b_ms, bound_by=b_by)
    q_t = q.t().contiguous()
    got, name = int8pack_mm(torch, x, q_t, scale)
    out["library"] = name
    out["library_ms"] = None
    if got is not None:
        s_x = scale.to(x.dtype)
        out["library_ms"] = cold_ms(
            torch, lambda c: torch._weight_int8pack_mm(x, c, s_x), q_t)
    del q_t, got
    dense = q.to(torch.bfloat16)
    out["dense_ms"] = cold_ms(torch, lambda c: torch.matmul(x, c), dense)
    out["dense_call_us"] = call_us(torch, lambda: torch.matmul(x, dense))
    del dense
    return out


# a profiled int8 request's kernel groups (group -> substring of names)
INT8_PROFILE_GROUPS = {"flash_ms": "flash_fwd", "wdot_ms": "wdot",
                       "wdot_decode_ms": "wdot_skinny",
                       "attention_ms": "decode_attn",
                       "kv_quantize_ms": "kv_quantize"}
# K6's extension shape: a [1, 256] suffix block against a 1024-token
# prefix (models/serving.py _extend at its largest suffix bucket)
K6_EXTEND = dict(prefix=1024, suffix=256)
K6_LONG = dict(rows=8, max_len=32768)   # a decode round of a 32K-token server


def int8_attention_inputs(torch, np, gen) -> dict:
    """K6's and K7's operands at the llama_350m serving shapes: a decode
    round (8 rows, max_len 2048, limits 129..2047, bf16 queries; the
    cache layer as a tuple), an extension (one row, K6_EXTEND: 256 bf16
    queries after a 1024-token prefix, max_len 1280), a decode round of
    a long cache (K6_LONG: 8 rows, max_len 32768, limits 129..32767, which
    K6 streams through one slot in rounds), a decode round's K7 write [8,
    1, 4, 64] (row 7 past the cache, dropped) and a 2048-token prefill
    stack [24, 2048, 4, 64], bf16."""
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]

    def cache(b, max_len):
        k8, v8 = (torch.randint(-127, 128, (b, max_len, kv, d),
                                generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((b, max_len, kv), generator=gen, device="cuda")
                  * 0.02 + 1e-3 for _ in range(2))
        return k8, v8, ks, vs

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    b, max_len = 8, 2048
    pre, suf = K6_EXTEND["prefix"], K6_EXTEND["suffix"]
    return {
        "decode_q": randn(b, 1, heads, d), "decode_cache": cache(b, max_len),
        "decode_lens": torch.tensor(np.linspace(129, 2047, b).astype(
            np.int64), device="cuda"),
        "extend_q": randn(1, suf, heads, d),
        "extend_cache": cache(1, pre + suf),
        "extend_lens": torch.tensor([pre], dtype=torch.int64, device="cuda"),
        "long_q": randn(K6_LONG["rows"], 1, heads, d),
        "long_cache": cache(K6_LONG["rows"], K6_LONG["max_len"]),
        "long_lens": torch.tensor(np.linspace(
            129, K6_LONG["max_len"] - 1, K6_LONG["rows"]).astype(np.int64),
            device="cuda"),
        "kvq_decode": (randn(b, 1, kv, d), randn(b, 1, kv, d)),
        "kvq_decode_lens": torch.tensor([0, 5, 129, 700, 1300, 2000, 2047,
                                         2048], dtype=torch.int64,
                                        device="cuda"),
        "kvq_prefill": (randn(LLAMA["layers"], 2048, kv, d),
                        randn(LLAMA["layers"], 2048, kv, d))}


def time_int8_attention(torch, i8, inp,
                        shapes=("decode", "extend", "long")) -> dict:
    """K6 at the decode, the extension and the long shape: the device
    time of a call
    with a cold L2 (``ms``: cold_ms, a CUDA graph over copies of the cache
    layer), the eager event time of back-to-back calls (``eager_ms``, the
    host's time between them included) and the host time of a call
    (``host_us``), beside the bound."""
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    out = {}
    for shape in shapes:
        q, layer, lens = (inp[f"{shape}_q"], inp[f"{shape}_cache"],
                          inp[f"{shape}_lens"])
        b, t = q.shape[:2]
        max_len = layer[0].shape[1]
        limits = (lens[:, None] + torch.arange(t, device="cuda")).clamp(
            max=max_len - 1)
        visible = int((limits + 1).sum())             # query-positions
        rows = int(limits[:, -1].sum()) + b           # positions read
        b_ms, b_by = bound(4.0 * heads * d * visible,
                           rows * kv * (2 * d + 8) + 2 * 2 * b * t * heads * d,
                           "bfloat16")

        def call(c=layer, q=q, lens=lens):
            return i8.decode_attention_int8(q, *c, lengths=lens)

        out[shape] = dict(
            ms=cold_ms(torch, lambda c: call(c), layer),
            eager_ms=cuda_ms(torch, call), host_us=host_us(torch, call),
            bound_ms=b_ms, bound_by=b_by, visible_positions=visible)
    return out


def time_kv_quantize(torch, i8, inp) -> dict:
    """K7 at the prefill stack (``prefill``: kv_quantize_rows, the device
    time in a CUDA graph over copies of K and V, cold_ms) and at a decode
    round's write (``decode``: the same write captured 20 times in a
    graph, graph_ms), each beside its eager event time, the host time of
    a call and the bound (the bytes of the rows kept)."""
    kx, vx = inp["kvq_prefill"]
    elems = 2 * kx.numel()
    d = kx.shape[-1]
    b_ms, b_by = bound(3.0 * elems, elems * (2 + 1) + elems // d * 4,
                       "float32")

    def rows(c=(kx, vx)):
        return i8.kv_quantize_rows(*c)

    out = {"prefill": dict(ms=cold_ms(torch, rows, (kx, vx)),
                           eager_ms=cuda_ms(torch, rows),
                           host_us=host_us(torch, rows), bound_ms=b_ms,
                           bound_by=b_by)}
    kx, vx = inp["kvq_decode"]
    lens = inp["kvq_decode_lens"]
    b, _, kv, d = kx.shape
    cache = [torch.zeros((b, 2048, kv, d), dtype=torch.int8, device="cuda")
             for _ in range(2)] + [torch.ones((b, 2048, kv), device="cuda")
                                   for _ in range(2)]

    def write():
        i8.kv_quantize(kx, vx, *cache, lengths=lens)

    kept = 2 * int((lens < 2048).sum()) * kv
    b_ms, b_by = bound(3.0 * kept * d, kept * (d * (2 + 1) + 4), "float32")
    out["decode"] = dict(ms=graph_ms(torch, [write] * 20),
                         eager_ms=cuda_ms(torch, write),
                         host_us=host_us(torch, write), bound_ms=b_ms,
                         bound_by=b_by)
    return out


def int8_holder(checks: dict, max_err: dict):
    """``hold(name, label, got, want, f32)``: records in ``checks`` whether
    a K5 or K6 result is within its tolerance of its plain version (f32:
    rtol 2e-5, atol 2e-5; bf16: 2^-7 of the plain output's largest
    magnitude) and raises ``max_err[name]`` to its largest difference."""
    def hold(name, label, got, want, f32):
        err = float((got.float() - want.float()).abs().max())
        if f32:
            ok = bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
        else:
            ok = err <= 2.0 ** -7 * float(want.float().abs().max())
        checks[f"{name}/{label}"] = ok
        max_err[name] = max(max_err[name], err)

    return hold


def check_int8_kernels(torch, np, gen) -> tuple[dict, dict]:
    """The three kernels of csrc/int8_serve.cu against their plain
    versions on the card at the llama_350m serving shapes: int8_wdot (K5)
    at every (K, N) of the model with M 1, 8 and 16 (decode rounds) and
    2048 (the largest prefill bucket), in f32 and bf16, timed in bf16 by
    time_int8_wdot (a cold L2's device time, eager time, the library's
    int8-weight product and a dense bf16 matmul beside it);
    decode_attention_int8 (K6) at 8 rows, max_len 2048, 4 KV heads of 4
    query heads, D 64, ragged limits 129..2047 and a contiguous block, at
    the extension shape (K6_EXTEND) and at a long cache (K6_LONG), timed
    by time_int8_attention;
    kv_quantize (K7) at a decode round's [8, 1, 4, 64] (one write past
    max_len, dropped) and a 2048-token prefill stack [24, 2048, 4, 64],
    byte for byte, timed by time_kv_quantize.  Each beside its plain
    version and its bound.  Returns (max_abs_err, times) by kernel name."""
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    checks, report = {}, {}
    max_err = {name: 0.0 for name in INT8_REPLACES}
    hold = int8_holder(checks, max_err)

    with torch.inference_mode():
        for k, n in INT8_WDOT_SHAPES:
            q = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
            scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
            for m in INT8_WDOT_ROWS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device="cuda",
                                    dtype=dtype)
                    hold("int8_wdot", f"{m}x{k}x{n}/{dtype}",
                         i8.int8_wdot(x, q, scale),
                         i8.int8_wdot_reference(x, q, scale),
                         dtype == torch.float32)
                report[f"int8_wdot {m}x{k}x{n}"] = time_int8_wdot(
                    torch, i8, x, q, scale)
            del q, scale
        # K6: the serving shape, ragged and contiguous
        b, max_len, kv, d = 8, 2048, LLAMA["kv"], LLAMA["d"]
        inp = int8_attention_inputs(torch, np, gen)
        k8, v8, ks, vs = inp["decode_cache"]
        lens = inp["decode_lens"]
        for dtype in (torch.float32, torch.bfloat16):
            q = inp["decode_q"].to(dtype)
            for label, kw in (("ragged", dict(lengths=lens)),
                              ("contiguous", dict(base=1500))):
                got = i8.decode_attention_int8(q, k8, v8, ks, vs, **kw)
                want = i8.decode_attention_int8_reference(
                    q, k8, v8, ks, vs, kw.get("lengths"), kw.get("base", 0))
                hold("decode_attention_int8", f"{label}/{dtype}", got, want,
                     dtype == torch.float32)
        q = inp["extend_q"]
        hold("decode_attention_int8", "extend/torch.bfloat16",
             i8.decode_attention_int8(q, *inp["extend_cache"],
                                      lengths=inp["extend_lens"]),
             i8.decode_attention_int8_reference(
                 q, *inp["extend_cache"], inp["extend_lens"], 0), False)
        for dtype in (torch.float32, torch.bfloat16):
            q = inp["long_q"].to(dtype)
            hold("decode_attention_int8", f"long/{dtype}",
                 i8.decode_attention_int8(q, *inp["long_cache"],
                                          lengths=inp["long_lens"]),
                 i8.decode_attention_int8_reference(
                     q, *inp["long_cache"], inp["long_lens"], 0),
                 dtype == torch.float32)
        times = time_int8_attention(torch, i8, inp)
        q = inp["decode_q"]
        plain = cuda_ms(torch, lambda: i8.decode_attention_int8_reference(
            q, k8, v8, ks, vs, lens, 0), iters=5)
        report["decode_attention_int8"] = dict(
            **times["decode"], plain_ms=plain, library_ms=None,
            extend=times["extend"], long=times["long"])
        del k8, v8, ks, vs
        # K7: a decode round's write (row 7 past the cache, dropped) and a
        # prefill stack, bytes equal to the plain version
        kx, vx = inp["kvq_decode"]
        dec_lens = inp["kvq_decode_lens"]
        outs = []
        for _ in range(2):
            outs.append([torch.zeros((b, max_len, kv, d), dtype=torch.int8,
                                     device="cuda") for _ in range(2)]
                        + [torch.ones((b, max_len, kv), device="cuda")
                           for _ in range(2)])
        i8.kv_quantize(kx, vx, *outs[0], lengths=dec_lens)
        i8.kv_quantize_reference(kx, vx, *outs[1], dec_lens, 0)
        checks["kv_quantize/decode"] = all(
            same_bytes(torch, g, w) for g, w in zip(*outs))
        del outs
        kx, vx = inp["kvq_prefill"]
        got = i8.kv_quantize_rows(kx, vx)
        ref_k, ref_v = i8.kv_rows_reference(kx), i8.kv_rows_reference(vx)
        want = (ref_k[0], ref_v[0], ref_k[1], ref_v[1])
        checks["kv_quantize/prefill"] = all(
            same_bytes(torch, g, w) for g, w in zip(got, want))
        max_err["kv_quantize"] = max(
            float((g.float() - w.float()).abs().max())
            for g, w in zip(got, want))
        del got, want, ref_k, ref_v
        times = time_kv_quantize(torch, i8, inp)
        plain = cuda_ms(torch, lambda: (i8.kv_rows_reference(kx),
                                        i8.kv_rows_reference(vx)), iters=5)
        report["kv_quantize"] = dict(**times["prefill"], plain_ms=plain,
                                     library_ms=None, decode=times["decode"])
        del kx, vx, inp
    emit({"phase": "int8_kernels", "checks": checks, "max_abs_err": max_err,
          **report})
    if not all(checks.values()):
        fail(f"an int8 serving kernel differs from its plain version: "
             f"{[k for k, ok in checks.items() if not ok]}")
    torch.cuda.empty_cache()
    times = {"int8_wdot": report["int8_wdot 8x1024x32000"],
             "decode_attention_int8": report["decode_attention_int8"],
             "kv_quantize": report["kv_quantize"]}
    return max_err, times


def serve_int8(torch, np, fa, rng) -> dict:
    """int8 serving: llama_350m's bf16 store through quantize_params,
    served by a DecodeServer with the int8 KV cache (8 slots x 2048) on
    the same 8-prompt burst as ``serve``; its launches must be the counts
    the design gives (a prefill: flash_fwd once a layer, int8_wdot 7 times
    a layer and once for the LM head, kv_quantize once; a decode round:
    int8_wdot as a prefill, decode_attention_int8 and kv_quantize once a
    layer).  A profiled request, then the prefix leg: a 1024-token prefix
    served once, 8 prompts that extend it by 64-256 tokens (each must
    extend it: 8 prefix hits) and one exact resubmission (a prompt hit),
    the extensions' TTFT beside the same prompts on a server without the
    cache.  Last, a 2-layer f32 model (head_dim 64) with int8 weights,
    the int8 cache and the prefix cache, whose greedy streams must be
    token-exact against generate with the same weights and cache dtype,
    for extended and replayed prompts.  Returns the burst's launches."""
    from parameter_server_distributed_tpu_torch.models import serving
    from parameter_server_distributed_tpu_torch.models.generation import \
        generate
    from parameter_server_distributed_tpu_torch.models.quant import (
        quantize_params, store_bytes)
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, flash_attention_auto)
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    model = get_model("llama_350m", dtype="bf16")
    params = quantize_params(model.init_params(0, device="cuda"))
    torch.cuda.empty_cache()
    as_is, dense_bytes = store_bytes(params)
    vocab = model.config.vocab
    prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
    srv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                               cache_dtype="int8", device="cuda")
    cache = srv._cache
    cache_bytes = {"codes": cache.k.numel() + cache.v.numel(),
                   "scales": 4 * (cache.k_scale.numel()
                                  + cache.v_scale.numel()),
                   "bf16_equivalent": 2 * (cache.k.numel() + cache.v.numel())}
    warm_buckets(serving, srv, prompts[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    i8.reset_launches()
    b = burst(torch, srv, prompts)
    launches = {**fa.launches, **i8.launches}
    layers, prefills, rounds = LLAMA["layers"], len(prompts), len(b["gaps"])
    per_forward = 7 * layers + 1
    expected = {"flash_fwd": layers * prefills, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0,
                "int8_wdot": per_forward * (prefills + rounds),
                "decode_attention_int8": layers * rounds,
                "kv_quantize": prefills + layers * rounds}
    emit({"phase": "serve_int8", "model": "llama_350m",
          "dtype": "bfloat16, int8 weights, int8 KV cache", "slots": 8,
          "max_len": 2048, "prompt_lens": list(PROMPT_LENS),
          **burst_report(np, b),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "store_bytes": as_is, "store_bytes_unquantized": dense_bytes,
          "cache_bytes": cache_bytes, "launches": launches,
          "expected_launches": expected})
    check_streams(b, vocab, "int8 serving")
    if launches != expected:
        fail(f"int8 serving launches {launches} != {expected}")

    def one_request():
        srv.submit(prompts[-1], max_new_tokens=8)
        srv.run_to_completion()

    prof = profile_window(torch, one_request, INT8_PROFILE_GROUPS)
    # K5's prefill products: every K5 launch that is not a decode round's
    wdot = prof["group_ms"]
    prof["group_ms"]["wdot_prefill_ms"] = (
        None if wdot["wdot_ms"] is None
        else wdot["wdot_ms"] - wdot["wdot_decode_ms"])
    emit({"phase": "profile_int8", **prof})
    del srv, cache
    torch.cuda.empty_cache()

    # the prefix leg
    prefix = rng.integers(0, vocab, PREFIX_LEN).tolist()
    exts = [prefix + rng.integers(0, vocab, n).tolist()
            for n in PREFIX_SUFFIXES]

    def prefix_ttft(server):
        t0 = time.perf_counter()
        times = []
        for p in exts:
            server.submit(p, max_new_tokens=8)
            times.append(time.perf_counter() - t0)
        server.run_to_completion()
        return times

    psrv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                                cache_dtype="int8", prompt_cache=16,
                                device="cuda")
    psrv.submit(prefix, max_new_tokens=4)
    psrv.run_to_completion()
    fa.reset_launches()
    i8.reset_launches()
    cached = prefix_ttft(psrv)
    leg_launches = {**fa.launches, **i8.launches}
    t1 = time.perf_counter()
    psrv.submit(exts[3], max_new_tokens=8)
    replay_s = time.perf_counter() - t1
    psrv.run_to_completion()
    stats = psrv.stats
    del psrv
    torch.cuda.empty_cache()
    nsrv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                                cache_dtype="int8", device="cuda")
    plain = prefix_ttft(nsrv)
    del nsrv
    emit({"phase": "serve_int8_prefix", "prefix_len": PREFIX_LEN,
          "suffix_lens": list(PREFIX_SUFFIXES),
          "ttft_p50_s": float(np.median(cached)), "ttft_s": cached,
          "no_cache_ttft_p50_s": float(np.median(plain)),
          "no_cache_ttft_s": plain, "replay_ttft_s": replay_s,
          "launches": leg_launches, "stats": stats})
    if (stats["prefix_hits"] != 8 or stats["prompt_cache_hits"] != 1
            or stats["prefill_tokens"] >= stats["prompt_tokens"]):
        fail(f"the prefix leg's stats {stats}: want 8 prefix hits, 1 prompt "
             f"hit and fewer prefill than prompt tokens")

    # f32: int8 weights, int8 cache and the prefix cache, token-exact
    # against generate
    small = Transformer(TransformerConfig(
        vocab=1024, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=torch.float32),
        attention_fn=flash_attention_auto)          # head_dim 64
    sparams = quantize_params(small.init_params(1, device="cuda"))
    base = rng.integers(0, 1024, 128).tolist()
    longer = base + rng.integers(0, 1024, 32).tolist()
    sprompts = {"first": base, "extended": longer,
                "extended_twice": longer + rng.integers(0, 1024, 40).tolist(),
                "replayed": longer}
    ssrv = serving.DecodeServer(small, sparams, slots=2, max_len=512,
                                cache_dtype="int8", prompt_cache=8,
                                device="cuda")
    exact = {}
    for label, p in sprompts.items():
        rid = ssrv.submit(p, max_new_tokens=8)
        got = ssrv.run_to_completion()[rid]
        exact[label] = got == generate(small, sparams, [p], 8,
                                       cache_dtype="int8")[0].tolist()
    sstats = ssrv.stats
    emit({"phase": "serve_int8_vs_generate_f32",
          "model": "2-layer f32, head_dim 64, int8 weights and cache",
          "token_exact": exact, "stats": sstats})
    if not all(exact.values()) or sstats["prefix_hits"] != 2 \
            or sstats["prompt_cache_hits"] != 1:
        fail(f"f32 int8 DecodeServer streams differ from generate or "
             f"missed the cache: {exact}, {sstats}")
    return launches


def cli_int8() -> None:
    """The two CLIs with the int8 flags, as processes at once:
    serve_main (--quant=int8 --kv-cache=int8 --prompt-cache=4
    --fused-rounds=4) answering 2 JSONL requests and generate_main
    (--quant=int8 --kv-cache=int8) answering one prompt; both exit 0."""
    env = dict(os.environ, PYTHONPATH=HERE, PSDT_FLASH_ATTENTION="1")
    reqs = [{"id": 1, "tokens": list(range(100, 400)), "max_new": 8},
            {"id": 2, "prompt": "The parameter server " * 10, "max_new": 8}]
    serve = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.cli.serve_main",
         "--model=llama_350m", "--slots=2", "--max-len=2048",
         "--quant=int8", "--kv-cache=int8", "--prompt-cache=4",
         "--fused-rounds=4"], cwd=HERE, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    gen = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.cli.generate_main",
         "--model=llama_350m", "--quant=int8", "--kv-cache=int8",
         "--prompt=The parameter server", "--max-new=8"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = serve.communicate(
            "".join(json.dumps(r) + "\n" for r in reqs), timeout=600)
        g_out, g_err = gen.communicate(timeout=600)
    finally:
        for proc in (serve, gen):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    done = [line for line in lines if line.get("done")]
    emit({"phase": "cli_int8", "serve_returncode": serve.returncode,
          "done_lines": len(done), "serve_stderr_tail": err[-400:],
          "generate_returncode": gen.returncode,
          "generate_stdout": g_out[-200:], "generate_stderr_tail":
          g_err[-400:]})
    if serve.returncode != 0 or sorted(d["id"] for d in done) != [1, 2]:
        fail(f"serve_main --quant=int8 answered {len(done)} of 2 requests "
             f"(exit {serve.returncode})")
    if gen.returncode != 0:
        fail(f"generate_main --quant=int8 exited {gen.returncode}")


# the speculative serving phase (serve_spec): draft_len of its legs, the
# rows K5 takes there (the draft's catch-up block of 8 x 2 tokens, the
# verify block of 8 x (k + 1)), and the plain / speculative turns a leg
SPEC_K = 4
SPEC_ROWS = (16, 8 * (SPEC_K + 1))
SPEC_TURNS = ("plain", "spec", "spec", "plain")
BEAM = dict(width=4, prompt=512, new=32)     # one prompt of llama_350m


def check_spec_kernels(torch, np, gen) -> tuple[dict, dict]:
    """K5, K6 and K7 at the shapes speculative serving gives them, against
    their plain versions (the tolerances of check_int8_kernels): K5 at
    M 16 (the draft's catch-up block, the skinny kernel's limit) and M 40
    (the verify block at k = 4: bf16 on wgmma, f32 on the tiled kernel)
    at every llama_350m product, f32 rows bit for bit against the same
    rows at M 1; K6 at a ragged verify block of T = 5 (8 rows, max_len
    2048, one row straddling the cache's end and one finished row past
    it), f32 bit for bit against 5 single-query calls; K7 at the same
    block, byte for byte (the writes past max_len dropped).  K5 and K6
    timed with a cold L2 in a CUDA graph (cold_ms), K7 in a graph of 20
    writes (graph_ms), each beside its bound.  Returns (max_abs_err,
    times) by kernel name."""
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    checks, report = {}, {}
    max_err = {name: 0.0 for name in INT8_REPLACES}
    hold = int8_holder(checks, max_err)
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    t, b, max_len = SPEC_K + 1, 8, 2048

    with torch.inference_mode():
        for k, n in INT8_WDOT_SHAPES:
            q = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
            scale = torch.rand(n, generator=gen, device="cuda") * 1e-3 + 1e-4
            for m in SPEC_ROWS:
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((m, k), generator=gen, device="cuda",
                                    dtype=dtype)
                    got = i8.int8_wdot(x, q, scale)
                    hold("int8_wdot", f"{m}x{k}x{n}/{dtype}", got,
                         i8.int8_wdot_reference(x, q, scale),
                         dtype == torch.float32)
                    if dtype == torch.float32:
                        checks[f"int8_wdot/{m}x{k}x{n}/rows_as_m1"] = all(
                            bits_equal(torch, i8.int8_wdot(
                                x[r:r + 1].contiguous(), q, scale),
                                got[r:r + 1]) for r in (0, m // 2, m - 1))
                b_ms, b_by = bound(2.0 * m * k * n, k * n + 4 * n + 2 * m * k
                                   + 4 * m * n, "bfloat16")
                report[f"int8_wdot {m}x{k}x{n}"] = dict(
                    kernel=i8.int8_wdot_shape(x, q),
                    ms=cold_ms(torch, lambda c: i8.int8_wdot(x, c, scale),
                               q),
                    plain_ms=cuda_ms(torch, lambda: i8.int8_wdot_reference(
                        x, q, scale), iters=5),
                    bound_ms=b_ms, bound_by=b_by)
            del q, scale
        # K6 and K7 at a ragged verify block: limits across the chunks,
        # one row ending on the cache's last position, one straddling
        # it, one finished row past it
        lens = torch.tensor([129, 300, 700, 1000, 1500, max_len - t,
                             max_len - 2, max_len + 3], dtype=torch.int64,
                            device="cuda")
        k8, v8 = (torch.randint(-127, 128, (b, max_len, kv, d), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, max_len, kv), generator=gen, device="cuda")
                  * 0.02 + 1e-3 for _ in range(2))
        layer = (k8, v8, ks, vs)
        q_bf = torch.randn((b, t, heads, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            q = q_bf.to(dtype)
            got = i8.decode_attention_int8(q, *layer, lengths=lens)
            hold("decode_attention_int8", f"verify_t{t}/{dtype}", got,
                 i8.decode_attention_int8_reference(q, *layer, lens, 0),
                 dtype == torch.float32)
            if dtype == torch.float32:
                checks[f"decode_attention_int8/verify_t{t}/as_single"] = all(
                    bits_equal(torch, i8.decode_attention_int8(
                        q[:, j:j + 1].contiguous(), *layer,
                        lengths=lens + j), got[:, j:j + 1].contiguous())
                    for j in range(t))
        times = time_int8_attention(
            torch, i8, {"verify_q": q_bf, "verify_cache": layer,
                        "verify_lens": lens}, ("verify",))
        report["decode_attention_int8"] = dict(
            **times["verify"], plain_ms=cuda_ms(
                torch, lambda: i8.decode_attention_int8_reference(
                    q_bf, *layer, lens, 0), iters=5))
        kx, vx = (torch.randn((b, t, kv, d), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(2))
        outs = [[torch.zeros((b, max_len, kv, d), dtype=torch.int8,
                             device="cuda") for _ in range(2)]
                + [torch.ones((b, max_len, kv), device="cuda")
                   for _ in range(2)] for _ in range(2)]
        i8.kv_quantize(kx, vx, *outs[0], lengths=lens)
        i8.kv_quantize_reference(kx, vx, *outs[1], lens, 0)
        checks[f"kv_quantize/verify_t{t}"] = all(
            same_bytes(torch, g, w) for g, w in zip(*outs))
        max_err["kv_quantize"] = max(float((g.float() - w.float()).abs().max())
                                     for g, w in zip(*outs))
        cache = outs[0]

        def write():
            i8.kv_quantize(kx, vx, *cache, lengths=lens)

        kept = 2 * int(((lens[:, None] + torch.arange(t, device="cuda"))
                        < max_len).sum()) * kv
        b_ms, b_by = bound(3.0 * kept * d, kept * (d * (2 + 1) + 4),
                           "float32")
        report["kv_quantize"] = dict(
            ms=graph_ms(torch, [write] * 20), bound_ms=b_ms, bound_by=b_by,
            plain_ms=cuda_ms(torch, lambda: i8.kv_quantize_reference(
                kx, vx, *outs[1], lens, 0), iters=5))
        del outs, cache, layer, k8, v8, ks, vs
    emit({"phase": "spec_kernels", "checks": checks, "max_abs_err": max_err,
          **report})
    if not all(checks.values()):
        fail(f"an int8 serving kernel differs from its plain version at the "
             f"verify shapes: {[k for k, ok in checks.items() if not ok]}")
    torch.cuda.empty_cache()
    return max_err, report


def _spec_burst(torch, np, srv, prompts, launches_of) -> dict:
    """One 8-request ``burst`` on ``srv``: TTFT, gaps, tokens/s, the
    launches (from 0), and tokens per target forward (a request's tokens
    over its prefill and the rounds it took part in)."""
    torch.cuda.synchronize()
    launches_of(reset=True)
    b = burst(torch, srv, prompts)
    forwards = len(b["rids"]) + sum(len(e) for e in b["emitted"])
    tokens = sum(len(b["results"][r]) for r in b["rids"])
    return {"results": [b["results"][r] for r in b["rids"]],
            "tokens": tokens, "wall_s": b["wall"],
            "tokens_per_s": tokens / b["wall"],
            "ttft_p50_s": float(np.median(b["ttft"])),
            "gap_p50_s": float(np.median(b["gaps"])),
            "rounds": len(b["gaps"]),
            "tokens_per_target_forward": tokens / forwards,
            "launches": launches_of(), "stats": srv.stats}


def serve_spec(torch, np, fa) -> dict:
    """Speculative serving: llama_350m (bf16, seed 0) in DecodeServers of
    8 slots x 2048 on serve's 8-prompt burst (the same prompts), 32 new
    tokens, greedy, in three legs: ``self`` (draft = the target, k = 4
    pinned: every proposal agrees, the upper bound of the accept rate),
    ``layers2`` (a 2-layer draft of llama_350m's widths, seed 1, the
    adaptive depth controller from k = 2, cost ratio the parameter share)
    on the native cache, and ``self_int8`` (int8 weights and cache, k = 4
    pinned).  Each leg runs plain decode and speculation in turns (plain,
    spec, spec, plain; a fresh server a turn) and holds every speculative
    turn's launches to the design's counts: a prefill runs flash_fwd once
    a layer of each model; a round runs k + 1 forwards of the target's
    layers (the draft's catch-up block, k - 1 draft steps, the verify
    block; draft = target), each 169 int8_wdot, 24 decode_attention_int8
    and 24 kv_quantize on the int8 leg.  One round's host syncs are
    counted at the dispatcher.  Then beam search at width 4 (one prompt of
    512 tokens, 32 new), and a 2-layer f32 model (head_dim 64) with int8
    weights whose speculative greedy streams (the server with and without
    the prefix cache, both cache dtypes; the batched decoder) must be
    token-exact against generate, and beam width 1 equal to greedy.
    Returns the speculative turns' launches, summed."""
    from parameter_server_distributed_tpu_torch.models import serving
    from parameter_server_distributed_tpu_torch.models.generation import (
        beam_search, generate, speculative_generate_batched)
    from parameter_server_distributed_tpu_torch.models.quant import \
        quantize_params
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, flash_attention_auto)
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    model = get_model("llama_350m", dtype="bf16")
    params = model.init_params(0, device="cuda")
    layers = LLAMA["layers"]
    d2 = Transformer(dataclasses.replace(model.config, n_layers=2),
                     attention_fn=model.attention_fn)
    d2params = d2.init_params(1, device="cuda")
    qparams = quantize_params(params)
    torch.cuda.empty_cache()
    vocab = model.config.vocab
    rng = np.random.default_rng(0)         # serve's prompts, drawn alike
    prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
    legs = {
        "self": dict(params=params, cache_dtype="native", draft=model,
                     draft_params=params, adaptive_draft=False),
        "layers2": dict(params=params, cache_dtype="native", draft=d2,
                        draft_params=d2params, adaptive_draft=True,
                        draft_cost_ratio=max(
                            0.05, d2.num_params() / model.num_params())),
        "self_int8": dict(params=qparams, cache_dtype="int8", draft=model,
                          draft_params=qparams, adaptive_draft=False)}

    def launches_of(reset=False):
        if reset:
            fa.reset_launches()
            i8.reset_launches()
            return None
        return {**fa.launches, **i8.launches}

    def server(leg, spec):
        kw = dict(legs[leg])
        p, cache_dtype = kw.pop("params"), kw.pop("cache_dtype")
        if not spec:
            kw = {}
        return serving.DecodeServer(model, p, slots=8, max_len=2048,
                                    cache_dtype=cache_dtype, device="cuda",
                                    draft_len=SPEC_K, **kw)

    total = {}
    report = {}
    for leg, kw in legs.items():
        int8 = kw["cache_dtype"] == "int8"
        dlayers = kw["draft"].config.n_layers
        # warm-up outside the count: a request per prefill bucket
        for spec in (False, True):
            srv = server(leg, spec)
            for n in sorted({min(serving._bucket(n), 2048)
                             for n in PROMPT_LENS}):
                srv.submit((prompts[0] * (n // len(prompts[0]) + 1))[:n - 16],
                           max_new_tokens=4)
                srv.run_to_completion()
            del srv
        turns = []
        for kind in SPEC_TURNS:
            srv = server(leg, kind == "spec")
            turn = _spec_burst(torch, np, srv, prompts, launches_of)
            turn["kind"] = kind
            if kind == "spec":
                # one round's host syncs, on a fresh burst's first round
                srv.submit(prompts[0], max_new_tokens=NEW_TOKENS)
                srv.submit(prompts[1], max_new_tokens=NEW_TOKENS)
                turn["round_syncs"] = {"depth": srv.stats["draft_depth"],
                                       **host_syncs(torch, srv.step)}
                srv.run_to_completion()
            del srv
            torch.cuda.empty_cache()
            turns.append(turn)
        plain = [t for t in turns if t["kind"] == "plain"]
        spec = [t for t in turns if t["kind"] == "spec"]
        prefills = len(prompts)
        for t in turns:
            rounds = t["rounds"]
            if t["kind"] == "plain":
                want = {"flash_fwd": layers * prefills}
                if int8:
                    want.update(int8_wdot=(7 * layers + 1) * (prefills
                                                              + rounds),
                                decode_attention_int8=layers * rounds,
                                kv_quantize=prefills + layers * rounds)
            else:
                want = {"flash_fwd": (layers + dlayers) * prefills}
                if int8:
                    fwd = (SPEC_K + 1) * rounds
                    want.update(int8_wdot=(7 * layers + 1) * (2 * prefills
                                                              + fwd),
                                decode_attention_int8=layers * fwd,
                                kv_quantize=2 * prefills + layers * fwd)
            got = {name: n for name, n in t["launches"].items() if n}
            t["expected_launches"] = want
            if got != want:
                fail(f"serve_spec leg {leg} ({t['kind']}) launches {got} "
                     f"!= {want}")
        for t in spec:
            for name, n in t["launches"].items():
                total[name] = total.get(name, 0) + n
        agree = [sum(a == b for a, b in zip(t["results"],
                                            plain[0]["results"]))
                 for t in spec]
        if not all(len(r) == NEW_TOKENS and all(0 <= x < vocab for x in r)
                   for t in turns for r in t["results"]):
            fail(f"serve_spec leg {leg} did not answer every request with "
                 f"{NEW_TOKENS} in-vocab tokens")
        med = {kind: {key: float(np.median([t[key] for t in turns
                                            if t["kind"] == kind]))
                      for key in ("ttft_p50_s", "gap_p50_s", "tokens_per_s",
                                  "tokens_per_target_forward")}
               for kind in ("plain", "spec")}
        report[leg] = {
            "turns": [{k: v for k, v in t.items() if k != "results"}
                      for t in turns],
            "median": med,
            "spec_over_plain_tokens_per_s": (med["spec"]["tokens_per_s"]
                                             / med["plain"]["tokens_per_s"]),
            "accept_rate": [t["stats"]["draft_accept_rate"] for t in spec],
            "final_draft_depth": [t["stats"]["draft_depth"] for t in spec],
            "streams_equal_plain": agree}
        emit({"phase": "serve_spec", "leg": leg, "model": "llama_350m",
              "draft": ("llama_350m itself" if kw["draft"] is model
                        else "2-layer llama_350m widths, seed 1"),
              "dtype": ("bfloat16, int8 weights, int8 KV cache" if int8
                        else "bfloat16, native cache"), "slots": 8,
              "max_len": 2048, "draft_len": SPEC_K,
              "adaptive_draft": kw["adaptive_draft"], **report[leg]})
    # beam search at width 4
    tok = torch.tensor([prompts[4][:BEAM["prompt"]]], device="cuda")
    beam_search(model, params, tok, 4, beam_width=BEAM["width"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, score = beam_search(model, params, tok, BEAM["new"],
                             beam_width=BEAM["width"])
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    emit({"phase": "beam_search", "model": "llama_350m", "dtype": "bfloat16",
          "prompts": 1, "prompt_len": BEAM["prompt"],
          "beam_width": BEAM["width"], "new_tokens": BEAM["new"],
          "wall_s": beam_s, "tokens_per_s": BEAM["new"] / beam_s,
          "score": float(score[0]),
          "finite": bool(torch.isfinite(score).all())})
    if out.shape != (1, BEAM["new"]) or not torch.isfinite(score).all():
        fail(f"beam search gave {tuple(out.shape)}, score {score}")
    del params, qparams, d2params
    torch.cuda.empty_cache()

    # f32: token-exact against generate
    small = Transformer(TransformerConfig(
        vocab=1024, d_model=256, n_heads=4, n_kv_heads=2, n_layers=2,
        d_ff=512, max_seq=512, mlp_act="swiglu", dtype=torch.float32),
        attention_fn=flash_attention_auto)          # head_dim 64
    dense = small.init_params(1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    # a draft that agrees in part: the target's weights, perturbed
    noisy = {name: w + 0.03 * w.std() * torch.randn(
        w.shape, generator=g, device="cuda") if w.ndim == 2 else w
        for name, w in dense.items()}
    sparams, sdraft = quantize_params(dense), quantize_params(noisy)
    base = rng.integers(0, 1024, 128).tolist()
    longer = base + rng.integers(0, 1024, 32).tolist()
    sprompts = {"first": base, "extended": longer,
                "extended_twice": longer + rng.integers(0, 1024, 40).tolist(),
                "replayed": longer}
    exact, accept = {}, {}
    for cache_dtype in ("native", "int8"):
        for pcache in (0, 8):
            ssrv = serving.DecodeServer(
                small, sparams, slots=2, max_len=512,
                cache_dtype=cache_dtype, prompt_cache=pcache,
                draft=small, draft_params=sdraft, draft_len=SPEC_K,
                adaptive_draft=False, device="cuda")
            label = f"{cache_dtype}/prompt_cache={pcache}"
            for name, p in sprompts.items():
                rid = ssrv.submit(p, max_new_tokens=16)
                got = ssrv.run_to_completion()[rid]
                exact[f"{label}/{name}"] = got == generate(
                    small, sparams, [p], 16,
                    cache_dtype=cache_dtype)[0].tolist()
            accept[label] = ssrv.stats["draft_accept_rate"]
            if pcache and (ssrv.stats["prefix_hits"] != 2
                           or ssrv.stats["prompt_cache_hits"] != 1):
                fail(f"the f32 speculative server missed the prefix cache: "
                     f"{ssrv.stats}")
        batch = torch.tensor([rng.integers(0, 1024, 96).tolist()
                              for _ in range(8)], device="cuda")
        got, bstats = speculative_generate_batched(
            small, sparams, small, sdraft, batch, 16, draft_len=SPEC_K,
            cache_dtype=cache_dtype)
        exact[f"{cache_dtype}/batched"] = torch.equal(
            got, generate(small, sparams, batch, 16,
                          cache_dtype=cache_dtype))
        accept[f"{cache_dtype}/batched"] = bstats["draft_accept_rate"]
    beam1, _ = beam_search(small, sparams, batch, 16, beam_width=1)
    exact["beam_width_1"] = torch.equal(beam1, generate(small, sparams,
                                                        batch, 16))
    emit({"phase": "serve_spec_vs_generate_f32",
          "model": "2-layer f32, head_dim 64, int8 weights",
          "draft": "the same model, weights perturbed, int8",
          "token_exact": exact, "accept_rate": accept})
    if not all(exact.values()):
        fail(f"f32 speculative streams differ from generate: {exact}")
    return total


def cli_spec() -> None:
    """The two CLIs with the speculative and beam flags, as processes at
    once: serve_main with llama_350m drafting for itself (--draft-seed=0,
    --draft-len=4 pinned: every round commits several tokens a request)
    answering 2 JSONL requests, each token streamed once and in order;
    generate_main --beam=4 answering one prompt; both exit 0."""
    env = dict(os.environ, PYTHONPATH=HERE, PSDT_FLASH_ATTENTION="1")
    reqs = [{"id": 1, "tokens": list(range(100, 400)), "max_new": 9},
            {"id": 2, "tokens": list(range(7, 50)), "max_new": 7}]
    serve = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.cli.serve_main",
         "--model=llama_350m", "--slots=2", "--max-len=512",
         "--draft-model=llama_350m", "--draft-seed=0", "--draft-len=4",
         "--no-adaptive-draft"], cwd=HERE, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    gen = subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.cli.generate_main",
         "--model=llama_350m", "--beam=4", "--tokens=5,6,7,8,9",
         "--max-new=8"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = serve.communicate(
            "".join(json.dumps(r) + "\n" for r in reqs), timeout=600)
        g_out, g_err = gen.communicate(timeout=600)
    finally:
        for proc in (serve, gen):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    lines = [json.loads(line) for line in out.splitlines() if line.strip()]
    done = {line["id"]: line["tokens"] for line in lines if line.get("done")}
    streamed: dict = {}
    for line in lines:
        if "token" in line:
            streamed.setdefault(line["id"], []).append(line["token"])
    stats = err.split("serving stats: ")[-1].strip()
    emit({"phase": "cli_spec", "serve_returncode": serve.returncode,
          "done": {k: len(v) for k, v in done.items()},
          "serve_stats": stats[-400:], "serve_stderr_tail": err[-300:],
          "generate_returncode": gen.returncode,
          "generate_stdout": g_out[-200:],
          "generate_stderr_tail": g_err[-300:]})
    if (serve.returncode != 0 or sorted(done) != [1, 2]
            or any(streamed.get(r["id"]) != done[r["id"]]
                   or len(done[r["id"]]) != r["max_new"] for r in reqs)):
        fail(f"serve_main --draft-model answered {sorted(done)} of 2 "
             f"requests, streamed {streamed} (exit {serve.returncode})")
    if gen.returncode != 0 or len(g_out.strip().split(",")) != 8:
        fail(f"generate_main --beam=4 exited {gen.returncode}: {g_out!r}")


# the decode fleet phases: new tokens of the burst streams, of the
# drained burst (long enough that a drain lands mid-stream) and of the
# mid-burst rolling update's streams; the router's table poll; the
# fingerprint cap the fleet processes run at (models.prefix_tree.fp_max's
# default: it holds the first blocks of every cached path); wall-clock
# limits
FLEET_DRAIN_NEW = 128
FLEET_UPDATE_NEW = 96
FLEET_POLL_S = 0.1
FLEET_FP_DEFAULT = 64
FLEET_LIMIT_S = 360.0


class Burst:
    """Every prompt sent at once to ``address``'s ``SubmitStream`` (a
    router or one decode server), a thread a stream; a stream's TTFT is
    from the burst's start to its first chunk on the host."""

    def __init__(self, address: str, prompts: list, max_new: int):
        from parameter_server_distributed_tpu_torch.fleet import \
            messages as fmsg
        from parameter_server_distributed_tpu_torch.rpc.service import \
            RpcClient

        self._fmsg = fmsg
        self._client = RpcClient(address, fmsg.DECODE_SERVICE,
                                 fmsg.DECODE_METHODS)
        self.prompts = prompts
        self.max_new = max_new
        self.results: list = [None] * len(prompts)
        self._first = threading.Semaphore(0)
        self._threads: list = []
        self.t0 = 0.0

    def _one(self, i: int) -> None:
        import grpc

        tokens, versions, first, error = [], [], None, "no done chunk"
        try:
            for chunk in self._client.call(
                    "SubmitStream", self._fmsg.DecodeRequest(
                        tokens=self.prompts[i], max_new=self.max_new,
                        temperature=-1.0), timeout=600.0):
                if first is None:
                    first = time.perf_counter()
                    self._first.release()
                if chunk.done:
                    error = chunk.error
                    break
                tokens.append(int(chunk.token))
                versions.append(int(chunk.weight_version))
        except grpc.RpcError as exc:
            error = f"rpc error {exc.code()}"
        finally:
            if first is None:
                self._first.release()
        self.results[i] = {"tokens": tokens, "versions": versions,
                           "error": error,
                           "ttft_s": (first or time.perf_counter()) - self.t0,
                           "done_s": time.perf_counter() - self.t0}

    def start(self) -> "Burst":
        self.t0 = time.perf_counter()
        self._threads = [threading.Thread(target=self._one, args=(i,),
                                          daemon=True)
                         for i in range(len(self.prompts))]
        for thread in self._threads:
            thread.start()
        return self

    def wait_first(self, timeout: float = 300.0) -> None:
        """Until every stream has its first chunk (or ended)."""
        deadline = time.monotonic() + timeout
        for _ in self.prompts:
            if not self._first.acquire(
                    timeout=max(0.0, deadline - time.monotonic())):
                fail("a fleet stream got no first chunk in time")

    def join(self, timeout: float = 600.0) -> dict:
        """Wait for every stream; the burst's summary (fails on a stream
        that did not end)."""
        deadline = time.monotonic() + timeout
        for thread in self._threads:
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self._client.close()
        if any(t.is_alive() for t in self._threads):
            fail("a fleet stream outlived its burst's limit")
        wall = max(r["done_s"] for r in self.results)
        ttft = [r["ttft_s"] for r in self.results]
        n_tokens = sum(len(r["tokens"]) for r in self.results)
        return {"streams": len(self.results), "wall_s": wall,
                "ttft_p50_s": _pct(ttft, 50), "ttft_p99_s": _pct(ttft, 99),
                "streams_per_s": len(self.results) / wall,
                "tokens_per_s": n_tokens / wall, "tokens": n_tokens,
                "errors": [r["error"] for r in self.results if r["error"]],
                "short": sum(len(r["tokens"]) != self.max_new
                             for r in self.results)}

    def run(self) -> dict:
        return self.start().join()


def _pct(values: list, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, np.float64), q))


def fleet_rows(caddr: str) -> list:
    """The coordinator's fleet table through ctl_main's UpdateFleet
    query."""
    from parameter_server_distributed_tpu_torch.cli import ctl_main
    from parameter_server_distributed_tpu_torch.fleet import \
        messages as fmsg

    resp = ctl_main._fleet_call(caddr, fmsg.FleetRequest(
        server_id=-1, action=fmsg.FLEET_QUERY))
    if resp is None:
        fail("the coordinator does not answer UpdateFleet")
    return list(resp.entries)


def decode_status(address: str):
    """A decode server's Control STATUS."""
    from parameter_server_distributed_tpu_torch.fleet import \
        messages as fmsg
    from parameter_server_distributed_tpu_torch.rpc.service import RpcClient

    client = RpcClient(address, fmsg.DECODE_SERVICE, fmsg.DECODE_METHODS)
    try:
        return client.call("Control", fmsg.DecodeControlRequest(
            action=fmsg.CTRL_STATUS), timeout=30.0)
    finally:
        client.close()


def wait_until(cond, deadline: float, what: str) -> None:
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    fail(f"timed out waiting for {what}")


def settle(caddr: str, raddr: str, deadline: float) -> None:
    """Wait until the fleet table shows every ACTIVE server idle (its
    heartbeat caught up with the last burst), then refresh the router's
    table with a status probe: a burst arrives at a fleet at rest.  A
    burst routed on a table older than a heartbeat places by stale free
    slots (on the card, 11 of 16 streams once landed on one server)."""
    def idle() -> bool:
        rows = [e for e in fleet_rows(caddr)
                if int(e.state) == 1]          # MEMBER_ACTIVE
        return all(int(e.free_slots) == int(e.slots)
                   and int(e.queue_depth) == 0
                   and int(e.active_streams) == 0 for e in rows)

    wait_until(idle, deadline, "the fleet's heartbeats to show it idle")
    decode_status(raddr)


def placement_at_cap(rows: list, prompts: list, cap: int) -> dict:
    """Where the router's score puts ``prompts`` sent at once (one table,
    its claims debited stream by stream) had each server's fingerprint
    held only its first ``cap`` hashes, the default cap's fingerprint
    being the first hashes of a larger cap's: computed from the table
    ``rows``, not routed.  {"landed": {server: streams}, "overlap":
    blocks of the first prompt each server advertises}."""
    import types

    from parameter_server_distributed_tpu_torch.models.prefix_tree import (
        block_hashes, overlap_blocks, unpack_fp)
    from parameter_server_distributed_tpu_torch.fleet.router import \
        score_backends

    table = [types.SimpleNamespace(
        server_id=int(e.server_id), state=int(e.state),
        free_slots=int(e.free_slots), queue_depth=int(e.queue_depth),
        prefix_fp=bytes(e.prefix_fp)[:4 * cap]) for e in rows]
    claims: dict = {}
    landed = {e.server_id: 0 for e in table}
    for p in prompts:
        ranked = score_backends(table, claims, block_hashes(p), 1.0)
        sid = ranked[0].server_id
        claims[sid] = claims.get(sid, 0) + 1
        landed[sid] += 1
    first = block_hashes(prompts[0])
    return {"landed": landed,
            "overlap": {e.server_id: overlap_blocks(
                first, unpack_fp(e.prefix_fp)) for e in table}}


def bucket_warmup(vocab: int, rng) -> list:
    """One prompt a prefill bucket of PROMPT_LENS (each 2 short of it)."""
    return [rng.integers(0, vocab, n - 2).tolist()
            for n in sorted({min(1 << max(4, (n - 1).bit_length()), 2048)
                             for n in PROMPT_LENS})]


def fleet_wire(np, rng) -> dict:
    """The decode fleet as its users run it, all processes on the one
    card: cli.coordinator_main, two cli.serve_main in fleet mode
    (llama_350m bf16, flash prefill, 8 slots x 2048, the prefix cache,
    --serve-port=0, --server-id 0 and 1) and cli.route_main; this
    process is the client, every stream through the router.  After a
    warm-up of each server's prefill buckets: the shared-prefix arm (one
    warm stream of a 1024-token prefix, a wait until its holder's
    heartbeat carries the prefix's blocks at the default fingerprint cap,
    then its 8 extensions at once, which must all land on the holder and
    forward far fewer tokens than they hold; beside it the same lengths
    without a shared prefix sent straight to the other server, and the
    placement the router's score gives from the same table, computed
    and printed), the uniform arm (serve's 8 prompt lengths twice over,
    16 at once, sent to a fleet at rest; then once more at once without
    waiting, on heartbeats of the last burst, which must land 8 and 8
    too), then a burst of 8 long
    streams with ``ctl_main fleet-drain 1`` sent mid-burst (server 1
    finishes its in-flight streams, shows GONE and exits 0 by itself),
    then the uniform arm again against the fleet of one.  SIGTERM ends
    the rest; every process must exit 0.  Each server's flash launches
    (its exit report) must be 24 a full prefill its stats give.
    Returns the path's launches."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet_wire-",
                           dir=os.path.join(HERE, "build"))
    env = child_env(tmp, PSDT_FLASH_ATTENTION="1")
    env.pop("PSDT_PREFIX_FP_MAX", None)
    try:
        return _fleet_wire_in(tmp, _spawner(tmp, env), np, rng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _fleet_wire_in(tmp: str, spawn, np, rng) -> dict:
    import signal

    from parameter_server_distributed_tpu_torch.fleet import \
        messages as fmsg
    from parameter_server_distributed_tpu_torch.models.prefix_tree import (
        block_hashes, fp_block, overlap_blocks, unpack_fp)

    layers, vocab = LLAMA["layers"], 32000
    deadline = time.monotonic() + FLEET_LIMIT_S
    out: dict = {}
    try:
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0")
        caddr = "127.0.0.1:" + _wait_line(
            coord_log, r"Coordinator server listening on [\d.]+:(\d+)",
            coord, deadline)
        servers = [spawn("serve_main", "--model=llama_350m", "--slots=8",
                         "--max-len=2048", "--prompt-cache=16",
                         "--serve-port=0", f"--coordinator={caddr}",
                         f"--server-id={sid}",
                         f"--report={tmp}/serve{sid}.json")
                   for sid in (0, 1)]
        router, router_log = spawn("route_main", f"--coordinator={caddr}",
                                   f"--poll-s={FLEET_POLL_S}",
                                   f"--report={tmp}/route.json")
        raddr = "127.0.0.1:" + _wait_line(
            router_log, r"fleet router on port (\d+)", router, deadline)
        t_up = time.perf_counter()
        for proc, log in servers:
            _wait_line(log, r"decode fleet server \d on port (\d+)", proc,
                       deadline)
        wait_until(lambda: sum(int(e.state) == fmsg.MEMBER_ACTIVE
                               for e in fleet_rows(caddr)) == 2,
                   deadline, "both decode servers ACTIVE")
        address = {int(e.server_id): e.address for e in fleet_rows(caddr)}
        for sid in (0, 1):
            for p in bucket_warmup(vocab, rng):
                Burst(address[sid], [p], 2).run()
        out["startup_s"] = time.perf_counter() - t_up

        # the shared-prefix arm
        prefix = rng.integers(0, vocab, PREFIX_LEN).tolist()
        exts = [prefix + rng.integers(0, vocab, n).tolist()
                for n in PREFIX_SUFFIXES]
        served = {sid: decode_status(address[sid]).streams_served
                  for sid in (0, 1)}
        warm = Burst(raddr, [prefix], 4).run()
        holder = next(sid for sid in (0, 1)
                      if decode_status(address[sid]).streams_served
                      > served[sid])
        other = 1 - holder
        hashes = block_hashes(exts[0])
        t_fp = time.perf_counter()

        def advertised() -> int:
            return max((overlap_blocks(hashes, unpack_fp(bytes(e.prefix_fp)))
                        for e in fleet_rows(caddr)
                        if int(e.server_id) == holder), default=0)

        # the 8 extensions all stay on the holder while its advertised
        # blocks outbid the other server's 8 free slots
        wait_until(lambda: advertised() >= len(PREFIX_SUFFIXES), deadline,
                   "the holder's heartbeat to carry the prefix")
        fp_wait = time.perf_counter() - t_fp
        ctl = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.cli.ctl_main", "fleet",
             caddr], cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=60)
        if ctl.returncode != 0 or "2 servers" not in ctl.stdout:
            fail(f"ctl_main fleet exited {ctl.returncode}: {ctl.stdout} "
                 f"{ctl.stderr[-500:]}")
        # the router polls the table when an admission finds it older
        # than its poll period, and admissions that arrive during that
        # poll route on the old table: settle() refreshes it first
        settle(caddr, raddr, deadline)
        rows = fleet_rows(caddr)
        at_cap = placement_at_cap(rows, exts, FLEET_FP_DEFAULT)
        before = {sid: decode_status(address[sid]) for sid in (0, 1)}
        arm = Burst(raddr, exts, 8).run()
        after = {sid: decode_status(address[sid]) for sid in (0, 1)}
        landed = {sid: after[sid].streams_served
                  - before[sid].streams_served for sid in (0, 1)}
        h0, h1 = before[holder], after[holder]
        ratio = ((h1.prefill_tokens - h0.prefill_tokens)
                 / max(1, h1.prompt_tokens - h0.prompt_tokens))
        base = Burst(address[other],
                     [rng.integers(0, vocab, len(p)).tolist()
                      for p in exts], 8).run()
        out["prefix"] = {"holder": holder, "landed": landed,
                         "prefill_over_prompt": ratio,
                         "fingerprint_wait_s": fp_wait,
                         "advertised_blocks": advertised(),
                         "prefix_blocks": PREFIX_LEN // fp_block(),
                         "fp_max": FLEET_FP_DEFAULT,
                         "warm_stream": warm, "extensions": arm,
                         "no_shared_prefix": base,
                         "computed_placement": at_cap,
                         "ctl_fleet": ctl.stdout}
        if landed[holder] != 8 or landed[other] != 0 or ratio >= 0.5 \
                or arm["errors"] or arm["short"]:
            fail(f"the shared-prefix arm: landed {landed} (holder "
                 f"{holder}), prefill/prompt {ratio}, {arm['errors']}")

        # the uniform arm on two servers
        prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
        settle(caddr, raddr, deadline)
        served = {sid: decode_status(address[sid]).streams_served
                  for sid in (0, 1)}
        out["uniform_2"] = Burst(raddr, prompts * 2, NEW_TOKENS).run()
        out["uniform_2"]["landed"] = {
            sid: decode_status(address[sid]).streams_served - served[sid]
            for sid in (0, 1)}
        # the same lengths again at once, the fleet not settled: the
        # table holds heartbeats of the last burst, the router's claims
        # and credits (fleet/router.py) place by the slots free now
        served = {sid: decode_status(address[sid]).streams_served
                  for sid in (0, 1)}
        prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
        out["uniform_2_unsettled"] = Burst(raddr, prompts * 2,
                                           NEW_TOKENS).run()
        out["uniform_2_unsettled"]["landed"] = {
            sid: decode_status(address[sid]).streams_served - served[sid]
            for sid in (0, 1)}

        # a long burst, server 1 drained mid-burst
        drain_prompts = [rng.integers(0, vocab, n).tolist()
                         for n in PROMPT_LENS]
        settle(caddr, raddr, deadline)
        burst = Burst(raddr, drain_prompts, FLEET_DRAIN_NEW).start()
        burst.wait_first()
        st = decode_status(address[1])
        in_flight = st.slots - st.free_slots
        drain = subprocess.run(
            [sys.executable, "-m", f"{PACKAGE}.cli.ctl_main",
             "fleet-drain", "1", caddr], cwd=HERE,
            env=dict(os.environ, PYTHONPATH=HERE), capture_output=True,
            text=True, timeout=60)
        drained = burst.join()
        proc1 = servers[1][0]
        try:
            rc1 = proc1.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc1 = "still running"
        states = {int(e.server_id): fmsg.STATE_NAMES[int(e.state)]
                  for e in fleet_rows(caddr)}
        out["drain"] = {"in_flight_on_1": in_flight,
                        "ctl_stdout": drain.stdout.strip(),
                        "burst": drained, "server1_exit": rc1,
                        "states": states}
        if (drain.returncode != 0 or in_flight < 1 or drained["errors"]
                or drained["short"] or rc1 != 0 or states[1] != "gone"):
            fail(f"the drain: {out['drain']}")

        # the uniform arm on the fleet of one
        settle(caddr, raddr, deadline)
        prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
        out["uniform_1"] = Burst(raddr, prompts * 2, NEW_TOKENS).run()
        for name in ("uniform_2", "uniform_2_unsettled", "uniform_1"):
            if out[name]["errors"] or out[name]["short"]:
                fail(f"fleet_wire {name}: {out[name]}")
        for name in ("uniform_2", "uniform_2_unsettled"):
            if out[name]["landed"] != {0: 8, 1: 8}:
                fail(f"fleet_wire {name} landed {out[name]['landed']}: "
                     f"want 8 on each server")

        for proc, log in (servers[0], (router, router_log),
                          (coord, coord_log)):
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=120.0)
            except subprocess.TimeoutExpired:
                rc = "hung at SIGTERM"
            if rc != 0:
                with open(log) as f:
                    fail(f"{proc.args[2]} exited {rc}: {f.read()[-3000:]}")
    finally:
        for proc in spawn.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60.0)
    reports = {}
    for name in ("serve0", "serve1", "route"):
        with open(os.path.join(tmp, f"{name}.json")) as f:
            reports[name] = json.load(f)
    launches, per_server = {}, {}
    for sid in (0, 1):
        r = reports[f"serve{sid}"]
        stats = r["stats"]
        full = (stats["requests_admitted"] - stats["prompt_cache_hits"]
                - stats["prefix_hits"])
        got = {k: v for k, v in r["launches"].items() if v}
        per_server[sid] = {"streams_served": r["streams_served"],
                           "full_prefills": full, "launches": got,
                           "stats": stats,
                           "peak_mem_gb": r["peak_mem_bytes"] / 1e9}
        if got != {"flash_fwd": layers * full}:
            fail(f"server {sid}'s launches {got} != {layers} x {full} full "
                 f"prefills of flash_fwd")
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    routed = 1 + 8 + 16 + 16 + 8 + 16
    route = reports["route"]
    emit({"phase": "fleet_wire", "model": "llama_350m", "dtype": "bfloat16",
          "servers": 2, "slots": 8, "max_len": 2048,
          "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
          **out, "servers_report": per_server,
          "router": {"streams_routed": route["streams_routed"],
                     "streams_rejected": route["streams_rejected"]}})
    if (route["streams_routed"], route["streams_rejected"]) != (routed, 0):
        fail(f"the router routed {route['streams_routed']} and rejected "
             f"{route['streams_rejected']}: want {routed} and 0")
    return launches


def time_swap_parts(server, marks: list) -> None:
    """Wrap a FleetDecodeServer's ``transform`` and its DecodeServer's
    ``swap_params`` so that each swap appends its host-clock marks to
    ``marks``: transform start and end, swap start and end (the swap
    runs under the dispatch lock, the transform before it takes the
    lock)."""
    transform, swap = server._transform, server.server.swap_params

    def timed_transform(store):
        marks.append({"transform_start": time.perf_counter()})
        try:
            return transform(store)
        finally:
            marks[-1]["transform_end"] = time.perf_counter()

    def timed_swap(params, **kwargs):
        marks[-1]["swap_start"] = time.perf_counter()
        try:
            return swap(params, **kwargs)
        finally:
            marks[-1]["swap_end"] = time.perf_counter()

    server._transform = timed_transform
    server.server.swap_params = timed_swap


def rollout_parts(marks: dict, t0: float, t1: float) -> dict:
    """A rolling update's host time from ``t0`` to ``t1``, server by
    server in swap order: the wait for the server's round boundary (from
    the previous server's swap end), the transform, the wait for the
    dispatch lock, the swap; then the controller's reply."""
    firsts = sorted((mk[0] for mk in marks.values()
                     if mk and len(mk[0]) == 4),
                    key=lambda mk: mk["transform_start"])
    sid_of = {id(mk[0]): sid for sid, mk in marks.items() if mk}
    servers, prev = {}, t0
    for mk in firsts:
        servers[sid_of[id(mk)]] = {
            "round_wait_s": mk["transform_start"] - prev,
            "transform_s": mk["transform_end"] - mk["transform_start"],
            "lock_wait_s": mk["swap_start"] - mk["transform_end"],
            "swap_s": mk["swap_end"] - mk["swap_start"]}
        prev = mk["swap_end"]
    return {"servers": servers, "reply_s": t1 - prev}


def fleet_update(torch, np, rng) -> dict:
    """Rolling weight updates in process (versions published without a
    training run): two FleetDecodeServers on llama_350m (bf16, int8
    weights and KV cache, 8 slots x 2048) whose ``transform`` is
    quantize_params, behind a port Coordinator and FleetRouter, with a
    FleetController.  Mid-burst, version 1 (the seed-1 store) is
    published and rolled out: no stream dropped, each stream's version
    stamps 0...0 1...1.  rollback(0) pins: a version 2 published after
    it serves no chunk and its rollout is refused.  A store with a
    drifted shape is refused and the last-good weights serve a lone
    stream token for token as before.  After version 1 is rolled out, a
    lone stream equals a fresh int8 server's on the seed-1 store.  K5-K7
    and flash launches over the two bursts must be the design's counts
    for the prefills and rounds the servers' stats give.  Then a 2-layer
    f32 model of llama_350m's widths through the same coordinator and
    router: every stream token-exact against generate (int8 weights and
    cache) before and after a rolling update.  Times of swap_params
    (bf16; int8, the quantizing transform included) and of the rollout,
    with its parts (rollout_parts).
    Returns the path's launches."""
    from parameter_server_distributed_tpu_torch.config import \
        CoordinatorConfig
    from parameter_server_distributed_tpu_torch.fleet import \
        messages as fmsg
    from parameter_server_distributed_tpu_torch.fleet.controller import \
        FleetController
    from parameter_server_distributed_tpu_torch.fleet.decode import \
        FleetDecodeServer
    from parameter_server_distributed_tpu_torch.fleet.router import \
        FleetRouter
    from parameter_server_distributed_tpu_torch.models import serving
    from parameter_server_distributed_tpu_torch.models.generation import \
        generate
    from parameter_server_distributed_tpu_torch.models.quant import \
        quantize_params
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, flash_attention_auto)
    from parameter_server_distributed_tpu_torch.ops import \
        flash_attention as fa
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
    from parameter_server_distributed_tpu_torch.server.coordinator_service \
        import Coordinator

    layers = LLAMA["layers"]
    per_forward = 7 * layers + 1
    model = get_model("llama_350m", dtype="bf16")
    vocab = model.config.vocab
    stores = {v: model.init_params(v, device="cuda") for v in (0, 1, 2)}
    deadline = time.monotonic() + FLEET_LIMIT_S
    out: dict = {}

    def start_fleet(m, params, ids, max_len):
        fleet = [FleetDecodeServer(
            serving.DecodeServer(m, quantize_params(params), slots=8,
                                 max_len=max_len, cache_dtype="int8",
                                 device="cuda"),
            server_id=sid, coordinator=caddr, transform=quantize_params,
            heartbeat_s=0.1) for sid in ids]
        for server in fleet:
            server.start()
        wait_until(lambda: sum(
            int(f.state) == fmsg.MEMBER_ACTIVE and f.server_id in ids
            for f in coordinator.core.fleet_table()[1]) == len(ids),
            deadline, "the fleet servers ACTIVE")
        return fleet

    def retire(fleet):
        for server in fleet:
            coordinator.core.fleet_drain(server.server_id)
        for server in fleet:
            if not server.wait_drained(60.0):
                fail(f"server {server.server_id} did not drain")
            server.stop()

    def lone(address, prompt, max_new=NEW_TOKENS):
        r = Burst(address, [prompt], max_new)
        r.run()
        return r.results[0]

    coordinator = Coordinator(CoordinatorConfig(bind_address="127.0.0.1",
                                                port=0))
    caddr = f"127.0.0.1:{coordinator.start()}"
    router = FleetRouter(caddr, poll_s=FLEET_POLL_S)
    raddr = f"127.0.0.1:{router.start()}"
    controller = FleetController(coordinator.core)
    fleet: list = []
    try:
        fleet = start_fleet(model, stores[0], (0, 1), 2048)
        for server in fleet:
            server.publish_version(stores[0], 0)
            for p in bucket_warmup(vocab, rng):
                lone(server.address, p, 2)
        check = rng.integers(0, vocab, 300).tolist()
        v0 = lone(fleet[0].address, check)
        marks = {server.server_id: [] for server in fleet}
        for server in fleet:
            time_swap_parts(server, marks[server.server_id])

        # burst 1: version 1 rolled out mid-burst (8 streams on 16
        # slots: none waits for a slot, so each starts under version 0)
        fa.reset_launches()
        i8.reset_launches()
        stats0 = [s.server.stats for s in fleet]
        prompts = [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]
        burst = Burst(raddr, prompts, FLEET_UPDATE_NEW).start()
        burst.wait_first()
        for server in fleet:
            server.publish_version(stores[1], 1)
        t0 = time.perf_counter()
        rolled = controller.rolling_update(1)
        t1 = time.perf_counter()
        rollout_s = t1 - t0
        parts = rollout_parts(marks, t0, t1)
        b1 = burst.join()
        stamps = [r["versions"] for r in burst.results]
        runs_0_then_1 = sum(v[0] == 0 and v[-1] == 1 and v == sorted(v)
                            for v in stamps)
        # rollback to 0 pins; version 2 is held and never served
        pinned = controller.rollback(0)
        for server in fleet:
            server.publish_version(stores[2], 2)
        after_pin = Burst(raddr, prompts, NEW_TOKENS)
        b2 = after_pin.run()
        pinned_versions = sorted({v for r in after_pin.results
                                  for v in r["versions"]})
        refused = controller.rolling_update(2)
        stats1 = [s.server.stats for s in fleet]
        launches = {**fa.launches, **i8.launches}
        admitted = sum(b["requests_admitted"] - a["requests_admitted"]
                       for a, b in zip(stats0, stats1))
        rounds = sum(b["steps"] - a["steps"]
                     for a, b in zip(stats0, stats1))
        expected = {"flash_fwd": layers * admitted, "flash_bwd_dq": 0,
                    "flash_bwd_dkv": 0,
                    "int8_wdot": per_forward * (admitted + rounds),
                    "decode_attention_int8": layers * rounds,
                    "kv_quantize": admitted + layers * rounds}
        # bf16 (int8 weights) streams of burst 2 against a lone server's
        lone_equal = sum(
            lone(fleet[0].address, p)["tokens"] == r["tokens"]
            for p, r in zip(prompts, after_pin.results))
        # a drifted store: refused, the last-good weights serve on
        controller.unpin()
        drifted = dict(stores[0])
        drifted["embed/tok"] = drifted["embed/tok"][:-1]
        fleet[0].publish_version(drifted, 3)
        swap3 = fleet[0].Control(fmsg.DecodeControlRequest(
            action=fmsg.CTRL_SWAP, version=3), None)
        serving3 = fleet[0].weight_version()
        kept = lone(fleet[0].address, check)
        # version 1 again: a lone stream equals a fresh int8 server's
        rolled_again = controller.rolling_update(1)
        v1 = lone(fleet[0].address, check)
        fresh = serving.DecodeServer(model, quantize_params(stores[1]),
                                     slots=8, max_len=2048,
                                     cache_dtype="int8", device="cuda")
        rid = fresh.submit(check, max_new_tokens=NEW_TOKENS)
        fresh_tokens = fresh.run_to_completion()[rid]
        del fresh
        out["bf16"] = {
            "burst_update": b1, "rollout_s": rollout_s,
            "rollout_parts": parts, "rolled": rolled,
            "streams_0_then_1": runs_0_then_1,
            "burst_pinned": b2, "pinned_versions": pinned_versions,
            "rollback": pinned, "refused_after_pin": refused,
            "streams_equal_lone": lone_equal,
            "drift": {"success": swap3.success, "message": swap3.message,
                      "serving": serving3,
                      "lone_equal_before": kept["tokens"] == v0["tokens"]},
            "v1_lone_equals_fresh": v1["tokens"] == fresh_tokens,
            "v1_differs_from_v0": v1["tokens"] != v0["tokens"],
            "launches": launches, "expected_launches": expected,
            "stats": [s.server.stats for s in fleet]}
        faults = []
        if b1["errors"] or b1["short"] or runs_0_then_1 != len(stamps):
            faults.append(f"burst 1: {b1['errors']}, short {b1['short']}, "
                          f"{runs_0_then_1} of {len(stamps)} 0...1")
        if not all(rolled.values()) or not all(pinned.values()) \
                or any(refused.values()) or pinned_versions != [0] \
                or b2["errors"] or b2["short"]:
            faults.append(f"the pin: rolled {rolled}, rollback {pinned}, "
                          f"v2 rollout {refused}, served "
                          f"{pinned_versions}")
        if swap3.success or "failed" not in swap3.message or serving3 != 0 \
                or kept["tokens"] != v0["tokens"]:
            faults.append(f"the drifted store: {out['bf16']['drift']}")
        if not all(rolled_again.values()) or v1["tokens"] != fresh_tokens:
            faults.append("version 1 does not serve the seed-1 int8 store")
        if launches != expected:
            faults.append(f"launches {launches} != {expected}")
        if faults:
            fail(f"fleet_update: {faults}")
        retire(fleet)
        fleet = []
        torch.cuda.empty_cache()

        # swap_params times: bf16, and int8 with its transform
        bsrv = serving.DecodeServer(model, stores[0], slots=1, max_len=64,
                                    device="cuda")
        isrv = serving.DecodeServer(model, quantize_params(stores[0]),
                                    slots=1, max_len=64, cache_dtype="int8",
                                    device="cuda")
        swap_ms = {"bf16": [], "int8_with_transform": []}
        for i in range(4):
            for name, srv in (("bf16", bsrv), ("int8_with_transform", isrv)):
                store = stores[1 + i % 2]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                srv.swap_params(quantize_params(store) if srv is isrv
                                else store, version=i + 1)
                torch.cuda.synchronize()
                swap_ms[name].append((time.perf_counter() - t0) * 1e3)
        out["swap_params_ms"] = swap_ms
        del bsrv, isrv, stores
        torch.cuda.empty_cache()

        # f32: a 2-layer model of llama_350m's widths, token-exact
        c = model.config
        small = Transformer(TransformerConfig(
            vocab=c.vocab, d_model=c.d_model, n_heads=c.n_heads,
            n_kv_heads=c.n_kv_heads, n_layers=2, d_ff=c.d_ff,
            max_seq=1024, mlp_act=c.mlp_act, dtype=torch.float32),
            attention_fn=flash_attention_auto)
        sstores = {v: small.init_params(v, device="cuda") for v in (0, 1)}
        fleet = start_fleet(small, sstores[0], (2, 3), 1024)
        time.sleep(FLEET_POLL_S)
        decode_status(raddr)
        exact = {}
        sprompts = [rng.integers(0, c.vocab, n).tolist()
                    for n in (64, 128, 256, 512) * 2]
        for version in (0, 1):
            if version:
                for server in fleet:
                    server.publish_version(sstores[1], 1)
                if not all(controller.rolling_update(1).values()):
                    fail("the f32 fleet refused version 1")
            burst = Burst(raddr, sprompts, 8)
            burst.run()
            qparams = quantize_params(sstores[version])
            exact[version] = [
                r["tokens"] == generate(small, qparams, [p], 8,
                                        cache_dtype="int8")[0].tolist()
                and set(r["versions"]) == {version}
                for p, r in zip(sprompts, burst.results)]
        out["f32"] = {"model": "2-layer f32, llama_350m widths, int8 "
                               "weights and cache", "token_exact": exact}
        retire(fleet)
        fleet = []
        if not all(exact[0] + exact[1]):
            fail(f"f32 fleet streams differ from generate: {exact}")
    finally:
        for server in fleet:
            server.stop()
        controller.close()
        router.stop()
        coordinator.stop()
    emit({"phase": "fleet_update", "model": "llama_350m",
          "dtype": "bfloat16, int8 weights and KV cache", "servers": 2,
          "slots": 8, "max_len": 2048, "new_tokens": FLEET_UPDATE_NEW,
          **out})
    return launches


# delta_follow: a llama_350m PS on its device close with one worker, and a
# serve_main following it (fleet mode, int8 weights and cache); the worker's
# rounds, then a wait for its first two closes without a subscriber; the
# burst's streams and tokens; the phase's wall-clock limit
FOLLOW = dict(rounds=9, unfed_rounds=2, lr=1e-3, streams=8, max_new=640,
              limit_s=300.0)


def _metrics_steps(path: str) -> int:
    """The iterations a worker's metrics file holds so far."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def delta_follow(np, rng) -> dict:
    """Live weight publication as its users run it, every process on the
    card: cli.ps_main (llama_350m, sharded_adam under PSDT_DEVICE_APPLY=1
    PSDT_ARENA=1, the whole close on the card, one worker),
    cli.coordinator_main, one cli.worker_main (llama_350m bf16, batch 8,
    FOLLOW["rounds"] gradient rounds over the rings) and, once the PS has
    closed FOLLOW["unfed_rounds"] rounds with no delta receiver, one
    cli.serve_main --follow (fleet mode, standalone, 8 slots x 2048,
    --quant=int8 --kv-cache=int8).  The server subscribes (the PS arms
    its delta chain then), swaps each followed version in between decode
    rounds, uploaded through one pinned copy and quantized as the boot
    weights were; this process follows the PS too (a second subscriber)
    and sends the server a burst of 8 streams while versions land.

    Held: the server's follower took every version as a checked delta
    pair but its first, in one session, never degraded, each crc equal
    to the one the PS published for that version; after the last round
    this process's follower holds, byte for byte, a full bf16 pull's
    decode, and the server's crc of it is the pull's; the server swapped
    every version its follower handed over; every stream retires at
    full length, its version stamps never fall and at least 3 versions
    land during the burst; flash_fwd and K5-K7 launch in the server;
    every child exits 0.  Printed: the chain's build ms per apply, the
    PS's close with and without a subscriber, the pair bytes and the
    changed share against a full bf16 serve, the publish-to-swap latency
    per version on the host clock, the transform and swap times, each
    process's peak card and host memory.  Returns the path's launches,
    summed over the processes."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="delta_follow-",
                           dir=os.path.join(HERE, "build"))
    env = child_env(tmp, PSDT_FLASH_ATTENTION="1", PSDT_DEVICE_APPLY="1",
                    PSDT_ARENA="1", PSDT_STRIPES=str(DEVICE_STRIPES),
                    PSDT_SUBSCRIBE_POLL_S="0.2")
    try:
        return _delta_follow_in(tmp, _spawner(tmp, env), np, rng)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _delta_follow_in(tmp: str, spawn, np, rng) -> dict:
    import signal

    from parameter_server_distributed_tpu_torch.delta.chain import store_crc
    from parameter_server_distributed_tpu_torch.delta.subscriber import \
        WeightFollower
    from parameter_server_distributed_tpu_torch.models.transformer import \
        llama_350m
    from parameter_server_distributed_tpu_torch.rpc import data_plane
    from parameter_server_distributed_tpu_torch.rpc import messages as m

    deadline = time.monotonic() + FOLLOW["limit_s"]
    t0 = time.perf_counter()
    marks: dict = {}
    follower = None
    try:
        ps, ps_log = spawn("ps_main", "127.0.0.1:0", "1", "100000",
                           "--optimizer=sharded_adam",
                           f"--lr={FOLLOW['lr']}",
                           f"--ckpt-dir={tmp}/ck", f"--report={tmp}/ps.json")
        ps_addr = "127.0.0.1:" + _wait_line(
            ps_log, r"Parameter server listening on [\d.]+:(\d+)", ps,
            deadline)
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0", ps_addr)
        caddr = "127.0.0.1:" + _wait_line(
            coord_log, r"Coordinator server listening on [\d.]+:(\d+)",
            coord, deadline)
        worker, worker_log = spawn(
            "worker_main", caddr, "0", str(FOLLOW["rounds"] + 1),
            "--model=llama_350m", f"--batch={TRAIN['batch']}",
            "--dtype=bf16", f"--report={tmp}/worker.json")
        metrics = os.path.join(tmp, "metrics-0.jsonl")
        # the bootstrap and the first rounds close with no delta receiver
        wait_until(lambda: _metrics_steps(metrics)
                   >= FOLLOW["unfed_rounds"] + 1 or worker.poll() is not None,
                   deadline, "the worker's first rounds")
        marks["unfed_done_s"] = time.perf_counter() - t0
        server, server_log = spawn(
            "serve_main", "--model=llama_350m", "--slots=8",
            "--max-len=2048", "--quant=int8", "--kv-cache=int8",
            "--serve-port=0", f"--follow={ps_addr}", "--subscriber-id=1",
            f"--report={tmp}/serve.json")
        follower = WeightFollower(ps_addr, subscriber_id=2).start()
        saddr = "127.0.0.1:" + _wait_line(
            server_log, r"decode fleet server \d on port (\d+)", server,
            deadline)
        wait_until(lambda: decode_status(saddr).weight_version > 0,
                   deadline, "the server's first followed version")
        marks["server_ready_s"] = time.perf_counter() - t0
        prompts = [rng.integers(0, 32000, n).tolist() for n in PROMPT_LENS]
        streams = Burst(saddr, prompts, FOLLOW["max_new"])
        burst_wall = [time.time()]
        burst = streams.run()
        burst_wall.append(time.time())
        marks["burst_done_s"] = time.perf_counter() - t0
        try:
            rc = worker.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "still running"
        if rc != 0:
            with open(worker_log) as f:
                fail(f"the worker exited {rc}: {f.read()[-3000:]}")
        marks["worker_done_s"] = time.perf_counter() - t0
        # the last version: a full bf16 pull, stamped with its version
        client = data_plane.PSClient(ps_addr)
        try:
            pull = client.delta_pull(m.PullRequest(wire_dtype=m.WIRE_BF16),
                                     timeout=120.0)
        finally:
            client.close()
        if pull is None or pull.store is None or pull.served_delta:
            fail("the PS answered no full bf16 pull of its last version")
        final = pull.to_version
        wait_until(lambda: follower.version == final
                   and decode_status(saddr).weight_version == final,
                   deadline, f"both followers at version {final}")
        base = follower.base()
        same = sorted(base) == sorted(pull.store) and all(
            np.asarray(base[k]).tobytes() == pull.store[k].tobytes()
            for k in pull.store)
        pull_crc = store_crc(pull.store)
        local = {"version": follower.version,
                 "sessions": follower.sessions,
                 "degraded": follower.degraded,
                 "received": follower.versions_received}
        follower.stop()
        follower = None
        for proc, log in ((server, server_log), (ps, ps_log),
                          (coord, coord_log)):
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=120.0)
            except subprocess.TimeoutExpired:
                rc = "hung at SIGTERM"
            if rc != 0:
                with open(log) as f:
                    fail(f"{proc.args[2]} exited {rc}: {f.read()[-3000:]}")
    finally:
        if follower is not None:
            follower.stop()
        for proc in spawn.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60.0)
    reports = {}
    for name in ("ps", "worker", "serve"):
        with open(os.path.join(tmp, f"{name}.json")) as f:
            reports[name] = json.load(f)
    ps_r, serve_r = reports["ps"], reports["serve"]
    published = {int(v): (int(crc), float(t))
                 for v, crc, t in ps_r["delta"]["published"]}
    fol = serve_r["follower"]
    history = fol["history"]
    swaps = {int(v): float(t) for v, t in serve_r["swaps"]}
    bad_crc = [(v, crc) for v, crc, _t, delta in history
               if delta and published.get(int(v), (None,))[0] != crc]
    deltas = sum(1 for h in history if h[3])
    stamps_ok = all(r["versions"] == sorted(r["versions"])
                    for r in streams.results)
    burst_versions = sorted({v for r in streams.results
                             for v in r["versions"]})
    landed = sorted(v for v, t in swaps.items()
                    if burst_wall[0] <= t <= burst_wall[1])
    latency = {v: t - published[v][1] for v, t in swaps.items()
               if v in published}
    stats = serve_r["stats"]
    launches: dict = {}
    for r in reports.values():
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    hist = ps_r["histograms"]
    total = sum(int(np.prod(s)) for s in llama_350m().param_shapes().values())
    out = {
        "phase": "delta_follow", "model": "llama_350m",
        "ps": "sharded_adam, PSDT_DEVICE_APPLY=1 PSDT_ARENA=1",
        "server": "int8 weights and cache, 8 slots x 2048, fleet mode",
        "marks_s": marks, "rounds": FOLLOW["rounds"],
        "versions_published": len(published),
        "follower": {k: fol[k] for k in ("version", "versions_received",
                                          "versions_consumed", "sessions",
                                          "degraded", "degrade_reason")},
        "follower_deltas": deltas, "local_follower": local,
        "final_version": final, "final_bytes_equal_full_pull": same,
        "final_crc_equal": history[-1][1] in (None, pull_crc),
        "weight_swaps": stats.get("weight_swaps"),
        "burst": {k: v for k, v in burst.items()},
        "burst_versions": burst_versions,
        "versions_landed_in_burst": landed,
        "chain_build_ms": hist.get("ps.serve.delta_build_ms"),
        "close_s_with_subscriber": hist.get("ps.barrier_close_sink_s"),
        "close_s_without_subscriber": hist.get("ps.barrier_close_nosink_s"),
        "pair_bytes": ps_r["gauges"].get("ps.serve.delta_pair_bytes"),
        "changed": ps_r["gauges"].get("ps.serve.delta_changed"),
        "changed_share": (ps_r["gauges"].get("ps.serve.delta_changed", 0)
                          / total),
        "full_bf16_serve_bytes": 2 * total,
        "delta_bytes_served": ps_r["counters"].get("ps.serve.delta_bytes"),
        "publish_to_swap_s": {
            "per_version": latency,
            "p50": _pct(list(latency.values()), 50) if latency else None,
            "max": max(latency.values()) if latency else None},
        "transform_s": serve_r["histograms"].get("fleet.transform_s"),
        "swap_s": serve_r["histograms"].get("fleet.swap_s"),
        "follower_apply_s": serve_r["histograms"].get(
            "serve.follow.apply_s"),
        "peak_gb": {name: {"card": r["peak_mem_bytes"] / 1e9,
                           "host_rss": r["peak_rss_bytes"] / 1e9}
                    for name, r in reports.items()},
        "launches": {name: {k: v for k, v in r["launches"].items() if v}
                     for name, r in reports.items()},
        "wall_s": time.perf_counter() - t0}
    emit(out)
    faults = []
    if fol["degraded"] or fol["sessions"] != 1 or local["degraded"] \
            or local["sessions"] != 1:
        faults.append("a follower degraded or reconnected")
    if bad_crc:
        faults.append(f"followed crcs differ from the PS's: {bad_crc[:4]}")
    if deltas < 3 or fol["version"] != final:
        faults.append(f"{deltas} delta versions followed, at "
                      f"{fol['version']} of {final}")
    if not same or not out["final_crc_equal"]:
        faults.append("the followed store is not the full pull's")
    if stats.get("weight_swaps", 0) < fol["versions_consumed"]:
        faults.append(f"{stats.get('weight_swaps')} swaps for "
                      f"{fol['versions_consumed']} versions handed over")
    if burst["errors"] or burst["short"] or not stamps_ok \
            or len(landed) < 3:
        faults.append(f"the burst: {burst['errors']}, {burst['short']} "
                      f"short, stamps in order {stamps_ok}, versions "
                      f"{landed} landed in it")
    served = reports["serve"]["launches"]
    if min(served.get(k, 0) for k in ("flash_fwd", *INT8_REPLACES)) <= 0:
        faults.append(f"the server's launches {served}")
    if faults:
        fail(f"delta_follow: {'; '.join(faults)}")
    return launches


def model_flops_per_step(model, batch: int, seq: int) -> float:
    """6*N*T over the matmul parameters (every 2-D weight but embed/tok)
    plus 6*B*H*D*S^2 per layer for causal attention; no remat recompute."""
    c = model.config
    n_mm = sum(math.prod(s) for name, s in model.param_shapes().items()
               if len(s) == 2 and name != "embed/tok")
    return (6.0 * n_mm * batch * seq
            + 6.0 * batch * c.n_heads * c.head_dim * seq * seq * c.n_layers)


def train(torch, np, fa, fu) -> dict:
    """The training path: full-width llama_350m, 5 worker steps and Adam
    applies on one batch, then one sgd and one momentum apply; then one
    profiled step, the same 5 steps with dense attention, and a 2-layer
    f32 model's gradients through the kernels against dense attention.
    Returns the path's launch counts."""
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import PallasOptimizer
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, causal_attention,
        flash_attention_auto)
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    b, s, steps = TRAIN["batch"], TRAIN["seq"], TRAIN["steps"]
    model, batches = get_model_and_batches("llama_350m", b, seed=0,
                                           dtype="bf16")
    c = model.config
    if model.attention_fn is not flash_attention_auto or not c.remat or \
            c.remat_policy != "full" or c.loss_chunk != 128:
        fail(f"llama_350m training config: attention "
             f"{model.attention_fn.__name__}, remat {c.remat} "
             f"{c.remat_policy}, loss_chunk {c.loss_chunk}")
    batch = next(batches)
    trainer = Trainer(model)
    store = trainer.init_params(0)
    n_tensors = len(store)
    opt = PallasOptimizer("adam", TRAIN["lr"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fu.reset_launches()
    params, losses, grad_s, apply_s = store, [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        grads, loss = trainer.compute_gradients(params, batch)
        t1 = time.perf_counter()       # the loss and grads are on the host
        params = opt.apply(params, grads)
        torch.cuda.synchronize()
        apply_s.append(time.perf_counter() - t1)
        grad_s.append(t1 - t0)
        losses.append(loss)
    other_s = {}
    for rule in ("sgd", "momentum"):
        t0 = time.perf_counter()
        PallasOptimizer(rule, TRAIN["lr"]).apply(params, grads)
        torch.cuda.synchronize()
        other_s[rule] = time.perf_counter() - t0
    launches = {**fa.launches, **fu.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_apply = update_launches(fu, model.param_shapes())   # the tables
    expected = {"flash_fwd": 2 * c.n_layers * steps,    # remat recompute
                "flash_bwd_dq": c.n_layers * steps,
                "flash_bwd_dkv": c.n_layers * steps,
                "fused_sgd": per_apply, "fused_momentum": per_apply,
                "fused_adam": per_apply * steps}
    # steady state: the steps after the first (which uploads the host
    # store and warms the allocator and the GEMM heuristics)
    step_s = float(np.median([g + a for g, a in zip(grad_s[1:],
                                                    apply_s[1:])]))
    grad_med = float(np.median(grad_s[1:]))
    flops = model_flops_per_step(model, b, s)
    emit({"phase": "train", "model": "llama_350m", "dtype": "bfloat16",
          "params": model.num_params(), "tensors": n_tensors,
          "batch": b, "seq": s, "remat": c.remat_policy,
          "loss_chunk": c.loss_chunk, "optimizer": "adam",
          "lr": TRAIN["lr"], "losses": losses, "grad_step_s": grad_s,
          "apply_s": apply_s, "sgd_apply_s": other_s["sgd"],
          "momentum_apply_s": other_s["momentum"],
          "step_s_median": step_s, "grad_step_s_median": grad_med,
          "tokens_per_s": b * s / step_s, "peak_mem_gb": peak,
          "model_flops_per_step": flops, "mfu": flops / (step_s * 989e12),
          "mfu_grad_step": flops / (grad_med * 989e12),
          "launches": launches, "expected_launches": expected})
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"llama_350m losses not finite and falling: {losses}")
    if launches != expected:
        fail(f"training launches {launches} != expected {expected}")

    # one profiled round (worker step + Adam apply) on card-resident
    # params, kernels summed by name
    def one_step():
        g_, _ = trainer.compute_gradients(params, batch)
        opt.apply(params, g_)

    # the host round trips of a step on card-resident params: one packed
    # gradient download, and the apply's uploads of the host gradients
    copies = dtoh_copies(torch, one_step)
    if copies != 1:
        fail(f"a training step made {copies} device-to-host copies, not 1")
    # a whole step's trace ends with its Adam launches
    prof = profile_window(torch, one_step, {
        "flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
        "flash_bwd_dkv": "flash_bwd_dkv", "fused_adam": "Adam",
        "gemm": "gemm", "nvjet": "nvjet", "dtoh": "Memcpy DtoH",
        "htod": "Memcpy HtoD"},
        {"fused_adam": update_launches(fu, model.param_shapes()),
         "flash_fwd": 2 * c.n_layers, "flash_bwd_dq": c.n_layers,
         "flash_bwd_dkv": c.n_layers, "dtoh": copies}, fu.launches)
    emit({"phase": "train_profile", "dtoh_copies": copies, **prof})
    del params, grads, store, opt, trainer
    torch.cuda.empty_cache()

    # the same steps with dense attention (f32 scores and softmax, P
    # rounded to bf16 before the value product) from the same weights on
    # the same batch: the first loss is the same function of the same
    # inputs; later ones drift apart as each path's rounding compounds
    # through Adam
    dense_trainer = Trainer(Transformer(c, attention_fn=causal_attention))
    dense_params, dense_opt = dense_trainer.init_params(0), PallasOptimizer(
        "adam", TRAIN["lr"])
    dense_losses = []
    for _ in range(steps):
        g_, loss_ = dense_trainer.compute_gradients(dense_params, batch)
        dense_params = dense_opt.apply(dense_params, g_)
        dense_losses.append(loss_)
    emit({"phase": "train_losses_vs_dense", "losses_flash": losses,
          "losses_dense": dense_losses,
          "abs_diff": [abs(a - b) for a, b in zip(losses, dense_losses)],
          "tol_first_rel": 1e-3})
    if (abs(losses[0] - dense_losses[0]) > 1e-3 * abs(dense_losses[0])
            or dense_losses[-1] >= dense_losses[0]):
        fail(f"llama_350m first loss {losses[0]} off dense "
             f"{dense_losses[0]}, or dense losses not falling")
    del dense_trainer, dense_params, dense_opt, g_
    torch.cuda.empty_cache()

    # a 2-layer f32 model (head_dim 64, remat, chunked loss): gradients
    # through the kernels against dense attention, the same f32
    # arithmetic in another order, within rtol 1e-3, atol 1e-5
    cfg = TransformerConfig(vocab=1024, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=256,
                            mlp_act="swiglu", dtype=torch.float32,
                            remat=True, loss_chunk=128)
    flash_t = Trainer(Transformer(cfg, attention_fn=flash_attention_auto))
    dense_t = Trainer(Transformer(cfg, attention_fn=causal_attention))
    small = flash_t.init_params(2)
    tok = np.random.default_rng(3).integers(0, 1024, (4, 256),
                                            dtype=np.int32)
    gf, lf = flash_t.compute_gradients(small, tok)
    gd, ld = dense_t.compute_gradients(small, tok)
    worst = max(float(np.max(np.abs(gf[n] - gd[n]))
                      / max(float(np.max(np.abs(gd[n]))), 1e-30))
                for n in gd)
    ok = all(np.allclose(gf[n], gd[n], rtol=1e-3, atol=1e-5) for n in gd)
    emit({"phase": "train_flash_vs_dense_f32",
          "model": "2-layer f32, head_dim 64", "loss_flash": lf,
          "loss_dense": ld, "max_rel_grad_diff": worst, "rtol": 1e-3,
          "atol": 1e-5, "ok": ok})
    if not ok or abs(lf - ld) > 1e-5 * abs(ld):
        fail(f"f32 flash gradients off dense (worst {worst}, loss "
             f"{lf} vs {ld})")
    return launches


def ps_round(torch, np, fa, fu) -> dict:
    """The parameter-server round (BASELINE config 1) in process: a
    CoordinatorCore registers workers 0 and 1, a ParameterServerCore over
    make_optimizer("pallas_adam") is initialised with Trainer.init_params
    (0), and two full-width llama_350m workers (bf16, flash attention,
    remat "full", loss_chunk 128), each on its own batch (the first of
    its registry stream, seeded with its id), take ROUND["rounds"] rounds of
    serve_parameters -> compute_gradients -> receive_gradients, one after
    the other; the second push closes each barrier.  Then the round-1
    params against the plain Adam update of the numpy mean, one
    pallas_sgd and one pallas_momentum apply through a one-worker core,
    and a checkpoint resume on the 2-layer f32 model.  Returns the
    round's launch counts (the rounds and the two one-apply cores),
    the store after round 1 as host numpy, and the round's headline
    numbers."""
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import PallasOptimizer
    from parameter_server_distributed_tpu_torch.checkpoint.manager import \
        CheckpointManager
    from parameter_server_distributed_tpu_torch.core.coordinator_core \
        import CoordinatorCore
    from parameter_server_distributed_tpu_torch.core.optimizer import \
        make_optimizer
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        ParameterServerCore
    from parameter_server_distributed_tpu_torch.core.tensor import to_host
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, TransformerConfig, flash_attention_auto)
    from parameter_server_distributed_tpu_torch.obs import stats
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    b, s, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    workers, rounds = ROUND["workers"], ROUND["rounds"]
    coord = CoordinatorCore("127.0.0.1", 50051)
    for wid in range(workers):
        coord.register_worker(wid, "127.0.0.1", 6000 + wid, f"worker{wid}")
    opt = make_optimizer("pallas_adam", lr)
    fallback = stats.counter("ps.apply.device_fallback").value
    if not (isinstance(opt, PallasOptimizer) and opt.device.type == "cuda"
            and fallback == 0):
        fail(f"pallas_adam is {type(opt).__name__} (device fallbacks "
             f"{fallback}), not PallasOptimizer on the card")
    ps = ParameterServerCore(total_workers=workers, optimizer=opt,
                             live_workers_fn=coord.width_provider())
    sides = [get_model_and_batches("llama_350m", b, seed=wid, dtype="bf16")
             for wid in range(workers)]
    model = sides[0][0]
    if model.attention_fn is not flash_attention_auto:
        fail("PSDT_FLASH_ATTENTION=1 did not select the flash kernel")
    trainers = [Trainer(m) for m, _ in sides]
    batches = [next(stream) for _, stream in sides]
    init = trainers[0].init_params(0)
    ps.initialize_parameters(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fu.reset_launches()
    losses, times, pushes, kept = [], [], [], {}

    def one_round(it: int) -> dict:
        """serve -> gradient step -> push for each worker in turn; the
        host-clock split of the round.  Keeps round 1's gradients and
        worker 0's last ones in ``kept``."""
        t = {"serve_s": [], "step_s": []}
        for wid in range(workers):
            t0 = time.perf_counter()
            _, params, ready = ps.serve_parameters(it)
            t1 = time.perf_counter()
            on_card = all(isinstance(v, torch.Tensor) and v.is_cuda
                          for v in params.values())
            if not ready or (it > 1 and not on_card):
                fail(f"round {it}: the served store is not ready on the "
                     f"card (ready {ready}, on the card {on_card})")
            grads, loss = trainers[wid].compute_gradients(params,
                                                          batches[wid])
            t2 = time.perf_counter()
            result = ps.receive_gradients(wid, it, grads)
            torch.cuda.synchronize()    # the closing push's apply
            t3 = time.perf_counter()
            t["serve_s"].append(t1 - t0)
            t["step_s"].append(t2 - t1)
            t["close_s" if wid == workers - 1 else "push_s"] = t3 - t2
            losses.append(loss)
            pushes.append([it, wid, result.success,
                           result.aggregation_complete,
                           result.workers_received, result.total_workers])
            if not result.success or result.aggregation_complete != (
                    wid == workers - 1):
                fail(f"round {it} worker {wid}: push {pushes[-1]}")
            if it == 1:
                kept.setdefault("first", []).append(grads)
            if wid == 0:
                kept["last0"] = grads
        status = ps.check_sync_status(it)
        if status[1:] != (True, workers, workers):
            fail(f"round {it}: check_sync_status {status}")
        t["round_s"] = (sum(t["serve_s"]) + sum(t["step_s"]) + t["push_s"]
                        + t["close_s"])
        return t

    for it in range(1, rounds + 1):
        times.append(one_round(it))
        if it == 1:
            after_first = ps.get_parameters()
    launches = {**fa.launches, **fu.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    # where a round's time goes: rounds after the counts are read (their
    # losses and pushes are not the phase's)
    n_losses, n_pushes = len(losses), len(pushes)
    last0 = kept.pop("last0")
    # the round's only device-to-host copies are the workers' packed
    # gradient downloads: the core never takes served card tensors to
    # the host.  Counted over a fourth round, the profiled window is the
    # fifth (a whole round's trace ends with the closing push's Adam
    # launches; a retaken window is the next round)
    extra = iter(range(rounds + 1, rounds + 2 + PROFILE_ATTEMPTS))
    copies = dtoh_copies(torch, lambda: one_round(next(extra)))
    prof = profile_window(torch, lambda: one_round(next(extra)), {
        "flash": "flash_", "fused_adam": "update_kernel", "gemm": "gemm",
        "nvjet": "nvjet", "dtoh": "Memcpy DtoH", "htod": "Memcpy HtoD"},
        {"fused_adam": update_launches(fu, model.param_shapes()),
         "flash": 4 * model.config.n_layers * workers, "dtoh": copies},
        fu.launches)
    del losses[n_losses:], pushes[n_pushes:]
    c = model.config
    expected = {"flash_fwd": 2 * c.n_layers * workers * rounds,
                "flash_bwd_dq": c.n_layers * workers * rounds,
                "flash_bwd_dkv": c.n_layers * workers * rounds,
                "fused_sgd": 0, "fused_momentum": 0,
                "fused_adam": update_launches(fu, model.param_shapes())
                * rounds}
    steady = times[1:]
    round_s = float(np.median([t["round_s"] for t in steady]))
    flops = workers * model_flops_per_step(model, b, s)
    mean_loss = [float(np.mean(losses[i * workers:(i + 1) * workers]))
                 for i in range(rounds)]

    # round 1 against the plain Adam update of the numpy mean of the two
    # workers' round-1 gradients (the core's fold and scale: a copy of
    # the first, the second added, times f32 1/2), from the init
    bc = fu.bias_corrections(1, 0.9, 0.999)
    worst, ok = 0.0, True
    with torch.inference_mode():
        for n, p0 in init.items():
            mean = np.array(kept["first"][0][n], np.float32)
            mean += kept["first"][1][n]
            mean *= np.float32(1.0 / workers)
            p = torch.from_numpy(p0).cuda()
            g = torch.from_numpy(mean).cuda()
            ref = fu.adam_reference(p, g, torch.zeros_like(p),
                                    torch.zeros_like(p), lr, 0.9, 0.999,
                                    1e-8, *bc)
            got = after_first[n]
            worst = max(worst, float((got - ref).abs().max()))
            ok = ok and bool(torch.isclose(got, ref, rtol=1e-5,
                                           atol=1e-7).all())
    # the wire round's round-1 checkpoint is held against this store
    round1 = to_host(after_first)
    del after_first
    kept.clear()
    headline = {"round_s_median": round_s,
                "tokens_per_s": workers * b * s / round_s,
                "mfu": flops / (round_s * PEAK_FLOPS["bfloat16"]),
                "peak_mem_gb": peak, "mean_loss": mean_loss,
                "round1_losses": losses[:workers]}
    emit({"phase": "ps_round", "model": "llama_350m", "dtype": "bfloat16",
          "params": model.num_params(), "workers": workers,
          "rounds": rounds, "batch": b, "seq": s, "optimizer": "pallas_adam",
          "lr": lr, "stripes": ps.stripes,
          "aggregation": ps.aggregation_mode,
          "device_fallbacks": stats.counter(
              "ps.apply.device_fallback").value,
          "pushes": pushes, "losses": losses, "mean_loss": mean_loss,
          "times": times, "round_s_median": round_s,
          "serve_s_median": float(np.median([sum(t["serve_s"])
                                             for t in steady])),
          "step_s_median": [float(np.median([t["step_s"][w]
                                             for t in steady]))
                            for w in range(workers)],
          "push_s_median": float(np.median([t["push_s"] for t in steady])),
          "close_s_median": float(np.median([t["close_s"]
                                             for t in steady])),
          "tokens_per_s": workers * b * s / round_s,
          "model_flops_per_round": flops,
          "mfu": flops / (round_s * PEAK_FLOPS["bfloat16"]),
          "peak_mem_gb": peak,
          "barrier_close_s": stats.histogram("ps.barrier_close_s").summary(),
          "round1_vs_plain_adam": {"max_abs_err": worst, "rtol": 1e-5,
                                   "atol": 1e-7, "ok": ok},
          "launches": launches, "expected_launches": expected})
    emit({"phase": "ps_round_profile", "dtoh_copies": copies, **prof})
    if copies != workers:
        fail(f"a round made {copies} device-to-host copies, not {workers}")
    if not ok:
        fail(f"round-1 params off the plain Adam update by {worst}")
    if launches != expected:
        fail(f"ps_round launches {launches} != expected {expected}")
    if not all(math.isfinite(x) for x in losses) or \
            mean_loss[-1] >= mean_loss[0]:
        fail(f"ps_round losses not finite and falling: {losses}")

    # one pallas_sgd and one pallas_momentum apply through a one-worker
    # core, from the init, on worker 0's last gradients (the mean of one
    # push is the push: times f32 1.0)
    fu.reset_launches()
    other = {}
    for rule in ("sgd", "momentum"):
        core = ParameterServerCore(total_workers=1,
                                   optimizer=make_optimizer(f"pallas_{rule}",
                                                            lr))
        core.initialize_parameters(init)
        t0 = time.perf_counter()
        result = core.receive_gradients(0, 1, last0)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        worst, ok = 0.0, result.aggregation_complete
        with torch.inference_mode():
            for n, got in core.get_parameters().items():
                p = torch.from_numpy(init[n]).cuda()
                g = torch.from_numpy(last0[n]).cuda()
                ref = (fu.sgd_reference(p, g, lr) if rule == "sgd" else
                       fu.momentum_reference(p, g, torch.zeros_like(p), lr,
                                             0.9))
                worst = max(worst, float((got - ref).abs().max()))
                ok = ok and bool(torch.isclose(got, ref, rtol=1e-5,
                                               atol=1e-7).all())
        other[rule] = {"push_s": apply_s, "max_abs_err": worst, "ok": ok}
        if not ok:
            fail(f"pallas_{rule} through a core off its plain version by "
                 f"{worst}")
        del core
    one = {"fused_sgd": update_launches(fu, model.param_shapes()),
           "fused_momentum": update_launches(fu, model.param_shapes())}
    emit({"phase": "ps_round_sgd_momentum", **other,
          "launches": dict(fu.launches), "expected_launches": one})
    if {k: fu.launches[k] for k in one} != one:
        fail(f"one-apply cores launched {fu.launches}, not {one}")
    launches.update(one)
    del ps, opt, trainers, last0, init
    torch.cuda.empty_cache()

    # checkpoint resume on the 2-layer f32 model: save after round 2,
    # load into a fresh core with a fresh PallasOptimizer, push the same
    # round-3 gradients to both; the stores must be equal bit for bit
    cfg = TransformerConfig(vocab=1024, d_model=256, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=512, max_seq=256,
                            mlp_act="swiglu", dtype=torch.float32,
                            remat=True, loss_chunk=128)
    small = Trainer(Transformer(cfg, attention_fn=flash_attention_auto))
    toks = [np.random.default_rng(10 + wid).integers(0, 1024, (4, 256),
                                                      dtype=np.int32)
            for wid in range(workers)]
    live = ParameterServerCore(total_workers=workers,
                               optimizer=PallasOptimizer("adam", lr))
    live.initialize_parameters(small.init_params(2))

    def push_round(cores, it):
        for wid in range(workers):
            grads_, _ = small.compute_gradients(
                live.serve_parameters(it)[1], toks[wid])
            for core_ in cores:
                core_.receive_gradients(wid, it, grads_)

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ps_round-", dir=os.path.join(HERE, "build"))
    try:
        for it in (1, 2):
            push_round([live], it)
        path = CheckpointManager(live, tmp).save()
        resumed = ParameterServerCore(total_workers=workers,
                                      optimizer=PallasOptimizer("adam", lr))
        CheckpointManager(resumed, tmp).load(path)
        files = sorted(os.listdir(tmp))
        push_round([live, resumed], 3)
        a, r = live.get_parameters(), resumed.get_parameters()
        equal = sorted(a) == sorted(r) and all(
            torch.equal(a[n], r[n]) for n in a)
    finally:
        shutil.rmtree(tmp)
    emit({"phase": "ps_round_checkpoint", "model": "2-layer f32",
          "files": files, "resumed_iteration": resumed.current_iteration,
          "bit_exact": equal, "tmp_removed": not os.path.exists(tmp)})
    if not equal or os.path.exists(tmp):
        fail("the resumed core's store differs from the live one's")
    return launches, round1, headline


# ---- the device close (ops/device_apply.py, csrc/device_apply.cu)
DEVICE_APPLY_REF = "parameter_server_distributed_tpu/core/device_apply.py:"
# where each kernel's first reference program is (file:line), the rule
# the kernels line times for sharded_update (the wire round's), f32
# operations an element of each rule
DA_REPLACES = {"fold_segments": "400", "scale_mean": "643",
               "sharded_update": "212", "topk_scatter": "498"}
DA_LINE_RULE = "adam"
DA_FLOPS = {"sgd": 2, "momentum": 4, "adam": 14, "adamw": 17, "lion": 10}
# ps_device_round: the wire encodings of (worker 0, worker 1) by round;
# round 1 is the wire round's f32, the others run the decode lanes
DEVICE_ROUND_WIRE = {1: ("f32", "f32"), 2: ("bf16", "int8"),
                     3: ("topk", "raw")}


def bits_equal(torch, a, b) -> bool:
    """Bytes equal (NaN and -0.0 included)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and bool(torch.equal(a.view(torch.int32), b.view(torch.int32))))


# K1's lanes (source / set or add) and the bytes each moves an element:
# the source read, dst read by an add, dst written
FOLD_LANES = {"f32/set": 8, "bf16/set": 6, "int8/set": 5,
              "f32/add": 12, "bf16/add": 10, "int8/add": 9}
FOLD_SCALE = 0.0123       # the int8 rows' dequantize scale
# the per-tensor close's one-row calls: llama_350m's largest tensor (the
# embedding) and its smallest (a norm)
ONE_ROWS = {"embedding": 32_768_000, "norm": 1024}


def fold_store(torch, shapes, gen):
    """The llama_350m store packed into DEVICE_STRIPES slabs as the flat
    close packs it (core.arena.PackingTable, alignment 1): the table,
    the stripes in use, random f32 slabs, and one flat source of every
    tensor back to back a source type (f32; its bf16 rounding; random
    int8 codes)."""
    from parameter_server_distributed_tpu_torch.core.arena import \
        PackingTable

    table = PackingTable({n: torch.empty(s, device="meta")
                          for n, s in shapes.items()}, DEVICE_STRIPES, 1)
    stripes = [s for s in range(table.stripes) if table.stripe_sizes[s]]
    dst = {s: torch.randn(table.stripe_sizes[s], generator=gen,
                          device="cuda") for s in stripes}
    src32 = torch.randn(table.total_elems, generator=gen, device="cuda")
    sources = {"f32": src32, "bf16": src32.bfloat16(),
               "int8": torch.randint(-127, 128, (table.total_elems,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int8)}
    return table, stripes, dst, sources


def store_rows(mod, table, stripes, src, dsts) -> list:
    """Every tensor of the store one fold row of ``mod`` (an
    ops.device_apply), read back to back from ``src`` into its slab."""
    out, off = [], 0
    for s in stripes:
        for name in table.stripe_names[s]:
            e = table.entries[name]
            out.append(mod.Segment(dsts[s], e.offset, src, off, e.length,
                                   FOLD_SCALE))
            off += e.length
    return out


def vector_path(np, mod, rows) -> dict:
    """How many rows and elements of a fold launch over ``rows`` take the
    vector path, from the library's own plan (``mod.fold_plan``)."""
    first, plan = mod.fold_plan(rows)
    n = np.array([r.n for r in rows], np.int64)
    vec = (plan & mod.PLAN_VECTOR) != 0
    elems = 4 * ((n - (plan & 3)) // 4)
    return {"rows": len(rows), "vector_rows": int(vec.sum()),
            "elements": int(n.sum()),
            "vector_elements": int(elems[vec].sum()),
            "spans": int(first[-1])}


def time_fold_scale(torch, mod, table, stripes, dst, sources) -> dict:
    """K1 and K2 of ``mod`` (an ops.device_apply module), each one
    launch a call: K1 in
    every lane over the store (219 rows into the slabs), and the f32 and
    bf16 add lanes on one row of each ONE_ROWS size; K2 over the 8
    slabs and over the 219 tensors as the per-tensor close's
    ``scale_means`` gives them.  Device ms from a CUDA graph of the
    calls (``graph_ms``: an eager event time would count the host time
    of a 219-row call before its launch).
    Host microseconds a call (``host_us``) of the norm-sized and 219-row
    calls, of the norm-sized fold's C entry point alone (the table's
    plan and the launch, arguments built beforehand), and for the
    norm-sized calls ``call_us`` too (as K5 has: the larger of the
    host's and the card's time a call).  Inputs are changed."""
    out = {"fold": {}, "fold_one_row": {}, "fold_host_us": {},
           "fold_call_us": {}, "scale": {}, "scale_host_us": {},
           "scale_call_us": {}}
    for lane in FOLD_LANES:
        kind, op = lane.split("/")
        rows = store_rows(mod, table, stripes, sources[kind], dst)
        call = (lambda rows=rows, add=op == "add":
                mod.fold_segments(rows, add))
        call()
        out["fold"][lane] = graph_ms(torch, [call] * 5)
    rows = store_rows(mod, table, stripes, sources["f32"], dst)
    out["fold_host_us"]["f32/add/store"] = host_us(
        torch, lambda: mod.fold_segments(rows, True))
    big = max(ONE_ROWS.values())
    row_dst = torch.randn(big, device="cuda")
    for kind in ("f32", "bf16"):
        src = sources[kind][:big]
        for name, n in ONE_ROWS.items():
            one = [mod.Segment(row_dst, 0, src, 0, n)]
            call = (lambda one=one: mod.fold_segments(one, True))
            key = f"{kind}/add/{name}"
            out["fold_one_row"][key] = graph_ms(torch, [call] * 20)
            if n < 1 << 20:
                out["fold_host_us"][key] = host_us(torch, call)
                out["fold_call_us"][key] = call_us(torch, call)
    out["fold_host_us"]["c_entry/f32/add/norm"] = fold_entry_us(
        torch, mod, row_dst, sources["f32"])
    inv = 0.5
    slabs = [(dst[s], inv) for s in stripes]
    per_tensor = [(dst[s][e.offset:e.offset + e.length], inv)
                  for s in stripes for e in map(table.entries.get,
                                                table.stripe_names[s])]
    norm = [(row_dst[:ONE_ROWS["norm"]], inv)]
    for key, part, calls in (("slabs", slabs, 5),
                             ("tensors_219", per_tensor, 5),
                             ("norm", norm, 200)):
        call = (lambda part=part: mod.scale_mean(part))
        call()
        out["scale"][key] = graph_ms(torch, [call] * calls)
    out["scale_host_us"]["norm"] = host_us(torch,
                                           lambda: mod.scale_mean(norm))
    out["scale_call_us"]["norm"] = call_us(torch,
                                           lambda: mod.scale_mean(norm))
    out["scale_host_us"]["tensors_219"] = host_us(
        torch, lambda: mod.scale_mean(per_tensor))
    return out


def fold_entry_us(torch, mod, dst, src) -> float:
    """Host microseconds a call of ``mod``'s C entry point alone (the
    table's plan and the launch, its arguments built beforehand): one
    norm-sized f32 add row of ``src`` into ``dst``."""
    fn = mod._lib().psdt_fold_segments
    args = [ctypes.c_longlong(dst.data_ptr()),
            ctypes.c_longlong(src.data_ptr()),
            ctypes.c_longlong(ONE_ROWS["norm"]), ctypes.c_float(1.0)]
    stream = torch.cuda.current_stream().cuda_stream
    return host_us(torch, lambda: fn(*map(ctypes.addressof, args), 1, 0, 1,
                                     stream))


def time_yardsticks(torch, sources, n: int) -> dict:
    """One PyTorch call over the same bytes as each K1 lane over the
    store (into one flat f32 tensor of ``n`` elements), and ``mul_`` for
    K2, timed as ``time_fold_scale`` times the kernels (a CUDA graph);
    None for a call this torch refuses.  The int8 add's ``add_(q,
    alpha=scale)`` may round otherwise than the kernel: a yardstick of
    time only."""
    flat = torch.randn(n, device="cuda")
    q = sources["int8"]
    calls = {
        "f32/set": lambda: flat.copy_(sources["f32"]),
        "bf16/set": lambda: flat.copy_(sources["bf16"]),
        "int8/set": lambda: torch.mul(q, FOLD_SCALE, out=flat),
        "f32/add": lambda: flat.add_(sources["f32"]),
        "bf16/add": lambda: flat.add_(sources["bf16"]),
        "int8/add": lambda: flat.add_(q, alpha=FOLD_SCALE),
        "scale": lambda: flat.mul_(0.5)}
    out = {}
    for key, call in calls.items():
        try:
            call()
            out[key] = graph_ms(torch, [call] * 5)
        except RuntimeError as exc:   # a call this torch refuses
            out[key] = None
            emit({"phase": "yardstick_refused", "lane": key,
                  "error": str(exc)[:200]})
    del flat
    return out


def check_device_apply(torch, np, shapes, gen) -> tuple[dict, dict]:
    """The four kernels of csrc/device_apply.cu against their plain
    versions on the card, bytes equal, at the llama_350m store's shapes
    (336,118,784 f32 elements packed into 8 stripe slabs by
    core.arena.PackingTable): fold_segments for each source (f32, bf16,
    int8) and lane (set, add), every tensor one row, in one launch, with
    every row on the vector path (the library's own plan says so);
    scale_mean over the 8 slabs in one launch and over the 219 tensors
    in one; sharded_update for each of the five rules over the 8 slabs
    in one launch (AdamW's and Lion's decay lanes the table's prefixes);
    topk_scatter of the embedding (32.8M elements) at the codec's
    default density, also against the host codec's decode.  Then each
    timed beside its plain version, its bound (bytes / 3.35 TB/s) and
    one PyTorch call over the same bytes (every K1 lane its own, see
    ``time_fold_scale``; ``mul_``; ``torch.optim``'s fused step; none
    for Lion and the top-k scatter).  Returns (max_abs_err, times) by
    kernel name; fold_segments' times carry the other five lanes under
    ``lanes``."""
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import ShardedDeviceOptimizer
    from parameter_server_distributed_tpu_torch.core import device_apply
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.rpc import codec

    table, stripes, dst, sources = fold_store(torch, shapes, gen)
    n = table.total_elems

    def slabs(abs_=False):
        return {s: (lambda x: x.abs() if abs_ else x)(torch.randn(
            table.stripe_sizes[s], generator=gen, device="cuda"))
            for s in stripes}

    def clone(d):
        return {s: x.clone() for s, x in d.items()}

    def same(a, b) -> bool:
        return all(bits_equal(torch, a[s], b[s]) for s in a)

    def err(a, b) -> float:
        return max(float((a[s] - b[s]).abs().max()) for s in a)

    def rows(src, dsts):
        return store_rows(da, table, stripes, src, dsts)

    def per_tensor(dsts, inv):
        return [(dsts[s][e.offset:e.offset + e.length], inv)
                for s in stripes
                for e in map(table.entries.get, table.stripe_names[s])]

    max_err, times, report = {}, {}, {}
    # fold_segments: every lane, all 219 tensors from one flat source into
    # the slabs in one launch, and which rows the plan vectorises
    worst, checks, vector = 0.0, {}, {}
    for kind, src in sources.items():
        vector[kind] = vector_path(np, da, rows(src, dst))
        for add in (False, True):
            got, want = clone(dst), clone(dst)
            before = da.launches["fold_segments"]
            da.fold_segments(rows(src, got), add)
            da.fold_segments_reference(rows(src, want), add)
            torch.cuda.synchronize()
            checks[f"{kind}/{'add' if add else 'set'}"] = same(got, want)
            worst = max(worst, err(got, want))
            if da.launches["fold_segments"] != before + 1:
                fail("fold_segments took more than one launch for the store")
    del got, want
    max_err["fold_segments"] = worst
    bad = {k: v for k, v in vector.items() if v["vector_rows"] != v["rows"]}
    if bad:
        fail(f"llama_350m rows left off the fold's vector path: {bad}")
    # scale_mean: the 8 slabs in one launch, the 219 tensors in one
    inv = device_apply.inverse_count(2)
    worst, ok = 0.0, True
    for pick in (lambda d: [(d[s], inv) for s in stripes],
                 lambda d: per_tensor(d, inv)):
        got, want = clone(dst), clone(dst)
        da.scale_mean(pick(got))
        da.scale_mean_reference(pick(want))
        torch.cuda.synchronize()
        ok = ok and same(got, want)
        worst = max(worst, err(got, want))
    del got, want
    checks["scale"] = ok
    max_err["scale_mean"] = worst
    # both timed beside their bounds, their plain versions and one PyTorch
    # call over the same bytes (K1 in every lane)
    t = time_fold_scale(torch, da, table, stripes, dst, sources)
    yard = time_yardsticks(torch, sources, n)
    lanes = {}
    for lane, nbytes in FOLD_LANES.items():
        b_ms, b_by = bound(n, nbytes * n, "float32")
        lanes[lane] = dict(ms=t["fold"][lane], bound_ms=b_ms, bound_by=b_by,
                           library_ms=yard[lane],
                           share_of_bound=b_ms / t["fold"][lane])
    p_rows = rows(sources["f32"], clone(dst))
    plain = cuda_ms(torch, lambda: da.fold_segments_reference(p_rows, True),
                    iters=3)
    del p_rows
    head = lanes["f32/add"]
    times["fold_segments"] = dict(
        ms=head["ms"], plain_ms=plain, library_ms=head["library_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        lanes={k: v for k, v in lanes.items() if k != "f32/add"})
    one_row = {key: dict(ms=ms, bound_ms=bound(
        n_row, FOLD_LANES[key.rsplit("/", 1)[0]] * n_row, "float32")[0])
        for key, ms in t["fold_one_row"].items()
        for n_row in [ONE_ROWS[key.rsplit("/", 1)[1]]]}
    report["fold_segments"] = {
        "bits_equal": {k: v for k, v in checks.items() if "/" in k},
        "rows": len(rows(sources["f32"], dst)), "vector_path": vector,
        "lanes": lanes, "one_row": one_row, "host_us": t["fold_host_us"],
        "call_us": t["fold_call_us"], "plain_ms": plain,
        "library": "one PyTorch call over one flat tensor: copy_ (f32, "
                   "bf16 set), mul(out=) (int8 set), add_ (adds; int8 "
                   "with alpha=scale, which may round otherwise)"}
    del sources
    s_plain = [(x.clone(), inv) for x in dst.values()]
    plain = cuda_ms(torch, lambda: da.scale_mean_reference(s_plain), iters=3)
    del s_plain
    b_ms, b_by = bound(n, 8 * n, "float32")
    times["scale_mean"] = dict(ms=t["scale"]["slabs"], plain_ms=plain,
                               library_ms=yard["scale"], bound_ms=b_ms,
                               bound_by=b_by)
    report["scale_mean"] = {"bits_equal": {"scale": ok},
                            "library": "Tensor.mul_ (one flat tensor)",
                            "tensors_219_ms": t["scale"]["tensors_219"],
                            "norm_ms": t["scale"]["norm"],
                            "host_us": t["scale_host_us"],
                            "call_us": t["scale_call_us"],
                            **times["scale_mean"]}
    del dst
    torch.cuda.empty_cache()
    # sharded_update: each rule over the 8 slabs in one launch
    worst, by_rule = 0.0, {}
    for rule in da.RULES:
        opt = ShardedDeviceOptimizer(rule, 1e-3, device="cuda")
        opt.step = 3
        scalars = opt._scalars()
        p, g = slabs(), slabs()
        nslots = da.RULE_SLOTS[rule]
        slots = [slabs(abs_=(i == 1)) for i in range(nslots)]
        decay = {s: table.decay_len(s) if rule in ("adamw", "lion") else 0
                 for s in stripes}

        def upd_rows(sl, outs):
            return [da.UpdateRow(p[s], g[s], outs[s],
                                 *[x[s] for x in sl], *[None] * (2 - nslots),
                                 decay[s], False) for s in stripes]

        k_slots, r_slots = [clone(x) for x in slots], [clone(x) for x in slots]
        k_out = {s: torch.empty_like(p[s]) for s in stripes}
        r_out = {s: torch.empty_like(p[s]) for s in stripes}
        before = da.launches["sharded_update"]
        da.sharded_update(rule, upd_rows(k_slots, k_out), scalars)
        if da.launches["sharded_update"] != before + 1:
            fail(f"sharded_update {rule} took more than one launch")
        for row in upd_rows(r_slots, r_out):
            da.sharded_update_reference(rule, row, scalars)
        torch.cuda.synchronize()
        pairs = [(k_out, r_out)] + list(zip(k_slots, r_slots))
        checks[f"update/{rule}"] = all(same(a, b) for a, b in pairs)
        worst = max([worst] + [err(a, b) for a, b in pairs])
        del r_slots, r_out
        k_rows = upd_rows(k_slots, k_out)
        ms = cuda_ms(torch, lambda: da.sharded_update(rule, k_rows, scalars),
                     iters=10)
        p_rows = upd_rows([clone(x) for x in slots], clone(k_out))
        plain = cuda_ms(torch, lambda: [da.sharded_update_reference(
            rule, r, scalars) for r in p_rows], iters=2, warmup=1)
        del p_rows
        torch.cuda.empty_cache()
        library = None
        if rule != "lion":
            param = torch.nn.Parameter(torch.randn(n, generator=gen,
                                                   device="cuda"))
            param.grad = torch.randn(n, generator=gen, device="cuda")
            lib = (torch.optim.SGD([param], lr=1e-3, fused=True,
                                   momentum=0.9 if rule == "momentum"
                                   else 0.0)
                   if rule in ("sgd", "momentum") else
                   torch.optim.Adam([param], lr=1e-3, fused=True)
                   if rule == "adam" else
                   torch.optim.AdamW([param], lr=1e-3, fused=True))
            library = cuda_ms(torch, lib.step, iters=10)
            del lib, param
        b_ms, b_by = bound(DA_FLOPS[rule] * n, da.UPDATE_BYTES[rule] * n,
                           "float32")
        by_rule[rule] = dict(ms=ms, plain_ms=plain, library_ms=library,
                             bound_ms=b_ms, bound_by=b_by)
        del p, g, slots, k_slots, k_out, k_rows
        torch.cuda.empty_cache()
    max_err["sharded_update"] = worst
    times["sharded_update"] = by_rule[DA_LINE_RULE]
    report["sharded_update"] = {"by_rule": by_rule,
                                "library": "torch.optim SGD / SGD momentum "
                                           "/ Adam / AdamW (fused=True); "
                                           "none for Lion"}
    # topk_scatter: the embedding at the codec's default density
    total = max(math.prod(s) for s in shapes.values())
    x = np.random.default_rng(9).standard_normal(total).astype(np.float32)
    k = codec.topk_k(total, codec.TOPK_DEFAULT_DENSITY)
    buf = bytearray(codec.payload_nbytes(codec.WIRE_TOPK, total, k))
    codec.PythonCodec().pack_into(codec.WIRE_TOPK, x, buf, k)
    host = codec.PythonCodec().unpack(codec.WIRE_TOPK, bytes(buf), total)
    idx = device_apply.upload(np.frombuffer(bytes(buf), "<u4", k, 4), "cuda")
    vals = device_apply.upload(np.frombuffer(bytes(buf), "<u2", k,
                                             4 + 4 * k),
                               "cuda").view(torch.bfloat16)
    got = da.topk_scatter(idx, vals, total)
    want = da.topk_scatter_reference(idx, vals, total)
    torch.cuda.synchronize()
    checks["topk"] = (bits_equal(torch, got, want)
                      and got.cpu().numpy().tobytes() == host.tobytes())
    max_err["topk_scatter"] = float((got - want).abs().max())
    ms = cuda_ms(torch, lambda: da.topk_scatter(idx, vals, total), iters=10)
    plain = cuda_ms(torch, lambda: da.topk_scatter_reference(idx, vals,
                                                             total), iters=3)
    b_ms, b_by = bound(total, 4 * total + 6 * k, "float32")
    # the library's scatter, timed as the kernel is beside it: a cold L2
    # in a CUDA graph (cold_ms), index_put_ of the f32 values at int64
    # indices into a zeroed f32 tensor (the inputs widened beforehand)
    idx64, vals32 = idx.long(), vals.float()
    lib_out = torch.zeros(total, dtype=torch.float32,
                          device="cuda").index_put_((idx64,), vals32)
    checks["topk_index_put"] = bits_equal(torch, lib_out, want)
    del lib_out
    cold = {"ms": cold_ms(torch, lambda c: da.topk_scatter(c[0], c[1],
                                                           total),
                          (idx, vals)),
            "library_ms": cold_ms(torch, lambda c: torch.zeros(
                total, dtype=torch.float32, device="cuda").index_put_(
                    (c[0],), c[1]), (idx64, vals32)),
            "library": "torch.zeros(n).index_put_((int64 idx,), f32 values)"}
    times["topk_scatter"] = dict(ms=ms, plain_ms=plain,
                                 library_ms=cold["library_ms"],
                                 bound_ms=b_ms, bound_by=b_by, cold_l2=cold)
    report["topk_scatter"] = {"elements": total, "kept": k,
                              **times["topk_scatter"]}
    emit({"phase": "device_apply_kernels", "elements": n,
          "tensors": len(shapes), "stripes": len(stripes),
          "bits_equal": checks, "max_abs_err": max_err, **report})
    if not all(checks.values()):
        fail(f"a device-close kernel differs from its plain version: "
             f"{checks}")
    torch.cuda.empty_cache()
    return max_err, times


def ps_device_round(torch, np, fa) -> tuple[dict, dict, dict]:
    """The PS's device close in process: two full-width llama_350m
    Trainer workers on the card (the flash kernels) and three cores at 8
    stripes fed the same pushes for 3 rounds: host numpy ``adam``
    (native off), ``sharded_adam`` under PSDT_DEVICE_APPLY=1 (per-tensor
    device close) and the same under PSDT_ARENA=1 (the flat close).
    Each push is encoded for the wire (by round: f32 and f32; bf16 and
    int8; top-k and raw f32) and decoded by the host core's codec and
    onto the card for the device cores.  The three stores must be
    byte-identical after every round.  Reports each core's close time
    (its ``ps.barrier_close_s`` observation), the kernels' launches
    (equal to the counts the design gives), the readback time, the peak
    card memory and both fallback counters (0).  Returns (the launches,
    the round-1 store as host numpy and the round-1 losses, which the
    wire round's device leg is held to)."""
    from parameter_server_distributed_tpu_torch import native
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import ShardedDeviceOptimizer
    from parameter_server_distributed_tpu_torch.core.optimizer import \
        make_optimizer
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        ParameterServerCore
    from parameter_server_distributed_tpu_torch.core.stripes import \
        partition_names
    from parameter_server_distributed_tpu_torch.core.tensor import (
        from_wire, to_host, to_wire)
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.obs import stats
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.rpc import codec
    from parameter_server_distributed_tpu_torch.rpc.data_plane import \
        decode_gradients
    from parameter_server_distributed_tpu_torch.rpc.wire import ArrayPayload
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    b, lr, workers = TRAIN["batch"], TRAIN["lr"], ROUND["workers"]
    rounds = len(DEVICE_ROUND_WIRE)
    native.set_enabled(False)
    env = {k: os.environ.get(k) for k in ("PSDT_DEVICE_APPLY", "PSDT_ARENA")}
    try:
        os.environ["PSDT_DEVICE_APPLY"] = "1"
        cores = {}
        for name, opt, arena in (("host", "adam", "0"),
                                 ("sharded", "sharded_adam", "0"),
                                 ("arena", "sharded_adam", "1")):
            os.environ["PSDT_ARENA"] = arena
            cores[name] = ParameterServerCore(
                total_workers=workers, stripes=DEVICE_STRIPES,
                optimizer=make_optimizer(opt, lr))
        for name in ("sharded", "arena"):
            opt = cores[name]._optimizer
            if not (isinstance(opt, ShardedDeviceOptimizer)
                    and opt.device.type == "cuda"
                    and cores[name].device_fold() is not None):
                fail(f"the {name} core does not close on the card")
        if cores["arena"]._arena is None or cores["sharded"]._arena:
            fail("PSDT_ARENA did not arm the arena core alone")
        sides = [get_model_and_batches("llama_350m", b, seed=wid,
                                       dtype="bf16")
                 for wid in range(workers)]
        trainers = [Trainer(m) for m, _ in sides]
        batches = [next(stream) for _, stream in sides]
        init = trainers[0].init_params(0)
        for core in cores.values():
            core.initialize_parameters(init)
        names = list(init)
        groups = len(partition_names(names, DEVICE_STRIPES))
        counters = ("ps.apply.device_fallback", "ps.apply.arena_fallback")
        fb_before = {c: stats.counter(c).value for c in counters}
        close_hist = stats.histogram("ps.barrier_close_s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        da.reset_launches()
        launches = {name: dict.fromkeys(da.launches, 0) for name in cores}
        expected = {name: dict.fromkeys(da.launches, 0) for name in cores}
        closes = {name: [] for name in cores}
        identical, losses, round1 = [], [], None
        for it in range(1, rounds + 1):
            for wid in range(workers):
                _, params, _ = cores["host"].serve_parameters(it)
                grads, loss = trainers[wid].compute_gradients(params,
                                                              batches[wid])
                losses.append(loss)
                wire = codec.WIRE_DTYPE_NAMES[DEVICE_ROUND_WIRE[it][wid]]
                msgs = to_wire(grads, wire_dtype=wire)
                for t in msgs:   # encode once: the bytes both decodes read
                    if isinstance(t.packed, ArrayPayload):
                        t.packed = t.packed.tobytes()
                del grads
                decodes = {codec.WIRE_BF16: len(names),
                           codec.WIRE_INT8: len(names)}.get(wire, 0)
                kept = (sum(1 for t in msgs if np.frombuffer(
                    t.packed, "<u4", 1)[0]) if wire == codec.WIRE_TOPK
                    else 0)
                for name, core in cores.items():
                    before = dict(da.launches)
                    hist_before = close_hist.total
                    t0 = time.perf_counter()
                    g = (from_wire(msgs) if name == "host" else
                         decode_gradients(msgs, core.device_fold()))
                    result = core.receive_gradients(wid, it, g)
                    del g
                    torch.cuda.synchronize()
                    if wid == workers - 1:
                        closes[name].append({
                            "push_s": time.perf_counter() - t0,
                            "close_s": close_hist.total - hist_before})
                    for k in da.launches:
                        launches[name][k] += da.launches[k] - before[k]
                    if not result.success or result.aggregation_complete \
                            != (wid == workers - 1):
                        fail(f"{name} core, round {it} worker {wid}: "
                             f"{result.message}")
                    if name == "host":
                        continue
                    e = expected[name]
                    e["fold_segments"] += decodes
                    e["topk_scatter"] += kept
                    e["fold_segments"] += (len(names) if name == "sharded"
                                           else groups)
                del msgs
            for name in ("sharded", "arena"):
                # per tensor: one scale a stripe group; flat: one for
                # every stripe slab
                expected[name]["scale_mean"] += (groups if name == "sharded"
                                                 else 1)
                expected[name]["sharded_update"] += groups
            stores = {name: to_host(core.get_parameters())
                      for name, core in cores.items()}
            same = {name: all(stores[name][n].tobytes()
                              == stores["host"][n].tobytes() for n in names)
                    and list(stores[name]) == names
                    for name in ("sharded", "arena")}
            identical.append(same)
            if it == 1:
                round1 = {n: np.array(stores["arena"][n]) for n in names}
            del stores
        peak = torch.cuda.max_memory_allocated() / 1e9
        fallbacks = {c: stats.counter(c).value - fb_before[c]
                     for c in counters}
        arena_store = type(cores["arena"]._params).__name__
    finally:
        native.set_enabled(os.environ.get("PSDT_NATIVE", "1").lower()
                           not in ("0", "false"))
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    flash = dict(fa.launches)
    emit({"phase": "ps_device_round", "model": "llama_350m",
          "workers": workers, "rounds": rounds, "stripes": DEVICE_STRIPES,
          "optimizer": "adam (host numpy) / sharded_adam / sharded_adam "
                       "+ arena", "lr": lr, "wire": DEVICE_ROUND_WIRE,
          "losses": losses, "stores_identical": identical,
          "closes": closes, "launches": launches,
          "expected_launches": expected, "flash_launches": flash,
          "readback_s": stats.histogram("ps.apply.readback_s").summary(),
          "arena_store": arena_store, "peak_mem_gb": peak,
          "fallbacks": fallbacks})
    if not all(all(s.values()) for s in identical):
        fail(f"the device cores' stores differ from the host core's: "
             f"{identical}")
    if launches != expected:
        fail(f"ps_device_round launches {launches} != {expected}")
    if any(fallbacks.values()) or arena_store != "ArenaStore":
        fail(f"ps_device_round fell back: {fallbacks}, {arena_store}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"ps_device_round losses not finite: {losses}")
    del cores, trainers
    torch.cuda.empty_cache()
    total = {k: sum(launches[name][k] for name in launches)
             for k in da.launches}
    return {**flash, **total}, round1, {"round1_losses": losses[:workers]}


def _wait_line(path: str, pattern: str, proc, deadline: float) -> str:
    """The first match of ``pattern`` in a child's log, waiting until
    ``deadline``; fails if the child exits first or time runs out."""
    while time.monotonic() < deadline:
        with open(path) as f:
            found = re.search(pattern, f.read())
        if found:
            return found.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    with open(path) as f:
        tail = f.read()[-3000:]
    fail(f"{' '.join(proc.args[2:4])} never printed {pattern!r} "
         f"(exit {proc.poll()}): {tail}")


def ps_wire_round(np, round1, in_process: dict | None,
                  leg: str = "host") -> dict:
    """The parameter-server round over the wire (BASELINE config 1 as its
    users run it): cli.ps_main (2 workers, lr 1e-3, a checkpoint every
    iteration into build/), cli.coordinator_main and two cli.worker_main
    processes (full-width llama_350m, bf16, batch 8, worker i on
    get_model_and_batches("llama_350m", 8, seed=i) as in ps_round), all
    on the card on free localhost ports.  Iteration 0 is the bootstrap
    (each worker pushes init_params(0); the PS adopts their mean, the
    init), then the leg's gradient rounds (WIRE_LEGS), each one fused
    PushPullStream round per worker with bucketed gradient downloads.
    Leg "host": the PS applies pallas_adam on the card after a numpy fold
    and scale, 2 rounds.  Leg "device": --optimizer=sharded_adam under
    PSDT_DEVICE_APPLY=1 PSDT_ARENA=1, the whole close on the card, 2
    rounds.

    The epoch-1 checkpoint (the store after the first gradient round) is
    held against ``round1`` (host leg: ps_round's, at rtol 1e-5, atol
    1e-7; device leg: ps_device_round's, byte for byte) and the workers'
    round-1 losses against the in-process ones (rtol 1e-6), unless
    ``round1`` and ``in_process`` are None; every epoch's file must
    hold its own iteration and, in its optimizer sidecar, that
    iteration's Adam step (the PS takes each at the apply that advanced
    the epoch, whatever its writer lags).  Rounds from 2 on take each
    stream's next batches (ps_round repeats the first), so their losses
    are only held finite.  Each process writes an exit report (launch
    counts, peak card memory, its obs histograms) and each worker its
    per-iteration phase times (PSDT_METRICS_FILE).  Fails if a child
    exits non-zero, a check misses or the phase outlives its limit;
    every child is killed on the way out.  Returns the path's launch
    counts, summed over the processes."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f"ps_wire_round-{leg}-",
                           dir=os.path.join(HERE, "build"))
    env = child_env(tmp, PSDT_FLASH_ATTENTION="1", **WIRE_LEGS[leg][2])
    try:
        return _wire_round_in(tmp, _spawner(tmp, env), np, round1,
                              in_process, leg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def push_stripe_pairs(np, shapes: dict, stripes: int) -> int:
    """The (chunk, stripe) pairs of one f32 push of a store of ``shapes``:
    a worker pushes its gradients in the trainer's layout order (sorted
    by name), cut into chunks by rpc/data_plane.split_tensors at the
    stream chunk size (the children inherit this process's), and a flat
    fold launches ``fold_segments`` once per pair and lane."""
    from types import SimpleNamespace

    from parameter_server_distributed_tpu_torch.core.stripes import \
        stripe_of
    from parameter_server_distributed_tpu_torch.rpc.data_plane import (
        split_tensors, stream_chunk_bytes)

    tensors = [SimpleNamespace(name=n, packed=b"", data=np.broadcast_to(
        np.float32(0), tuple(shapes[n]))) for n in sorted(shapes)]
    return sum(len({stripe_of(t.name, stripes) for t in chunk})
               for chunk in split_tensors(tensors, stream_chunk_bytes()))


def child_env(tmp: str, **knobs) -> dict:
    """The environment of a wire phase's children: this one, with the
    transport and codec knobs at their defaults unless ``knobs`` sets
    them, and per-iteration metrics into ``tmp``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PSDT_SHM", "PSDT_NATIVE", "PSDT_SHM_RING_BYTES",
                        "PSDT_DEVICE_APPLY", "PSDT_ARENA", "PSDT_STRIPES")}
    # a fatal signal in a child prints its Python traceback into its log
    return {**env, "PYTHONPATH": HERE, "PYTHONFAULTHANDLER": "1", **knobs,
            "PSDT_METRICS_FILE": os.path.join(tmp, "metrics-%d.jsonl")}


def _spawner(tmp: str, env: dict):
    """spawn(cli name, *args) -> (process, log path), a port CLI as a child
    with ``env``, its output in ``tmp``; ``spawn.procs`` lists them."""
    procs = []

    def spawn(name: str, *args) -> tuple:
        log = os.path.join(tmp, f"{name}-{len(procs)}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"{PACKAGE}.cli.{name}", *args],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=HERE)
        procs.append(proc)
        return proc, log

    spawn.procs = procs
    return spawn


def _run_round(spawn, ps_args: list, workers_args: list, limit_s: float
               ) -> tuple[float, int]:
    """A PS (``ps_args``), a coordinator and one worker per entry of
    ``workers_args`` as children (``_run_cluster`` with one shard).
    Returns (wall seconds to the workers' end, the PS's pid)."""
    wall, pids = _run_cluster(spawn, [ps_args], workers_args, limit_s)
    return wall, pids[0]


def _run_cluster(spawn, shard_args: list, workers_args: list,
                 limit_s: float) -> tuple[float, list]:
    """One PS per entry of ``shard_args`` (its arguments, all started at
    once), a coordinator naming the first as its PS and the others in
    --ps-shards, and one worker per entry of ``workers_args`` (started at
    once) as children; waits for the workers, then stops the PSs and the
    coordinator with SIGTERM.  Fails if a child exits non-zero or the
    round outlives ``limit_s``; kills every child on the way out.
    Returns (wall seconds to the workers' end, the PSs' pids)."""
    import signal

    deadline = time.monotonic() + limit_s
    t0 = time.perf_counter()
    try:
        shards = [spawn("ps_main", "127.0.0.1:0", *args)
                  for args in shard_args]
        ports = [_wait_line(log, r"Parameter server listening on "
                            r"[\d.]+:(\d+)", ps, deadline)
                 for ps, log in shards]
        more = [f"--ps-shards={','.join(f'127.0.0.1:{p}' for p in ports[1:])}"
                ] if len(ports) > 1 else []
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0",
                                 f"127.0.0.1:{ports[0]}", *more)
        coord_port = _wait_line(coord_log, r"Coordinator server listening "
                                r"on [\d.]+:(\d+)", coord, deadline)
        children = [spawn("worker_main", f"127.0.0.1:{coord_port}", *args)
                    for args in workers_args]
        for proc, log in children:
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                fail(f"a worker outlived the phase's {limit_s} s")
            if rc != 0:
                tails = []
                for ps, ps_log in shards:
                    with open(ps_log) as g:
                        tails.append(f"a PS (exit {ps.poll()}): "
                                     f"{g.read()[-6000 // len(shards):]}")
                with open(log) as f:
                    fail(f"worker exited {rc}: {f.read()[-3000:]}\n"
                         + "\n".join(tails))
        wall = time.perf_counter() - t0
        for proc, log in (*shards, (coord, coord_log)):
            proc.send_signal(signal.SIGTERM)
        for proc, log in (*shards, (coord, coord_log)):
            try:
                rc = proc.wait(timeout=120.0)
            except subprocess.TimeoutExpired:
                rc = "hung at SIGTERM"
            if rc != 0:
                with open(log) as f:
                    fail(f"{proc.args[2]} exited {rc}: {f.read()[-3000:]}")
    finally:
        for proc in spawn.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60.0)
    return wall, [ps.pid for ps, _ in shards]


def shm_left(pid: int) -> list[str]:
    """Shared-memory segments of process ``pid`` still in /dev/shm."""
    if not os.path.isdir("/dev/shm"):
        return []
    return [n for n in os.listdir("/dev/shm") if n.startswith(f"psdt-{pid}-")]


def transport_faults(reports: dict, shm: bool, native: bool) -> list[str]:
    """What in the processes' exit reports contradicts the transport and
    codec asked for: a fallback to gRPC, the other codec resolved, ring
    bytes where none may be."""
    bad = []
    for role, r in reports.items():
        fallback = r["counters"].get("rpc.shm.fallback")
        codec = r["gauges"].get("rpc.codec.native")
        if fallback != 0:
            bad.append(f"{role}: rpc.shm.fallback {fallback}")
        if codec != (1.0 if native else 0.0):
            bad.append(f"{role}: rpc.codec.native {codec}")
        if not shm and r["counters"].get("rpc.shm.bytes", 0):
            bad.append(f"{role}: ring bytes over gRPC")
    return bad


def _wire_round_in(tmp: str, spawn, np, round1, in_process,
                   leg: str) -> dict:
    """ps_wire_round's body, its children and files under ``tmp``."""
    from parameter_server_distributed_tpu_torch.checkpoint.manager import \
        CheckpointManager
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        ParameterServerCore
    from parameter_server_distributed_tpu_torch.core.stripes import \
        partition_names
    from parameter_server_distributed_tpu_torch.models.transformer import \
        llama_350m
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu

    b, s, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    workers = ROUND["workers"]
    optimizer, rounds, _ = WIRE_LEGS[leg]
    device = leg == "device"
    ckpt_dir = os.path.join(tmp, "ck")
    wall, ps_pid = _run_round(
        spawn, [str(workers), "1", f"--optimizer={optimizer}", f"--lr={lr}",
                f"--ckpt-dir={ckpt_dir}", f"--report={tmp}/ps.json"],
        [[str(wid), str(rounds + 1), "--model=llama_350m", f"--batch={b}",
          "--dtype=bf16", f"--report={tmp}/worker-{wid}.json"]
         for wid in range(workers)], WIRE_LIMIT_S)
    left = shm_left(ps_pid)

    def load(name: str) -> dict:
        with open(os.path.join(tmp, name)) as f:
            return json.load(f)

    reports = {"ps": load("ps.json"),
               **{f"worker {w}": load(f"worker-{w}.json")
                  for w in range(workers)}}
    records = {}
    for wid in range(workers):
        with open(os.path.join(tmp, f"metrics-{wid}.jsonl")) as f:
            records[wid] = [json.loads(line) for line in f]

    # the store after the first gradient round, from its checkpoint
    core = ParameterServerCore(total_workers=workers)
    ck_files = sorted(os.listdir(ckpt_dir))
    epoch, iteration = CheckpointManager(core, ckpt_dir).load(
        os.path.join(ckpt_dir, "checkpoint_epoch_1.ckpt"))
    got = core.get_parameters()
    worst, ok = 0.0, (epoch, iteration) == (1, 1)
    if round1 is not None:
        ok = ok and sorted(got) == sorted(round1)
        for n, ref in round1.items():
            worst = max(worst, float(np.max(np.abs(got[n] - ref))))
            ok = ok and (got[n].tobytes() == ref.tobytes() if device else
                         bool(np.allclose(got[n], ref, rtol=1e-5,
                                          atol=1e-7)))
    del core, got
    # (epoch, iteration) from each file's header (checkpoint/codec.py:
    # two little-endian int32 first) and the Adam step of its sidecar
    held = []
    for e in range(rounds + 1):
        path = os.path.join(ckpt_dir, f"checkpoint_epoch_{e}.ckpt")
        with open(path, "rb") as f:
            header = struct.unpack("<ii", f.read(8))
        step = 0
        if os.path.exists(path + ".opt.npz"):
            with np.load(path + ".opt.npz") as npz:
                # a 1-element array (PallasOptimizer) or a 0-d scalar
                # (the host optimizers' layout, ShardedDeviceOptimizer's)
                step = int(np.asarray(npz["__scalar__/step"]).reshape(-1)[0])
        held.append([*header, step])
    epochs_ok = held == [[e, e, e] for e in range(rounds + 1)]

    # launches, summed over the processes, against the path's
    model = llama_350m()
    layers = model.config.n_layers
    launches = {}
    for report in reports.values():
        for name, n in report["launches"].items():
            launches[name] = launches.get(name, 0) + n
    expected = {"flash_fwd": 2 * layers * workers * rounds,
                "flash_bwd_dq": layers * workers * rounds,
                "flash_bwd_dkv": layers * workers * rounds,
                "fused_sgd": 0, "fused_momentum": 0,
                "fused_adam": 0 if device else
                update_launches(fu, model.param_shapes()) * rounds,
                **dict.fromkeys(da.launches, 0),
                **dict.fromkeys(i8.launches, 0)}
    fold_pairs = None
    if device:
        # the bootstrap folds per tensor (a copy and an add each) and
        # scales per stripe group; each flat round scales every stripe
        # slab in one launch and updates once a stripe; the first flat
        # close packs the bootstrap store once a stripe.  A flat fold is
        # one launch per (chunk, stripe, lane): each worker's push
        # touches the same pairs, the first to reach a pair seeds it on
        # the set lane and the other adds on the add lane
        shapes = model.param_shapes()
        groups = len(partition_names(shapes, DEVICE_STRIPES))
        fold_pairs = push_stripe_pairs(np, shapes, DEVICE_STRIPES)
        expected.update(
            fold_segments=2 * len(shapes) + groups
            + workers * fold_pairs * rounds,
            scale_mean=groups + rounds, sharded_update=groups * rounds)
    by_process = {role: {k: v for k, v in r["launches"].items() if v}
                  for role, r in reports.items()}

    def med(key: str, iters) -> float | None:
        vals = [r[key] for wid in records for r in records[wid]
                if r["step"] in iters and key in r]
        return float(np.median(vals)) if vals else None

    steady = range(2, rounds + 1)
    round_s = float(np.median([max(r["step_time_s"] for wid in records
                                   for r in records[wid] if r["step"] == it)
                               for it in steady]))
    flops = workers * model_flops_per_step(model, b, s)
    losses = [[r["loss"] for r in records[wid] if r["step"] >= 1]
              for wid in range(workers)]
    mean_loss = [float(np.mean([losses[w][i] for w in range(workers)]))
                 for i in range(rounds)]
    ps_hist = reports["ps"]["histograms"]
    # the rings carried every fused round: a push and a pull of the f32
    # store a round, each way, per worker
    ring_floor = rounds * 2 * 4 * model.num_params()
    ring_bytes = {role: r["counters"].get("rpc.shm.bytes", 0)
                  for role, r in reports.items()}
    faults = transport_faults(reports, shm=True, native=True) + [
        f"{role} moved {n} ring bytes, under {ring_floor}"
        for role, n in ring_bytes.items()
        if role != "ps" and n < ring_floor]
    ps_counters = reports["ps"]["counters"]
    device_faults = [] if not device else [
        f"PS {k} {ps_counters.get(k)}" for k, want in (
            ("ps.apply.device_fallback", 0), ("ps.apply.arena_fallback", 0),
            ("ps.apply.arena", rounds)) if ps_counters.get(k) != want]
    if device and reports["ps"].get("optimizer") != "ShardedDeviceOptimizer":
        device_faults.append(f"PS optimizer {reports['ps'].get('optimizer')}")
    out = {"phase": "ps_wire_round", "leg": leg, "model": "llama_350m",
           "dtype": "bfloat16", "processes": ["ps_main", "coordinator_main"]
           + [f"worker_main {w}" for w in range(workers)],
           "workers": workers, "rounds": rounds, "batch": b, "seq": s,
           "optimizer": optimizer, "lr": lr, "wire": "f32",
           "ps_optimizer_class": reports["ps"].get("optimizer"),
           "ps_apply_counters": {k: ps_counters.get(k) for k in (
               "ps.apply.device", "ps.apply.arena",
               "ps.apply.device_fallback", "ps.apply.arena_fallback")},
           "ps_readback_s": reports["ps"]["histograms"].get(
               "ps.apply.readback_s"),
           "fold_push_stripe_pairs": fold_pairs,
           "transport": "shm", "ring_bytes": ring_bytes,
           # the rings' bytes over the fused rounds' whole time (barrier
           # wait, encode, fold and apply included): a floor on the rate
           "ring_gb_per_fused_s": {
               f"worker {w}": ring_bytes[f"worker {w}"] / 1e9 / sum(
                   r["fused_s"] for r in records[w] if "fused_s" in r)
               for w in records},
           "ring_bytes_floor_per_worker": ring_floor,
           "shm_fallback": {role: r["counters"].get("rpc.shm.fallback")
                            for role, r in reports.items()},
           "codec_native": {role: r["gauges"].get("rpc.codec.native")
                            for role, r in reports.items()},
           "segments_left": left, "over_grpc_before": GRPC_ROUNDS,
           "wall_s": wall, "round_s_median": round_s,
           "tokens_per_s": workers * b * s / round_s,
           "mfu": flops / (round_s * PEAK_FLOPS["bfloat16"]),
           "iterations": {w: [{k: v for k, v in r.items() if k != "t"}
                              for r in records[w]] for w in records},
           "phase_medians_s": {
               "pull_s (iteration 1)": med("pull_s", (1,)),
               "compute_s": med("compute_s", steady),
               "fused_push_barrier_pull_s": med("fused_s", steady),
               "dtoh_device_ms": med("dtoh_ms", steady),
               "dtoh_wait_s": med("dtoh_wait_s", steady)},
           "ps_barrier_close_s": ps_hist.get("ps.barrier_close_s"),
           "ps_barrier_wait_s": ps_hist.get("ps.barrier_wait_s"),
           "ps_serve_s": ps_hist.get("ps.serve_s"),
           "ps_serve_encode_s": ps_hist.get("ps.serve.encode_s"),
           "ps_apply_s": ps_hist.get("ps.apply_s"),
           "peak_mem_gb": {role: r["peak_mem_bytes"] / 1e9
                           for role, r in reports.items()},
           "losses": losses, "mean_loss": mean_loss,
           "checkpoints": ck_files,
           "checkpoint_epoch_iteration_step": held,
           "round1_vs_ps_round": {"max_abs_err": worst, "rtol": 1e-5,
                                  "atol": 1e-7, "checked": round1 is not None,
                                  "ok": ok},
           "in_process": in_process,
           "launches": launches, "expected_launches": expected,
           "launches_by_process": by_process}
    emit(out)
    if faults:
        fail(f"ps_wire_round did not ride the rings with the native codec: "
             f"{faults}")
    if device_faults:
        fail(f"ps_wire_round's device close: {device_faults}")
    if left:
        fail(f"the PS left shared-memory segments behind: {left}")
    if not ok:
        fail(f"the wire round's round-1 store is off ps_round's by {worst} "
             f"(epoch {epoch}, iteration {iteration})")
    if not epochs_ok:
        fail(f"a checkpoint does not hold its epoch's iteration and Adam "
             f"step: {held}")
    if launches != expected:
        fail(f"ps_wire_round launches {launches} != expected {expected}")
    if any(v for k, v in reports["ps"]["launches"].items()
           if k.startswith("flash")) or any(
            reports[f"worker {w}"]["launches"][k] for w in range(workers)
            for k in ("fused_sgd", "fused_momentum", "fused_adam",
                      *da.launches)):
        fail(f"a kernel ran in the wrong process: {by_process}")
    if any(len(h) != rounds for h in losses) or not all(
            math.isfinite(x) for h in losses for x in h):
        fail(f"ps_wire_round losses not finite: {losses}")
    if in_process is not None and not np.allclose(
            [h[0] for h in losses], in_process["round1_losses"], rtol=1e-6):
        fail(f"round-1 losses {[h[0] for h in losses]} are not ps_round's "
             f"{in_process['round1_losses']}")
    return launches


def in_parallel(thunks: dict, here: str | None = None) -> dict:
    """Run the thunks all at once, each on a thread of its own but the one
    keyed ``here``, which runs on the calling thread (this process's own
    card work, the profiler); their results by key.  A thunk that raised
    (a ``fail`` included) raises again here, the first by key order, once
    every thread has ended."""
    results, errors = {}, {}

    def run(key, fn):
        try:
            results[key] = fn()
        except BaseException as exc:  # noqa: BLE001 — raised below
            errors[key] = exc

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in thunks.items() if item[0] != here]
    for t in threads:
        t.start()
    if here is not None:
        run(here, thunks[here])
    for t in threads:
        t.join()
    for key in thunks:
        if key in errors:
            raise errors[key]
    return results


def config1_wire(np) -> dict:
    """BASELINE config 1 as the reference runs it: cli.ps_main (1 worker,
    no --optimizer, so its default pallas_sgd, lr CONFIG1["lr"], a
    checkpoint every iteration), cli.coordinator_main and one
    cli.worker_main (mnist_mlp, batch 256, bf16 on the wire), all on the
    card; a bootstrap and 5 gradient rounds.  Four legs, run at once
    (each its own processes, files and free ports): (a) the
    defaults, the shared-memory rings and the native codec; (b)
    PSDT_SHM=0, gRPC; (c) PSDT_SHM=0 PSDT_NATIVE=0 and --optimizer=sgd,
    gRPC, the Python codec and the PS's plain host SGD in numpy; (d) the
    rings and the native codec with --optimizer=sharded_sgd under
    PSDT_DEVICE_APPLY=1 PSDT_ARENA=1: the bf16 pushes decode on the card
    (fold_segments' bf16 lane) and the whole close runs there, flat.
    Every epoch's checkpoint must be byte-identical across the legs,
    which holds the fused_sgd kernel of legs (a) and (b) and the device
    close of leg (d) to the plain rule at config 1's shapes; each leg's
    processes must have used the transport and codec it asked for, the
    loss must fall, the PS of legs (a) and (b) must count one fused_sgd
    launch per apply (as ops.fused_update.plan gives), that of leg (c)
    none, that of leg (d) the device close's launches and no fallback.
    Returns the launch counts of legs (a) and (d), summed over their
    processes, and leg (a)'s checkpoint files, epoch by epoch."""
    import hashlib
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.core.stripes import \
        partition_names
    from parameter_server_distributed_tpu_torch.models.mlp import mnist_mlp
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu

    b, rounds, lr = CONFIG1["batch"], CONFIG1["rounds"], CONFIG1["lr"]
    # leg -> (environment, ps_main's optimizer flags)
    legs = {"shm_native": ({}, []),
            "grpc_native": ({"PSDT_SHM": "0"}, []),
            "grpc_python_host_sgd": ({"PSDT_SHM": "0", "PSDT_NATIVE": "0"},
                                     ["--optimizer=sgd"]),
            "shm_native_device_sgd": ({"PSDT_DEVICE_APPLY": "1",
                                       "PSDT_ARENA": "1",
                                       "PSDT_STRIPES": str(DEVICE_STRIPES)},
                                      ["--optimizer=sharded_sgd"])}
    shapes = mnist_mlp().param_shapes()
    per_apply = update_launches(fu, shapes)
    # the device leg's PS: the bootstrap push (f32, before the worker has
    # seen a packed pull) folds per tensor (a copy each) and scales per
    # stripe group; each round decodes each bf16 tensor (fold_segments'
    # bf16 lane), folds its one chunk into each stripe slab, scales
    # every slab in one launch and updates once a stripe; the first flat
    # close packs the bootstrap store once a stripe
    groups = len(partition_names(shapes, DEVICE_STRIPES))
    device_launches = {
        "fold_segments": len(shapes) + rounds * (len(shapes) + groups)
        + groups,
        "scale_mean": groups + rounds,
        "sharded_update": rounds * groups, "topk_scatter": 0}
    out = {"phase": "config1_wire", "model": "mnist_mlp", "batch": b,
           "rounds": rounds, "optimizer": "pallas_sgd (ps_main default); "
           "host sgd in the last leg", "lr": lr, "wire": "bf16", "legs": {}}
    ckpts, faults, launches_a = {}, [], None
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)

    def run_leg(leg: str) -> tuple:
        extra, opt_args = legs[leg]
        tmp = tempfile.mkdtemp(prefix=f"config1-{leg}-",
                               dir=os.path.join(HERE, "build"))
        try:
            env = child_env(tmp, **extra)
            ckpt_dir = os.path.join(tmp, "ck")
            wall, ps_pid = _run_round(
                _spawner(tmp, env),
                ["1", "1", *opt_args, f"--lr={lr}",
                 f"--ckpt-dir={ckpt_dir}", f"--report={tmp}/ps.json"],
                [["0", str(rounds + 1), "--model=mnist_mlp", f"--batch={b}",
                  "--wire=bf16", f"--report={tmp}/worker-0.json"]],
                CONFIG1_LIMIT_S)
            reports = read_reports(tmp, {"ps": "ps.json",
                                         "worker 0": "worker-0.json"})
            with open(os.path.join(tmp, "metrics-0.jsonl")) as f:
                records = [json.loads(line) for line in f]
            files = []
            for e in range(rounds + 1):
                with open(os.path.join(ckpt_dir,
                                       f"checkpoint_epoch_{e}.ckpt"),
                          "rb") as f:
                    files.append(f.read())
            return wall, reports, records, files, shm_left(ps_pid)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    # the legs are independent clusters of tiny processes: they run at
    # once, so their round times are taken beside each other's
    results = in_parallel({leg: (lambda leg=leg: run_leg(leg))
                           for leg in legs})
    for leg, (extra, opt_args) in legs.items():
        device = "PSDT_DEVICE_APPLY" in extra
        expected_ps = {"flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0, "fused_momentum": 0,
                       "fused_adam": 0, "fused_sgd": 0 if opt_args
                       else per_apply * rounds,
                       **(device_launches if device
                          else dict.fromkeys(da.launches, 0)),
                       **dict.fromkeys(i8.launches, 0)}
        wall, reports, records, ckpts[leg], left = results[leg]
        shm = leg.startswith("shm_")
        leg_faults = transport_faults(reports, shm=shm,
                                      native=not extra.get("PSDT_NATIVE"))
        ring = reports["worker 0"]["counters"].get("rpc.shm.bytes", 0)
        if shm and ring <= 0:
            leg_faults.append("worker 0 moved no ring bytes")
        if left:
            leg_faults.append(f"segments left: {left}")
        ps_launches = reports["ps"]["launches"]
        if ps_launches != expected_ps:
            leg_faults.append(f"PS launches {ps_launches} != {expected_ps}")
        if any(reports["worker 0"]["launches"].values()):
            leg_faults.append(f"worker launches "
                              f"{reports['worker 0']['launches']}")
        if device:
            counters = reports["ps"]["counters"]
            leg_faults += [f"PS {k} {counters.get(k)}" for k, want in (
                ("ps.apply.device_fallback", 0),
                ("ps.apply.arena_fallback", 0), ("ps.apply.arena", rounds))
                if counters.get(k) != want]
            if reports["ps"].get("optimizer") != "ShardedDeviceOptimizer":
                leg_faults.append(f"PS optimizer "
                                  f"{reports['ps'].get('optimizer')}")
        losses = [r["loss"] for r in records if r["step"] >= 1]
        if len(losses) != rounds or not all(
                math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
            leg_faults.append(f"losses not finite and falling: {losses}")
        faults += [f"{leg}: {f}" for f in leg_faults]
        steady = [r for r in records if r["step"] >= 2]
        out["legs"][leg] = {
            "env": extra, "ps_args": opt_args, "wall_s": wall,
            "losses": losses, "expected_ps_launches": expected_ps,
            "round_s_median": float(np.median([r["step_time_s"]
                                               for r in steady])),
            "fused_s_median": float(np.median([r["fused_s"]
                                               for r in steady])),
            "compute_s_median": float(np.median([r["compute_s"]
                                                 for r in steady])),
            "ps_apply_s": reports["ps"]["histograms"].get("ps.apply_s"),
            "ring_bytes_worker": ring,
            "shm_fallback": {k: r["counters"].get("rpc.shm.fallback")
                             for k, r in reports.items()},
            "codec_native": {k: r["gauges"].get("rpc.codec.native")
                             for k, r in reports.items()},
            "peak_mem_gb": {k: r["peak_mem_bytes"] / 1e9
                            for k, r in reports.items()},
            "launches": {k: {n: v for n, v in r["launches"].items() if v}
                         for k, r in reports.items()},
            "checkpoint_sha256": [hashlib.sha256(c).hexdigest()[:16]
                                  for c in ckpts[leg]]}
        if shm:
            launches_a = launches_a or {}
            for r in reports.values():
                for n, v in r["launches"].items():
                    launches_a[n] = launches_a.get(n, 0) + v
    identical = all(ckpts[leg] == ckpts["shm_native"] for leg in legs)
    out["checkpoints_identical"] = identical
    emit(out)
    if faults:
        fail(f"config1_wire: {faults}")
    if not identical:
        fail("config1_wire: the legs' checkpoints differ: "
             + json.dumps({leg: v["checkpoint_sha256"]
                           for leg, v in out["legs"].items()}))
    return launches_a, ckpts["shm_native"]


# BASELINE config 2 (1 PS / 4 workers, async-SGD CIFAR-10 ResNet-18) as
# BASELINE.md runs it: 4 resnet18_cifar workers at batch 256, the PS at
# staleness 4; each worker a bootstrap iteration, then ``rounds``
# gradient iterations; an SGD rate at which the loss falls
CONFIG2 = dict(workers=4, batch=256, rounds=10, lr=0.05, staleness=4)
CONFIG2_LIMIT_S = 300.0   # the phase's wall-clock limit, children included
# the image rows' in-process card steps: the CIFAR rows at config 2's
# batch, the ImageNet rows at a batch of 32 (each row's own full width);
# then a CHECK_IMAGES-image batch on the card against the port on the CPU
IMAGE_ROWS = {"resnet18_cifar": 256, "vit_tiny_cifar": 256,
              "resnet50_imagenet": 32, "vit_s16_imagenet": 32}
CHECK_IMAGES = 4
# how each row's CHECK_IMAGES gradients are held, card against CPU:
# "strict" rtol 5e-4, atol 1e-5 a entry; "max" within 2^-5 of each
# gradient's largest entry; None not held (reported).  A float32 conv's
# weight gradient is a sum with much cancellation, whose error cuDNN's
# and the CPU's algorithms bound against the norm of their inputs: at
# resnet18_cifar's card-seeded store the CPU port's own float32
# gradients lie 120 times the strict allowance from a float64
# evaluation (1.1 % of the largest entry; resnet_grad_conditioning.py),
# and ResNet-50's at its init are ill-conditioned (PERF.md section 6)
GRADS_HELD = {"resnet18_cifar": "max", "vit_tiny_cifar": "strict",
              "resnet50_imagenet": None, "vit_s16_imagenet": "max"}


def sgd_at_resnet18(torch, fu, gen) -> dict:
    """The SGD kernel at the resnet18_cifar store (62 f32 tensors,
    11,173,962 elements, most of them 64- to 512-element norm vectors)
    against ``fu.sgd_reference`` bit for bit, in the planner's launches,
    then timed beside the plain version, the bound (12 bytes and 2
    operations an element) and torch.optim's fused SGD over the same
    tensors.  Returns the kernels line's entry for that store."""
    from parameter_server_distributed_tpu_torch.models.resnet import \
        resnet18

    shapes = resnet18().param_shapes()
    n = sum(math.prod(s) for s in shapes.values())
    p, g = llama_store(torch, shapes, gen), llama_store(torch, shapes, gen)
    names = list(p)
    expected = update_launches(fu, shapes)
    fu.reset_launches()
    with torch.inference_mode():
        out = fu.fused_sgd(p, g, 0.05)
        ref = {x: fu.sgd_reference(p[x], g[x], 0.05) for x in names}
        torch.cuda.synchronize()
    launched = fu.launches["fused_sgd"]
    exact = all(bool(torch.equal(out[x], ref[x])) for x in names)
    err = max(float((out[x] - ref[x]).abs().max()) for x in names)
    del out, ref

    def kernel():
        return fu.fused_sgd(p, g, 1e-3)

    def plain():
        return [fu.sgd_reference(p[x], g[x], 1e-3) for x in names]

    with torch.inference_mode():
        runs = [cuda_ms(torch, kernel, iters=20)]
        plain_ms = cuda_ms(torch, plain, iters=5)
        runs.append(cuda_ms(torch, kernel, iters=20))
        kernel_dev = device_profile(torch, kernel)
    params = [torch.nn.Parameter(p[x].clone()) for x in names]
    for param, x in zip(params, names):
        param.grad = g[x]
    opt = torch.optim.SGD(params, lr=1e-3, fused=True)
    library = cuda_ms(torch, opt.step, iters=20)
    del opt, params
    bound_ms, bound_by = bound(UPDATE_FLOPS["sgd"] * n,
                               UPDATE_BYTES["sgd"] * n, "float32")
    entry = {"tensors": len(names), "elements": n,
             "launches_per_apply": launched, "max_abs_err": err,
             "bit_exact": exact, "ms": min(runs), "ms_runs": runs,
             "device_ms": kernel_dev["ms"], "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": library,
             "library": "torch.optim.SGD(fused=True)"}
    emit({"phase": "fused_sgd_resnet18_store", **entry})
    if not exact:
        fail(f"fused_sgd at the resnet18_cifar store is not bit-equal to "
             f"sgd_reference: max abs err {err}")
    if launched != expected:
        fail(f"fused_sgd took {launched} launches over the resnet18_cifar "
             f"store, not the planner's {expected}")
    del p, g
    torch.cuda.empty_cache()
    return entry


def _grads_agree(np, got: dict, want: dict, by_max: bool
                 ) -> tuple[bool, dict]:
    """Whether the card's gradients ``got`` match the CPU's ``want``:
    within rtol 5e-4, atol 1e-5 a entry (the reference's gradient
    tolerance), or with ``by_max`` within 2^-5 of each gradient's largest
    entry.  Also the three largest errors over their allowance."""
    ratio = {}
    for name, ref in want.items():
        diff = np.abs(got[name] - ref)
        allowed = (2.0 ** -5 * float(np.abs(ref).max()) if by_max
                   else 1e-5 + 5e-4 * np.abs(ref))
        ratio[name] = float(np.max(diff / np.maximum(allowed, 1e-30)))
    worst = dict(sorted(ratio.items(), key=lambda kv: -kv[1])[:3])
    return (all(r <= 1.0 for r in ratio.values())
            and len(got) == len(want)), worst


def image_rows(torch, np) -> dict:
    """Each image row of the registry (IMAGE_ROWS) on the card: its model
    at full width from get_model_and_batches, one batch of its synthetic
    stream (the CIFAR rows share theirs, the ImageNet rows theirs), a
    Trainer step from a seeded store twice (the first holds cuDNN's
    set-up), the losses and gradients finite; then the same model and
    store on a CHECK_IMAGES-image slice of the batch, on the card against
    the port on the CPU (TF32 off): the loss within rtol 5e-4 (bf16 rows
    1e-2) and the gradients as GRADS_HELD says, which catches padding or
    layout faults that only cuDNN's algorithms would show.  ResNet-50's
    gradients at its init are ill-conditioned (two float32 evaluations on
    the CPU that differ only in their thread count part by 18 % of a
    gradient's largest entry), so for resnet50_imagenet the comparison
    holds its bf16 loss and its float32 logits (the same store: within
    5e-4 of the largest logit, 1e-5 at least), and reports the
    gradients' distance beside the CPU's own spread over thread counts.
    Reports each row's step time, images/s and peak card memory."""
    import dataclasses

    from parameter_server_distributed_tpu_torch.models.convert import \
        params_from_numpy
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    out, faults, first = {}, [], {}
    for name, batch in IMAGE_ROWS.items():
        model, batches = get_model_and_batches(name, batch, seed=0)
        key = "imagenet" if "imagenet" in name else "cifar"
        data_s = 0.0
        if key not in first:
            t0 = time.perf_counter()
            first[key] = next(batches)
            data_s = time.perf_counter() - t0
        x, y = first[key]
        del batches
        trainer = Trainer(model)
        store = trainer.init_params(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps, losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            grads, loss = trainer.compute_gradients(store, (x, y))
            steps.append(time.perf_counter() - t0)
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = all(math.isfinite(v) for v in losses) and all(
            bool(np.isfinite(g).all()) for g in grads.values())
        del grads
        bf16 = model.config.dtype == torch.bfloat16
        xs, ys = x[:CHECK_IMAGES], y[:CHECK_IMAGES]
        card, card_loss = trainer.compute_gradients(store, (xs, ys))
        t0 = time.perf_counter()
        cpu, cpu_loss = Trainer(model, device="cpu").compute_gradients(
            store, (xs.cpu(), ys.cpu()))
        cpu_s = time.perf_counter() - t0
        held = GRADS_HELD[name]
        agree, worst = _grads_agree(np, card, cpu, held != "strict")
        strict = (_grads_agree(np, card, cpu, False)[1]
                  if held != "strict" else worst)
        loss_ok = abs(card_loss - cpu_loss) <= (1e-2 if bf16 else 5e-4) \
            * abs(cpu_loss)
        row = {
            "dtype": str(model.config.dtype).replace("torch.", ""),
            "params": model.num_params(), "tensors": len(store),
            "batch": batch, "image": list(x.shape[1:]),
            "data_s": data_s, "step_s": steps,
            "images_per_s": batch / steps[-1], "peak_mem_gb": peak,
            "losses": losses, "check_images": CHECK_IMAGES,
            "card_loss": card_loss, "cpu_loss": cpu_loss, "cpu_s": cpu_s,
            "grads_held": {"strict": "rtol 5e-4, atol 1e-5",
                           "max": "2^-5 of each gradient's largest entry",
                           None: "reported, not held"}[held],
            "worst_over_allowance": worst,
            "worst_over_strict_allowance": strict}
        if name == "resnet50_imagenet":
            # the CPU against itself at one thread: the gradients' spread
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                cpu1, _ = Trainer(model, device="cpu").compute_gradients(
                    store, (xs.cpu(), ys.cpu()))
            finally:
                torch.set_num_threads(threads)
            row["cpu_threads_1_vs_n"] = _grads_agree(np, cpu1, cpu, True)[1]
            f32 = type(model).from_config(dataclasses.replace(
                model.config, dtype=torch.float32))
            with torch.no_grad():
                logits = {dev: f32.apply(params_from_numpy(
                    store, f32.config, device=dev), xs.to(dev)).cpu()
                    for dev in ("cuda", "cpu")}
            # within 5e-4 of the largest logit, 1e-5 at least
            err = float((logits["cuda"] - logits["cpu"]).abs().max())
            top = float(logits["cpu"].abs().max())
            logits_ok = err <= 1e-5 + 5e-4 * top
            row["f32_logits"] = {"max_abs_err": err, "max_abs": top}
            row["agree"] = loss_ok and logits_ok
        else:
            row["agree"] = agree and loss_ok
        out[name] = row
        if not finite:
            faults.append(f"{name}: a loss or gradient is not finite")
        if not row["agree"]:
            faults.append(f"{name}: card against CPU: losses {card_loss} "
                          f"{cpu_loss}, worst {worst}")
        del trainer, store, card, cpu, model
        torch.cuda.empty_cache()
    emit({"phase": "image_rows", "rows": out,
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    if faults:
        fail(f"image_rows: {faults}")
    return out


def write_cifar_npz(np, path: str) -> None:
    """The synthetic CIFAR stand-in that resnet18_cifar's stream samples
    at batch 256 (the class-cluster set of dataset seed 0, 4096 NHWC
    images), as the npz of x and y that ``--data`` reads."""
    from parameter_server_distributed_tpu_torch.data.synthetic import \
        synthetic_cifar10

    ds = synthetic_cifar10(num_examples=4096, seed=0)
    np.savez(path, x=ds.x.reshape(-1, 32, 32, 3), y=ds.y)


def config2_wire(np, workers: int = CONFIG2["workers"],
                 batch: int = CONFIG2["batch"],
                 rounds: int = CONFIG2["rounds"],
                 device_args: tuple = ()) -> dict:
    """BASELINE config 2 as the reference runs it: cli.ps_main (``workers``
    workers, its default optimizer pallas_sgd, --staleness=4, lr
    CONFIG2["lr"]), cli.coordinator_main and ``workers``
    cli.worker_main processes (resnet18_cifar, batch 256, the
    shared-memory rings and the native codec), all on the card; the last
    worker reads --data=<an npz of the synthetic CIFAR stand-in>.  Each
    worker runs a bootstrap iteration (the first seeds the PS, the others'
    pushes are its duplicates) and ``rounds`` gradient iterations, each
    ending in one applied push (a push refused as stale fast-forwards the
    worker, which pushes again).  Holds: every child exits 0, each
    worker's loss falls, the PS applied ``workers * rounds`` updates with
    one fused_sgd launch each (as ops.fused_update.plan gives for the
    store), no host-rule fallback, every process on the rings and the
    native codec, no segment left.  Prints the pushes refused as stale
    (each worker's log), the aggregate grad-samples/s, a round's p50
    split (step, data, compute, fused push + serve round; the PS's apply
    and serve) and each worker's peak card memory.  ``device_args``
    (e.g. ("--device=cpu",)) goes to the PS and the workers.  Returns the
    launch counts summed over the processes."""
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.models.resnet import \
        resnet18
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    lr, staleness = CONFIG2["lr"], CONFIG2["staleness"]
    # a CPU rehearsal's children launch no kernel
    per_apply = update_launches(fu, resnet18().param_shapes()) \
        if not device_args else 0
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="config2-", dir=os.path.join(HERE, "build"))
    try:
        npz = os.path.join(tmp, "cifar.npz")
        write_cifar_npz(np, npz)
        env = child_env(tmp)
        t0 = time.perf_counter()
        wall, ps_pid = _run_round(
            _spawner(tmp, env),
            [str(workers), "10", f"--staleness={staleness}", f"--lr={lr}",
             f"--ckpt-dir={tmp}/ck", f"--report={tmp}/ps.json",
             *device_args],
            [[str(w), str(rounds + 1), "--model=resnet18_cifar",
              f"--batch={batch}", f"--report={tmp}/worker-{w}.json",
              *device_args,
              *([f"--data={npz}"] if w == workers - 1 else [])]
             for w in range(workers)], CONFIG2_LIMIT_S)
        phase_s = time.perf_counter() - t0
        reports, records, stale = {}, {}, {}
        with open(os.path.join(tmp, "ps.json")) as f:
            reports["ps"] = json.load(f)
        for w in range(workers):
            with open(os.path.join(tmp, f"worker-{w}.json")) as f:
                reports[f"worker {w}"] = json.load(f)
            with open(os.path.join(tmp, f"metrics-{w}.jsonl")) as f:
                records[w] = [json.loads(line) for line in f]
            # the worker logs are the spawner's, named by their order
            log = os.path.join(tmp, f"worker_main-{w + 2}.log")
            with open(log) as f:
                stale[w] = f.read().count("fast-forwarding")
        left = shm_left(ps_pid)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    faults = transport_faults(reports, shm=True, native=True)
    if left:
        faults.append(f"segments left: {left}")
    ps = reports["ps"]
    applied = ps.get("applied_updates")
    expected_ps = {**{name: 0 for name in ps["launches"]},
                   "fused_sgd": per_apply * workers * rounds}
    if applied != workers * rounds:
        faults.append(f"PS applied {applied} updates, not "
                      f"{workers * rounds}")
    if ps["launches"] != expected_ps:
        faults.append(f"PS launches {ps['launches']} != {expected_ps}")
    if ps["launches"].get("fused_sgd") != per_apply * (applied or 0):
        faults.append("PS fused_sgd launches differ from its applied "
                      "pushes")
    if ps.get("optimizer") != "PallasOptimizer" or \
            ps["counters"].get("ps.apply.device_fallback") != 0:
        faults.append(f"PS optimizer {ps.get('optimizer')}, fallbacks "
                      f"{ps['counters'].get('ps.apply.device_fallback')}")
    losses, per_worker = {}, {}
    for w in range(workers):
        r = reports[f"worker {w}"]
        if any(r["launches"].values()):
            faults.append(f"worker {w} launches {r['launches']}")
        if r["counters"].get("rpc.shm.bytes", 0) <= 0:
            faults.append(f"worker {w} moved no ring bytes")
        grads = [rec for rec in records[w] if not rec.get("bootstrap")
                 and math.isfinite(rec.get("loss", float("nan")))]
        losses[w] = [rec["loss"] for rec in grads]
        if len(losses[w]) < rounds - 1 or losses[w][-1] >= losses[w][0]:
            faults.append(f"worker {w} losses not falling: {losses[w]}")
        per_worker[w] = {"peak_mem_gb": r["peak_mem_bytes"] / 1e9,
                         "stale_refusals": stale[w],
                         "gradient_iterations": len(losses[w]),
                         "data": "npz" if w == workers - 1 else "synthetic"}
    steady = [rec for w in range(workers) for rec in records[w]
              if not rec.get("bootstrap") and rec["step"] >= 2]

    def p50(key):
        vals = [rec[key] for rec in steady if key in rec]
        return float(np.median(vals)) if vals else None

    # gradient iterations of all workers over the wall time between the
    # first worker's first gradient iteration and the last worker's end
    starts = [rec["t"] - rec["step_time_s"] for w in range(workers)
              for rec in records[w] if not rec.get("bootstrap")]
    ends = [rec["t"] for w in range(workers) for rec in records[w]]
    span = max(ends) - min(starts)
    samples = batch * sum(len(v) for v in losses.values())
    hist = ps["histograms"]
    out = {"phase": "config2_wire", "model": "resnet18_cifar",
           "batch": batch, "workers": workers, "rounds": rounds,
           "staleness": staleness, "lr": lr,
           "optimizer": "pallas_sgd (ps_main default)",
           "wall_s": wall, "phase_s": phase_s,
           "applied_updates": applied,
           "stale_refusals": sum(stale.values()),
           "fused_sgd_per_apply": per_apply,
           "grad_samples_per_s": samples / span, "train_span_s": span,
           "round_p50_s": {"step": p50("step_time_s"), "data": p50("data_s"),
                           "compute": p50("compute_s"),
                           "fused_push_serve": p50("fused_s"),
                           "pull": p50("pull_s")},
           "ps_apply_s": hist.get("ps.apply_s"),
           "ps_serve_s": hist.get("ps.serve_s"),
           "ps_serve_encode_s": hist.get("ps.serve.encode_s"),
           "losses": losses, "workers_detail": per_worker,
           "peak_mem_gb": {k: r["peak_mem_bytes"] / 1e9
                           for k, r in reports.items()},
           "launches": {k: {n: v for n, v in r["launches"].items() if v}
                        for k, r in reports.items()},
           "expected_ps_launches": {k: v for k, v in expected_ps.items()
                                    if v}}
    emit(out)
    if faults:
        fail(f"config2_wire: {faults}")
    launches = dict.fromkeys(list(fu.launches) + list(da.launches)
                             + list(i8.launches), 0)
    for r in reports.values():
        for name, v in r["launches"].items():
            launches[name] = launches.get(name, 0) + v
    return launches


# BASELINE config 3 ("4 PS shards / 8 workers, 1B MLP sharded push/pull",
# BASELINE.md:33) as the reference runs it: four cli.ps_main shards behind
# cli.coordinator_main --ps-shards, mlp_1b workers at batch 2048 with bf16
# on the wire, the synchronous barrier; a bootstrap, then ``rounds``
# gradient rounds.  Each batch is fresh random data (registry
# _mlp_1b_batches), so the loss falls only as SGD shrinks the init's
# logits: at lr 2^-7 by 0.03-0.05 in two steps on the card, within a
# batch's noise; 2^-4 (PERF.md §4).  ``workers``: what one card holds of
# BASELINE's 8 (config3_probe.py; PERF.md §4); ``threads``: torch's
# intra-op threads a process (the processes share the host's 8 cores)
CONFIG3 = dict(shards=4, workers=2, batch=2048, rounds=3, lr=2.0 ** -4,
               threads=2)
CONFIG3_WORKERS_SET_BY = (
    "the card: one wire worker takes 21.7 GB (allocator peak) and 23.6 GB "
    "of the card with its share of contexts and caches, the four shards "
    "23.9 GB, so 2 workers fit in 90 % of the card's 85.5 GB and 3 do "
    "not; the host's memory would hold 3 (config3_probe.py)")
CONFIG3_LIMIT_S = 420.0   # the big leg's wall-clock limit, children included


def read_reports(tmp: str, names: dict) -> dict:
    """role -> the exit report ``tmp/<file>`` for each (role, file)."""
    out = {}
    for role, name in names.items():
        with open(os.path.join(tmp, name)) as f:
            out[role] = json.load(f)
    return out


def config3_wire(np, reference_ckpts: list, workers: int = CONFIG3["workers"],
                 batch: int = CONFIG3["batch"],
                 rounds: int = CONFIG3["rounds"], model: str = "mlp_1b",
                 device_args: tuple = ()) -> dict:
    """BASELINE config 3: the big leg (``config3_big``) and the exact leg
    (``config3_exact``, against ``reference_ckpts``) at once: the exact
    leg's tiny processes are done while the big leg's start up and
    bootstrap, before its rounds.  Returns the launch counts summed over
    both legs' processes."""
    legs = in_parallel({
        "big": lambda: config3_big(np, workers, batch, rounds, model,
                                   device_args),
        "exact": lambda: config3_exact(np, reference_ckpts, device_args)})
    launches = dict(legs["big"][0])
    for name, v in legs["exact"].items():
        launches[name] = launches.get(name, 0) + v
    return launches


class MemorySampler:
    """While its block runs, a thread reads every ``period_s`` the card
    memory in use by every process (nvidia-smi's memory.used), the
    host's available memory (/proc/meminfo MemAvailable) and the resident
    memory (VmRSS) of each process ``pids()`` lists; ``peaks()`` gives the
    most card memory used, the least host memory available and each
    process's largest RSS seen, in GB, with the card's total.  A sampled
    RSS is the host peak of a child where the kernel keeps no VmHWM (the
    exit report's fallback, ru_maxrss, carries the parent's size)."""

    def __init__(self, period_s: float = 0.5, pids=lambda: ()):
        self.period_s = period_s
        self.pids = pids
        self.card_used_mib: list[int] = []
        self.card_total_mib = 0
        self.host_avail_kib: list[int] = []
        self.rss_kib: dict[int, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used,memory.total",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=10).stdout.split("\n")[0].split(",")
            self.card_used_mib.append(int(out[0]))
            self.card_total_mib = int(out[1])
        except (OSError, ValueError, IndexError,
                subprocess.TimeoutExpired):
            pass
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        self.host_avail_kib.append(int(line.split()[1]))
        except OSError:
            pass
        for pid in list(self.pids()):
            try:
                with open(f"/proc/{pid}/status") as f:
                    for line in f:
                        if line.startswith("VmRSS:"):
                            self.rss_kib[pid] = max(self.rss_kib.get(pid, 0),
                                                    int(line.split()[1]))
            except (OSError, ValueError):
                pass   # not started yet, or gone

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self._sample()

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)

    def peaks(self) -> dict:
        return {"card_used_gb_max": max(self.card_used_mib, default=0)
                * 2 ** 20 / 1e9,
                "card_used_gb_at_start": (self.card_used_mib or [0])[0]
                * 2 ** 20 / 1e9,
                "card_total_gb": self.card_total_mib * 2 ** 20 / 1e9,
                "host_available_gb_min": min(self.host_avail_kib, default=0)
                * 1024 / 1e9,
                "host_available_gb_at_start": (self.host_avail_kib or [0])[0]
                * 1024 / 1e9,
                "rss_gb_max_by_pid": {pid: kib * 1024 / 1e9
                                      for pid, kib in self.rss_kib.items()},
                "samples": len(self.card_used_mib)}


def config3_big(np, workers: int, batch: int, rounds: int, model: str,
                device_args: tuple = ()) -> tuple[dict, dict]:
    """BASELINE config 3 as the reference runs it, every process a port
    CLI on the card: CONFIG3["shards"] cli.ps_main shards (``workers``
    workers each, their default optimizer pallas_sgd, lr CONFIG3["lr"],
    a checkpoint directory each), cli.coordinator_main --ps-shards, and
    ``workers`` cli.worker_main processes (mlp_1b, batch 2048, bf16 on
    the wire, the default barrier, the rings and the native codec), each
    a bootstrap and ``rounds`` gradient rounds; torch at
    CONFIG3["threads"] intra-op threads a process.  The store splits as
    ``shard_owner`` places it, unevenly: for mlp_1b shard 1 holds twice
    the others' elements.

    Held: each shard's exit store holds exactly the names shard_owner
    gives it and their union is the model; every worker's pull after the
    bootstrap is whole (no reseed, no partial pull); each shard launches
    fused_sgd once per applied round (as ops.fused_update.plan gives for
    its partition) and nothing else runs a kernel; no process falls back
    to gRPC or resolves the Python codec, each worker moves at least 2 B
    a parameter each way each round through the rings and each shard 2 B
    a parameter of its partition each way each round a worker, and no
    segment is left; every worker's loss after its last round is below
    its first; every child exits 0.  Prints per round the slowest
    worker's times, per shard its apply, serve and barrier-close times
    and its ring rate, grad-samples/s, peak card memory and host RSS a
    process, the card memory in use and the host memory available at
    their extremes (``MemorySampler``), the worker count and what set
    it.  ``device_args`` (e.g. ("--device=cpu",)) goes to every PS and
    worker.  Returns the launch counts summed over the processes and the
    printed line."""
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8
    from parameter_server_distributed_tpu_torch.worker.ps_shards import \
        shard_owner

    n, lr = CONFIG3["shards"], CONFIG3["lr"]
    shapes = {k: tuple(v) for k, v in get_model(model).param_shapes().items()}
    parts = [{k: v for k, v in shapes.items() if shard_owner(k, n) == i}
             for i in range(n)]
    elements = [sum(math.prod(v) for v in part.values()) for part in parts]
    total = sum(elements)
    # a CPU rehearsal's children launch no kernel
    per_apply = [update_launches(fu, part) if part and not device_args
                 else 0 for part in parts]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="config3-", dir=os.path.join(HERE, "build"))
    try:
        env = child_env(tmp, OMP_NUM_THREADS=str(CONFIG3["threads"]))
        spawn = _spawner(tmp, env)
        t0 = time.perf_counter()
        with MemorySampler(pids=lambda: [p.pid for p in spawn.procs]
                           ) as memory:
            wall, pids = _run_cluster(
                spawn,
                [[str(workers), "1000", f"--lr={lr}",
                  f"--ckpt-dir={tmp}/ck{i}", f"--report={tmp}/ps-{i}.json",
                  *device_args] for i in range(n)],
                [[str(w), str(rounds + 1), f"--model={model}",
                  f"--batch={batch}", "--wire=bf16",
                  f"--report={tmp}/worker-{w}.json", *device_args]
                 for w in range(workers)], CONFIG3_LIMIT_S)
        phase_s = time.perf_counter() - t0
        reports = read_reports(tmp, {
            **{f"shard {i}": f"ps-{i}.json" for i in range(n)},
            **{f"worker {w}": f"worker-{w}.json" for w in range(workers)}})
        records, reseeds = {}, {}
        for w in range(workers):
            with open(os.path.join(tmp, f"metrics-{w}.jsonl")) as f:
                records[w] = [json.loads(line) for line in f]
            # the spawner names logs by start order: the shards, the
            # coordinator, then the workers
            with open(os.path.join(tmp, f"worker_main-{n + 1 + w}.log")) as f:
                text = f.read()
            reseeds[w] = text.count("re-seeding") + text.count("re-pulling")
        left = [seg for pid in pids for seg in shm_left(pid)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    faults = transport_faults(reports, shm=True, native=True)
    if left:
        faults.append(f"segments left: {left}")
    stores = [reports[f"shard {i}"].get("store") or {} for i in range(n)]
    placed = [{k: tuple(v) for k, v in st.items()} for st in stores]
    if placed != parts:
        faults.append(f"shard stores {[sorted(p) for p in placed]} are not "
                      f"shard_owner's {[sorted(p) for p in parts]}")
    merged = {k: v for p in placed for k, v in p.items()}
    if merged != shapes:
        faults.append("the shards' union is not the model")
    launches = dict.fromkeys(list(fu.launches) + list(da.launches)
                             + list(i8.launches), 0)
    for i in range(n):
        got = reports[f"shard {i}"]["launches"]
        want = {**dict.fromkeys(got, 0), "fused_sgd": per_apply[i] * rounds}
        if got != want:
            faults.append(f"shard {i} launches {got} != {want}")
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
    per_round_floor = 2 * 2 * total          # 2 B a parameter each way
    shard_floor = [2 * 2 * e * workers * rounds for e in elements]
    ring = {role: r["counters"].get("rpc.shm.bytes", 0)
            for role, r in reports.items()}
    losses, peak = {}, {}
    for w in range(workers):
        r = reports[f"worker {w}"]
        if any(r["launches"].values()):
            faults.append(f"worker {w} launches {r['launches']}")
        if ring[f"worker {w}"] < per_round_floor * rounds:
            faults.append(f"worker {w} moved {ring[f'worker {w}']} ring "
                          f"bytes, under {per_round_floor * rounds}")
        boot = [rec["step"] for rec in records[w] if rec.get("bootstrap")]
        if boot != [0] or reseeds[w]:
            faults.append(f"worker {w}: bootstraps at {boot}, {reseeds[w]} "
                          f"reseed or partial-pull lines")
        losses[w] = [rec["loss"] for rec in records[w]
                     if not rec.get("bootstrap")]
        if len(losses[w]) != rounds or not all(
                math.isfinite(x) for x in losses[w]) or \
                losses[w][-1] >= losses[w][0]:
            faults.append(f"worker {w} losses not finite and falling: "
                          f"{losses[w]}")
    for i in range(n):
        if ring[f"shard {i}"] < shard_floor[i]:
            faults.append(f"shard {i} moved {ring[f'shard {i}']} ring bytes, "
                          f"under {shard_floor[i]}")
    peaks = memory.peaks()
    rss = peaks.pop("rss_gb_max_by_pid")
    # per round, the slowest worker's times; the rounds' span
    by_round = {}
    for it in range(1, rounds + 1):
        recs = [rec for w in range(workers) for rec in records[w]
                if rec["step"] == it]
        by_round[it] = {key: max(rec.get(key, 0.0) for rec in recs)
                        for key in ("step_time_s", "compute_s", "fused_s",
                                    "pull_s")}
    starts = [rec["t"] - rec["step_time_s"] for w in range(workers)
              for rec in records[w] if not rec.get("bootstrap")]
    ends = [rec["t"] for w in range(workers) for rec in records[w]]
    span = max(ends) - min(starts)
    fused_span = sum(v["fused_s"] for v in by_round.values())
    out = {"phase": "config3_wire", "leg": model, "card": nvidia_smi(),
           "model": model, "params": total, "shards": n,
           "partition_elements": elements,
           "partition_names": [sorted(p) for p in parts],
           "workers": workers, "workers_set_by": CONFIG3_WORKERS_SET_BY,
           "batch": batch, "rounds": rounds, "lr": lr, "wire": "bf16",
           "optimizer": "pallas_sgd (ps_main default)",
           "torch_threads": CONFIG3["threads"], "wall_s": wall,
           "phase_s": phase_s, "per_round_slowest_worker": by_round,
           "grad_samples_per_s": workers * batch * rounds / span,
           "train_span_s": span,
           "shards_detail": {i: {
               "elements": elements[i],
               "apply_s": reports[f"shard {i}"]["histograms"].get(
                   "ps.apply_s"),
               "serve_s": reports[f"shard {i}"]["histograms"].get(
                   "ps.serve_s"),
               "serve_encode_s": reports[f"shard {i}"]["histograms"].get(
                   "ps.serve.encode_s"),
               "barrier_close_s": reports[f"shard {i}"]["histograms"].get(
                   "ps.barrier_close_s"),
               "ring_bytes": ring[f"shard {i}"],
               "ring_gb_per_fused_s": ring[f"shard {i}"] / 1e9 / fused_span
               if fused_span else None} for i in range(n)},
           "ring_bytes": ring, "ring_floor_per_worker":
               per_round_floor * rounds, "ring_floor_per_shard": shard_floor,
           "losses": losses,
           "peak_mem_gb": {k: r["peak_mem_bytes"] / 1e9
                           for k, r in reports.items()},
           "peak_rss_gb": {k: r["peak_rss_bytes"] / 1e9
                           for k, r in reports.items()},
           "peak_rss_source": {k: r.get("peak_rss_source")
                               for k, r in reports.items()},
           # the spawner's order: the shards, the coordinator, the workers
           "peak_rss_sampled_gb": dict(zip(
               [f"shard {i}" for i in range(n)] + ["coordinator"]
               + [f"worker {w}" for w in range(workers)],
               [rss.get(p.pid) for p in spawn.procs])),
           "memory_sampled": peaks,
           "shm_fallback": {k: r["counters"].get("rpc.shm.fallback")
                            for k, r in reports.items()},
           "codec_native": {k: r["gauges"].get("rpc.codec.native")
                            for k, r in reports.items()},
           "launches": {k: {name: v for name, v in r["launches"].items()
                            if v} for k, r in reports.items()},
           "segments_left": left}
    emit(out)
    if faults:
        fail(f"config3_wire: {faults}")
    return launches, out


def config3_exact(np, reference_ckpts: list, device_args: tuple = ()
                  ) -> dict:
    """config3_wire's exact leg: one mnist_mlp worker over
    CONFIG3["shards"] cli.ps_main shards at config1_wire's settings
    (batch 256, bf16 on the wire, pallas_sgd at CONFIG1["lr"], seed 0, a
    checkpoint every iteration, CONFIG1["rounds"] rounds), where
    shard_owner leaves shards 0 and 3 nothing.  A one-worker fold has no
    order to vary, so every epoch's four checkpoints, merged, must hold
    tensor for tensor the bytes of ``reference_ckpts`` (config1_wire leg
    a's single-PS files); each shard launches fused_sgd once per apply
    of a partition that is not empty; the rings and the native codec
    everywhere, no segment left, the loss falling.  Returns the launch
    counts summed over the processes."""
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.checkpoint import codec
    from parameter_server_distributed_tpu_torch.models.mlp import mnist_mlp
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu
    from parameter_server_distributed_tpu_torch.worker.ps_shards import \
        shard_owner

    n, b, rounds, lr = (CONFIG3["shards"], CONFIG1["batch"],
                        CONFIG1["rounds"], CONFIG1["lr"])
    shapes = mnist_mlp().param_shapes()
    parts = [{k: v for k, v in shapes.items() if shard_owner(k, n) == i}
             for i in range(n)]
    per_apply = [update_launches(fu, part) if part and not device_args
                 else 0 for part in parts]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="config3-exact-",
                           dir=os.path.join(HERE, "build"))
    try:
        wall, pids = _run_cluster(
            _spawner(tmp, child_env(tmp)),
            [["1", "1", f"--lr={lr}", f"--ckpt-dir={tmp}/ck{i}",
              f"--report={tmp}/ps-{i}.json", *device_args]
             for i in range(n)],
            [["0", str(rounds + 1), "--model=mnist_mlp", f"--batch={b}",
              "--wire=bf16", f"--report={tmp}/worker-0.json", *device_args]],
            CONFIG1_LIMIT_S)
        reports = read_reports(tmp, {
            **{f"shard {i}": f"ps-{i}.json" for i in range(n)},
            "worker 0": "worker-0.json"})
        with open(os.path.join(tmp, "metrics-0.jsonl")) as f:
            records = [json.loads(line) for line in f]
        epochs = []
        for e in range(rounds + 1):
            merged, headers = {}, set()
            for i in range(n):
                epoch, iteration, store = codec.load(os.path.join(
                    tmp, f"ck{i}", f"checkpoint_epoch_{e}.ckpt"))
                headers.add((epoch, iteration))
                merged.update(store)
            epochs.append((headers, merged))
        left = [seg for pid in pids for seg in shm_left(pid)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    faults = transport_faults(reports, shm=True, native=True)
    if left:
        faults.append(f"segments left: {left}")
    if reports["worker 0"]["counters"].get("rpc.shm.bytes", 0) <= 0:
        faults.append("worker 0 moved no ring bytes")
    launches: dict = {}
    for i in range(n):
        got = reports[f"shard {i}"]["launches"]
        want = {**dict.fromkeys(got, 0), "fused_sgd": per_apply[i] * rounds}
        if got != want:
            faults.append(f"shard {i} launches {got} != {want}")
        if sorted(reports[f"shard {i}"].get("store") or {}) != \
                sorted(parts[i]):
            faults.append(f"shard {i} holds "
                          f"{sorted(reports[f'shard {i}'].get('store'))}")
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
    identical, differing = True, {}
    for e, ((headers, merged), ref) in enumerate(zip(epochs,
                                                      reference_ckpts)):
        r_epoch, r_iteration, want = codec.loads(ref)
        bad = sorted(k for k in set(want) | set(merged)
                     if k not in want or k not in merged
                     or merged[k].tobytes() != want[k].tobytes())
        if bad or headers != {(r_epoch, r_iteration)}:
            identical = False
            differing[e] = {"tensors": bad, "headers": sorted(headers)}
    if len(reference_ckpts) != rounds + 1:
        identical = False
    losses = [r["loss"] for r in records if r["step"] >= 1]
    if len(losses) != rounds or not all(math.isfinite(x) for x in losses) \
            or losses[-1] >= losses[0]:
        faults.append(f"losses not finite and falling: {losses}")
    emit({"phase": "config3_wire", "leg": "mnist_mlp_exact", "shards": n,
          "partition_names": [sorted(p) for p in parts], "batch": b,
          "rounds": rounds, "lr": lr, "wall_s": wall, "losses": losses,
          "checkpoints_identical_to_config1_leg_a": identical,
          "differing": differing,
          "launches": {k: {name: v for name, v in r["launches"].items()
                           if v} for k, r in reports.items()},
          "segments_left": left})
    if faults:
        fail(f"config3_wire exact leg: {faults}")
    if not identical:
        fail(f"config3_wire: the sharded checkpoints differ from config1 "
             f"leg a's: {differing}")
    return launches


def first_adam_vs_plain(torch, np, fu, before, grads, after,
                        opt) -> dict:
    """The first Adam apply of a store, tensor by tensor: the params and
    both moments the kernel left against the plain version on the same
    inputs (zero moments, step 1), within rtol 1e-5, atol 1e-7.  Names
    the tensors whose chunks the planner split across two launches (the
    kernel continues such a tensor from a negative first block), which
    the comparison covers with the rest."""
    sizes = [p.numel() for p in before.values()]
    tables = [set(t[:, 0].tolist())
              for t in fu.plan(sizes, [True] * len(sizes))]
    split = [n for i, n in enumerate(before)
             if sum(i in t for t in tables) > 1]
    slots = opt.state_snapshot()
    bc = fu.bias_corrections(1, opt.b1, opt.b2)
    worst, ok = {}, True
    with torch.inference_mode():
        for n, p in before.items():
            g = torch.from_numpy(np.require(grads[n], np.float32,
                                            "CW")).cuda()
            m, v = torch.zeros_like(p), torch.zeros_like(p)
            ref = fu.adam_reference(p, g, m, v, opt.learning_rate, opt.b1,
                                    opt.b2, opt.eps, *bc)
            for got, want in ((after[n], ref), (slots[f"m/{n}"], m),
                              (slots[f"v/{n}"], v)):
                worst[n] = max(worst.get(n, 0.0),
                               float((got - want).abs().max()))
                ok = ok and bool(torch.isclose(got, want, rtol=1e-5,
                                               atol=1e-7).all())
            del g, m, v, ref
    del slots
    return {"tensors": len(before), "launches": len(tables),
            "split_across_launches": split, "max_abs_err": worst,
            "rtol": 1e-5, "atol": 1e-7, "ok": ok}


def mlp_train(torch, np, fa, fu) -> dict:
    """The 1.34B-parameter MLP (mlp_1b: 5 layers of 16384 x 16384, bf16
    weights and activations, f32 products) at batch 2048: 3
    Trainer.compute_gradients -> PallasOptimizer("adam").apply steps on
    one batch, params on the card from a seed.  The losses must be finite
    and falling, with one Adam launch per apply (the planner's tables),
    and the first apply's params and moments must match the plain Adam
    update tensor by tensor (first_adam_vs_plain).  Then one more step
    under the profiler.  Reports the step time (median of steps 2-3),
    samples/s, MFU = 6*N*B / (t * 989e12), the peak card memory of the
    steps (the comparison's own memory left out) and the profiled step's
    split.  Returns the path's launch counts."""
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import PallasOptimizer
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    b, steps, lr = MLP_TRAIN["batch"], MLP_TRAIN["steps"], MLP_TRAIN["lr"]
    model, batches = get_model_and_batches("mlp_1b", b, seed=0)
    batch = next(batches)
    trainer = Trainer(model)
    params = {k: v.float() for k, v in model.init_params(0).items()}
    opt = PallasOptimizer("adam", lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fu.reset_launches()
    losses, grad_s, apply_s, peaks = [], [], [], []
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        grads, loss = trainer.compute_gradients(params, batch)
        t1 = time.perf_counter()
        before, params = params, opt.apply(params, grads)
        torch.cuda.synchronize()
        grad_s.append(t1 - t0)
        apply_s.append(time.perf_counter() - t1)
        losses.append(loss)
        if step == 1:
            peaks.append(torch.cuda.max_memory_allocated() / 1e9)
            first = first_adam_vs_plain(torch, np, fu, before, grads, params,
                                        opt)
            torch.cuda.reset_peak_memory_stats()
        del grads, before
    launches = {**fa.launches, **fu.launches}
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    per_apply = update_launches(fu, model.param_shapes())
    expected = {name: 0 for name in launches}
    expected["fused_adam"] = per_apply * steps

    # one more step under the profiler, after the counts are read: where
    # a step's time goes on the card.  A whole trace holds each layer's
    # forward GEMM, its weight-gradient GEMM and, for all but the first,
    # its input-gradient GEMM
    layers = model.num_layers

    def one_step():
        g_, _ = trainer.compute_gradients(params, batch)
        opt.apply(params, g_)

    prof = profile_window(torch, one_step, {
        "gemm": "gemm", "nvjet": "nvjet", "elementwise": "elementwise",
        "reduce": "reduce_kernel", "fused_adam": "update_kernel",
        "dtoh": "Memcpy DtoH", "htod": "Memcpy HtoD"},
        {"fused_adam": per_apply, "gemm": 3 * layers - 1}, fu.launches)
    n = model.num_params()
    step_s = float(np.median([g + a for g, a in zip(grad_s[1:],
                                                    apply_s[1:])]))
    grad_med = float(np.median(grad_s[1:]))
    emit({"phase": "mlp_train", "model": "mlp_1b", "dtype": "bfloat16",
          "params": n, "batch": b, "optimizer": "adam", "lr": lr,
          "losses": losses, "grad_step_s": grad_s, "apply_s": apply_s,
          "step_s_median": step_s, "grad_step_s_median": grad_med,
          "samples_per_s": b / step_s,
          "mfu": 6.0 * n * b / (step_s * PEAK_FLOPS["bfloat16"]),
          "mfu_grad_step": 6.0 * n * b / (grad_med * PEAK_FLOPS["bfloat16"]),
          "peak_mem_gb": max(peaks), "peak_mem_gb_step1_and_later": peaks,
          "first_adam_vs_plain": first, "launches": launches,
          "expected_launches": expected})
    emit({"phase": "mlp_train_profile", **prof})
    if not first["ok"]:
        fail(f"mlp_1b's first Adam apply is off the plain update: "
             f"{first['max_abs_err']}")
    if not all(math.isfinite(x) for x in losses) or not all(
            later < earlier for earlier, later in zip(losses, losses[1:])):
        fail(f"mlp_1b losses not finite and falling: {losses}")
    if launches != expected:
        fail(f"mlp_train launches {launches} != expected {expected}")
    return launches


# ---- slice 19: the MoE transformer and the HF conversion on the card

# moe_350m (parameter_server_distributed_tpu/models/transformer.py:974):
# lm_350m's trunk (24 layers, d_model 1024, 16 heads, d_ff 4096, vocab
# 32000, bf16) with every 2nd FFN routed over 8 experts, top-1
MOE = dict(params=1_072_317_440, tensors=207, moe_layers=12, rounds=2,
           capacity=1280)
# GPT-2 small's shape: the public "gpt2" configuration of the Hugging
# Face hub (its config.json)
GPT2 = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
            n_head=12, activation_function="gelu_new",
            layer_norm_epsilon=1e-5, n_inner=None)
# every padded bucket (256, 512, 1024) divides by 128 and stays within
# the 1024 positions with NEW_TOKENS more
HF_PROMPT_LENS = (129, 300, 700, 992)
# llama_350m's transformers configuration (the shape from_hf_llama maps
# onto llama_350m's architecture)
LLAMA_HF = dict(vocab_size=32000, hidden_size=1024, num_attention_heads=16,
                num_key_value_heads=4, num_hidden_layers=24,
                intermediate_size=2816, max_position_embeddings=1024,
                rope_theta=10000.0, rms_norm_eps=1e-6, hidden_act="silu",
                rope_scaling=None, attention_bias=False)


class RouteTap:
    """Wraps a model's MoE router: records every routing it makes (card
    tensors, no sync).  With ``replay`` set to another forward's records
    it hands back their experts, queue places and keeps in order, the
    gates taken from this forward's own probabilities, so two forwards
    that differ in their attention alone route alike; ``changed`` counts
    the assignments each replayed route overrode."""

    def __init__(self, model, replay=None):
        self.layer = model._moe
        self.route = model._moe.route
        self.replay = replay
        self.seen, self.changed = [], []
        model._moe.route = self

    def __call__(self, router_w, tokens, cap):
        r = self.route(router_w, tokens, cap)
        if self.replay is not None:
            want = self.replay[len(self.seen)]
            self.changed.append(r.top_idx.ne(want.top_idx).sum())
            gates = r.probs.gather(1, want.top_idx)
            if gates.shape[1] > 1:
                gates = gates / gates.sum(dim=-1, keepdim=True)
            r = dataclasses.replace(r, top_idx=want.top_idx, gates=gates,
                                    position=want.position, keep=want.keep)
        self.seen.append(r)
        return r

    def close(self) -> None:
        del self.layer.route       # the class's method again

    def dropped(self) -> list:
        """Each recorded route's dropped assignments and their count."""
        return [[int((~r.keep).sum()), r.keep.numel()] for r in self.seen]


class StandIn:
    """What models/hf.py reads of a transformers model: ``.config`` and
    ``.state_dict()`` (the card has no transformers)."""

    def __init__(self, config: dict, state: dict):
        import types
        self.config = types.SimpleNamespace(**config)
        self._state = state

    def state_dict(self) -> dict:
        return self._state


def gpt2_state(np, seed: int = 0) -> dict:
    """A GPT-2 small state dict under the Hugging Face names, float32
    numpy from ``seed``: N(0, 0.02) weights (the residual projections
    over sqrt(2 L), as GPT-2 initialises them), norm scales 1 + N(0,
    0.02), N(0, 0.02) biases (zero in GPT-2's init: nonzero here so the
    bias path carries values)."""
    rng = np.random.default_rng(seed)
    d, layers = GPT2["n_embd"], GPT2["n_layer"]
    out_scale = 1.0 / math.sqrt(2 * layers)

    def w(*shape, scale=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            0.02 * scale)

    sd = {"transformer.wte.weight": w(GPT2["vocab_size"], d),
          "transformer.wpe.weight": w(GPT2["n_positions"], d),
          "transformer.ln_f.weight": 1 + w(d), "transformer.ln_f.bias": w(d)}
    for i in range(layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": 1 + w(d), p + "ln_1.bias": w(d),
                   p + "attn.c_attn.weight": w(d, 3 * d),
                   p + "attn.c_attn.bias": w(3 * d),
                   p + "attn.c_proj.weight": w(d, d, scale=out_scale),
                   p + "attn.c_proj.bias": w(d),
                   p + "ln_2.weight": 1 + w(d), p + "ln_2.bias": w(d),
                   p + "mlp.c_fc.weight": w(d, 4 * d),
                   p + "mlp.c_fc.bias": w(4 * d),
                   p + "mlp.c_proj.weight": w(4 * d, d, scale=out_scale),
                   p + "mlp.c_proj.bias": w(d)})
    return sd


def round_syncs(torch, srv, prompts) -> dict:
    """Host syncs of one decode round (the second after two admissions),
    counted at the dispatcher."""
    for p in prompts[:2]:
        srv.submit(p, max_new_tokens=NEW_TOKENS)
    srv.step()
    syncs = host_syncs(torch, srv.step)
    srv.run_to_completion()
    return syncs


def moe_serve(torch, np, fa, rng) -> dict:
    """moe_350m served: a DecodeServer (bf16, 8 slots x 2048, flash
    prefill, random weights from seed 0) answers serve's 8 prompts with
    32 greedy tokens each; flash launches 24 a prefill exactly; a
    llama_350m server beside it: the burst in turns, each model's
    profiled request, and the host syncs of a decode round, moe_350m's
    equal to llama_350m's (its routing makes no host sync); the first
    stream beside the port's
    generate (reported: the server's prefill is capacity-routed over the
    padded bucket, generate's over the prompt, as in the reference, and
    bf16 flash and dense attention round apart), and in float32 at
    bucket-sized prompts, where the two compute the same function, each
    stream token-exact against generate; a 512-token prefill's logits
    with the flash kernel against dense attention given the same routes.
    Returns the burst's launch counts."""
    from parameter_server_distributed_tpu_torch.models import serving
    from parameter_server_distributed_tpu_torch.models.generation import \
        generate
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, causal_attention, flash_attention_auto)

    model = get_model("moe_350m", dtype="bf16")
    c = model.config
    if model.attention_fn is not flash_attention_auto:
        fail("PSDT_FLASH_ATTENTION=1 did not select the flash kernel")
    params = model.init_params(0, device="cuda")
    n_params = sum(v.numel() for v in params.values())
    if len(params) != MOE["tensors"] or n_params != MOE["params"]:
        fail(f"moe_350m has {n_params} parameters in {len(params)} tensors")
    prompts = [rng.integers(0, c.vocab, n).tolist() for n in PROMPT_LENS]
    srv = serving.DecodeServer(model, params, slots=8, max_len=2048,
                               device="cuda")
    warm_buckets(serving, srv, prompts[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    b = burst(torch, srv, prompts)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected = {"flash_fwd": c.n_layers * len(prompts), "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
    check_streams(b, c.vocab, "moe_350m serving")
    syncs = round_syncs(torch, srv, prompts)

    # a llama_350m server beside it on the same card and prompts: the
    # burst in turns (moe_350m's above, then llama_350m, llama_350m,
    # moe_350m), one decode round's host syncs, and each model's
    # profiled request at the largest bucket (its prefill and 7 rounds)
    llama = get_model("llama_350m", dtype="bf16")
    lsrv = serving.DecodeServer(llama, llama.init_params(0, device="cuda"),
                                slots=8, max_len=2048, device="cuda")
    warm_buckets(serving, lsrv, prompts[0])
    turns = [b]
    for server in (lsrv, lsrv, srv):
        turns.append(burst(torch, server, prompts))
        check_streams(turns[-1], c.vocab, "a serving turn")
    llama_syncs = round_syncs(torch, lsrv, prompts)
    profiles = {}
    for name, server in (("moe_350m", srv), ("llama_350m", lsrv)):
        def one_request(server=server):
            server.submit(prompts[-1], max_new_tokens=8)
            server.run_to_completion()
        prof = profile_window(torch, one_request, {"flash_ms": "flash_fwd"})
        profiles[name] = {k: prof[k] for k in (
            "window_s", "kernel_ms", "device_busy_share", "trace", "top")}
    del lsrv, llama
    torch.cuda.empty_cache()
    # the first stream beside generate: each prefill's dropped
    # assignments a MoE layer (the server's over the padded bucket)
    first = b["results"][b["rids"][0]]
    tap = RouteTap(model)
    with torch.inference_mode():
        srv._prefill(np.asarray(prompts[0]),
                     serving._bucket(len(prompts[0])))
    server_drops = tap.dropped()
    tap.seen.clear()
    gen = generate(model, params, [prompts[0]], NEW_TOKENS)[0].tolist()
    gen_drops = tap.dropped()[:MOE["moe_layers"]]
    tap.close()
    agree = next((i for i, (x, y) in enumerate(zip(first, gen)) if x != y),
                 len(gen))
    stats = srv.stats
    del srv
    torch.cuda.empty_cache()

    # float32 at bucket-sized prompts: the server and generate compute the
    # same function (the same capacity, flash on both), token for token
    model32 = Transformer(dataclasses.replace(c, dtype=torch.float32))
    params32 = {n: v.float() for n, v in params.items()}
    sprompts = [rng.integers(0, c.vocab, n).tolist() for n in (256, 512)]
    ssrv = serving.DecodeServer(model32, params32, slots=2, max_len=1024,
                                device="cuda")
    srids = [ssrv.submit(p, max_new_tokens=8) for p in sprompts]
    sres = ssrv.run_to_completion()
    exact32 = [sres[r] == generate(model32, params32, [p], 8)[0].tolist()
               for r, p in zip(srids, sprompts)]
    del ssrv, model32, params32
    torch.cuda.empty_cache()

    # a 512-token prefill's logits: flash against dense attention, the
    # dense forward given the flash forward's routes (and without them,
    # reported)
    dense = Transformer(c, attention_fn=causal_attention)
    tok = torch.tensor([prompts[3] + [0]], device="cuda")    # S = 512
    with torch.inference_mode():
        tap = RouteTap(model)
        lf = model.apply(params, tok)[0, -2]
        tap.close()
        free = dense.apply(params, tok)[0, -2]
        dtap = RouteTap(dense, replay=tap.seen)
        ld = dense.apply(params, tok)[0, -2]
        dtap.close()
    rel = float((lf - ld).abs().max() / ld.abs().max())
    rel_free = float((lf - free).abs().max() / free.abs().max())
    rerouted = [int(x) for x in dtap.changed]
    del dense, params, model
    torch.cuda.empty_cache()
    emit({"phase": "moe_serve", "model": "moe_350m", "dtype": "bfloat16",
          "params": n_params, "tensors": MOE["tensors"], "slots": 8,
          "max_len": 2048, "prompt_lens": list(PROMPT_LENS),
          "buckets": [min(serving._bucket(n), 2048) for n in PROMPT_LENS],
          **burst_report(np, b), "peak_mem_gb": peak,
          "flash_launches": launches, "expected_launches": expected,
          "in_turns": [{"model": m, "ttft_p50_s": float(np.median(
              t["ttft"])), "gap_p50_s": float(np.median(t["gaps"]))}
              for m, t in zip(("moe_350m", "llama_350m", "llama_350m",
                               "moe_350m"), turns)],
          "profiled_request": profiles,
          "round_host_syncs": syncs, "llama_350m_round_host_syncs":
          llama_syncs, "first_stream_vs_generate": {
              "equal": first == gen, "tokens_agreeing": agree,
              "server_prefill_dropped": server_drops,
              "generate_prefill_dropped": gen_drops},
          "f32_bucket_prompts_token_exact": exact32,
          "logits_flash_vs_dense": {"seq": 512, "max_rel_diff": rel,
                                    "tol": 5e-2,
                                    "max_rel_diff_own_routes": rel_free,
                                    "assignments_rerouted": rerouted},
          "stats": stats})
    if launches != expected:
        fail(f"moe_350m serving flash launches {launches} != {expected}")
    if syncs != llama_syncs:
        fail(f"a moe_350m decode round's host syncs {syncs} != "
             f"llama_350m's {llama_syncs}")
    if not all(exact32):
        fail(f"float32 moe_350m streams differ from generate: {exact32}")
    if not torch.isfinite(lf).all() or rel > 5e-2:
        fail(f"moe_350m flash logits off dense by {rel}")
    return launches


def moe_train(torch, np, fa, fu) -> dict:
    """moe_350m through the PS round in process, as ps_round runs it: a
    CoordinatorCore with one worker, a ParameterServerCore over
    make_optimizer("pallas_adam"), a port Trainer (bf16, flash, remat
    "full", loss_chunk 128) on one batch of 8 x 1024 tokens, 2 rounds.
    The launches must be the design's (a step: 48 flash_fwd with the
    recompute, 24 dQ, 24 dK/dV; an apply: the update planner's tables);
    remat's recompute routes as the forward; on the same store and batch
    given the same routes, round 1's loss within 1e-3 of dense
    attention's, and each gradient tensor within 2^-5 in L2 of dense
    attention's in float32 (the bf16 dense gradients reported beside).
    Reports each round's loss split into NLL and moe_aux_coef x aux, each
    MoE layer's dropped share of its assignments at capacity 1280 and its
    aux loss, and the peak card memory.  Returns the path's launch
    counts."""
    from parameter_server_distributed_tpu_torch.async_sgd.device_optimizer \
        import PallasOptimizer
    from parameter_server_distributed_tpu_torch.core.coordinator_core \
        import CoordinatorCore
    from parameter_server_distributed_tpu_torch.core.optimizer import \
        make_optimizer
    from parameter_server_distributed_tpu_torch.core.ps_core import \
        ParameterServerCore
    from parameter_server_distributed_tpu_torch.models.convert import \
        params_from_numpy
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model_and_batches
    from parameter_server_distributed_tpu_torch.models.transformer import (
        Transformer, causal_attention, flash_attention_auto)
    from parameter_server_distributed_tpu_torch.obs import stats
    from parameter_server_distributed_tpu_torch.worker.trainer import Trainer

    b, s, lr, rounds = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"], \
        MOE["rounds"]
    model, batches = get_model_and_batches("moe_350m", b, seed=0,
                                           dtype="bf16")
    c = model.config
    if model.attention_fn is not flash_attention_auto or not c.remat or \
            c.remat_policy != "full" or c.loss_chunk != 128:
        fail(f"moe_350m training config: attention "
             f"{model.attention_fn.__name__}, remat {c.remat} "
             f"{c.remat_policy}, loss_chunk {c.loss_chunk}")
    coord = CoordinatorCore("127.0.0.1", 50051)
    coord.register_worker(0, "127.0.0.1", 6000, "worker0")
    opt = make_optimizer("pallas_adam", lr)
    if not (isinstance(opt, PallasOptimizer) and opt.device.type == "cuda"
            and stats.counter("ps.apply.device_fallback").value == 0):
        fail(f"pallas_adam is {type(opt).__name__}, not PallasOptimizer on "
             f"the card")
    ps = ParameterServerCore(total_workers=1, optimizer=opt,
                             live_workers_fn=coord.width_provider())
    trainer = Trainer(model)
    batch = next(batches)
    init = trainer.init_params(0)
    ps.initialize_parameters(init)
    tap = RouteTap(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    fu.reset_launches()
    losses, round_s = [], []
    for it in range(1, rounds + 1):
        t0 = time.perf_counter()
        _, params, ready = ps.serve_parameters(it)
        grads, loss = trainer.compute_gradients(params, batch)
        if it == 1:     # kept for the check below, outside the round's time
            t1 = time.perf_counter()
            first_grads = {n: g.copy() for n, g in grads.items()}
            t0 += time.perf_counter() - t1
        result = ps.receive_gradients(0, it, grads)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if not (ready and result.success and result.aggregation_complete):
            fail(f"moe_350m round {it}: ready {ready}, push {result}")
    launches = {**fa.launches, **fu.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del grads, params
    tap.close()
    expected = {"flash_fwd": 2 * c.n_layers * rounds,
                "flash_bwd_dq": c.n_layers * rounds,
                "flash_bwd_dkv": c.n_layers * rounds,
                "fused_sgd": 0, "fused_momentum": 0,
                "fused_adam": update_launches(fu, model.param_shapes())
                * rounds}
    # each round's forward routes, then remat's recompute of them in the
    # backward pass (in reverse order); a round's loss is its NLL plus
    # moe_aux_coef times the layers' aux
    n_moe = MOE["moe_layers"]
    per_round = []
    for it in range(rounds):
        fwd = tap.seen[2 * n_moe * it:2 * n_moe * it + n_moe]
        layers = []
        for i, r in zip(range(1, c.n_layers, 2), fwd):
            frac = torch.bincount(r.top_idx.reshape(-1),
                                  minlength=c.moe_experts).float()
            frac = frac / r.top_idx.numel()
            layers.append({"layer": i, "capacity": r.capacity,
                           "dropped_share": float((~r.keep).float().mean()),
                           "aux": float(c.moe_experts * torch.sum(
                               frac * r.probs.detach().mean(dim=0)))})
        aux = sum(layer["aux"] for layer in layers)
        per_round.append({"loss": losses[it], "aux_total": aux,
                          "nll": losses[it] - c.moe_aux_coef * aux,
                          "moe_layers": layers})
    first = tap.seen[:2 * n_moe]          # round 1: forward, recompute
    same_recompute = all(torch.equal(a.top_idx, r.top_idx)
                         and torch.equal(a.keep, r.keep)
                         for a, r in zip(first[:n_moe],
                                         first[n_moe:][::-1]))
    del tap
    # round 1 with dense attention on the same store and batch: its loss
    # without the flash forward's routes (reported), and its loss and
    # gradients given them (forward and recompute replayed), in bf16 and
    # in float32 (the plain version: the same function without bf16's
    # rounding)
    del ps, opt, trainer
    gc.collect()
    torch.cuda.empty_cache()
    dense = Transformer(c, attention_fn=causal_attention)
    dparams = params_from_numpy(init, c, device="cuda")
    with torch.inference_mode():
        free_loss = float(dense.loss(dparams, batch))
    del dparams
    grads_of = {"flash": first_grads}
    for name, cfg in (("dense", c), ("f32", dataclasses.replace(
            c, dtype=torch.float32))):
        dense = Transformer(cfg, attention_fn=causal_attention)
        dtap = RouteTap(dense, replay=first)
        grads_of[name], loss_ = Trainer(dense).compute_gradients(init,
                                                                 batch)
        dtap.close()
        if name == "dense":
            dense_loss, rerouted = loss_, [int(x) for x in dtap.changed]
        del dense, dtap
        torch.cuda.empty_cache()
    del first, init, first_grads
    # each tensor's difference: its largest |entry| over the reference's
    # largest, and its L2 norm over the reference's
    diffs = {pair: {"max": {}, "l2": {}} for pair in (
        "flash_vs_dense", "flash_vs_f32", "dense_vs_f32")}
    for name in grads_of["f32"]:
        g = {k: torch.from_numpy(v[name]).cuda() for k, v in grads_of.items()}
        for pair in diffs:
            x, ref = (g[k] for k in pair.split("_vs_"))
            d = x - ref
            diffs[pair]["max"][name] = float(
                d.abs().max() / ref.abs().max().clamp_min(1e-30))
            diffs[pair]["l2"][name] = float(
                d.norm() / ref.norm().clamp_min(1e-30))
    del grads_of, g, d, x, ref
    torch.cuda.empty_cache()

    def summary(by_name: dict) -> dict:
        worst = max(by_name, key=by_name.get)
        return {"worst": worst, "worst_rel": by_name[worst],
                "rel_p50": float(np.median(list(by_name.values())))}

    # held: each tensor of the flash step within 2^-5 of the float32
    # plain gradient in L2 (the bf16 dense path, reported beside it, is
    # as far: bf16's rounding through 24 layers)
    grad_rel = diffs["flash_vs_f32"]["l2"]
    worst = max(grad_rel, key=grad_rel.get)
    emit({"phase": "moe_train", "model": "moe_350m", "dtype": "bfloat16",
          "params": model.num_params(), "batch": b, "seq": s,
          "remat": c.remat_policy, "loss_chunk": c.loss_chunk,
          "optimizer": "pallas_adam", "lr": lr, "rounds": rounds,
          "losses": losses, "round_s": round_s, "peak_mem_gb": peak,
          "launches": launches, "expected_launches": expected,
          "rounds_split": per_round,
          "recompute_routes_equal": same_recompute,
          "first_loss_dense": dense_loss,
          "first_loss_dense_own_routes": free_loss,
          "assignments_rerouted": rerouted, "tol_first_rel": 1e-3,
          "first_grads": {"tensors": len(grad_rel), "tol_rel": 2 ** -5,
                          **{pair: {m: summary(v) for m, v in d.items()}
                             for pair, d in diffs.items()}}})
    if not all(math.isfinite(x) for x in losses):
        fail(f"moe_350m losses not finite: {losses}")
    if launches != expected:
        fail(f"moe_350m training launches {launches} != {expected}")
    if any(layer["capacity"] != MOE["capacity"]
           for r in per_round for layer in r["moe_layers"]):
        fail(f"moe_350m training capacity {per_round} != "
             f"{MOE['capacity']}")
    if abs(losses[0] - dense_loss) > 1e-3 * abs(dense_loss):
        fail(f"moe_350m first loss {losses[0]} off dense {dense_loss}")
    if not same_recompute:
        fail("remat's recompute routed moe_350m unlike its forward")
    if len(grad_rel) != MOE["tensors"] or not all(
            math.isfinite(x) and x <= 2 ** -5 for x in grad_rel.values()):
        fail(f"moe_350m's first gradients off the float32 plain ones on "
             f"the same routes: {worst} by {grad_rel[worst]} in L2")
    return launches


def hf_serve(torch, np, fa, rng) -> dict:
    """The HF conversion on the card: a GPT-2 small state dict under the
    Hugging Face names (random, from numpy at seed 0) through the port's
    from_hf_gpt2 (float32, the --hf-gpt2 default), served by a
    DecodeServer (4 slots x 1024: learned positions, LayerNorm, biases,
    flash prefill) with 4 prompts of 129-992 tokens and 32 greedy tokens
    each after one warm-up request a bucket: flash launches 12 a prefill
    exactly, the first stream equal to
    generate's; then the llama_350m store round to_hf_llama ->
    from_hf_llama, byte for byte.  Returns the burst's launch counts."""
    from parameter_server_distributed_tpu_torch.models import hf, serving
    from parameter_server_distributed_tpu_torch.models.generation import \
        generate
    from parameter_server_distributed_tpu_torch.models.registry import \
        get_model
    from parameter_server_distributed_tpu_torch.models.transformer import \
        flash_attention_auto

    t0 = time.perf_counter()
    state = gpt2_state(np)
    t1 = time.perf_counter()
    model, params = hf.from_hf_gpt2(StandIn(GPT2, state), device="cuda")
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t1
    c = model.config
    del state
    if model.attention_fn is not flash_attention_auto:
        fail("PSDT_FLASH_ATTENTION=1 did not select the flash kernel")
    if (c.pos_emb, c.norm, c.bias, c.d_ff, c.dtype) != (
            "learned", "layernorm", True, 3072, torch.float32):
        fail(f"from_hf_gpt2 gave {c}")
    prompts = [rng.integers(0, c.vocab, n).tolist() for n in HF_PROMPT_LENS]
    srv = serving.DecodeServer(model, params, slots=4, max_len=1024,
                               device="cuda")
    warm_buckets(serving, srv, prompts[0], HF_PROMPT_LENS, 1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    b = burst(torch, srv, prompts)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    expected = {"flash_fwd": c.n_layers * len(prompts), "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
    check_streams(b, c.vocab, "GPT-2 serving")
    first = b["results"][b["rids"][0]]
    gen = generate(model, params, [prompts[0]], NEW_TOKENS)[0].tolist()
    n_params = model.num_params()
    del srv, params, model
    torch.cuda.empty_cache()

    # llama_350m to the transformers names and back
    llama = get_model("llama_350m", dtype="bf16")
    lparams = llama.init_params(0, device="cuda")
    t2 = time.perf_counter()
    sd = hf.to_hf_llama(llama, lparams)
    back_model, back = hf.from_hf_llama(StandIn(LLAMA_HF, sd),
                                        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    round_trip_s = time.perf_counter() - t2
    arch = ("vocab", "d_model", "n_heads", "kv_heads", "n_layers", "d_ff",
            "max_seq", "norm_eps", "rope_theta", "mlp_act", "pos_emb",
            "norm", "bias", "dtype")
    same_arch = all(getattr(back_model.config, f) == getattr(llama.config, f)
                    for f in arch)
    same_bytes = (list(back) == list(lparams) and all(
        torch.equal(back[n].view(torch.int16), lparams[n].view(torch.int16))
        for n in lparams))
    del sd, back, lparams, llama, back_model
    torch.cuda.empty_cache()
    emit({"phase": "hf_serve", "model": "gpt2 (small's shape)",
          "dtype": "float32", "params": n_params,
          "state_s": t1 - t0, "convert_s": convert_s,
          "prompt_lens": list(HF_PROMPT_LENS), "slots": 4, "max_len": 1024,
          **burst_report(np, b), "peak_mem_gb": peak,
          "flash_launches": launches, "expected_launches": expected,
          "first_stream_equal_generate": first == gen,
          "llama_350m_round_trip": {"same_architecture": same_arch,
                                    "bytes_equal": same_bytes,
                                    "seconds": round_trip_s}})
    if launches != expected:
        fail(f"GPT-2 serving flash launches {launches} != {expected}")
    if first != gen:
        fail("the GPT-2 server's first stream differs from generate")
    if not (same_arch and same_bytes):
        fail(f"llama_350m to_hf_llama -> from_hf_llama: architecture "
             f"{same_arch}, bytes {same_bytes}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside this script")
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from parameter_server_distributed_tpu_torch.models.transformer import \
        llama_350m
    from parameter_server_distributed_tpu_torch.ops import build
    from parameter_server_distributed_tpu_torch.ops import \
        flash_attention as fa
    from parameter_server_distributed_tpu_torch.ops import fused_update as fu

    t_start = time.perf_counter()
    # ---- device
    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    print(smi, flush=True)
    # whether the wire round's gRPC services could run here (reported only)
    emit({"phase": "env", "python": sys.version.split()[0],
          "grpc": importlib.util.find_spec("grpc") is not None})

    # ---- build every kernel source, all nvcc processes at once
    from parameter_server_distributed_tpu_torch import native

    t0 = time.perf_counter()
    # the host C++ library (g++) builds while nvcc runs
    native_build = {}
    host_lib = threading.Thread(target=lambda: native_build.update(
        lib=native.lib(), s=time.perf_counter() - t0))
    host_lib.start()
    seconds = build.build(build.SOURCES)
    host_lib.join()
    ptxas = {name: ptxas_report(log)
             for name, log in build.BUILD_LOGS.items()}
    wall = time.perf_counter() - t0
    tensor_core = tensor_core_counts(build)
    emit({"phase": "build", "seconds": seconds, "wall_s": wall,
          "native_s": native_build["s"],
          "native_library": native.library_path(),
          "ptxas": ptxas, "tensor_core_sass": tensor_core})
    if native_build["lib"] is None:
        fail("the host C++ library (native/psdt_native.cpp) did not build")
    # the bf16 forward, dQ and dK/dV kernels run their products on the
    # tensor cores
    for src_name, kernel in (("flash_fwd", "flash_fwd_mma_kernel"),
                             ("flash_bwd", "flash_bwd_dq_mma_kernel"),
                             ("flash_bwd", "flash_bwd_dkv_mma_kernel")):
        for dim in (64, 128):
            if not sum(tensor_core[src_name]["by_kernel"].get(
                    f"{kernel}/D{dim}", {}).values()):
                fail(f"{kernel} (D={dim}) has no HMMA/HGMMA in its SASS")
    # K5's prefill kernel runs on wgmma alone, and no int8 serving kernel
    # spills (a spill is a local-memory round trip in a bytes-bound loop)
    wgmma = tensor_core["int8_serve"]["by_kernel"].get(
        "wdot_wgmma_kernel", {})
    if not wgmma.get("HGMMA") or wgmma.get("HMMA"):
        fail(f"wdot_wgmma_kernel's SASS holds {wgmma}: want HGMMA and no "
             f"HMMA")
    spills = {k: v for k, v in ptxas.get("int8_serve", {}).items()
              if re.search(r"\b[1-9]\d* bytes spill (stores|loads)", v)}
    if spills:
        fail(f"int8_serve.cu kernels spill: {spills}")

    # ---- every kernel against its plain version, then timed
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = llama_350m().param_shapes()
    max_err = {"flash_fwd": check_flash_fwd(torch, fa, gen),
               **check_flash_bwd(torch, fa, gen),
               **check_updates(torch, fu, shapes, gen)}
    torch.cuda.empty_cache()
    serve_t = time_flash_fwd(torch, F, fa, gen)
    train_t = time_flash_train(torch, F, fa, gen)
    update_t = time_updates(torch, fu, shapes, gen)
    update_t["fused_sgd"]["resnet18_store"] = sgd_at_resnet18(torch, fu, gen)
    da_err, da_t = check_device_apply(torch, np, shapes, gen)
    max_err.update(da_err)
    i8_err, i8_t = check_int8_kernels(torch, np, gen)
    max_err.update(i8_err)
    spec_err, spec_t = check_spec_kernels(torch, np, gen)
    for name, err in spec_err.items():
        max_err[name] = max(max_err[name], err)
    # K5-K7 at the verify shapes ride on their kernels-line entries
    i8_t["int8_wdot"]["verify"] = {k: v for k, v in spec_t.items()
                                   if k.startswith("int8_wdot")}
    for name in ("decode_attention_int8", "kv_quantize"):
        i8_t[name]["verify"] = spec_t[name]
    emit({"phase": "kernels_checked", "elapsed_s":
          time.perf_counter() - t_start})

    # ---- the two paths, each with its own launch count
    os.environ["PSDT_FLASH_ATTENTION"] = "1"
    rng = np.random.default_rng(0)
    serve_fwd = serve(torch, np, fa, rng)
    torch.cuda.empty_cache()
    emit({"phase": "served", "elapsed_s": time.perf_counter() - t_start})
    int8_launches = serve_int8(torch, np, fa, rng)
    torch.cuda.empty_cache()
    cli_int8()
    emit({"phase": "served_int8", "elapsed_s": time.perf_counter() - t_start})
    spec_launches = serve_spec(torch, np, fa)
    torch.cuda.empty_cache()
    cli_spec()
    emit({"phase": "served_spec", "elapsed_s": time.perf_counter() - t_start})
    fleet_wire_launches = fleet_wire(np, rng)
    fleet_update_launches = fleet_update(torch, np, rng)
    torch.cuda.empty_cache()
    emit({"phase": "fleet_done", "elapsed_s": time.perf_counter() - t_start})
    follow_launches = delta_follow(np, rng)
    emit({"phase": "delta_followed",
          "elapsed_s": time.perf_counter() - t_start})
    train_launches = train(torch, np, fa, fu)
    torch.cuda.empty_cache()
    emit({"phase": "trained", "elapsed_s": time.perf_counter() - t_start})
    round_launches, round1, in_process = ps_round(torch, np, fa, fu)
    torch.cuda.empty_cache()
    emit({"phase": "ps_rounded", "elapsed_s": time.perf_counter() - t_start})
    device_launches, device_round1, device_in = ps_device_round(torch, np,
                                                                fa)
    emit({"phase": "ps_device_rounded",
          "elapsed_s": time.perf_counter() - t_start})
    # the MoE transformer and the HF conversion, each alone on an emptied
    # card
    rng19 = np.random.default_rng(19)
    slice19 = {}
    for name, phase in (
            ("moe_serve", lambda: moe_serve(torch, np, fa, rng19)),
            ("moe_train", lambda: moe_train(torch, np, fa, fu)),
            ("hf_serve", lambda: hf_serve(torch, np, fa, rng19))):
        gc.collect()
        torch.cuda.empty_cache()
        slice19[name] = phase()
        emit({"phase": f"{name}_done",
              "elapsed_s": time.perf_counter() - t_start})
    gc.collect()
    torch.cuda.empty_cache()
    # the wire round's two legs and config 1's four, each its own cluster
    # of processes, run at once (their round times taken beside each
    # other's; the checks are each leg's own)
    wire = in_parallel({
        "host": lambda: ps_wire_round(np, round1, in_process, "host"),
        "device": lambda: ps_wire_round(np, device_round1, device_in,
                                        "device"),
        "config1": lambda: config1_wire(np)})
    del round1, device_round1
    wire_launches = dict(wire["host"])
    for name, n in wire["device"].items():
        wire_launches[name] = wire_launches.get(name, 0) + n
    config1_launches, config1_ckpts = wire["config1"]
    emit({"phase": "ps_wire_and_config1_done",
          "elapsed_s": time.perf_counter() - t_start})
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
    from parameter_server_distributed_tpu_torch.ops import int8_serve as i8

    def mlp_and_image_rows() -> tuple[dict, dict]:
        mlp = mlp_train(torch, np, fa, fu)
        torch.cuda.empty_cache()
        emit({"phase": "mlp_trained",
              "elapsed_s": time.perf_counter() - t_start})
        # the image rows in process: no kernel of the port runs there
        for mod in (fa, fu, da, i8):
            mod.reset_launches()
        image_rows(torch, np)
        image = {**fa.launches, **fu.launches, **da.launches, **i8.launches}
        if any(image.values()):
            fail(f"image_rows launched {image}")
        torch.cuda.empty_cache()
        emit({"phase": "image_rows_done",
              "elapsed_s": time.perf_counter() - t_start})
        return mlp, image

    # config 2's processes run beside this process's 1B MLP steps and
    # image rows (each side's times taken beside the other's; this
    # process's launch counts are its own)
    done = in_parallel({"here": mlp_and_image_rows,
                        "config2": lambda: config2_wire(np)}, here="here")
    (mlp_launches, image_launches), config2_launches = (done["here"],
                                                        done["config2"])
    emit({"phase": "config2_done",
          "elapsed_s": time.perf_counter() - t_start})
    config3_launches = config3_wire(np, config1_ckpts)
    del config1_ckpts
    emit({"phase": "config3_done",
          "elapsed_s": time.perf_counter() - t_start})

    # ---- kernels line: flash_fwd at the largest serving bucket (S=2048,
    # B=1), the others at the training shapes, the device close's at the
    # llama_350m store, int8_wdot at a decode round's LM head (M=8, K=1024,
    # N=32000), decode_attention_int8 at the serving round (8 ragged rows
    # of max_len 2048), kv_quantize at a 2048-token prefill stack;
    # launches from the main paths' runs
    sources = {"flash_fwd": ("flash_fwd.cu", PALLAS + "flash_attention.py:86"),
               "flash_bwd_dq": ("flash_bwd.cu",
                                PALLAS + "flash_attention.py:162"),
               "flash_bwd_dkv": ("flash_bwd.cu",
                                 PALLAS + "flash_attention.py:202"),
               "fused_sgd": ("fused_update.cu", PALLAS + "fused_update.py:42"),
               "fused_momentum": ("fused_update.cu",
                                  PALLAS + "fused_update.py:46"),
               "fused_adam": ("fused_update.cu", PALLAS + "fused_update.py:53"),
               **{name: ("device_apply.cu", DEVICE_APPLY_REF + line)
                  for name, line in DA_REPLACES.items()},
               **{name: ("int8_serve.cu", INT8_REF + line)
                  for name, line in INT8_REPLACES.items()}}
    by_path = {name: {"serve": serve_fwd if name == "flash_fwd" else 0,
                      "serve_int8": int8_launches.get(name, 0),
                      "serve_spec": spec_launches.get(name, 0),
                      "fleet_wire": fleet_wire_launches.get(name, 0),
                      "fleet_update": fleet_update_launches.get(name, 0),
                      "delta_follow": follow_launches.get(name, 0),
                      "train": train_launches.get(name, 0),
                      "ps_round": round_launches.get(name, 0),
                      "ps_device_round": device_launches.get(name, 0),
                      **{path: slice19[path].get(name, 0)
                         for path in ("moe_serve", "moe_train", "hf_serve")},
                      "ps_wire_round": wire_launches.get(name, 0),
                      "config1_wire": config1_launches.get(name, 0),
                      "mlp_train": mlp_launches.get(name, 0),
                      "image_rows": image_launches.get(name, 0),
                      "config2_wire": config2_launches.get(name, 0),
                      "config3_wire": config3_launches.get(name, 0)}
               for name in sources}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    times = {"flash_fwd": serve_t[2048], **{k: v for k, v in train_t.items()
                                            if k != "flash_fwd"}, **update_t,
             **da_t, **i8_t}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = times[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"{PACKAGE}/csrc/{src}",
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max_err[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "launches_by_path": by_path[name]}
        for key in ("lanes", "verify", "resnet18_store", "cold_l2"):
            if key in t:
                entry[key] = t[key]
        kernels.append(entry)
    # the device close's kernels run on the device-close paths only, the
    # int8 serving kernels on serve_int8, serve_spec, fleet_update and
    # delta_follow only; flash_fwd on both fleet paths, delta_follow and
    # the three paths of slice 19, the backward kernels and Adam on
    # moe_train
    if any(k["launches"] <= 0 or (k["name"] in INT8_REPLACES and min(
            k["launches_by_path"][path]
            for path in ("serve_int8", "serve_spec", "fleet_update",
                         "delta_follow")) <= 0)
           or (k["name"] == "flash_fwd" and min(
               k["launches_by_path"][path]
               for path in ("fleet_wire", "fleet_update", "delta_follow",
                            "moe_serve", "moe_train", "hf_serve")) <= 0)
           or (k["name"] in ("flash_bwd_dq", "flash_bwd_dkv", "fused_adam")
               and k["launches_by_path"]["moe_train"] <= 0)
           or (k["name"] not in DA_REPLACES and k["name"] not in
               INT8_REPLACES and k["launches_by_path"]["ps_round"] <= 0)
           or (k["name"] == "fused_sgd"
               and min(k["launches_by_path"][path]
                       for path in ("config2_wire", "config3_wire")) <= 0)
           for k in kernels):
        fail(f"a kernel of the main paths never launched: {by_path}")
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
