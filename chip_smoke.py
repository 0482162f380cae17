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
- training: full-width llama_350m (bf16, remat "full", loss_chunk 128,
  flash attention, weights from a seed) taking 5 Trainer.compute_gradients
  -> PallasOptimizer("adam").apply steps on one batch of 8 x 1024 random
  tokens, then one sgd and one momentum apply over the same store; then
  the same 5 steps with dense attention, whose losses stand beside the
  kernels' (the first must agree within 1e-3);
- the parameter-server round: CoordinatorCore and ParameterServerCore
  (make_optimizer("pallas_adam")) driving two llama_350m workers through
  3 synchronous rounds (serve -> gradient step -> push; the second push
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
- the same round over the wire: cli.ps_main, cli.coordinator_main and
  two cli.worker_main processes (llama_350m) on localhost, a bootstrap
  iteration and gradient rounds over the fused PushPullStream data
  plane, which the same-host shared-memory rings carry with the native
  host codec (no process may fall back to gRPC or to the Python codec,
  each worker moves its pushes and pulls through the rings, and no
  segment is left in /dev/shm), in two legs: the PS's pallas_adam after
  a host fold (2 rounds; its epoch-1 checkpoint held against ps_round's
  round-1 store) and --optimizer=sharded_adam under both device-close
  knobs (3 rounds; its epoch-1 checkpoint byte-identical to
  ps_device_round's round-1 store, no apply fallback); every epoch's
  checkpoint holding its own iteration and Adam step, and the
  processes' launch counts from their exit reports;
- BASELINE config 1 as the reference runs it: cli.ps_main (1 worker, its
  default optimizer, pallas_sgd), cli.coordinator_main and one
  cli.worker_main (mnist_mlp, batch 256, bf16 on the wire), a bootstrap
  and 5 gradient rounds, in four legs (shm and the native codec; gRPC;
  gRPC, the Python codec and the PS's plain host SGD; shm with
  --optimizer=sharded_sgd and the device close, the bf16 pushes decoded
  on the card) whose checkpoints must be byte-identical, one fused_sgd
  launch per kernel apply, the device close's launches and a falling
  loss;
- the 1.34B-parameter MLP (mlp_1b, bf16, batch 2048): 3
  Trainer.compute_gradients -> PallasOptimizer("adam") steps on one
  batch, the loss falling, one Adam launch per apply, the first apply
  held against the plain Adam update tensor by tensor (the store spans
  two launches), then one profiled step.

The build phase also builds the host C++ library (native/psdt_native.cpp,
g++) that the wire phases' codec and rings run on.  Each path's launch
counts are set to 0 just before it runs and read just after (a process
of the wire phases counts from 0 and reports at exit), and must equal
the expected counts.  Each phase prints one JSON
line; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero
without one.

Comparisons in float32 run with TF32 off (torch.backends.*.allow_tf32 =
False), so float32 products are full float32.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
ROUND = dict(workers=2, rounds=3)
# the stripes of the in-process device round and of the device legs
DEVICE_STRIPES = 8
# the wire round's legs: the PS's optimizer, its gradient rounds after the
# bootstrap, and the knobs of its processes (the device leg closes on the
# card through the flat arena, at DEVICE_STRIPES stripes)
WIRE_LEGS = {"host": ("pallas_adam", 2, {}),
             "device": ("sharded_adam", 3,
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
    train_flash_vs_dense phases), MHA, D=128 and ragged segments (S=200,
    whose last q tile runs into the next segment's rows); returns the
    largest |o| error."""
    heads, kv, d = LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    cases = [(1, s, heads, kv, d, torch.bfloat16)
             for s in (128, 256, 512, 1024, 2048)]
    cases += [(TRAIN["batch"], TRAIN["seq"], heads, kv, d, torch.bfloat16),
              (1, 512, 16, 16, 64, torch.bfloat16),     # MHA
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
    llama_350m training shape, MHA, D=128, f32, and segments that are not
    a multiple of the 64-row tile.  f32 within rtol 5e-4, atol 1e-5 (the
    reference's gradient tolerance); bf16 within rtol 1e-2, atol 1e-3 of
    the f32 plain result on the same bf16 inputs (each output is rounded
    once to bf16).  Returns each kernel's largest absolute error."""
    b, heads, kv, d = TRAIN["batch"], LLAMA["heads"], LLAMA["kv"], LLAMA["d"]
    cases = [(b, TRAIN["seq"], heads, kv, d, torch.bfloat16),
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
    # warm-up, outside the count: one request per prefill bucket, so the
    # measured burst sees steady-state library and allocator state
    for n in sorted({min(serving._bucket(n), 2048) for n in PROMPT_LENS}):
        srv.submit((prompts[0] * (n // len(prompts[0]) + 1))[:n - 2],
                   max_new_tokens=2)
        srv.run_to_completion()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    # all 8 requests arrive at t0 and are admitted back to back: TTFT is
    # from t0 to the request's first token on the host (its prefill plus
    # the prefills queued ahead of it); a gap is one decode round
    t0 = time.perf_counter()
    ttft, prefill_s, gaps, rids = [], [], [], []
    for p in prompts:
        t1 = time.perf_counter()
        rids.append(srv.submit(p, max_new_tokens=NEW_TOKENS))
        prefill_s.append(time.perf_counter() - t1)
        ttft.append(time.perf_counter() - t0)
    while not srv.idle:
        t1 = time.perf_counter()
        srv.step()                      # returns with the tokens on host
        gaps.append(time.perf_counter() - t1)
    results = srv.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.launches)
    prefills = len(prompts)
    tokens = sum(len(results[r]) for r in rids)
    vocab = model.config.vocab
    emit({"phase": "serve", "model": "llama_350m", "dtype": "bfloat16",
          "params": model.num_params(), "slots": 8, "max_len": 2048,
          "prompt_lens": list(PROMPT_LENS),
          "buckets": [min(serving._bucket(n), 2048) for n in PROMPT_LENS],
          "requests_answered": len(results), "tokens_generated": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "ttft_p50_s": float(np.median(ttft)), "ttft_s": ttft,
          "prefill_s": prefill_s, "decode_rounds": len(gaps),
          "gap_p50_s": float(np.median(gaps)), "gap_max_s": max(gaps),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "flash_launches": launches,
          "expected_launches": {"flash_fwd": LLAMA["layers"] * prefills},
          "stats": srv.stats})
    if len(results) != prefills or any(
            len(results[r]) != NEW_TOKENS
            or not all(0 <= t < vocab for t in results[r]) for r in rids):
        fail("serving did not answer every request with in-vocab tokens")
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
    for n in sorted({min(serving._bucket(n), 2048) for n in PROMPT_LENS}):
        srv.submit((prompts[0] * (n // len(prompts[0]) + 1))[:n - 2],
                   max_new_tokens=2)
        srv.run_to_completion()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    i8.reset_launches()
    t0 = time.perf_counter()
    ttft, gaps, rids = [], [], []
    for p in prompts:
        rids.append(srv.submit(p, max_new_tokens=NEW_TOKENS))
        ttft.append(time.perf_counter() - t0)
    while not srv.idle:
        t1 = time.perf_counter()
        srv.step()
        gaps.append(time.perf_counter() - t1)
    results = srv.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa.launches, **i8.launches}
    layers, prefills, rounds = LLAMA["layers"], len(prompts), len(gaps)
    per_forward = 7 * layers + 1
    expected = {"flash_fwd": layers * prefills, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0,
                "int8_wdot": per_forward * (prefills + rounds),
                "decode_attention_int8": layers * rounds,
                "kv_quantize": prefills + layers * rounds}
    tokens = sum(len(results[r]) for r in rids)
    emit({"phase": "serve_int8", "model": "llama_350m",
          "dtype": "bfloat16, int8 weights, int8 KV cache", "slots": 8,
          "max_len": 2048, "prompt_lens": list(PROMPT_LENS),
          "requests_answered": len(results), "tokens_generated": tokens,
          "wall_s": wall, "tokens_per_s": tokens / wall,
          "ttft_p50_s": float(np.median(ttft)), "ttft_s": ttft,
          "decode_rounds": rounds, "gap_p50_s": float(np.median(gaps)),
          "gap_max_s": max(gaps),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "store_bytes": as_is, "store_bytes_unquantized": dense_bytes,
          "cache_bytes": cache_bytes, "launches": launches,
          "expected_launches": expected})
    if len(results) != prefills or any(
            len(results[r]) != NEW_TOKENS
            or not all(0 <= t < vocab for t in results[r]) for r in rids):
        fail("int8 serving did not answer every request with in-vocab "
             "tokens")
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

    def burst(server):
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
    cached = burst(psrv)
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
    plain = burst(nsrv)
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
    """One 8-request burst on ``srv`` (every request admitted at t0, then
    rounds until idle), as ``serve`` times it: TTFT, gaps, tokens/s, the
    launches (from 0), and tokens per target forward (a request's tokens
    over its prefill and the rounds it took part in)."""
    torch.cuda.synchronize()
    launches_of(reset=True)
    t0 = time.perf_counter()
    ttft, gaps, rids = [], [], []
    for p in prompts:
        rids.append(srv.submit(p, max_new_tokens=NEW_TOKENS))
        ttft.append(time.perf_counter() - t0)
    forwards = dict.fromkeys(rids, 1)
    while not srv.idle:
        t1 = time.perf_counter()
        emitted = srv.step()
        gaps.append(time.perf_counter() - t1)
        for rid in {rid for rid, _ in emitted}:
            forwards[rid] += 1
    results = srv.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(results[r]) for r in rids)
    return {"results": [results[r] for r in rids], "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)),
            "gap_p50_s": float(np.median(gaps)), "rounds": len(gaps),
            "tokens_per_target_forward": tokens / sum(forwards.values()),
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
    its registry stream, seeded with its id), take three rounds of
    serve_parameters -> compute_gradients -> receive_gradients, one after
    the other; the second push closes each barrier.  Then the round-1
    params against the plain Adam update of the numpy mean, one
    pallas_sgd and one pallas_momentum apply through a one-worker core,
    and a checkpoint resume on the 2-layer f32 model.  Returns the
    round's launch counts (the three rounds and the two one-apply cores),
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
    times["topk_scatter"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                 bound_ms=b_ms, bound_by=b_by)
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
    PSDT_DEVICE_APPLY=1 PSDT_ARENA=1, the whole close on the card, 3
    rounds.

    The epoch-1 checkpoint (the store after the first gradient round) is
    held against ``round1`` (host leg: ps_round's, at rtol 1e-5, atol
    1e-7; device leg: ps_device_round's, byte for byte) and the workers'
    round-1 losses against the in-process ones (rtol 1e-6), unless
    ``round1`` and ``in_process`` are None; every epoch's file must
    hold its own iteration and, in its optimizer sidecar, that
    iteration's Adam step (the PS takes each at the apply that advanced
    the epoch, whatever its writer lags).  Rounds 2-3 take each
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
    ``workers_args`` as children; waits for the workers, then stops the
    PS and the coordinator with SIGTERM.  Fails if a child exits
    non-zero or the round outlives ``limit_s``; kills every child on the
    way out.  Returns (wall seconds to the workers' end, the PS's pid)."""
    import signal

    deadline = time.monotonic() + limit_s
    t0 = time.perf_counter()
    try:
        ps, ps_log = spawn("ps_main", "127.0.0.1:0", *ps_args)
        ps_port = _wait_line(ps_log, r"Parameter server listening on "
                             r"[\d.]+:(\d+)", ps, deadline)
        coord, coord_log = spawn("coordinator_main", "127.0.0.1:0",
                                 f"127.0.0.1:{ps_port}")
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
                with open(log) as f, open(ps_log) as g:
                    fail(f"worker exited {rc}: {f.read()[-3000:]}\n"
                         f"the PS (exit {ps.poll()}): {g.read()[-6000:]}")
        wall = time.perf_counter() - t0
        for proc, log in ((ps, ps_log), (coord, coord_log)):
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
    return wall, ps.pid


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
                **dict.fromkeys(da.launches, 0)}
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


def config1_wire(np) -> dict:
    """BASELINE config 1 as the reference runs it: cli.ps_main (1 worker,
    no --optimizer, so its default pallas_sgd, lr CONFIG1["lr"], a
    checkpoint every iteration), cli.coordinator_main and one
    cli.worker_main (mnist_mlp, batch 256, bf16 on the wire), all on the
    card; a bootstrap and 5 gradient rounds.  Four legs: (a) the
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
    processes."""
    import hashlib
    import shutil
    import tempfile

    from parameter_server_distributed_tpu_torch.core.stripes import \
        partition_names
    from parameter_server_distributed_tpu_torch.models.mlp import mnist_mlp
    from parameter_server_distributed_tpu_torch.ops import device_apply as da
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
    for leg, (extra, opt_args) in legs.items():
        device = "PSDT_DEVICE_APPLY" in extra
        expected_ps = {"flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0, "fused_momentum": 0,
                       "fused_adam": 0, "fused_sgd": 0 if opt_args
                       else per_apply * rounds,
                       **(device_launches if device
                          else dict.fromkeys(da.launches, 0))}
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
            reports = {}
            for role, name in (("ps", "ps.json"), ("worker 0",
                                                    "worker-0.json")):
                with open(os.path.join(tmp, name)) as f:
                    reports[role] = json.load(f)
            with open(os.path.join(tmp, "metrics-0.jsonl")) as f:
                records = [json.loads(line) for line in f]
            ckpts[leg] = []
            for e in range(rounds + 1):
                with open(os.path.join(ckpt_dir,
                                       f"checkpoint_epoch_{e}.ckpt"),
                          "rb") as f:
                    ckpts[leg].append(f.read())
            left = shm_left(ps_pid)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
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
    return launches_a


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
    wire_launches = ps_wire_round(np, round1, in_process, "host")
    del round1
    device_wire = ps_wire_round(np, device_round1, device_in, "device")
    del device_round1
    for name, n in device_wire.items():
        wire_launches[name] = wire_launches.get(name, 0) + n
    emit({"phase": "ps_wire_rounded",
          "elapsed_s": time.perf_counter() - t_start})
    config1_launches = config1_wire(np)
    emit({"phase": "config1_done",
          "elapsed_s": time.perf_counter() - t_start})
    mlp_launches = mlp_train(torch, np, fa, fu)
    torch.cuda.empty_cache()

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
                      "train": train_launches.get(name, 0),
                      "ps_round": round_launches.get(name, 0),
                      "ps_device_round": device_launches.get(name, 0),
                      "ps_wire_round": wire_launches.get(name, 0),
                      "config1_wire": config1_launches.get(name, 0),
                      "mlp_train": mlp_launches.get(name, 0)}
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
        for key in ("lanes", "verify"):
            if key in t:
                entry[key] = t[key]
        kernels.append(entry)
    # the device close's kernels run on the device-close paths only, the
    # int8 serving kernels on serve_int8 and serve_spec only
    if any(k["launches"] <= 0 or (k["name"] in INT8_REPLACES and min(
            k["launches_by_path"][path]
            for path in ("serve_int8", "serve_spec")) <= 0)
           or (k["name"] not in DA_REPLACES and k["name"] not in
               INT8_REPLACES and k["launches_by_path"]["ps_round"] <= 0)
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
