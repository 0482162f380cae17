"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout
(one nvcc per source, all at once; the build phase counts each kernel's
tensor-core instructions in its SASS), holds each kernel against its plain
PyTorch version on the card and times it beside its bound and a library
yardstick, then drives the two paths of the port:

- serving: a full-width llama_350m DecodeServer (bf16, 8 slots, max_len
  2048, flash prefill, random weights from a seed) answering 8 requests,
  and the serve_main CLI answering 2 JSONL requests;
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
  and a CheckpointManager save / load / resume that must be bit-exact.

Each path's launch counts are set to 0 just before it runs and read just
after, and must equal the expected counts.  Each phase prints one JSON
line; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Needs one card; exits non-zero
without one.

Comparisons in float32 run with TF32 off (torch.backends.*.allow_tf32 =
False), so float32 products are full float32.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
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
    and per kernel (its name and head_dim, summed over types)."""
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
                by_kernel.setdefault(kernel, 0)
                continue
            op = re.search(r"\b(HGMMA|HMMA)\b", line)
            if op and kernel:
                totals[op.group(1)] += 1
                by_kernel[kernel] += 1
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
    wall time per call and its largest kernels."""
    def run():
        for _ in range(calls):
            fn()
    prof = profile_window(torch, run, {})
    return {"ms": prof["kernel_ms"] / calls,
            "events": prof["kernel_events"] / calls,
            "window_ms": 1e3 * prof["window_s"] / calls,
            "top": prof["top"][:3]}


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


def profile_window(torch, fn, names: dict[str, str]) -> dict:
    """Run ``fn`` under torch.profiler; kernel time summed by name, the
    device busy share (kernel time / the window's wall time) and the time
    of each group in ``names`` (group -> substring of kernel names)."""
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
    if not by_name:
        # the checks read from these events (the training step's one
        # device-to-host copy among them) must not pass on an empty trace
        fail("torch.profiler recorded no CUDA events")
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

    prof = profile_window(torch, one_step, {
        "flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
        "flash_bwd_dkv": "flash_bwd_dkv", "fused_adam": "Adam",
        "gemm": "gemm", "nvjet": "nvjet", "dtoh": "Memcpy DtoH",
        "htod": "Memcpy HtoD"})
    emit({"phase": "train_profile", **prof})
    # the host round trips of a step on card-resident params: one packed
    # gradient download, and the apply's uploads of the host gradients
    if prof["group_events"]["dtoh"] != 1:
        fail(f"a training step made {prof['group_events']['dtoh']} "
             f"device-to-host copies, not 1")
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
    round's launch counts (the three rounds and the two one-apply cores)."""
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
    # where a round's time goes: a fourth round under the profiler, after
    # the counts are read (its losses and pushes are not the phase's)
    n_losses, n_pushes = len(losses), len(pushes)
    last0 = kept.pop("last0")
    prof = profile_window(torch, lambda: one_round(rounds + 1), {
        "flash": "flash_", "fused_adam": "update_kernel", "gemm": "gemm",
        "nvjet": "nvjet", "dtoh": "Memcpy DtoH", "htod": "Memcpy HtoD"})
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
    del after_first
    kept.clear()
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
    emit({"phase": "ps_round_profile", **prof})
    # the round's only device-to-host copies are the workers' packed
    # gradient downloads: the core never takes served card tensors to
    # the host
    if prof["group_events"]["dtoh"] != workers:
        fail(f"a round made {prof['group_events']['dtoh']} device-to-host "
             f"copies, not {workers}")
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
    t0 = time.perf_counter()
    seconds = build.build(build.SOURCES)
    ptxas = {name: ptxas_report(log)
             for name, log in build.BUILD_LOGS.items()}
    wall = time.perf_counter() - t0
    tensor_core = tensor_core_counts(build)
    emit({"phase": "build", "seconds": seconds, "wall_s": wall,
          "ptxas": ptxas, "tensor_core_sass": tensor_core})
    # the bf16 forward, dQ and dK/dV kernels run their products on the
    # tensor cores
    for src_name, kernel in (("flash_fwd", "flash_fwd_mma_kernel"),
                             ("flash_bwd", "flash_bwd_dq_mma_kernel"),
                             ("flash_bwd", "flash_bwd_dkv_mma_kernel")):
        for dim in (64, 128):
            if not tensor_core[src_name]["by_kernel"].get(
                    f"{kernel}/D{dim}"):
                fail(f"{kernel} (D={dim}) has no HMMA/HGMMA in its SASS")

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
    emit({"phase": "kernels_checked", "elapsed_s":
          time.perf_counter() - t_start})

    # ---- the two paths, each with its own launch count
    os.environ["PSDT_FLASH_ATTENTION"] = "1"
    rng = np.random.default_rng(0)
    serve_fwd = serve(torch, np, fa, rng)
    torch.cuda.empty_cache()
    emit({"phase": "served", "elapsed_s": time.perf_counter() - t_start})
    train_launches = train(torch, np, fa, fu)
    torch.cuda.empty_cache()
    emit({"phase": "trained", "elapsed_s": time.perf_counter() - t_start})
    round_launches = ps_round(torch, np, fa, fu)

    # ---- kernels line: flash_fwd at the largest serving bucket (S=2048,
    # B=1), the others at the training shapes; launches from the main
    # paths' runs
    by_path = {name: {"serve": serve_fwd if name == "flash_fwd" else 0,
                      "train": train_launches[name],
                      "ps_round": round_launches[name]}
               for name in train_launches}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    times = {"flash_fwd": serve_t[2048], **{k: v for k, v in train_t.items()
                                            if k != "flash_fwd"}, **update_t}
    sources = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:86"),
               "flash_bwd_dq": ("flash_bwd.cu", "flash_attention.py:162"),
               "flash_bwd_dkv": ("flash_bwd.cu", "flash_attention.py:202"),
               "fused_sgd": ("fused_update.cu", "fused_update.py:42"),
               "fused_momentum": ("fused_update.cu", "fused_update.py:46"),
               "fused_adam": ("fused_update.cu", "fused_update.py:53")}
    kernels = []
    for name, (src, tpu) in sources.items():
        t = times[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"{PACKAGE}/csrc/{src}",
                 "replaces": PALLAS + tpu, "launches": launches[name],
                 "max_abs_err": max_err[name], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "launches_by_path": by_path[name]}
        kernels.append(entry)
    if any(k["launches"] <= 0 or k["launches_by_path"]["ps_round"] <= 0
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
