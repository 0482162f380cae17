"""Causal flash attention, forward and backward: the port of
parameter_server_distributed_tpu/ops/pallas/flash_attention.py.

``_flash_fwd`` keeps the JAX layouts: q [BH, S_q, D], k/v [BH, S, D] ->
(o [BH, S_q, D] in the input type, lse [BH, 1, S_q] f32).  ``_flash_bwd``
takes those plus the output gradient dO and returns (dq, dk, dv) in the
input types, dk/dv K/V-sized.  On a CUDA tensor each launches its
hand-written Hopper kernels (``csrc/flash_fwd.cu``; ``csrc/flash_bwd.cu``
for dQ and dK/dV) or raises; on a CPU tensor it runs
:func:`flash_fwd_reference` / :func:`flash_bwd_reference`, the plain
PyTorch versions of the same functions.  There is no other fallback, and
the JAX functions' ``interpret`` argument has no counterpart: the
tensor's device picks the path.

What the kernels compute in each type.  f32 inputs take CUDA-core
kernels whose products are f32 throughout.  bf16 inputs take tensor-core
kernels for the forward, dQ and dK/dV (``csrc/flash_mma.cuh``): the score
products QK^T and dO V^T are exact products of the bf16 inputs summed in
f32; the forward rounds P to bf16 before P V; the backward kernels split
P and dS into bf16 hi + lo parts (lo = bf16(x - hi)) and run each of
dS K, P^T dO and dS^T Q as two products, which keeps them to ~2^-17 of
the f32 values.  Softmax statistics, lse and delta are f32; each output
is rounded once to bf16.  The kernels take contiguous
operands whose data pointers are 16-byte aligned (their tile copies move
16 bytes a thread) and refuse others.

:class:`_Flash` takes the place of the JAX ``custom_vjp``: it saves only
q, k, v, o and lse, and its backward is the two backward kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# kernel launches on CUDA tensors, by kernel (the CPU path and the plain
# versions never count)
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch causal attention with the kernel's arithmetic: q
    scaled by 1/sqrt(D) in f32, f32 scores with masked entries at -1e30,
    f32 softmax, o in the input type and lse = m + log(max(l, 1e-30)).
    The q-rows axis holds ``S_q // seg`` segments of ``seg`` rows, each
    causal from its own first row against the same k/v."""
    bh, sq, d = q.shape
    groups = sq // seg
    qf = q.float().reshape(bh, groups, seg, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bgqd,bkd->bgqk", qf, k.float())
    mask = torch.ones(seg, seg, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float()) / l
    lse = (m + torch.log(l)).reshape(bh, 1, sq)
    return o.reshape(bh, sq, d).to(q.dtype), lse


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        seg: int) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch flash backward with the kernels' arithmetic, in f32:
    P = exp(s*scale - lse) recomputed from lse and masked to 0; delta =
    rowsum(dO*O); dS = P*(dO V^T - delta); dq = scale*dS K; dv = P^T dO and
    dk = scale*dS^T Q, each summed over the ``S_q // seg`` segments (the
    GQA group sum).  Returns (dq, dk, dv) in the input types."""
    bh, sq, d = q.shape
    groups = sq // seg
    scale = 1.0 / math.sqrt(d)

    def rows(x):  # [BH, G*S, D] -> [BH, G, S, D] in f32
        return x.float().reshape(bh, groups, seg, d)

    qf, of, dof = rows(q), rows(o), rows(do)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bgqd,bkd->bgqk", qf, kf) * scale
    mask = torch.ones(seg, seg, dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s.masked_fill(~mask, NEG_INF)
                  - lse.reshape(bh, groups, seg, 1)).masked_fill(~mask, 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bgqd,bkd->bgqk", dof, vf) - delta)
    dq = torch.einsum("bgqk,bkd->bgqd", ds, kf) * scale
    dk = torch.einsum("bgqk,bgqd->bkd", ds, qf) * scale
    dv = torch.einsum("bgqk,bgqd->bkd", p, dof)
    return dq.reshape(bh, sq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_LIBS: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        from . import build

        lib = build.load(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_fwd":
            lib.psdt_flash_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [f32, ptr]
            lib.psdt_flash_fwd.restype = i32
        else:
            lib.psdt_flash_bwd_dq.argtypes = ([ptr] * 7 + [i32] * 5
                                              + [f32, ptr])
            lib.psdt_flash_bwd_dkv.argtypes = ([ptr] * 8 + [i32] * 5
                                               + [f32, ptr])
            lib.psdt_flash_bwd_dq.restype = i32
            lib.psdt_flash_bwd_dkv.restype = i32
        _LIBS[name] = lib
    return lib


def _check_cuda(*xs: torch.Tensor) -> None:
    """The kernels' contract: one CUDA device, f32 or bf16 throughout,
    head_dim 64 or 128."""
    q = xs[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if any(x.dtype != q.dtype for x in xs):
        raise TypeError(f"flash dtypes differ: "
                        f"{[str(x.dtype) for x in xs]}")
    if any(x.device != q.device for x in xs):
        raise ValueError("flash operands must lie on one device")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, "
                         f"got {q.shape[-1]}")


def _check_aligned(*xs: torch.Tensor) -> None:
    """The kernels copy tiles 16 bytes a thread: every operand's data
    pointer must be 16-byte aligned (a view at an odd offset is not)."""
    bad = [i for i, x in enumerate(xs) if x.data_ptr() % 16]
    if bad:
        raise ValueError(f"flash operands {bad} are not 16-byte aligned")


def _launch(fn, name: str, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _flash_fwd_cuda(q, k, v, seg: int):
    _check_cuda(q, k, v)
    bh, sq, d = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=q.device)
    _launch(_lib("flash_fwd").psdt_flash_fwd, "flash_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq // seg, seg, d,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            device=q.device)
    return o, lse


def _bwd_args(q, k, v, o, lse, do, seg: int) -> tuple[list, tuple]:
    """The backward kernels' inputs as contiguous tensors in the C order
    (q, k, v, o, dO, lse), and their shape arguments."""
    _check_cuda(q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise TypeError("flash lse must be float32 on the operands' device")
    bh, sq, d = q.shape
    ins = [x.contiguous() for x in (q, k, v, o, do, lse)]
    _check_aligned(*ins)
    return ins, (bh, sq // seg, seg, d, int(q.dtype == torch.bfloat16),
                 1.0 / math.sqrt(d))


def _flash_bwd_dq_cuda(q, k, v, o, lse, do, seg: int) -> torch.Tensor:
    """dQ through ``csrc/flash_bwd.cu``'s dQ kernel."""
    ins, shape = _bwd_args(q, k, v, o, lse, do, seg)
    dq = torch.empty_like(ins[0])
    _launch(_lib("flash_bwd").psdt_flash_bwd_dq, "flash_bwd_dq",
            *(x.data_ptr() for x in ins), dq.data_ptr(), *shape,
            device=q.device)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, o, lse, do, seg: int):
    """(dK, dV) through ``csrc/flash_bwd.cu``'s dK/dV kernel."""
    ins, shape = _bwd_args(q, k, v, o, lse, do, seg)
    dk, dv = torch.empty_like(ins[1]), torch.empty_like(ins[2])
    _launch(_lib("flash_bwd").psdt_flash_bwd_dkv, "flash_bwd_dkv",
            *(x.data_ptr() for x in ins), dk.data_ptr(), dv.data_ptr(),
            *shape, device=q.device)
    return dk, dv


def _segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             block_q: int, bps: int) -> int:
    """Rows per causal segment of the q-rows axis (``bps`` q blocks per
    segment, 0 = one segment), after checking the shapes fold into it."""
    bh, sq, _ = q.shape
    seg = (bps or sq // block_q) * block_q
    if (k.shape[1] != seg or sq % seg or k.shape != v.shape
            or k.shape[0] != bh):
        raise ValueError(f"flash shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fold "
                         f"into segments of {seg} rows")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return seg


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int, block_k: int,
               bps: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [BH, S_q, D], k/v [BH, S, D] -> (o [BH, S_q, D], lse [BH, 1, S_q]).

    ``bps`` = q blocks per segment, as in the JAX ``_flash_fwd``: under
    the GQA fold S_q is G segments of ``bps * block_q`` rows; 0 means one
    segment.  ``block_q``/``block_k`` are the divisibility contract of the
    callers; the CUDA kernel picks its own tiles."""
    seg = _segment(q, k, v, block_q, bps)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, seg)
    return _flash_fwd_cuda(q, k, v, seg)


def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
               block_q: int, block_k: int,
               bps: int = 0) -> tuple[torch.Tensor, ...]:
    """The JAX ``_flash_bwd``: (q, k, v, o, lse, dO) in the
    :func:`_flash_fwd` layouts -> (dq [BH, S_q, D], dk, dv [BH, S, D]),
    with the G segments' contributions summed into dk/dv."""
    seg = _segment(q, k, v, block_q, bps)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, seg)
    return (_flash_bwd_dq_cuda(q, k, v, o, lse, do, seg),
            *_flash_bwd_dkv_cuda(q, k, v, o, lse, do, seg))


class _Flash(torch.autograd.Function):
    """Causal flash attention with the flash backward: the port of the
    JAX ``custom_vjp`` ``_flash``.  Saves q, k, v, o and lse only."""

    @staticmethod
    def forward(ctx, q, k, v, block_q: int, block_k: int, bps: int):
        o, lse = _flash_fwd(q, k, v, block_q, block_k, bps)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (block_q, block_k, bps)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.blocks)
        return dq, dk, dv, None, None, None


def _check_blocks(s: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"seq len {s} must divide by blocks "
                         f"({block_q}, {block_k})")
    return block_q, block_k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Causal flash attention, [B, S, H, D] -> [B, S, H, D] (drop-in for
    models.transformer.causal_attention), differentiable."""
    b, s, h, d = q.shape
    block_q, block_k = _check_blocks(s, block_q, block_k)

    def fold(x):  # [B,S,H,D] -> [B*H, S, D]
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

    out = _Flash.apply(fold(q), fold(k), fold(v), block_q, block_k, 0)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """Causal flash attention with unexpanded GQA K/V: q [B, S, H, D],
    k/v [B, S, KV, D] -> [B, S, H, D].  The G query heads of each kv head
    fold into the q-rows axis (q [B*KV, G*S, D] against k/v [B*KV, S, D]),
    so K/V are read kv_heads-sized and never repeated, and their gradients
    come back kv_heads-sized with the group sum built in."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError(f"query heads {h} must divide by kv heads {kv}")
    groups = h // kv
    if groups == 1:
        return flash_attention(q, k, v, block_q, block_k)
    block_q, block_k = _check_blocks(s, block_q, block_k)
    # head h = kv_head * G + group (repeat_kv convention)
    qf = q.reshape(b, s, kv, groups, d).permute(0, 2, 3, 1, 4).reshape(
        b * kv, groups * s, d)

    def fold_kv(x):  # [B,S,KV,D] -> [B*KV, S, D]
        return x.permute(0, 2, 1, 3).reshape(b * kv, s, d)

    out = _Flash.apply(qf, fold_kv(k), fold_kv(v), block_q, block_k,
                       s // block_q)
    out = out.reshape(b, kv, groups, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
