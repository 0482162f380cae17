"""Causal flash attention, forward: the port of
parameter_server_distributed_tpu/ops/pallas/flash_attention.py.

``_flash_fwd`` keeps the JAX layouts: q [BH, S_q, D], k/v [BH, S, D] ->
(o [BH, S_q, D] in the input type, lse [BH, 1, S_q] f32).  On a CUDA
tensor it launches the hand-written Hopper kernel ``csrc/flash_fwd.cu``
or raises; on a CPU tensor it runs :func:`flash_fwd_reference`, the plain
PyTorch version of the same function.  There is no other fallback, and
the JAX functions' ``interpret`` argument has no counterpart: the
tensor's device picks the path.

The backward kernels (dQ and dK/dV) belong to the training slice; a CUDA
input that requires grad raises until they land.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# kernel launches through _flash_fwd on CUDA tensors (the CPU path and
# flash_fwd_reference never count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("flash_fwd")
        lib.psdt_flash_fwd.argtypes = ([ctypes.c_void_p] * 5
                                       + [ctypes.c_int] * 5
                                       + [ctypes.c_float, ctypes.c_void_p])
        lib.psdt_flash_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _flash_fwd_cuda(q, k, v, seg: int):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention backward is not ported yet: it lands with the "
            "training slice (ROADMAP.md Queue 1, the transformer worker "
            "with the flash backward kernels); run the forward under "
            "torch.inference_mode()")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    bh, sq, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.psdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, sq // seg, seg, d,
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return o, lse


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               block_q: int, block_k: int,
               bps: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """q [BH, S_q, D], k/v [BH, S, D] -> (o [BH, S_q, D], lse [BH, 1, S_q]).

    ``bps`` = q blocks per segment, as in the JAX ``_flash_fwd``: under
    the GQA fold S_q is G segments of ``bps * block_q`` rows; 0 means one
    segment.  ``block_q``/``block_k`` are the divisibility contract of the
    callers; the CUDA kernel picks its own tiles."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    seg = (bps or sq // block_q) * block_q
    if sk != seg or sq % seg or k.shape != v.shape or k.shape[0] != bh:
        raise ValueError(f"flash shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fold "
                         f"into segments of {seg} rows")
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, seg)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_fwd_cuda(q, k, v, seg)


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
    models.transformer.causal_attention)."""
    b, s, h, d = q.shape
    block_q, block_k = _check_blocks(s, block_q, block_k)

    def fold(x):  # [B,S,H,D] -> [B*H, S, D]
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d)

    out, _ = _flash_fwd(fold(q), fold(k), fold(v), block_q, block_k)
    return out.reshape(b, h, s, d).permute(0, 2, 1, 3)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_q: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """Causal flash attention with unexpanded GQA K/V: q [B, S, H, D],
    k/v [B, S, KV, D] -> [B, S, H, D].  The G query heads of each kv head
    fold into the q-rows axis (q [B*KV, G*S, D] against k/v [B*KV, S, D]),
    so K/V are read kv_heads-sized and never repeated."""
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

    out, _ = _flash_fwd(qf, fold_kv(k), fold_kv(v), block_q, block_k,
                        s // block_q)
    out = out.reshape(b, kv, groups, s, d)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
