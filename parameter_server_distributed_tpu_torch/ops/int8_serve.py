"""int8 serving on the card: the three kernels of ``csrc/int8_serve.cu``,
each beside its plain PyTorch version.

They replace device programs of the JAX package that are XLA fusions, not
Pallas kernels, which stream only int8 bytes from device memory:

- :func:`int8_wdot` (K5): ``models/quant.py`` ``wdot`` (:106-115),
  ``y = (x @ q) * scale`` in f32 for f32 or bf16 ``x``, int8 ``q [K, N]``
  and an f32 per-channel ``scale [N]``;
- :func:`decode_attention_int8` (K6): the int8 einsums of
  ``models/generation.py`` ``decode_block`` (:224-246), one decode block's
  attention against an int8 cache layer;
- :func:`kv_quantize` (K7): ``models/generation.py`` ``_kv_quantize``
  (:79-86) with the cache writes of ``decode_block`` (:198-222), K and V
  of a block into the cache layer at contiguous or per-row positions,
  writes past ``max_len`` dropped; :func:`kv_quantize_rows` is its entry
  without a scatter, for a prefill's stacked ``[L, S, KV, D]``.

Each takes the kernel on CUDA tensors or raises (no quiet switch to the
plain version), and the plain version on CPU tensors.  Scalars enter the
plain versions as 0-dim tensors on the operand's device (a CUDA divide
by a CPU scalar multiplies by its reciprocal).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

Tensor = torch.Tensor

# kernel launches on CUDA tensors, by kernel (the CPU path and the plain
# versions never count)
launches = {"int8_wdot": 0, "decode_attention_int8": 0, "kv_quantize": 0}

KSEG = 64            # k run of one K5 fmaf chain
RUN_GROUPS = 8       # groups of K5's runs (a fixed summation order)
SKINNY_M = 16        # K5 rows up to which the skinny shape runs
# K5's kernels, as psdt_int8_wdot_shape numbers them
WDOT_SHAPES = ("skinny", "tensor_cores", "tiled")
MAXD = 256           # most head dim (K6, K7)
ATTN_THREADS = 256   # K6's block (csrc/decode_attn_plan.h)
ATTN_CHUNK = 256     # K6's positions a chunk: sums run chunk by chunk
ATTN_CLUSTER = 8     # K6's most blocks a cluster
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _scalar(value, like: Tensor) -> Tensor:
    return torch.tensor(float(value), dtype=torch.float32,
                        device=like.device)


def sqrt_head_dim(d: int) -> float:
    """The f32 divisor of the scores: the f32 square root of ``d``, as the
    reference's ``jnp.sqrt(jnp.asarray(d, jnp.float32))``."""
    return float(np.sqrt(np.float32(d)))


# ---------------------------------------------------------- plain versions
def int8_wdot_reference(x: Tensor, q: Tensor, scale: Tensor) -> Tensor:
    """``(x @ q) * scale`` in f32 (the int8 and bf16 upcasts are exact)."""
    return torch.matmul(x.float(), q.float()) * scale


def kv_rows_reference(x: Tensor) -> tuple[Tensor, Tensor]:
    """Symmetric int8 over the last axis: (int8 codes, f32 scale)."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, _scalar(1.0, x),
                        absmax / _scalar(127.0, x))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _positions(batch: int, t: int, lengths: Tensor | None, base: int,
               device) -> Tensor:
    """[B, T] cache positions of a block: ``lengths[b] + j`` (ragged) or
    ``base + j``."""
    offsets = torch.arange(t, dtype=torch.int64, device=device)
    if lengths is None:
        return (base + offsets)[None].expand(batch, t)
    return lengths.to(device=device, dtype=torch.int64)[:, None] + offsets


def kv_quantize_reference(k: Tensor, v: Tensor, qk: Tensor, qv: Tensor,
                          sk: Tensor, sv: Tensor, lengths: Tensor | None,
                          base: int) -> None:
    batch, t = k.shape[:2]
    max_len = qk.shape[1]
    pos = _positions(batch, t, lengths, base, k.device)
    keep = (pos >= 0) & (pos < max_len)
    rows = torch.arange(batch, device=k.device)[:, None].expand(batch, t)
    where = (rows[keep], pos[keep])
    for x, q_out, s_out in ((k, qk, sk), (v, qv, sv)):
        q, s = kv_rows_reference(x)
        q_out[where] = q[keep]
        s_out[where] = s[keep]


def decode_attention_int8_reference(q: Tensor, k8: Tensor, v8: Tensor,
                                    ks: Tensor, vs: Tensor,
                                    lengths: Tensor | None,
                                    base: int) -> Tensor:
    """The reference's math: f32 scores against the int8 keys, times the
    key scale, over sqrt(D), masked past each query's limit, an f32
    softmax, probabilities rounded to q's dtype and multiplied (in that
    dtype) by the value scale, the f32 product with the int8 values, cast
    to q's dtype."""
    batch, t, heads, d = q.shape
    max_len, kv = k8.shape[1], k8.shape[2]
    dtype = q.dtype
    limits = _positions(batch, t, lengths, base, q.device)
    slots = torch.arange(max_len, device=q.device)
    mask = (slots[None, None, :] <= limits[:, :, None])[:, None, None]
    qg = q.reshape(batch, t, kv, heads // kv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k8.float())
    scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores / _scalar(sqrt_head_dim(d), q)
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    probs = probs * vs.permute(0, 2, 1)[:, :, None, None, :].to(dtype)
    attn = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v8.float())
    return attn.to(dtype).reshape(batch, t, heads, d)


# ---------------------------------------------------------------- kernels
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("int8_serve")
        limits = (ctypes.c_int * 7)()
        lib.psdt_int8_serve_limits(limits)
        want = (KSEG, RUN_GROUPS, SKINNY_M, MAXD, ATTN_THREADS, ATTN_CHUNK,
                ATTN_CLUSTER)
        if tuple(limits) != want:
            raise RuntimeError(f"csrc/int8_serve.cu limits {tuple(limits)} "
                               f"differ from {want}")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.psdt_int8_wdot.argtypes = ([ptr, i32] + [ptr] * 3
                                       + [i32, i32, i32, ptr])
        lib.psdt_int8_wdot_shape.argtypes = [i32] * 4 + [ptr, ptr]
        lib.psdt_decode_attention_int8.argtypes = (
            [ptr, i32] + [ptr] * 5 + [i64, ptr] + [i32] * 6
            + [ctypes.c_float, ptr])
        lib.psdt_kv_quantize.argtypes = (
            [ptr, ptr, i32] + [ptr] * 5 + [i64] + [i32] * 5 + [ptr])
        for fn in (lib.psdt_int8_wdot, lib.psdt_int8_wdot_shape,
                   lib.psdt_decode_attention_int8, lib.psdt_kv_quantize):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _device_of(tensors: Sequence[Tensor], what: str) -> torch.device | None:
    """None when every tensor lies on the CPU; the one CUDA device
    otherwise; raises for a mix."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return None
    dev = next(iter(devices))
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"{what}: operands must lie on one cuda device (or "
                         f"all on the cpu), got {sorted(map(str, devices))}")
    return dev


def _check(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _launched(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lengths_arg(lengths: Tensor | None, dev: torch.device, batch: int,
                 what: str) -> int:
    if lengths is None:
        return 0
    _check(lengths.dtype == torch.int64 and lengths.is_contiguous()
           and lengths.shape == (batch,) and lengths.device == dev, what,
           "lengths are a contiguous int64 [B] on the operands' device")
    return lengths.data_ptr()


def int8_wdot(x: Tensor, q: Tensor, scale: Tensor) -> Tensor:
    """``x [..., K]`` (f32 or bf16) times int8 ``q [K, N]``, each column
    scaled by ``scale [N]``: an f32 ``[..., N]``."""
    k, n = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    # the decode path calls this 169 times a round: the device test is
    # kept to attribute reads
    if not (x2.is_cuda or q.is_cuda or scale.is_cuda):
        return int8_wdot_reference(x2, q, scale).reshape(*lead, n)
    dev = q.device
    _check(x2.device == dev and scale.device == dev, "int8_wdot",
           "operands must lie on one cuda device (or all on the cpu)")
    _check(x.dtype in _DTYPES and q.dtype == torch.int8
           and scale.dtype == torch.float32 and q.is_contiguous()
           and scale.is_contiguous() and scale.shape == (n,), "int8_wdot",
           "takes f32/bf16 x, a contiguous int8 [K, N] and an f32 [N] scale")
    x2 = x2.contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return y.reshape(*lead, n)
    with torch.cuda.device(dev):
        err = _lib().psdt_int8_wdot(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), q.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, k, n, _stream(dev))
    _launched(err, "int8_wdot")
    return y.reshape(*lead, n)


def int8_wdot_shape(x: Tensor, q: Tensor) -> str:
    """Which K5 kernel :func:`int8_wdot` launches for these CUDA operands:
    ``"skinny"`` (up to SKINNY_M rows), ``"tensor_cores"`` (bf16 rows
    above it whose 16-byte chunks are aligned) or ``"tiled"``."""
    k, n = q.shape
    x2 = x.reshape(-1, k).contiguous()
    shape = _lib().psdt_int8_wdot_shape(
        x2.shape[0], k, n, int(x2.dtype == torch.bfloat16), x2.data_ptr(),
        q.data_ptr())
    return WDOT_SHAPES[shape]


def decode_attention_int8(q: Tensor, k8: Tensor, v8: Tensor, ks: Tensor,
                          vs: Tensor, lengths: Tensor | None = None,
                          base: int = 0) -> Tensor:
    """Attention of a decode block ``q [B, T, H, D]`` against one int8
    cache layer (``k8``, ``v8 [B, max_len, KV, D]``, scales ``[B,
    max_len, KV]``): query ``j`` of row ``b`` sees positions up to
    ``lengths[b] + j`` (ragged) or ``base + j``.  Returns ``[B, T, H,
    D]`` in q's dtype."""
    dev = _device_of([q, k8, v8, ks, vs], "decode_attention_int8")
    if dev is None:
        return decode_attention_int8_reference(q, k8, v8, ks, vs, lengths,
                                               base)
    batch, t, heads, d = q.shape
    max_len, kv = k8.shape[1], k8.shape[2]
    what = "decode_attention_int8"
    _check(q.dtype in _DTYPES and k8.dtype == v8.dtype == torch.int8
           and ks.dtype == vs.dtype == torch.float32, what,
           "takes f32/bf16 queries, int8 K/V and f32 scales")
    _check(k8.shape == v8.shape == (batch, max_len, kv, d)
           and ks.shape == vs.shape == (batch, max_len, kv)
           and heads % kv == 0 and d % 4 == 0 and 4 <= d <= MAXD, what,
           f"shapes q {tuple(q.shape)}, cache {tuple(k8.shape)} (D a "
           f"multiple of 4 up to {MAXD})")
    _check(all(x.is_contiguous() for x in (q, k8, v8, ks, vs)), what,
           "takes contiguous tensors")
    out = torch.empty_like(q)
    lens = _lengths_arg(lengths, dev, batch, what)
    with torch.cuda.device(dev):
        err = _lib().psdt_decode_attention_int8(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k8.data_ptr(),
            v8.data_ptr(), ks.data_ptr(), vs.data_ptr(), lens, int(base),
            out.data_ptr(), batch, t, heads, kv, d, max_len,
            sqrt_head_dim(d), _stream(dev))
    _launched(err, what)
    return out


def kv_quantize(k: Tensor, v: Tensor, qk: Tensor, qv: Tensor, sk: Tensor,
                sv: Tensor, lengths: Tensor | None = None,
                base: int = 0) -> None:
    """Quantize a block's ``k``, ``v [B, T, KV, D]`` (f32 or bf16) over D
    into the cache layers ``qk``, ``qv [B, max_len, KV, D]`` (int8) and
    ``sk``, ``sv [B, max_len, KV]`` (f32) at positions ``lengths[b] + t``
    (ragged) or ``base + t``, in place; positions past ``max_len`` are
    dropped."""
    dev = _device_of([k, v, qk, qv, sk, sv], "kv_quantize")
    if dev is None:
        kv_quantize_reference(k, v, qk, qv, sk, sv, lengths, base)
        return
    batch, t, kv, d = k.shape
    max_len = qk.shape[1]
    what = "kv_quantize"
    _check(k.dtype == v.dtype and k.dtype in _DTYPES
           and qk.dtype == qv.dtype == torch.int8
           and sk.dtype == sv.dtype == torch.float32, what,
           "takes f32/bf16 K/V into int8 codes and f32 scales")
    _check(v.shape == k.shape and qk.shape == qv.shape == (batch, max_len,
                                                           kv, d)
           and sk.shape == sv.shape == (batch, max_len, kv) and d <= MAXD,
           what, f"shapes k {tuple(k.shape)}, cache {tuple(qk.shape)}")
    _check(all(x.is_contiguous() for x in (k, v, qk, qv, sk, sv)), what,
           "takes contiguous tensors")
    lens = _lengths_arg(lengths, dev, batch, what)
    with torch.cuda.device(dev):
        err = _lib().psdt_kv_quantize(
            k.data_ptr(), v.data_ptr(), int(k.dtype == torch.bfloat16),
            qk.data_ptr(), qv.data_ptr(), sk.data_ptr(), sv.data_ptr(), lens,
            int(base), batch, t, kv, d, max_len, _stream(dev))
    _launched(err, what)


def kv_quantize_rows(k: Tensor, v: Tensor
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The entry without a scatter: ``k``, ``v [N, S, KV, D]`` (a
    prefill's layers, stacked) to fresh ``(k8, v8, k_scale, v_scale)``,
    codes ``[N, S, KV, D]`` and scales ``[N, S, KV]``; one launch."""
    codes = [torch.empty(k.shape, dtype=torch.int8, device=k.device)
             for _ in range(2)]
    scales = [torch.empty(k.shape[:-1], dtype=torch.float32,
                          device=k.device) for _ in range(2)]
    kv_quantize(k, v, *codes, *scales)
    return codes[0], codes[1], scales[0], scales[1]
