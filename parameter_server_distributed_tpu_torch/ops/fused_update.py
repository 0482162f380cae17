"""Fused optimizer updates: the port of
parameter_server_distributed_tpu/ops/pallas/fused_update.py.

``fused_sgd``, ``fused_momentum`` and ``fused_adam`` take dicts of float32
tensors keyed by parameter name and run one pass per tensor.  On a CUDA
tensor each launches its hand-written Hopper kernel
(``csrc/fused_update.cu``) or raises; on a CPU tensor it runs the plain
PyTorch version beside it (:func:`sgd_reference`,
:func:`momentum_reference`, :func:`adam_reference`).  Params come back as
fresh tensors; the slots (velocity, m, v) are updated in place, which is
what the JAX package's buffer donation does.  Adam's bias corrections are
computed in f32 each step and passed as runtime kernel arguments, so
stepping never rebuilds or re-specialises anything.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import numpy as np
import torch

Tensor = torch.Tensor

# kernel launches on CUDA tensors, by kernel (the CPU path and the plain
# versions never count)
launches = {"fused_sgd": 0, "fused_momentum": 0, "fused_adam": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sgd_reference(p: Tensor, g: Tensor, lr: float) -> Tensor:
    """p - lr*g."""
    return p - lr * g


def momentum_reference(p: Tensor, g: Tensor, vel: Tensor, lr: float,
                       mu: float) -> Tensor:
    """vel <- mu*vel + g (in place); returns p - lr*vel."""
    vel.copy_(mu * vel + g)
    return p - lr * vel


def adam_reference(p: Tensor, g: Tensor, m: Tensor, v: Tensor, lr: float,
                   b1: float, b2: float, eps: float, bc1: float,
                   bc2: float) -> Tensor:
    """m <- b1*m + (1-b1)*g and v <- b2*v + (1-b2)*g*g (in place); returns
    p - lr*(m/bc1)/(sqrt(v/bc2) + eps)."""
    m.copy_(b1 * m + (1.0 - b1) * g)
    v.copy_(b2 * v + (1.0 - b2) * g * g)
    return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)


def bias_corrections(step: int, b1: float, b2: float) -> tuple[float, float]:
    """(1 - b1^step, 1 - b2^step) computed in f32, as the JAX kernel's
    SMEM scalars are."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** t),
            float(one - np.float32(b2) ** t))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import build

        lib = build.load("fused_update")
        ptr, n, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.psdt_fused_sgd.argtypes = [ptr] * 3 + [n, f32, ptr]
        lib.psdt_fused_momentum.argtypes = [ptr] * 4 + [n, f32, f32, ptr]
        lib.psdt_fused_adam.argtypes = [ptr] * 5 + [n] + [f32] * 8 + [ptr]
        for fn in (lib.psdt_fused_sgd, lib.psdt_fused_momentum,
                   lib.psdt_fused_adam):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _update(name: str, p: Tensor, g: Tensor, slots: tuple[Tensor, ...],
            scalars: tuple[float, ...], reference,
            kernel_extra: tuple[float, ...] = ()) -> Tensor:
    """One tensor's update: the plain version on the CPU, the kernel on
    the card (which takes ``scalars`` then ``kernel_extra``)."""
    if p.device.type == "cpu":
        return reference(p, g, *slots, *scalars)
    if p.device.type != "cuda":
        raise ValueError(f"fused updates run on cuda or cpu, not {p.device}")
    for x in (p, g, *slots):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {x.dtype}")
        if x.device != p.device or x.numel() != p.numel():
            raise ValueError(f"{name}: operands must be {p.numel()} "
                             f"elements on {p.device}")
    if any(not s.is_contiguous() for s in slots):
        raise ValueError(f"{name} updates its slots in place: they must be "
                         f"contiguous")
    p, g = p.contiguous(), g.contiguous()
    out = torch.empty_like(p)
    fn = getattr(_lib(), f"psdt_{name}")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), *(s.data_ptr() for s in slots),
                 out.data_ptr(), p.numel(), *scalars, *kernel_extra, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    return out


def fused_sgd(params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
              lr: float) -> dict[str, Tensor]:
    """param <- param - lr * grad, one fused pass per tensor; params with
    no gradient pass through."""
    return {name: (_update("fused_sgd", p, grads[name], (), (float(lr),),
                           sgd_reference) if name in grads else p)
            for name, p in params.items()}


def fused_momentum(params: Mapping[str, Tensor],
                   grads: Mapping[str, Tensor],
                   velocity: Mapping[str, Tensor], lr: float,
                   mu: float = 0.9) -> tuple[dict, dict]:
    """Fused momentum SGD: returns (new_params, velocity), the velocity
    tensors updated in place."""
    new_p = {}
    for name, p in params.items():
        if name not in grads:
            new_p[name] = p
            continue
        new_p[name] = _update("fused_momentum", p, grads[name],
                              (velocity[name],), (float(lr), float(mu)),
                              momentum_reference)
    return new_p, {name: velocity.get(name) for name in params}


def fused_adam(params: Mapping[str, Tensor], grads: Mapping[str, Tensor],
               m: Mapping[str, Tensor], v: Mapping[str, Tensor], step: int,
               lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> tuple[dict, dict, dict]:
    """Fused Adam: returns (new_params, m, v), the moment tensors updated
    in place.  ``step`` is 1-based; its bias corrections enter each launch
    as runtime scalars."""
    scalars = (float(lr), float(b1), float(b2), float(eps),
               *bias_corrections(step, b1, b2))
    # the kernel also takes 1-b1 and 1-b2, rounded to f32 once as the
    # plain version's scalar products round them
    extra = (1.0 - b1, 1.0 - b2)
    new_p = {}
    for name, p in params.items():
        if name not in grads:
            new_p[name] = p
            continue
        new_p[name] = _update("fused_adam", p, grads[name],
                              (m[name], v[name]), scalars, adam_reference,
                              extra)
    return (new_p, {name: m.get(name) for name in params},
            {name: v.get(name) for name in params})
