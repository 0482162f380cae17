"""Device-resident optimizers for the parameter server: the port of
``PallasOptimizer`` and ``DeviceOptimizer`` from
parameter_server_distributed_tpu/async_sgd/device_optimizer.py.

Both keep their slots on their device (the card unless the caller asks
for the CPU), update them in place (the port's form of the JAX buffer
donation) and never update params in place: the PS keeps serving
previously returned param dicts concurrently, and those may alias the
apply inputs, so each apply returns fresh tensors.  Both take numpy
arrays or tensors and return tensors on their device; their
``state_dict`` is numpy, downloaded through ``core.tensor.to_host``.

- ``PallasOptimizer`` applies through the fused-update kernels
  (ops/fused_update.py, ``csrc/fused_update.cu``): one launch over the
  whole store per apply (one per planned table where a store outgrows
  one), the fresh params views into one new buffer.
- ``DeviceOptimizer`` is the optax family (sgd, momentum, adam, adamw
  and ``adamw_bf16``) in plain torch on the device, tensor by tensor,
  with optax's formulas.  The reference has no Pallas kernel for it.

``ShardedDeviceOptimizer`` is not ported yet (ROADMAP.md Queue 1,
item 5).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.optimizer import HostOptimizer
from ..core.tensor import state_to_host
from ..device import resolve_device
from ..ops import fused_update as fu


def _to_device(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    # a copy only where the array is not already contiguous, f32 and
    # writable (torch will not alias read-only memory)
    return torch.from_numpy(np.require(x, np.float32, "CW")).to(device)


class PallasOptimizer(HostOptimizer):
    """Device-resident PS optimizer on the fused-update kernels.  Rules
    ``sgd``, ``momentum`` and ``adam``; ``step`` counts applies, and
    Adam's per-step bias corrections ride in as kernel arguments, so
    stepping never rebuilds anything.  ``device`` defaults to the card."""

    # one apply walks the whole store; not name-sliceable
    supports_striping = False

    RULES = ("sgd", "momentum", "adam")

    def __init__(self, rule: str = "sgd", learning_rate: float = 1.0,
                 momentum: float = 0.9, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, device=None):
        super().__init__(learning_rate)
        if rule not in self.RULES:
            raise ValueError(f"unknown pallas rule {rule!r}; options "
                             f"{self.RULES}")
        self.rule = rule
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps
        self.device = resolve_device(device)
        self._slots: dict[str, torch.Tensor] = {}   # vel/<n>, m/<n>, v/<n>
        self.step = 0

    def _slot(self, kind: str, name: str, like: torch.Tensor) -> torch.Tensor:
        """The slot ``kind/name``, zeros (a buffer of its own) the first
        time."""
        key = f"{kind}/{name}"
        if key not in self._slots:
            self._slots[key] = torch.zeros_like(like)
        return self._slots[key]

    def apply(self, params: Mapping, grads: Mapping) -> dict:
        """params and grads (numpy arrays or tensors) -> fresh param
        tensors on this optimizer's device."""
        p = {k: _to_device(v, self.device) for k, v in params.items()}
        g = {k: _to_device(v, self.device) for k, v in grads.items()
             if k in p}
        self.step += 1
        lr = self.learning_rate
        if self.rule == "sgd":
            return fu.fused_sgd(p, g, lr)
        if self.rule == "momentum":
            vel = {k: self._slot("vel", k, x) for k, x in p.items()}
            new_p, _ = fu.fused_momentum(p, g, vel, lr, self.momentum)
            return new_p
        m = {k: self._slot("m", k, x) for k, x in p.items()}
        v = {k: self._slot("v", k, x) for k, x in p.items()}
        new_p, _, _ = fu.fused_adam(p, g, m, v, self.step, lr, self.b1,
                                    self.b2, self.eps)
        return new_p

    def state_dict(self) -> dict:
        """Slots and step as numpy, in the JAX package's layout, so a
        checkpoint moves between the two optimizers."""
        return state_to_host(self.state_snapshot())

    def state_snapshot(self) -> dict:
        out: dict = {k: t.clone() for k, t in self._slots.items()}
        if self.step:
            out["step"] = np.asarray([self.step], np.int64)
        return out

    def load_state_dict(self, state: dict) -> None:
        state = dict(state or {})
        step = state.pop("step", None)
        self.step = int(np.asarray(step)[0]) if step is not None else 0
        self._slots = {k: torch.from_numpy(
            np.array(v, np.float32)).to(self.device)
            for k, v in state.items()}


def stochastic_round_bf16(x: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """Unbiased f32 -> bf16 rounding: add 16 uniform random bits to the
    16 bits being dropped, then truncate.  A carry out of the low half
    rounds up to the next bf16 with probability equal to the dropped
    fraction, so E[result] == x and a slow EMA keeps moving where
    round-to-nearest would freeze it below bf16's half-ulp.  The int32
    add wraps like the reference's uint32 one, and the arithmetic shift
    leaves the top 16 bits as a signed 16-bit value, the bf16 pattern.
    Inputs are finite (EMAs of finite gradients)."""
    bits = x.float().contiguous().view(torch.int32)
    noise = torch.randint(0, 1 << 16, bits.shape, generator=generator,
                          device=bits.device, dtype=torch.int32)
    return ((bits + noise) >> 16).to(torch.int16).view(torch.bfloat16)


class DeviceOptimizer(HostOptimizer):
    """The optax update rules on the device, in plain torch: ``sgd``,
    ``momentum`` (optax.sgd with a trace), ``adam``, ``adamw`` (decay on
    params of 2 or more dimensions) and ``adamw_bf16`` (AdamW with both
    moments carried in bf16 through :func:`stochastic_round_bf16`, half
    the slot memory; all arithmetic in f32).  The rounding bits come from
    an explicit generator (seed 0, as the reference's key), saved in the
    state.  Build one with the class methods; ``device`` defaults to the
    card."""

    # the whole store per apply, not name-sliceable
    supports_striping = False

    RULES = ("sgd", "momentum", "adam", "adamw", "adamw_bf16")

    def __init__(self, rule: str = "sgd", learning_rate: float = 1.0,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 device=None):
        super().__init__(learning_rate)
        if rule not in self.RULES:
            raise ValueError(f"unknown device rule {rule!r}; options "
                             f"{self.RULES}")
        self.rule = rule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.device = resolve_device(device)
        self.count = 0
        # slot kind ("trace", or "mu" and "nu") -> name -> tensor
        self._slots: dict[str, dict[str, torch.Tensor]] = {}
        self._generator = (torch.Generator(device=self.device)
                           .manual_seed(0)
                           if rule == "adamw_bf16" else None)

    @classmethod
    def sgd(cls, learning_rate: float = 1.0, device=None):
        return cls("sgd", learning_rate, device=device)

    @classmethod
    def momentum(cls, learning_rate: float = 1.0, momentum: float = 0.9,
                 device=None):
        return cls("momentum", learning_rate, momentum=momentum,
                   device=device)

    @classmethod
    def adam(cls, learning_rate: float = 1e-3, device=None):
        return cls("adam", learning_rate, device=device)

    @classmethod
    def adamw(cls, learning_rate: float = 1e-3, weight_decay: float = 1e-4,
              device=None):
        return cls("adamw", learning_rate, weight_decay=weight_decay,
                   device=device)

    @classmethod
    def adamw_bf16(cls, learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4, device=None):
        return cls("adamw_bf16", learning_rate, weight_decay=weight_decay,
                   device=device)

    def _slot(self, kind: str, name: str, like: torch.Tensor) -> torch.Tensor:
        slots = self._slots.setdefault(kind, {})
        if name not in slots:
            slots[name] = torch.zeros_like(
                like, dtype=(torch.bfloat16 if self.rule == "adamw_bf16"
                             else torch.float32))
        return slots[name]

    def _direction(self, name: str, p: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
        """The update before the -lr scale: g, the trace, or the Adam term
        (plus the masked decay)."""
        if self.rule == "sgd":
            return g
        if self.rule == "momentum":
            trace = self._slot("trace", name, p)
            trace.copy_(g + self.momentum * trace)
            return trace
        m, v = self._slot("mu", name, p), self._slot("nu", name, p)
        mu = (1.0 - self.b1) * g + self.b1 * m.float()
        nu = (1.0 - self.b2) * (g * g) + self.b2 * v.float()
        bc1, bc2 = fu.bias_corrections(self.count, self.b1, self.b2)
        out = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if self.rule == "adamw_bf16":
            m.copy_(stochastic_round_bf16(mu, self._generator))
            v.copy_(stochastic_round_bf16(nu, self._generator))
        else:
            m.copy_(mu)
            v.copy_(nu)
        if self.rule != "adam" and p.dim() >= 2:
            out = out + self.weight_decay * p
        return out

    def apply(self, params: Mapping, grads: Mapping) -> dict:
        """params and grads (numpy arrays or tensors) -> fresh param
        tensors on this optimizer's device; a param with no gradient
        takes a zero one, as the reference's does."""
        self.count += 1
        out = {}
        with torch.no_grad():
            for name, value in params.items():
                p = _to_device(value, self.device)
                g = (_to_device(grads[name], self.device) if name in grads
                     else torch.zeros_like(p))
                out[name] = p + (-self.learning_rate) * self._direction(
                    name, p, g)
        return out

    def state_dict(self) -> dict:
        """``count``, each slot kind as {name: f32 numpy} (bf16 slots
        widened exactly) and, for ``adamw_bf16``, the generator's state
        as ``rng``; {} before the first apply.  Not the reference's
        layout: its state is a pickled optax tree, which torch cannot
        rebuild."""
        return state_to_host(self.state_snapshot())

    def state_snapshot(self) -> dict:
        if not self.count:
            return {}
        out: dict = {"count": self.count}
        for kind, slots in self._slots.items():
            out[kind] = {n: t.clone() for n, t in slots.items()}
        if self._generator is not None:
            out["rng"] = self._generator.get_state().numpy().copy()
        return out

    def load_state_dict(self, state: dict) -> None:
        if state and "pickle" in state:
            raise ValueError(
                "this optimizer state is the JAX package's DeviceOptimizer "
                "state (a pickled optax tree); the port cannot load it — "
                "restore the params and start the optimizer afresh")
        state = dict(state or {})
        self.count = int(state.pop("count", 0))
        rng = state.pop("rng", None)
        if rng is not None and self._generator is not None:
            self._generator.set_state(torch.from_numpy(
                np.asarray(rng, np.uint8).copy()))
        dtype = (torch.bfloat16 if self.rule == "adamw_bf16"
                 else torch.float32)
        self._slots = {kind: {name: torch.from_numpy(
            np.array(value, np.float32)).to(self.device, dtype)
            for name, value in slots.items()}
            for kind, slots in state.items()}
