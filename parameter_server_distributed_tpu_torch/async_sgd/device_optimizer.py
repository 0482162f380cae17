"""Device-resident optimizers for the parameter server: the port of
``PallasOptimizer`` from
parameter_server_distributed_tpu/async_sgd/device_optimizer.py.

The optimizer keeps its slots on the card and applies updates through
the fused-update kernels (ops/fused_update.py, ``csrc/fused_update.cu``):
one launch over the whole store per apply (one per planned table where
a store outgrows one).  Slots are updated in place, the port's form of
the JAX buffer donation.  Params are never updated in place: the PS keeps
serving previously returned param dicts concurrently, and those may alias
the apply inputs, so each apply returns fresh tensors (views into one new
buffer).

``DeviceOptimizer`` (the optax family, with ``adamw_bf16``) and
``ShardedDeviceOptimizer`` are not ported yet (ROADMAP.md Queue 1,
items 3 and 5); they have no Pallas kernel.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.optimizer import HostOptimizer
from ..device import resolve_device
from ..ops import fused_update as fu


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

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        # a copy only where the array is not already contiguous, f32 and
        # writable (torch will not alias read-only memory)
        return torch.from_numpy(np.require(x, np.float32, "CW")).to(
            self.device)

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
        p = {k: self._to_device(v) for k, v in params.items()}
        g = {k: self._to_device(v) for k, v in grads.items() if k in p}
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
        out = {k: v.detach().cpu().numpy() for k, v in self._slots.items()}
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
