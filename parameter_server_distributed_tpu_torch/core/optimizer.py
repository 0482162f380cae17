"""Optimizers of the parameter server: the port's copy of
parameter_server_distributed_tpu/core/optimizer.py.

``HostOptimizer`` is the protocol ``ParameterServerCore`` calls.  The
host optimizers (``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Lion``)
apply their rule over float32 numpy stores.  Where the reference calls
its C++ library (``SGD``, ``Momentum``, ``Adam``, ``AdamW``) the port
calls its own copy of it (native/), and where the reference falls back
to numpy the port does too: the numpy paths are the reference's
sequences, one ufunc per operation in the same order and with the same
f32 scalars, so each path is bit for bit the reference's same path.  The
native Adam multiplies ``(1-b2)*g*g`` where numpy takes ``g*g*(1-b2)``,
as the reference's two paths do.  Outputs are fresh arrays (served param
dicts hold the old ones); slots update in place.

Striping: optimizer state is keyed per tensor name, so the striped
barrier close calls :meth:`HostOptimizer.tick` once per logical step and
then :meth:`HostOptimizer.apply_shard` concurrently over disjoint name
subsets.  The device optimizers (async_sgd/device_optimizer.py) apply
the whole store at once and leave ``supports_striping`` False.

:func:`make_optimizer` selects by name: plain names are the host
optimizers, ``pallas_<rule>`` the fused-update kernels
(``PallasOptimizer``), ``device_<rule>`` the optax rules in torch
(``DeviceOptimizer``).  When the card an accelerator optimizer needs is
absent, it degrades to the matching host optimizer and counts
``ps.apply.device_fallback``; an unknown rule raises.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np

from ..native import (adam_native, adamw_native, momentum_native,
                      sgd_native)
from ..native import lib as native_lib
from ..obs import stats as obs_stats

log = logging.getLogger("pst.optimizer")

# where each unported family is planned
ROADMAP_SHARDED = "ROADMAP.md Queue 1, item 5 (sharded device apply)"


class HostOptimizer:
    """Stateful optimizer over a named-tensor store."""

    #: True when state is per-tensor-name and :meth:`apply_shard` may run
    #: concurrently over disjoint name subsets (the striped PS hot path).
    supports_striping = False

    def __init__(self, learning_rate: float = 1.0):
        self.learning_rate = learning_rate

    def tick(self) -> None:
        """Advance per-logical-step state (Adam's bias-correction step
        counter) once per barrier apply.  The striped closer calls
        ``tick()`` once, then ``apply_shard()`` per stripe; calling
        :meth:`apply` does both."""

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        """Apply the update rule to a (sub)store without advancing the
        step counter.  Same-name slot state updates in place; returned
        params are fresh."""
        raise NotImplementedError

    def apply(self, params: Mapping, grads: Mapping) -> dict:
        self.tick()
        return self.apply_shard(params, grads)

    def state_dict(self) -> dict:
        return {}

    def state_snapshot(self) -> dict:
        """The state in :meth:`state_dict`'s layout, copied so that no
        later apply reaches it, and cheap enough to take under the PS
        core's locks: a device optimizer copies its slots on its device
        and leaves the download to ``core.tensor.state_to_host``.  A host
        optimizer's ``state_dict`` is such a copy already."""
        return self.state_dict()

    def load_state_dict(self, state: dict) -> None:
        pass


def _owned_f32(a) -> np.ndarray:
    """A contiguous writable float32 slot, copied only where the stored
    array is not one already (e.g. right after a checkpoint load)."""
    out = np.asarray(a, np.float32)
    if not (out.flags.c_contiguous and out.flags.writeable):
        out = np.array(out, np.float32)
    return out


class SGD(HostOptimizer):
    """param -= lr * grad."""

    supports_striping = True

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        lr = np.float32(self.learning_rate)
        use_native = native_lib() is not None
        out = {}
        for name, p in params.items():
            p = np.asarray(p, np.float32)
            if name not in grads:
                out[name] = p
                continue
            g = np.asarray(grads[name], np.float32)
            if use_native:
                p_new = np.array(p, np.float32)   # a fresh contiguous copy
                if sgd_native(p_new, g, float(lr)):
                    out[name] = p_new
                    continue
            out[name] = np.subtract(p, np.multiply(g, lr))
        return out


class Momentum(HostOptimizer):
    """v = mu*v + g (v = g on the first step); param -= lr * v."""

    supports_striping = True

    def __init__(self, learning_rate: float = 1.0, momentum: float = 0.9):
        super().__init__(learning_rate)
        self.momentum = momentum
        self.velocity: dict[str, np.ndarray] = {}

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        lr = np.float32(self.learning_rate)
        mu = np.float32(self.momentum)
        use_native = native_lib() is not None
        out = {}
        for name, p in params.items():
            p = np.asarray(p, np.float32)
            if name not in grads:
                out[name] = p
                continue
            g = np.asarray(grads[name], np.float32)
            v = self.velocity.get(name)
            if use_native:
                # fresh params (served dicts hold the old ones); the
                # velocity updates in place (state_dict copies it)
                p_new = np.array(p, np.float32)
                v_new = _owned_f32(v) if v is not None else np.zeros_like(g)
                if momentum_native(p_new, g, v_new, float(lr), float(mu)):
                    self.velocity[name] = v_new
                    out[name] = p_new
                    continue
            if v is None:
                # an owned copy: the slot updates in place from now on
                v = np.array(g, np.float32)
            else:
                v = _owned_f32(v)
                np.multiply(v, mu, out=v)
                np.add(v, g, out=v)
            self.velocity[name] = v
            out[name] = np.subtract(p, np.multiply(v, lr))
        return out

    def state_dict(self) -> dict:
        # a copy: the apply updates velocity in place
        return {"velocity": {k: np.array(v)
                             for k, v in self.velocity.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.velocity = {k: np.array(v, np.float32)
                         for k, v in state.get("velocity", {}).items()}


class Adam(HostOptimizer):
    supports_striping = True

    def __init__(self, learning_rate: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m: dict[str, np.ndarray] = {}
        self.v: dict[str, np.ndarray] = {}
        self.step = 0

    def tick(self) -> None:
        self.step += 1

    def _moments(self, name: str, g: np.ndarray):
        """In place on the owned slots: m = b1*m + (1-b1)*g and
        v = b2*v + (1-b2)*g*g."""
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        m = _owned_f32(self.m.get(name, np.zeros_like(g)))
        v = _owned_f32(self.v.get(name, np.zeros_like(g)))
        np.multiply(m, b1, out=m)
        np.add(m, np.multiply(g, np.float32(1.0) - b1), out=m)
        np.multiply(v, b2, out=v)
        np.add(v, np.multiply(np.multiply(g, g), np.float32(1.0) - b2),
               out=v)
        self.m[name], self.v[name] = m, v
        return m, v

    def _native_step(self, name: str, p: np.ndarray, g: np.ndarray,
                     wd: float | None, out: dict) -> bool:
        """One tensor through the fused C++ pass, AdamW's when ``wd`` is
        not None (its sweep rounds otherwise than Adam's even at 0):
        fresh params into ``out``, m and v updated in place.  False when
        the library declines, and nothing has changed."""
        m = _owned_f32(self.m.get(name, np.zeros_like(g)))
        v = _owned_f32(self.v.get(name, np.zeros_like(g)))
        p_new = np.array(p, np.float32)
        args = (p_new, g, m, v, float(np.float32(self.learning_rate)),
                self.b1, self.b2, self.eps, self.step)
        if not (adam_native(*args) if wd is None
                else adamw_native(*args, wd)):
            return False
        self.m[name], self.v[name] = m, v
        out[name] = p_new
        return True

    def _denom(self, v: np.ndarray, bc2: float) -> np.ndarray:
        """sqrt(v / bc2) + eps."""
        d = np.divide(v, bc2, out=np.empty_like(v))
        np.sqrt(d, out=d)
        np.add(d, self.eps, out=d)
        return d

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        lr = np.float32(self.learning_rate)
        bc1 = 1.0 - self.b1 ** self.step
        bc2 = 1.0 - self.b2 ** self.step
        use_native = native_lib() is not None
        out = {}
        for name, p in params.items():
            p = np.asarray(p, np.float32)
            if name not in grads:
                out[name] = p
                continue
            g = np.asarray(grads[name], np.float32)
            if use_native and self._native_step(name, p, g, None, out):
                continue
            m, v = self._moments(name, g)
            # p - lr * (m / bc1) / denom: lr multiplied before the divide
            # (explicit outputs: a ufunc on 0-d arrays without out=
            # returns a scalar, which cannot be an out= target)
            step = np.divide(m, bc1, out=np.empty_like(p))
            np.multiply(step, lr, out=step)
            np.divide(step, self._denom(v, bc2), out=step)
            out[name] = np.subtract(p, step, out=step)
        return out

    def state_dict(self) -> dict:
        # copies: the apply updates m and v in place
        return {"m": {k: np.array(v) for k, v in self.m.items()},
                "v": {k: np.array(v) for k, v in self.v.items()},
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.m = {k: np.array(v, np.float32)
                  for k, v in state.get("m", {}).items()}
        self.v = {k: np.array(v, np.float32)
                  for k, v in state.get("v", {}).items()}
        self.step = int(state.get("step", 0))


class AdamW(Adam):
    """Adam with decoupled weight decay on matrices only (params below
    2-D, norm scales and biases, are not decayed): the update is
    ``lr * (adam_term + wd * p)`` from the pre-update param."""

    def __init__(self, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-4, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.weight_decay = weight_decay

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        lr = np.float32(self.learning_rate)
        bc1 = 1.0 - self.b1 ** self.step
        bc2 = 1.0 - self.b2 ** self.step
        use_native = native_lib() is not None
        out = {}
        for name, p in params.items():
            p = np.asarray(p, np.float32)
            if name not in grads:
                out[name] = p
                continue
            wd = self.weight_decay if p.ndim >= 2 else 0.0
            g = np.asarray(grads[name], np.float32)
            if use_native and self._native_step(name, p, g, wd, out):
                continue
            m, v = self._moments(name, g)
            step = np.divide(m, bc1, out=np.empty_like(p))
            np.divide(step, self._denom(v, bc2), out=step)   # adam term
            if wd:
                np.add(step, np.multiply(p, np.float32(wd)), out=step)
            np.multiply(step, lr, out=step)
            out[name] = np.subtract(p, step, out=step)
        return out


class Lion(HostOptimizer):
    """Sign-momentum optimizer (Chen et al. 2023), one slot:
    p -= lr * (sign(b1*m + (1-b1)*g) + wd*p); m <- b2*m + (1-b2)*g, with
    decoupled decay on matrices only, as AdamW."""

    supports_striping = True

    def __init__(self, learning_rate: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.99, weight_decay: float = 1e-4):
        super().__init__(learning_rate)
        self.b1, self.b2 = b1, b2
        self.weight_decay = weight_decay
        self.m: dict[str, np.ndarray] = {}

    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        lr = np.float32(self.learning_rate)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        one = np.float32(1.0)
        out = {}
        for name, p in params.items():
            p = np.asarray(p, np.float32)
            if name not in grads:
                out[name] = p
                continue
            g = np.asarray(grads[name], np.float32)
            m = _owned_f32(self.m.get(name, np.zeros_like(g)))
            step = np.multiply(m, b1, out=np.empty_like(p))
            np.add(step, np.multiply(g, one - b1), out=step)
            np.sign(step, out=step)
            np.multiply(m, b2, out=m)
            np.add(m, np.multiply(g, one - b2), out=m)
            self.m[name] = m
            wd = self.weight_decay if p.ndim >= 2 else 0.0
            if wd:
                np.add(step, np.multiply(p, np.float32(wd)), out=step)
            np.multiply(step, lr, out=step)
            out[name] = np.subtract(p, step, out=step)
        return out

    def state_dict(self) -> dict:
        return {"m": {k: np.array(v) for k, v in self.m.items()}}

    def load_state_dict(self, state: dict) -> None:
        self.m = {k: np.array(v, np.float32)
                  for k, v in state.get("m", {}).items()}


HOST_OPTIMIZERS = ("sgd", "momentum", "adam", "adamw", "lion")


def _host_optimizer_for_rule(rule: str, learning_rate: float,
                             momentum: float,
                             weight_decay: float) -> HostOptimizer | None:
    """The host optimizer of a device-family rule, the degrade target
    when the card is absent (``adamw_bf16`` maps to AdamW: the bf16
    slots save card memory, the rule is the same).  None for a rule no
    host optimizer implements."""
    if rule == "sgd":
        return SGD(learning_rate)
    if rule == "momentum":
        return Momentum(learning_rate, momentum)
    if rule == "adam":
        return Adam(learning_rate)
    if rule in ("adamw", "adamw_bf16"):
        return AdamW(learning_rate, weight_decay)
    if rule == "lion":
        return Lion(learning_rate, weight_decay=weight_decay)
    return None


def _make_accelerator_optimizer(kind: str, rule: str, learning_rate: float,
                                momentum: float, weight_decay: float,
                                device) -> HostOptimizer | None:
    """A ``pallas_*`` or ``device_*`` optimizer on ``device``; None for a
    rule the family does not implement (the caller raises)."""
    from ..async_sgd.device_optimizer import DeviceOptimizer, PallasOptimizer

    if kind == "pallas":
        if rule not in PallasOptimizer.RULES:
            return None
        return PallasOptimizer(rule, learning_rate, momentum, device=device)
    if rule not in DeviceOptimizer.RULES:
        return None
    return DeviceOptimizer(rule, learning_rate, momentum=momentum,
                           weight_decay=weight_decay, device=device)


def make_optimizer(name: str, learning_rate: float, momentum: float = 0.9,
                   weight_decay: float = 1e-4, device=None) -> HostOptimizer:
    """PS optimizer by name: ``sgd|momentum|adam|adamw|lion`` are the host
    optimizers above; ``pallas_<sgd|momentum|adam>`` the fused-update
    kernels and ``device_<sgd|momentum|adam|adamw|adamw_bf16>`` the optax
    rules in torch, both on ``device`` (default: the card).

    When the card is absent (constructing the accelerator optimizer
    raises ``RuntimeError`` from ``device.resolve_device``), the matching
    host optimizer takes its place, counted in
    ``ps.apply.device_fallback`` and logged.  An unknown rule raises; so
    does ``sharded_*`` (not ported).  A kernel that fails to build or
    launch later, at apply time, raises there: that is not a degrade."""
    name = name.lower()
    if name in HOST_OPTIMIZERS:
        return _host_optimizer_for_rule(name, learning_rate, momentum,
                                        weight_decay)
    kind, _, rule = name.partition("_")
    if kind == "sharded" and rule:
        raise NotImplementedError(f"optimizer {name!r}: {ROADMAP_SHARDED}")
    if rule and kind in ("device", "pallas"):
        try:
            opt = _make_accelerator_optimizer(kind, rule, learning_rate,
                                              momentum, weight_decay, device)
        except RuntimeError as exc:
            host = _host_optimizer_for_rule(rule, learning_rate, momentum,
                                            weight_decay)
            if host is None:
                raise
            obs_stats.counter("ps.apply.device_fallback").add()
            log.warning("optimizer %r unavailable (%s); degrading to host %s",
                        name, exc, type(host).__name__)
            return host
        if opt is not None:
            return opt
    raise ValueError(f"unknown optimizer {name!r}")
