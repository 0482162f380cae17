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

- ``ShardedDeviceOptimizer`` is the stripe-sliceable family of the
  device close (``PSDT_DEVICE_APPLY``): five rules over per-name slots
  on its device, each stripe's update one ``sharded_update`` launch
  (ops/device_apply.py, ``csrc/device_apply.cu``) bit for bit the host
  numpy optimizers' (core/optimizer.py), and the flat arena's slabs
  (core/arena.py, ``PSDT_ARENA``).
"""

from __future__ import annotations

import threading
from typing import Mapping

import numpy as np
import torch

from ..core import device_apply
from ..core.optimizer import HostOptimizer
from ..core.tensor import state_to_host
from ..device import resolve_device
from ..ops import device_apply as da
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


class ShardedDeviceOptimizer(HostOptimizer):
    """The stripe-sliceable device optimizer of the PS close: the port of
    the JAX package's ``ShardedDeviceOptimizer``.

    Rules ``sgd``, ``momentum``, ``adam``, ``adamw`` and ``lion``, each
    the host numpy optimizer's operation for operation with the same f32
    scalars, so an apply equals the host apply bit for bit.  Slots are
    keyed per tensor name on ``device`` (default: the card), in the host
    optimizers' ``state_dict`` layout (``velocity``; ``m``, ``v`` and
    ``step``; ``m``), so checkpoints move between the host and sharded
    optimizers, across stripe counts and across ``PSDT_ARENA``.

    :meth:`apply_shard` updates a stripe's tensors in one
    ``sharded_update`` launch (a table of pointers; more only where a
    stripe outgrows one table) and returns fresh params; the slots update
    in place, and params and gradients are never written.  Under the
    arena (:meth:`apply_arena`) each slot kind lives as one flat slab per
    stripe, and each stripe's update is one launch over its slabs.

    Disjoint stripes may apply concurrently (each touches only its own
    names' slots); the core serialises logical steps.  ``_lock`` fences
    the arena slabs against the checkpoint snapshot and restore."""

    supports_striping = True
    device_resident = True
    supports_arena = True

    RULES = da.RULES
    _RULE_SLOTS = {"sgd": (), "momentum": ("velocity",),
                   "adam": ("m", "v"), "adamw": ("m", "v"), "lion": ("m",)}

    def __init__(self, rule: str, learning_rate: float,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 b1: float | None = None, b2: float | None = None,
                 eps: float = 1e-8, device=None):
        if rule not in self.RULES:
            raise ValueError(f"unknown sharded device rule {rule!r}; "
                             f"options {self.RULES}")
        device_apply.stage_chunk_elems()   # raises where it is asked for
        super().__init__(learning_rate)
        self.rule = rule
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.b1 = 0.9 if b1 is None else b1
        self.b2 = ((0.99 if rule == "lion" else 0.999) if b2 is None
                   else b2)
        self.eps = eps
        self.device = resolve_device(device)
        self.step = 0
        # slot kind -> name -> f32 tensor on the device
        self._slots: dict[str, dict[str, torch.Tensor]] = {
            kind: {} for kind in self._RULE_SLOTS[rule]}
        # under the arena: slot kind -> stripe -> flat slab, packed for
        # _arena_table's epoch; the per-name tables are empty meanwhile
        self._arena_slots: dict[str, dict[int, torch.Tensor]] = {}
        self._arena_table = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- steps
    def tick(self) -> None:
        if self.rule in ("adam", "adamw"):
            self.step += 1

    def _bias_corrections(self) -> tuple[np.float32, np.float32]:
        """Python-float powers, then one f32 rounding: the numpy path's
        cast on use of ``1.0 - b1 ** step``."""
        return (np.float32(1.0 - self.b1 ** self.step),
                np.float32(1.0 - self.b2 ** self.step))

    def _scalars(self) -> dict:
        f32, one = np.float32, np.float32(1.0)
        b1, b2 = f32(self.b1), f32(self.b2)
        bc1, bc2 = self._bias_corrections()
        return {"lr": f32(self.learning_rate), "mu": f32(self.momentum),
                "b1": b1, "omb1": one - b1, "b2": b2, "omb2": one - b2,
                "bc1": bc1, "bc2": bc2, "eps": f32(self.eps),
                "wd": f32(self.weight_decay)}

    def _decays(self) -> bool:
        return self.rule in ("adamw", "lion") and bool(self.weight_decay)

    # ------------------------------------------------------------- apply
    def apply_shard(self, params: Mapping, grads: Mapping) -> dict:
        """One shard's update in one launch: fresh params for the names
        with a gradient, the others passed through (a tensor as it is,
        anything else as f32 numpy), in ``params``' order as the host
        optimizers return them."""
        if self._arena_slots:
            with self._lock:
                self._spill_arena_locked()
        out: dict = {}
        todo: list[str] = []
        for name, p in params.items():
            if name in grads:
                todo.append(name)
            else:
                out[name] = (p if device_apply.is_device_array(p)
                             else np.asarray(p, np.float32))
        if not todo:
            return out
        todo.sort()
        dev = self.device
        ps = [device_apply.owned_f32(params[n], dev) for n in todo]
        gs = [device_apply.owned_f32(grads[n], dev) for n in todo]
        # every shape is checked before anything is allocated or launched,
        # so a refused apply leaves the slots as they were
        for name, p, g in zip(todo, ps, gs):
            if p.shape != g.shape:
                raise ValueError(f"param/gradient shape mismatch for "
                                 f"{name!r}: {tuple(p.shape)} vs "
                                 f"{tuple(g.shape)}")
            for kind, table in self._slots.items():
                s = table.get(name)
                if s is not None and s.shape != g.shape:
                    raise ValueError(f"slot {kind!r} shape mismatch for "
                                     f"{name!r}: {tuple(s.shape)} vs "
                                     f"gradient {tuple(g.shape)}")
        sizes, offsets, views = fu._layout(tuple(p.shape for p in ps))
        fresh = torch.empty(int(offsets[-1]), dtype=torch.float32,
                            device=ps[0].device)
        kinds = self._RULE_SLOTS[self.rule]
        new_slots: dict[str, dict[str, torch.Tensor]] = {k: {} for k in kinds}
        rows = []
        for i, (name, p, g) in enumerate(zip(todo, ps, gs)):
            slots, seed = [], False
            for kind in kinds:
                s = self._slots[kind].get(name)
                if s is None:
                    # first touch: Momentum's copy seed writes every
                    # element; the others start from zeros
                    seed = kind == "velocity"
                    s = (torch.empty if seed else torch.zeros)(
                        g.shape, dtype=torch.float32, device=g.device)
                    new_slots[kind][name] = s
                slots.append(s.view(-1))
            n = int(sizes[i])
            decay = n if self._decays() and p.dim() >= 2 else 0
            rows.append(da.UpdateRow(
                p.view(-1), g.view(-1),
                fresh[int(offsets[i]):int(offsets[i]) + n],
                *(slots + [None] * (2 - len(slots))), decay, seed))
        da.sharded_update(self.rule, rows, self._scalars())
        for kind, made in new_slots.items():
            self._slots[kind].update(made)
        for name, view in zip(todo, views):
            out[name] = fresh.as_strided(*view)
        return {name: out[name] for name in params}   # the store's order

    # ------------------------------------------------------------ arena
    def arena_ready(self, table) -> bool:
        """True when this optimizer can run ``table`` flat.  Only Momentum
        can refuse: its first-touch seed is a bit copy of the gradient,
        so a velocity table seeded for some names and not others cannot
        flatten.  Slabs of an older table epoch spill back first."""
        if self.rule != "momentum":
            return True
        if self._arena_slots:
            if (self._arena_table is not None
                    and self._arena_table.epoch == table.epoch):
                return True
            with self._lock:
                self._spill_arena_locked()
        have = set(self._slots["velocity"]) & set(table.entries)
        return not have or have == set(table.entries)

    def apply_arena(self, table, param_slabs: Mapping[int, torch.Tensor],
                    grad_slabs: Mapping[int, torch.Tensor]) -> dict:
        """One logical step over flat slabs, one launch per stripe: fresh
        param slabs out, the slot slabs in place, param and gradient slabs
        never written.  The caller serialises steps and has proven full
        coverage and :meth:`arena_ready`."""
        self._ensure_arena_slots(table)
        scalars = self._scalars()
        kinds = self._RULE_SLOTS[self.rule]
        out = {}
        for stripe in sorted(param_slabs):
            p, g = param_slabs[stripe], grad_slabs[stripe]
            slots, made, seed = [], {}, False
            for kind in kinds:
                s = self._arena_slots[kind].get(stripe)
                if s is None:
                    seed = kind == "velocity"
                    s = made[kind] = (torch.empty if seed else torch.zeros)(
                        p.shape, dtype=torch.float32, device=p.device)
                slots.append(s)
            fresh = torch.empty_like(p)
            decay = table.decay_len(stripe) if self._decays() else 0
            da.sharded_update(self.rule, [da.UpdateRow(
                p, g, fresh, *(slots + [None] * (2 - len(slots))), decay,
                seed)], scalars)
            for kind, s in made.items():
                self._arena_slots[kind][stripe] = s
            out[stripe] = fresh
        return out

    def apply_arena_range(self, *args, **kwargs):
        raise NotImplementedError(f"apply_arena_range: "
                                  f"{device_apply.ROADMAP_SHARDED_UPDATE}")

    def commit_arena_ranges(self, *args, **kwargs):
        raise NotImplementedError(f"commit_arena_ranges: "
                                  f"{device_apply.ROADMAP_SHARDED_UPDATE}")

    def _ensure_arena_slots(self, table) -> None:
        """Pack the per-name slots into per-stripe slabs for ``table``'s
        epoch (missing names pack as zeros, the host seed of every rule
        but Momentum, whose mixed case :meth:`arena_ready` excluded)."""
        if (self._arena_table is not None
                and self._arena_table.epoch == table.epoch):
            return
        with self._lock:
            if self._arena_slots:
                self._spill_arena_locked()
            slabs: dict[str, dict[int, torch.Tensor]] = {}
            for kind in self._RULE_SLOTS[self.rule]:
                by_name = self._slots[kind]
                slabs[kind] = {}
                if self.rule == "momentum" and not by_name:
                    continue    # unseeded: each stripe seeds on its apply
                for stripe in range(table.stripes):
                    size = table.stripe_sizes[stripe]
                    if not size:
                        continue
                    have = [n for n in table.stripe_names[stripe]
                            if n in by_name]
                    slabs[kind][stripe] = device_apply.slab_assemble(
                        tuple((table.entries[n].offset,
                               table.entries[n].length) for n in have),
                        [by_name[n] for n in have], size, self.device)
                self._slots[kind] = {}
            self._arena_slots = slabs
            self._arena_table = table

    def _spill_arena_locked(self) -> None:
        """Give the slots back to the per-name tables as views of the
        slabs (which then belong to the views alone) and drop the slabs.
        Caller holds ``_lock``."""
        table = self._arena_table
        if table is not None:
            for kind, per_stripe in self._arena_slots.items():
                by_name = self._slots.setdefault(kind, {})
                for stripe, slab in per_stripe.items():
                    by_name.update(table.device_views(stripe, slab))
        self._arena_slots = {}
        self._arena_table = None

    # ------------------------------------------------------- checkpoint
    def state_dict(self) -> dict:
        return state_to_host(self.state_snapshot())

    def state_snapshot(self) -> dict:
        """The slots copied on their device, per name, in the host
        optimizers' layout (arena slabs copied whole, then viewed per
        name); ``step`` for Adam and AdamW."""
        with self._lock:
            if self._arena_slots:
                table = self._arena_table
                out = {kind: {name: view for stripe, slab in
                              per_stripe.items() for name, view in
                              table.device_views(stripe,
                                                 slab.clone()).items()}
                       for kind, per_stripe in self._arena_slots.items()}
                for kind in self._RULE_SLOTS[self.rule]:
                    out.setdefault(kind, {})
            else:
                out = {kind: {name: t.clone() for name, t in table.items()}
                       for kind, table in self._slots.items()}
        if self.rule in ("adam", "adamw"):
            out["step"] = self.step
        return out

    def load_state_dict(self, state: dict) -> None:
        state = dict(state or {})
        with self._lock:
            self._arena_slots = {}
            self._arena_table = None
            for kind in self._RULE_SLOTS[self.rule]:
                self._slots[kind] = {
                    name: device_apply.upload(
                        np.asarray(arr, np.float32), self.device)
                    for name, arr in (state.get(kind) or {}).items()}
        if self.rule in ("adam", "adamw"):
            self.step = int(np.asarray(state.get("step", 0)).reshape(-1)[0])
