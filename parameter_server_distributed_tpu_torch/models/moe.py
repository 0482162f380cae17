"""Mixture-of-Experts layer in PyTorch: the port of
parameter_server_distributed_tpu/models/moe.py.

Top-k routing with capacity (k = 1 is the Switch transformer, k = 2 the
Mixtral/GShard shape): the router picks each token's top-k experts, the
gates are the raw top probability (k = 1) or the top-k probabilities
renormalised to sum one (k >= 2), and (token, choice) assignments past
an expert's capacity are dropped (they pass through the residual).

The reference expresses dispatch and combine as contractions with a
one-hot ``[N, k, E, C]`` tensor.  Each output of those contractions has
exactly one nonzero term, so the port moves rows by index instead: each
kept assignment's token row is gathered into its slot of a static
``[E, C, D]`` buffer, the two expert products run as one batched matmul
each over the buffers, and each assignment reads its slot back.  The
values are the reference's.  The capacity is static per shape, and the
routed path makes no host sync (no ``nonzero``, ``.item()`` or
``.tolist()``), so a decode round on the card never waits on the host.

Load-balancing auxiliary loss per Switch Transformer: ``E * sum_e f_e *
p_e`` (the fraction of assignments routed to e times its mean router
probability).  The router's product is taken in float32; the port keeps
PyTorch's default of no TF32 in float32 matmuls.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
import torch.nn.functional as F

from ..device import resolve_device

Tensor = torch.Tensor

# the reference's manual expert parallelism (expert_slice, used inside
# shard_map) and its expert sharding rules belong to the SPMD slice
ROADMAP_EXPERT_PARALLEL = ("ROADMAP.md Queue 1, item 8, multi-device SPMD "
                           "(expert_slice and the expert sharding rules)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 512
    num_experts: int = 8
    capacity_factor: float = 1.25
    # experts per token: 1 = Switch, 2 = Mixtral/GShard top-2
    top_k: int = 1
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class Routing:
    """One routing decision over N tokens and A = N * k assignments,
    token-major (token n's choices are n * k .. n * k + k - 1).

    ``probs`` [N, E] f32 router probabilities; ``top_idx`` [N, k] the
    chosen experts; ``gates`` [N, k] f32; ``position`` [A] each
    assignment's 0-based place in its expert's queue; ``keep`` [A]
    ``position < capacity``; ``capacity`` the queue length."""

    probs: Tensor
    top_idx: Tensor
    gates: Tensor
    position: Tensor
    keep: Tensor
    capacity: int


class MoELayer:
    def __init__(self, config: MoEConfig):
        if not 1 <= config.top_k <= config.num_experts:
            raise ValueError(
                f"top_k={config.top_k} must be in [1, num_experts="
                f"{config.num_experts}]")
        self.config = config

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        c = self.config
        return {
            "moe/router/w": (c.d_model, c.num_experts),
            "moe/w1": (c.num_experts, c.d_model, c.d_ff),
            "moe/w2": (c.num_experts, c.d_ff, c.d_model),
        }

    def init_params(self, rng: torch.Generator | int = 0, prefix: str = "",
                    device=None) -> dict[str, Tensor]:
        """Fresh weights on ``device`` (default: the card): the router at
        N(0, 0.02), the expert banks fan-in scaled, as the reference's
        scheme (a different random stream)."""
        c = self.config
        dev = resolve_device(device)
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator(device=dev).manual_seed(int(rng)))

        def randn(shape):
            return torch.randn(shape, generator=gen, dtype=c.dtype,
                               device=dev)

        return {
            f"{prefix}moe/router/w": randn((c.d_model, c.num_experts)) * 0.02,
            f"{prefix}moe/w1": randn((c.num_experts, c.d_model, c.d_ff))
            / math.sqrt(c.d_model),
            f"{prefix}moe/w2": randn((c.num_experts, c.d_ff, c.d_model))
            / math.sqrt(c.d_ff),
        }

    def capacity(self, num_assignments: int) -> int:
        """Per-expert queue length for ``num_assignments`` (token, choice)
        routing assignments: N tokens make N * top_k assignments."""
        c = self.config
        return max(1, int(math.ceil(
            num_assignments / c.num_experts * c.capacity_factor)))

    def route(self, router_w: Tensor, tokens: Tensor,
              capacity: int) -> Routing:
        """Route ``tokens`` [N, D]: f32 router logits, softmax, top-k with
        ties to the lower expert index (as ``lax.top_k``), the gates, and
        each assignment's queue position from a token-major running count
        of its expert."""
        c = self.config
        k = c.top_k
        logits = torch.matmul(tokens.float(), router_w.float())
        probs = torch.softmax(logits, dim=-1)                    # [N, E]
        # a stable descending sort keeps equal probabilities in index
        # order, so ties go to the lower expert as lax.top_k breaks them
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_probs, top_idx = order.values[:, :k], order.indices[:, :k]
        if k == 1:
            # Switch gates by the raw router probability: renormalising
            # would make the gate a constant 1 and cut the router's
            # gradient
            gates = top_probs
        else:
            gates = top_probs / top_probs.sum(dim=-1, keepdim=True)
        a_idx = top_idx.reshape(-1)                              # [A]
        experts = torch.arange(c.num_experts, device=tokens.device)
        onehot = (a_idx[:, None] == experts).to(torch.int32)     # [A, E]
        running = torch.cumsum(onehot, dim=0, dtype=torch.int32)  # 1-based
        position = running.gather(1, a_idx[:, None])[:, 0] - 1
        return Routing(probs=probs, top_idx=top_idx, gates=gates,
                       position=position, keep=position < capacity,
                       capacity=capacity)

    def apply(self, params: Mapping[str, Tensor], x: Tensor,
              prefix: str = "", capacity_override: int | None = None,
              expert_slice=None) -> tuple[Tensor, Tensor]:
        """x: [B, S, D] -> (out [B, S, D] in x's dtype, aux loss f32
        scalar).

        Dropped assignments (over capacity) contribute zero: callers add
        the residual.  ``capacity_override`` replaces the factor-derived
        capacity; pass the token count for drop-free inference (which
        token drops depends on every other token in the batch, so
        capacity dropping cannot be reproduced causally at decode
        time)."""
        if expert_slice is not None:
            raise NotImplementedError(
                f"expert_slice: {ROADMAP_EXPERT_PARALLEL}")
        c = self.config
        k = c.top_k
        b, s, d = x.shape
        n = b * s
        tokens = x.reshape(n, d)
        cap = (capacity_override if capacity_override is not None
               else self.capacity(n * k))
        r = self.route(params[f"{prefix}moe/router/w"], tokens, cap)
        dev = x.device
        slots = c.num_experts * cap
        # each assignment's slot in the flat [E * C] buffer; a dropped
        # one points past the end, at a zero row
        a_idx = r.top_idx.reshape(-1)
        slot = torch.where(r.keep, a_idx * cap + r.position,
                           torch.full_like(a_idx, slots))
        # the token filling each slot (n: none, the zero row)
        src = torch.full((slots + 1,), n, dtype=torch.long, device=dev)
        src.scatter_(0, slot, torch.arange(n * k, device=dev) // k)
        rows = torch.cat([tokens, tokens.new_zeros((1, d))])
        expert_in = rows[src[:slots]].reshape(c.num_experts, cap, d)
        w1 = params[f"{prefix}moe/w1"]
        w2 = params[f"{prefix}moe/w2"]
        h = F.gelu(torch.matmul(expert_in, w1), approximate="tanh")
        expert_out = torch.matmul(h, w2).reshape(slots, d)
        combined = torch.cat([expert_out, expert_out.new_zeros((1, d))])[slot]
        weight = (r.gates.reshape(-1) * r.keep).to(x.dtype)
        out = (combined * weight[:, None]).reshape(n, k, d).sum(dim=1)
        # Switch load-balancing aux: E * sum_e (fraction of assignments
        # to e) * (mean router probability of e)
        frac = (a_idx[:, None] == torch.arange(c.num_experts, device=dev)
                ).float().mean(dim=0)
        aux = c.num_experts * torch.sum(frac * r.probs.mean(dim=0))
        return out.reshape(b, s, d), aux
