"""The optimizer protocol of the parameter server: the port's own copy of
``HostOptimizer`` from parameter_server_distributed_tpu/core/optimizer.py.

Only the protocol is here; the numpy host optimizers (SGD, momentum,
Adam, AdamW) are not ported yet.
"""

from __future__ import annotations

from typing import Mapping


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

    def load_state_dict(self, state: dict) -> None:
        pass
