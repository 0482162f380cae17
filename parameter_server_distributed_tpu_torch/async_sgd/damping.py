"""Staleness-aware learning-rate damping: the port's copy of
parameter_server_distributed_tpu/async_sgd/damping.py.

A contribution ``s`` iterations stale applies at ``lr * beta ** s``
(beta in (0, 1]), implemented as a gradient pre-scale: scaling the
gradient by ``beta ** s`` before the optimizer sees it is exactly a
per-contribution learning-rate damp for every linear-in-lr step.

In the port the one consumer is bounded-staleness async mode
(``staleness_bound > 0``): an accepted stale push applies damped, OFF
unless ``PSDT_STALENESS_BETA`` is set explicitly, so default async runs
apply every push undamped.  (The K-of-N quorum and free-run consumers
are not ported: ROADMAP.md Queue 1, item 11.)

``PSDT_STALENESS_BETA`` sets beta (default 0.5).  ``PSDT_DAMP_FLOOR``
(default 0 = off) is the floor below which a damp scale counts as a
dropped contribution (:meth:`StalenessDamping.floored`; the flight
recorder event the reference records there is not ported: item 14).
Staleness inputs are clamped into ``[0, MAX_STALENESS]``: iteration
counters can run backward transiently (restore rewinds, racing
bootstrap), and a negative or absurd exponent must damp sanely rather
than amplify the gradient or overflow.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

ENV_BETA = "PSDT_STALENESS_BETA"
DEFAULT_BETA = 0.5
ENV_FLOOR = "PSDT_DAMP_FLOOR"
# clamp bound for the damp exponent: far past any plausible staleness,
# small enough that beta ** MAX_STALENESS underflows to an exact 0.0
MAX_STALENESS = 1 << 20


def clamp_staleness(staleness) -> int:
    """Staleness clamped into ``[0, MAX_STALENESS]`` (non-int inputs
    truncate like ``int(staleness)``)."""
    return min(max(int(staleness), 0), MAX_STALENESS)


class StalenessDamping:
    """``scale(s) = beta ** s`` with the shared env override."""

    def __init__(self, beta: float | None = None,
                 floor: float | None = None):
        raw = os.environ.get(ENV_BETA, "")
        if beta is not None:
            self.beta = float(beta)
        elif raw:
            self.beta = float(raw)
        else:
            self.beta = DEFAULT_BETA
        if not 0.0 < self.beta <= 1.0:
            raise ValueError(f"staleness damping beta must be in (0, 1], "
                             f"got {self.beta}")
        raw_floor = os.environ.get(ENV_FLOOR, "")
        if floor is not None:
            self.floor = float(floor)
        elif raw_floor:
            self.floor = float(raw_floor)
        else:
            self.floor = 0.0
        if not 0.0 <= self.floor < 1.0:
            raise ValueError(f"damp floor must be in [0, 1), "
                             f"got {self.floor}")

    def floored(self, value: float) -> bool:
        """True when ``value`` fell below the armed floor: the
        contribution is effectively dropped."""
        return self.floor > 0.0 and value < self.floor

    def scale(self, staleness: int) -> float:
        """The multiplier for a contribution ``staleness`` iterations
        old; fresh (staleness <= 0) contributions pass through at 1."""
        s = clamp_staleness(staleness)
        if s <= 0:
            return 1.0
        return float(self.beta ** s)

    def damp(self, gradients: Mapping[str, np.ndarray],
             staleness: int) -> dict[str, np.ndarray]:
        """A damped f32 copy of ``gradients`` (never mutates the input: a
        retried push replays the same payload).  The f32 scalar multiply
        matches the fold path's arithmetic, so a staleness-0 damp is
        bit-identical to no damp."""
        s = self.scale(staleness)
        if s == 1.0:
            return {name: np.asarray(g, np.float32)
                    for name, g in gradients.items()}
        f = np.float32(s)
        return {name: np.asarray(g, np.float32) * f
                for name, g in gradients.items()}


def async_damping() -> StalenessDamping | None:
    """The bounded-staleness async-mode instance: armed only by an
    explicit ``PSDT_STALENESS_BETA``."""
    if not os.environ.get(ENV_BETA, ""):
        return None
    return StalenessDamping()
