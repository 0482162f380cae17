"""Membership states: the port's copy of the constants of
parameter_server_distributed_tpu/elastic/messages.py:42-48.

The decode fleet's rows (``fleet/messages.py`` ``FleetEntry.state``)
carry them, so scale-in is the drain-before-stop path of elastic
membership applied to serving processes.  The values ride the wire:
append-only.  Not ported: ``MembershipEntry``, ``MembershipRequest``,
``MembershipResponse`` and the ``UpdateMembership`` method (ROADMAP.md
Queue 1, item 11)."""

from __future__ import annotations

MEMBER_JOINING = 0   # registered, join not yet announced
MEMBER_ACTIVE = 1    # serving (or, for a worker, announced its join)
MEMBER_DRAINING = 2  # finishing what is in flight, then leaving
MEMBER_GONE = 3      # left gracefully or reaped

STATE_NAMES = {MEMBER_JOINING: "joining", MEMBER_ACTIVE: "active",
               MEMBER_DRAINING: "draining", MEMBER_GONE: "gone"}
