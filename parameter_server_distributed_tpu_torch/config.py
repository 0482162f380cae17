"""Command-line helpers shared by the port's CLI mains (the port's own
copy of parse_argv / require_flag_value from
parameter_server_distributed_tpu/config.py)."""

from __future__ import annotations

from typing import Sequence


def parse_argv(argv: Sequence[str]) -> tuple[list[str], dict[str, str]]:
    """Split argv into (positional, flags): ``--k=v`` -> flags[k]=v,
    bare ``--k`` -> flags[k]="1"."""
    positional = [a for a in argv if not a.startswith("--")]
    flags = dict(f.lstrip("-").split("=", 1) if "=" in f else (f.lstrip("-"), "1")
                 for f in argv if f.startswith("--"))
    return positional, flags


def require_flag_value(argv: Sequence[str], *names: str,
                       hint: str = "") -> None:
    """Reject bare value-flags: :func:`parse_argv` maps ``--k`` (no "=")
    to "1", which would silently stand in for a real value."""
    for name in names:
        if name in argv:
            raise SystemExit(f"{name} requires an explicit value "
                             f"({name}=...{f' — {hint}' if hint else ''})")
