"""Shared env-knob parsing (the port's own copy of paddle_tpu/framework/env.py).

Read the variable, fall back to the default on garbage, optionally clamp
to a floor.
"""
from __future__ import annotations

import os

__all__ = ["bool_env", "int_env", "float_env"]


def bool_env(name: str, default: bool) -> bool:
    """Boolean env knob: unset -> ``default``; otherwise anything but
    (case-insensitive) ``0``/``false``/``off``/empty counts as on."""
    value = os.environ.get(name)
    if value is None:
        return default
    return value.strip().lower() not in ("0", "false", "off", "")


def float_env(name: str, default: float) -> float:
    """``float(os.environ[name])`` with ``default`` on missing or
    unparseable values."""
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def int_env(name: str, default: int, minimum: int | None = None) -> int:
    """``int(os.environ[name])`` with ``default`` on missing/unparseable
    values; clamped to ``minimum`` when given."""
    try:
        value = int(os.environ.get(name, default))
    except ValueError:
        return default
    if minimum is not None and value < minimum:
        return minimum
    return value
