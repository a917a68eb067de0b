"""Lock factories (port of paddle_tpu/obs/locks.py's factory half).

``make_lock`` / ``make_rlock`` / ``make_condition`` are the factories the
engine and the metrics registry build their locks with, so that a lock
sanitizer can be slotted in behind them. They return plain ``threading``
primitives. paddle_tpu's lock-order sanitizer (``PADDLE_TPU_LOCK_SAN``:
wait and hold histograms, a runtime lock-order graph, a deadlock
watchdog) is not ported yet — ROADMAP.md, A14: turning it on raises
``NotImplementedError`` instead of returning uninstrumented locks
silently.
"""
from __future__ import annotations

import os
import threading

__all__ = ["lock_san_enabled", "set_lock_san", "make_lock", "make_rlock",
           "make_condition"]

_san_override = None          # set_lock_san() tri-state; None -> env


def _not_ported():
    raise NotImplementedError(
        "the lock sanitizer (PADDLE_TPU_LOCK_SAN) is not ported yet — see "
        "ROADMAP.md")


def lock_san_enabled() -> bool:
    """Is the lock sanitizer asked for? ``PADDLE_TPU_LOCK_SAN`` (default
    off), or ``set_lock_san``'s override."""
    if _san_override is not None:
        return _san_override
    raw = os.environ.get("PADDLE_TPU_LOCK_SAN")
    return raw is not None and raw.strip().lower() not in ("0", "false",
                                                           "off", "")


def set_lock_san(on) -> None:
    """Force the sanitizer off (``False``) or back to the env (``None``);
    ``True`` raises: the sanitizer is not ported."""
    global _san_override
    if on:
        _not_ported()
    _san_override = None if on is None else False


def make_lock(name: str):
    """A mutex for the named site."""
    if lock_san_enabled():
        _not_ported()
    return threading.Lock()


def make_rlock(name: str):
    if lock_san_enabled():
        _not_ported()
    return threading.RLock()


def make_condition(name: str):
    """A condition variable (RLock semantics, as ``threading.Condition()``
    by default)."""
    if lock_san_enabled():
        _not_ported()
    return threading.Condition()
