"""Observability: metrics registry, span tracer, flight recorder (port of
paddle_tpu/obs/).

* :mod:`.metrics` — the process-wide registry of counters, gauges and
  histograms (bounded label sets, lock-guarded), exported as
  Prometheus-style text on ``/metrics``; the same text as paddle_tpu's
  for the same operations.
* :mod:`.efficiency` — model FLOPs or modeled bytes over measured wall
  time as a fraction of one card's peak (``ptpu_engine_tick_model_eff``).
* :mod:`.trace` — request-scoped spans (request ids propagate through the
  ``X-PTPU-Request-Id`` header to the engine) buffered in a fixed-size
  ring, the **flight recorder**, with Chrome/Perfetto JSON export and the
  ``POST /admin/trace`` capture (``torch.profiler`` beside it on request).
* :mod:`.locks` — the lock factories (plain ``threading`` primitives; the
  lock sanitizer is not ported yet).

Env knobs:
  PADDLE_TPU_OBS        ambient instrumentation on/off (default on)
  PADDLE_TPU_OBS_RING   flight-recorder capacity in events (4096)
  PADDLE_TPU_OBS_DIR    artifact/trace directory (obs_artifacts)
  PADDLE_TPU_EFF_CHIP   the efficiency card (efficiency.CHIP_SPECS)

The package imports only the standard library at import time; torch is
imported where a function needs it.
"""
from __future__ import annotations

import os

__all__ = ["enabled", "set_enabled", "metrics", "trace", "efficiency",
           "locks", "registry", "recorder", "span", "record_span",
           "dump_flight", "lock_san_enabled", "set_lock_san",
           "make_lock", "make_rlock", "make_condition"]

_enabled_override = None     # set_enabled() tri-state; None -> env
_enabled_env = None          # cached env read


def enabled() -> bool:
    """Is ambient instrumentation on? One cached read of
    ``PADDLE_TPU_OBS`` (default on); ``set_enabled`` overrides."""
    global _enabled_env
    if _enabled_override is not None:
        return _enabled_override
    if _enabled_env is None:
        raw = os.environ.get("PADDLE_TPU_OBS")
        _enabled_env = (True if raw is None else
                        raw.strip().lower() not in ("0", "false", "off",
                                                    ""))
    return _enabled_env


def set_enabled(on) -> None:
    """Force instrumentation on/off (``None`` re-reads the env). Affects
    gated sites built AFTER the call (the engine snapshots the flag at
    construction)."""
    global _enabled_override, _enabled_env
    _enabled_override = None if on is None else bool(on)
    _enabled_env = None


from . import efficiency, locks, metrics, trace           # noqa: E402
from .locks import (lock_san_enabled, make_condition, make_lock,  # noqa: E402
                    make_rlock, set_lock_san)
from .metrics import registry                             # noqa: E402
from .trace import dump_flight, record_span, recorder, span  # noqa: E402
