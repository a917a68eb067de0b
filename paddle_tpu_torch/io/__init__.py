"""``paddle.save`` / ``paddle.load`` (port of paddle_tpu/io/: its state
half; the data pipeline is not ported yet — see ROADMAP.md)."""
from .state import load, save

__all__ = ["save", "load"]
