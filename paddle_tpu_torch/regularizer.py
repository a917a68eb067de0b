"""paddle's ``regularizer`` module (port of paddle_tpu/regularizer.py):
``L1Decay`` and ``L2Decay``, the objects ``optimizer`` defines,
re-exported under the reference's module path."""
from .optimizer.optimizer import L1Decay, L2Decay

__all__ = ["L1Decay", "L2Decay"]
