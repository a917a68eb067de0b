from . import lr
from .optimizer import Adam, AdamW, L2Decay, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "L2Decay", "lr"]
