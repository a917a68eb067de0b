"""Optimizers, schedulers (``lr``) and weight decay (port of
paddle_tpu/optimizer/)."""
from . import lr
from .optimizer import (Adadelta, Adagrad, Adam, Adamax, AdamW, DGCMomentum,
                        L1Decay, L2Decay, Lamb, Lars, Momentum, Optimizer,
                        RMSProp, SGD)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "DGCMomentum",
           "L1Decay", "L2Decay", "lr"]
