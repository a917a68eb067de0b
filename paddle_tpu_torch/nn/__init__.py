"""Neural-network layers and functionals (port of paddle_tpu/nn/)."""
from .layer import Dropout, Embedding, LayerNorm, Linear, RMSNorm, Tanh

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "RMSNorm", "Tanh"]
